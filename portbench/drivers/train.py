"""Train traffic: one trainer in a closed loop, ``train_step`` per frame
over the configuration's frames in a seeded order per epoch, a background
drawn each step, the drop counters read on the host after every step and
fed to the capacity governor, as the program's ``train_loop`` does.

Set-up builds the train state at the traffic's start iteration, lets the
program's governor settle its rasterizer settings from
``RasterizeSettings()`` on forward passes, then drives the state through
its first ``compare_steps`` steps with the window's own step and feed; the
window goes on with the same state. After the window the reference follows
those first steps from the same inputs, and ``compare`` holds the two.
"""
from __future__ import annotations

import importlib
import math
import statistics
import time

import numpy as np
import torch

import harness
from build import PROGRAM, REFERENCE, build_trainer
from inputs import generator, make_inputs

DIAGNOSTICS = ("raster_dropped_pairs", "raster_truncated", "raster_exchange_overflow")


class Feed:
    """The frame order (a permutation per epoch from a numpy generator) and
    the backgrounds (a ``torch.Generator`` on the device), from the seed."""

    def __init__(self, seed: int, n_frames: int, device):
        self.rng = np.random.default_rng(int(seed) & ((1 << 63) - 1))
        self.gen = generator(seed + 1, device)
        self.n, self.order, self.device = n_frames, [], device

    def next(self):
        if not self.order:
            self.order = list(self.rng.permutation(self.n))
        return int(self.order.pop(0)), torch.rand(3, generator=self.gen, device=self.device)


def leaf_norms(tensors: dict) -> dict:
    names = list(tensors)
    vals = torch.stack([tensors[k].detach().float().norm() for k in names]).tolist()
    return dict(zip(names, vals))


def snapshot(trainables) -> dict:
    return {k: p.detach().clone() for k, p in trainables.named_parameters()}


class Trainer:
    """One side's state and its step: the program's in the window, either
    side's in the compared steps."""

    def __init__(self, side, governor=None):
        self.s = side
        self.governor = governor

    def step(self, frame_i: int, bg: torch.Tensor):
        s = self.s
        kw = {} if self.governor is None else {"settings": self.governor.settings}
        s.state, losses = s.loop.train_step(s.state, s.bundle, s.frames[frame_i], s.opt, s.cfg,
                                            is_warmup=False, bg=bg, **kw)
        s.state, _ = s.loop.maybe_adjust_gaussians(s.state, s.state.itr - 1, s.cfg)
        vals = torch.stack([losses["total"].float()] + [losses[k].float() for k in DIAGNOSTICS]
                           ).tolist()
        if self.governor is not None:
            self.governor.update(*vals[1:])
        ok = math.isfinite(vals[0]) and vals[1] == 0 and vals[2] == 0
        return vals[0], ok


def first_steps(trainer: Trainer, steps, on_step=None) -> dict:
    """Drives ``trainer`` through ``steps`` [(frame, bg)]: each step's loss,
    every leaf's gradient norm as Adam got it in step 1 (its first moment
    over 1 - b1), and every leaf's change over all the steps, taken before
    any later step moves it."""
    s = trainer.s
    p0 = snapshot(s.state.trainables)
    losses, grad = [], None
    for i, (frame_i, bg) in enumerate(steps):
        if on_step is not None:
            on_step(i)
        loss, _ = trainer.step(frame_i, bg)
        losses.append(loss)
        if i == 0:
            b1 = s.opt.b1
            grad = leaf_norms({k: m / (1.0 - b1) for k, m in s.state.opt_state.mu.items()})
    change = leaf_norms({k: p - p0[k] for k, p in s.state.trainables.named_parameters()})
    return {"loss": losses, "grad": grad, "change": change}


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """|program norm - reference norm| over the larger of the reference's
    norm of that leaf and of the median leaf, for every kept leaf."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def worst_leaf(prog: dict, ref: dict, keep):
    gaps = leaf_gaps(prog, ref, keep)
    k = max(gaps, key=gaps.get)
    return k, gaps[k]


def compare(p: dict, r: dict, loss_steps: int) -> dict:
    """The three numbers ``correct`` rests on: the largest relative gap of
    the first ``loss_steps`` steps' losses, and by the worst leaf the first
    gradient's norm and the change over all the compared steps. The last
    step's loss follows two sign-like Adam moves of the fresh moments, which
    a rounding flip of a near-zero gradient element changes, so it is left
    out. Leaves whose reference gradient is under a thousandth of the median
    leaf's move under Adam by round-off alone: the change leaves them out."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(p["loss"][:loss_steps], r["loss"]))
    leaves = sorted(r["grad"])
    med_g = statistics.median(r["grad"][k] for k in leaves)
    moved = [k for k in leaves if r["grad"][k] >= 1e-3 * med_g]
    grad, change = worst_leaf(p["grad"], r["grad"], leaves), worst_leaf(p["change"], r["change"], moved)
    return {"loss_gap": loss, "grad_gap": grad[1], "step_gap": change[1],
            "worst_leaves": (grad[0], change[0])}


def settle_settings(side, log) -> object:
    """The rasterizer settings the program's governor settles on from
    ``RasterizeSettings()`` (patience 1), on forward passes of the cell's
    frames that change no state; returns the settled settings."""
    model = importlib.import_module(f"{PROGRAM}.avatar.model")
    api = importlib.import_module(f"{PROGRAM}.ops.rasterizer.api")
    gov = side.loop.RasterCapacityGovernor(api.RasterizeSettings(), patience=1, log=log)
    s, b = side.state, side.bundle
    ones = torch.ones(3, device=s.trainables.scene.mean.device)
    n = len(side.frames)
    for k in range(16):
        frame = side.frames[k % n]
        with torch.no_grad():
            out = model.forward_frame(
                s.trainables, s.scene_aux, b.buffers, b.prior, b.statics, b.id_info, b.lpips,
                b.face_texture, b.face_texture_mask, b.init_joint_offset, frame, ones, side.cfg,
                is_warmup=False, mode="train", settings=gov.settings)
        dropped, truncated = (float(out.raster_dropped_pairs), float(out.raster_truncated))
        if dropped == 0 and truncated == 0 and k >= n - 1:
            break
        gov.update(dropped, truncated)
    return gov.settings


def program_side(env, inp):
    """Set-up of the program: build, settle, the first steps. Returns
    (trainer, feed, readings, the steps' (frame, bg))."""
    side = build_trainer(PROGRAM, inp, env.device, env.traffic["start_itr"],
                         env.traffic["tot_itr"])
    env.log("program built")
    feed = Feed(env.seed, len(side.frames), env.device)
    settings = settle_settings(side, env.log)
    env.log(f"settled rasterizer settings: {settings}")
    trainer = Trainer(side, side.loop.RasterCapacityGovernor(settings, log=env.log))
    steps = [feed.next() for _ in range(env.traffic["compare_steps"])]
    readings = first_steps(trainer, steps)
    env.log(f"first {len(steps)} steps done")
    return trainer, feed, readings, steps


def reference_side(env, inp, steps, counting: bool = False):
    """The reference's first steps on the same inputs, frames and
    backgrounds. With ``counting``: the compositing work of those steps
    and the FLOPs of the first, for the rooflines and ``mfu``."""
    from torch.utils.flop_counter import FlopCounterMode

    from counts.composite import COUNTS, work_per_unit

    ref = build_trainer(REFERENCE, inp, env.device, env.traffic["start_itr"],
                        env.traffic["tot_itr"])
    trainer = Trainer(ref)
    flops = FlopCounterMode(display=False) if counting else None
    COUNTS.reset()
    COUNTS.on = counting

    def on_step(i):
        if flops is not None and i == 0:
            flops.__enter__()
        if flops is not None and i == 1:
            flops.__exit__(None, None, None)

    try:
        readings = first_steps(trainer, steps, on_step)
    finally:
        COUNTS.on = False
    extra = {}
    if counting:
        extra = {"flops_first_step": flops.get_total_flops(), "work": work_per_unit(COUNTS, len(steps))}
    del ref, trainer
    return readings, extra


def run(env) -> dict:
    tr = env.traffic
    inp = make_inputs(env.cfg, env.seed, env.device, "train")
    env.log("inputs made")
    trainer, feed, prog, steps = program_side(env, inp)
    env.mark_setup()

    def one():
        return trainer.step(*feed.next())

    res = {"attempted": 0, "failed": 0}
    if env.trace:
        api = importlib.import_module(f"{PROGRAM}.ops.rasterizer.api")
        kernels = importlib.import_module(f"{PROGRAM}.ops.rasterizer.kernels")
        for k in kernels.KERNELS:
            k.launches = 0
        env.reset_peak()

        def units():
            for _ in range(tr["trace_units"]):
                res["attempted"] += 1
                res["failed"] += not one()[1]
            return tr["trace_units"]

        with harness.Spans([(api, "prepare", harness.SPANS["prepare"])]):
            n, window_s, trace = env.traced(units)
        res["launch_counters"] = {k.__name__: k.launches / n for k in kernels.KERNELS}
        res.update(trace=trace, units=n, unit_s=window_s / n)
    else:
        env.reset_peak()
        t0 = time.perf_counter()
        deadline = t0 + env.seconds
        while time.perf_counter() < deadline:
            res["attempted"] += 1
            res["failed"] += not one()[1]
        elapsed = time.perf_counter() - t0
        res["end_to_end"] = {"train_step_ms": 1e3 * elapsed / res["attempted"]}
    res["peak"] = env.peak()
    del trainer, feed
    harness.free_device()

    env.log(f"window closed: {res['attempted']} steps")
    ref, extra = reference_side(env, inp, steps, counting=env.trace)
    env.log("reference done")
    res.update(extra)
    gaps = compare(prog, ref, tr["loss_steps"])
    env.log(f"program losses {prog['loss']}, reference {ref['loss']}; worst leaves (gradient, "
            f"change) {gaps.pop('worst_leaves')}")
    for name, value in gaps.items():
        env.checks.add(name, value, tr["limits"][name])
    return res
