#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, for one cell:

    python3 portbench/control.py --workload <cell> --seeds 101 102 ... [--faults 3]

For each seed, in one process: the program's compared numbers against the
reference (the lower reading: set-up and the compared steps or frames as a
run makes them, without the window), the control's (the reference computed
one precision below the configuration's float32 with TF32 off: TF32 on for
matmuls and cuDNN, put in the program's place), and, on the first
``--faults`` seeds, the program with each of the cell's faults planted
(``FAULTS``). One JSON line per seed; the benchmark's runs never run this.
The CPU tests call ``readings`` at a tiny size.
"""
import argparse
import json
import os
import sys
from contextlib import contextmanager
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402

harness.set_cache_dirs()


def _scale_img(out, factor):
    out = dict(out)
    out["img"] = out["img"] * factor
    return out


def _half(out):
    out = dict(out)
    img = out["img"].clone()
    img[img.shape[0] // 2:] = 1.0  # the bottom half's tiles left out: background
    out["img"] = img
    return out


@contextmanager
def planted(fault: str, driver: str):
    """The program with one fault planted, for as long as the block runs:
    ``frozen`` a train step that returns its state unchanged; ``altered``
    every render's image 1% off where it is produced; ``half`` the bottom
    half of every frame's tiles left out."""
    import importlib

    if fault == "none":
        yield
        return
    if fault == "frozen":
        mod = importlib.import_module("exavatar_release_tpu_torch.train.loop")
        orig = mod.apply_update
        mod.apply_update = lambda state, *a, **k: state._replace(itr=state.itr + 1)
        attr = "apply_update"
    else:
        name = "avatar.model" if driver == "train" else "apps.animate"
        mod = importlib.import_module(f"exavatar_release_tpu_torch.{name}")
        orig = mod.rasterize
        change = (lambda o: _scale_img(o, 1.01)) if fault == "altered" else _half
        mod.rasterize = lambda *a, **k: change(orig(*a, **k))
        attr = "rasterize"
    try:
        yield
    finally:
        setattr(mod, attr, orig)


FAULTS = {"train": ("frozen", "altered"), "animate": ("altered", "half")}


def round_tf32(x):
    """``x`` with its float32 mantissa rounded to TF32's 10 bits (nearest,
    ties away from zero), differentiable as the identity."""
    import torch

    i = x.detach().float().contiguous().view(torch.int32)
    r = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


def _tf32_mode():
    """Off the card, TF32 emulated: the inputs of every matmul and
    convolution rounded to 10 mantissa bits, float32 accumulation."""
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    ops = {F.linear, F.conv2d, torch.matmul, torch.mm, torch.bmm, torch.einsum,
           torch.Tensor.__matmul__, torch.Tensor.matmul}

    class TF32Inputs(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in ops:
                args = tuple(round_tf32(a) if isinstance(a, torch.Tensor)
                             and a.is_floating_point() else a for a in args)
            return func(*args, **kwargs)

    return TF32Inputs()


@contextmanager
def tf32(on: bool, device="cuda"):
    """The control's precision: TF32 for matmuls and cuDNN on the card, its
    emulation elsewhere."""
    import torch

    if device != "cuda":
        if on:
            with _tf32_mode():
                yield
        else:
            yield
        return
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def train_readings(env, seed: int, faults):
    import drivers.train as T
    from inputs import make_inputs

    env.seed = seed
    inp = make_inputs(env.cfg, seed, env.device, "train")
    prog_runs = {}
    steps = None
    for fault in ("none",) + tuple(faults):
        with planted(fault, "train"):
            trainer, _, readings, steps_f = T.program_side(env, inp)
        steps = steps if steps is not None else steps_f
        prog_runs[fault] = readings
        del trainer
        harness.free_device()
    ref, _ = T.reference_side(env, inp, steps)
    harness.free_device()
    with tf32(True, env.device):
        ctl, _ = T.reference_side(env, inp, steps)
    harness.free_device()
    n = env.traffic["loss_steps"]
    cmp = lambda got: {k: v for k, v in T.compare(got, ref, n).items() if k != "worst_leaves"}
    out = {"program": cmp(prog_runs["none"]), "control": cmp(ctl),
           "losses": {"program": prog_runs["none"]["loss"], "reference": ref["loss"],
                      "control": ctl["loss"]}}
    for fault in faults:
        out[f"fault_{fault}"] = cmp(prog_runs[fault])
        out["losses"][f"fault_{fault}"] = prog_runs[fault]["loss"]
    return out


def animate_readings(env, seed: int, faults):
    import importlib

    import numpy as np

    import drivers.animate as A
    from build import PROGRAM, REFERENCE, build_avatar, camera, posed
    from inputs import make_inputs

    H, W = env.cfg["image"]
    inp = make_inputs(env.cfg, seed, env.device, "animate")
    n = inp.poses["trans"].shape[0]
    rng = np.random.default_rng(seed)
    sample = sorted(rng.choice(n, size=min(env.traffic["compare_frames"], n),
                               replace=False).tolist())
    anim = importlib.import_module(f"{PROGRAM}.apps.animate")
    api = importlib.import_module(f"{PROGRAM}.ops.rasterizer.api")
    settings = api.RasterizeSettings(**env.traffic["settings"])
    prior, cfg, human, buffers, id_info = build_avatar(PROGRAM, inp, env.device)
    cam = camera(PROGRAM, inp)
    prog = {}
    for fault in ("none",) + tuple(faults):
        with planted(fault, "animate"):
            prog[fault] = [A.quantize(anim.render_motion(
                human, buffers, prior, id_info, [posed(PROGRAM, inp, i)], [cam], cfg, settings,
                (H, W))[0]["img"]).cpu() for i in sample]
    del prior, human, buffers
    harness.free_device()
    side = build_avatar(REFERENCE, inp, env.device)
    ref = [A.reference_frame(side, inp, i, (H, W)) for i in sample]
    with tf32(True, env.device):
        ctl = [A.reference_frame(side, inp, i, (H, W)) for i in sample]
    del side
    harness.free_device()
    flips = lambda got: {"level_flips": max(A.flip_share(g, w) for g, w in zip(got, ref))}
    out = {"program": flips(prog["none"]), "control": flips(ctl)}
    for fault in faults:
        out[f"fault_{fault}"] = flips(prog[fault])
    return out


def readings(env, seed: int, faults=()):
    fn = train_readings if env.traffic["driver"] == "train" else animate_readings
    return fn(env, seed, faults)


def main(argv=None) -> int:
    import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3)
    args = ap.parse_args(argv)
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    _, cfg, traffic = run.cell_spec(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        run.log("control readings are taken on the card: no CUDA device")
        return 3
    from exavatar_release_tpu_torch import cuda_build

    cuda_build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = SimpleNamespace(cfg=cfg, traffic=traffic, device="cuda", seed=0, log=run.log)
    for k, seed in enumerate(args.seeds):
        faults = FAULTS[traffic["driver"]] if k < args.faults else ()
        r = readings(env, seed, faults)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
