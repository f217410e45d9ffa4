"""One rank of tests/test_torch_parallel_dist.py: a gloo process of a world
of four, which imports the PyTorch port only (never JAX).

``run(rank, world, port, scene, avatar, out_dir)`` joins the world, loads
what the parent built (``torch.save`` files: ``scene`` at once, ``avatar``
when the parent has written it, which it does while the ranks render),
runs every stage and writes its results to ``out_dir/rank<r>.pt``:

* the in-context renders (``rasterize`` with ``in_shard_axis``, with and
  without ``gaussian_shard``, dense backend "ref" and pair-major) on a
  (1, 4) and a (2, 2) process mesh: the outputs of every rank, and the
  value and input gradients of loss / D summed over the tile axis;
* one ``dp_train_step`` at data = 2 and one ``dp_tile_train_step`` at
  (data 2, tile 2) with and without ``gaussian_shard``, from the parent's
  state (``step_result``: losses, trainables, both moments, densification
  statistics); a second Gaussian-sharded step from the first;
* ``replicate_to_mesh`` of states that differ by rank;
* the (2, 2) mesh's layout under two processes per node.
"""
import copy
import dataclasses
import os
import time
import warnings

import torch
import torch.distributed as dist

from exavatar_release_tpu_torch.ops.rasterizer.api import rasterize
from exavatar_release_tpu_torch.parallel import (
    dp_tile_train_step,
    dp_train_step,
    init_distributed,
    make_host_mesh,
    replicate_to_mesh,
)
from exavatar_release_tpu_torch.train.loop import init_train_state
from exavatar_release_tpu_torch.train.optim import make_optimizer


def flat_trainables(state):
    return {k: v.detach().clone() for k, v in state.trainables.named_parameters()}


def step_result(state, losses):
    """What a step left: its losses, the trainables, both Adam moments (from
    zero moments mu = (1 - b1) g: the gradient itself, scale included) and
    the densification statistics."""
    aux = state.scene_aux
    return {"losses": losses, "trainables": flat_trainables(state),
            "mu": {k: v.clone() for k, v in state.opt_state.mu.items()},
            "nu": {k: v.clone() for k, v in state.opt_state.nu.items()},
            **{k: getattr(aux, k).clone() for k in ("xyz_grad_accum", "radius_max",
                                                     "track_cnt")}}


def _renders(inp, mesh, d):
    out = {}
    sc = inp["scene"]
    for mode, settings in inp["render_settings"].items():
        for gs in (False, True):
            ctx = dataclasses.replace(settings, mesh=mesh, in_shard_axis="tile", in_shard_size=d,
                                      gaussian_shard=gs)
            xs = [x.clone() for x in sc["args"]]
            for i in (0, 1, 3, 4):
                xs[i].requires_grad_(True)
            r = rasterize(*xs, sc["cam"], sc["img_shape"], sc["bg"], ctx)
            loss = ((r["img"] ** 2).sum() + r["mask"].sum() + r["depth"].sum()) / d
            loss.backward()
            summed = loss.detach().clone()
            dist.all_reduce(summed, group=mesh.group("tile"))
            grads = [xs[i].grad.clone() for i in (0, 1, 3, 4)]
            for g in grads:
                dist.all_reduce(g, group=mesh.group("tile"))
            out[mode, gs] = {"value": summed,
                             **{k: r[k].detach() for k in ("img", "mask", "depth", "mean2d",
                                                           "radius", "n_dropped")},
                             "exchange_overflow": r.get("exchange_overflow"),
                             "grads": grads}
    return out


def _wait_for(path, timeout_s=300.0):
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout_s} s")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def run(rank, world, port, scene, avatar, out_dir):
    torch.set_num_threads(1)
    os.environ["LOCAL_WORLD_SIZE"] = "2"  # two "nodes" of two processes
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        inp = torch.load(scene, weights_only=False)
        res = {"rank": rank}
        mesh22 = make_host_mesh(d_tile=2)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mesh14 = make_host_mesh(d_tile=4)
        res["span_warning"] = [str(w.message) for w in caught]
        res["layout"] = mesh22.device_mesh.mesh.tolist()
        res["index"] = (mesh22.index("data"), mesh22.index("tile"))
        res["renders4"] = _renders(inp, mesh14, 4)
        res["renders2"] = _renders(inp, mesh22, 2)
        inp = _wait_for(avatar)  # the parent writes it atomically

        def fresh():
            tr = copy.deepcopy(inp["trainables"])
            opt = make_optimizer(tr, inp["cfg"], 3.0, 100)
            return init_train_state(tr, copy.deepcopy(inp["scene_aux"]), opt), opt

        kw = dict(is_warmup=True, settings=inp["settings"])
        frames, bgs, bundle, cfg = inp["frames"], inp["bgs"], inp["bundle"], inp["cfg"]
        state, opt = fresh()
        state, losses = dp_train_step(state, bundle, frames, bgs, opt, cfg, mesh22, "data", **kw)
        res["dp"] = step_result(state, losses)
        for gs in (False, True):
            kw["settings"] = dataclasses.replace(inp["settings"], gaussian_shard=gs)
            state, opt = fresh()
            state, losses = dp_tile_train_step(state, bundle, frames, bgs, opt, cfg, mesh22, **kw)
            res["dp_tile", gs] = step_result(state, losses)
        state, losses = dp_tile_train_step(state, bundle, frames, bgs, opt, cfg, mesh22, **kw)
        res["second_step"] = (losses, flat_trainables(state))
        # every rank's own state (ranks 1-3 moved off rank 0's), then rank 0's
        state, _ = fresh()
        with torch.no_grad():
            for p in state.trainables.parameters():
                p.add_(float(rank))
            state.opt_state.mu["scene.mean"].fill_(float(rank))
            state.scene_aux.live[: rank].logical_not_()
        res["replicated"] = (flat_trainables(replicate_to_mesh(state, mesh22)),
                             state.opt_state.mu["scene.mean"].clone(),
                             state.scene_aux.live.clone())
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()

