"""The port's process-mesh paths (``exavatar_release_tpu_torch/parallel/``)
on real ``torch.distributed`` ranks: one spawn of four gloo processes on the
CPU for the whole file (tests/torch_dist_worker.py, one thread each, which
imports the port only), held against the port's own single-process results,
which tests/test_torch_parallel_raster.py and tests/test_torch_train_step.py
hold against the JAX package. Compiling the JAX package's data-parallel
programs here would cost minutes on the Tier-1 run's critical path, which
tests/test_parallel.py already fills.

* ``rasterize`` in context (``in_shard_axis``) at tile = 4 and 2, with and
  without ``gaussian_shard``, dense backend "ref" and pair-major, on
  tests/gs_scene.py's 96-Gaussian 64x256 scene in 8-row tiles: every rank's
  image, depth, mask and statistics against the local-mesh render of
  ``rasterize_sharded`` / ``rasterize_gaussian_sharded`` (1e-5, depth 1e-4,
  radius exact); the value and input gradients of loss / D summed over the
  tile axis at rtol 1e-5 / atol 2e-4 (tests/test_parallel.py's bounds);
* ``dp_train_step`` at data = 2 against one update on the mean of the two
  frames' ``loss_and_grads`` in this process: loss rtol 2e-4, trainables
  rtol 2e-3 / atol 2.2e-3 (one Adam quantum, tests/test_parallel.py:440-455:
  a near-zero gradient may flip sign under another summation order), and,
  since Adam's first step is blind to a gradient's scale, both moments
  (mu = (1 - b1) g from zero: a wrong 1/B or a sum taken twice shows) and
  the densification statistics at tests/test_torch_train_step.py's bounds;
  that file holds ``dp_train_step``'s mean gradient over two frames against
  the mean of JAX's ``value_and_grad`` of each;
* ``dp_tile_train_step`` at (data 2, tile 2), with and without
  ``gaussian_shard``, against ``dp_train_step`` at the same bounds;
* every rank's trainables equal after two steps, and after
  ``replicate_to_mesh`` of states that differ by rank;
* ``init_distributed`` a no-op alone, ``make_host_mesh`` keeping the tile
  rows within a node (and warning when they cannot be).

The avatar is tests/test_parallel.py's (``AvatarSetup(H=32, W=48,
capacity=128, n_scene=60, n_frames=2)``), built once here through
tests/torch_frame_fixture.py and carried across as the port's objects; its
renders use 8-row tiles, so that both bands of tile = 2 hold pixels.
"""
import copy
import dataclasses
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_dist_worker
from exavatar_release_tpu_torch.core.camera import Camera as TCamera
from exavatar_release_tpu_torch.ops.rasterizer.api import RasterizeSettings
from exavatar_release_tpu_torch.parallel import (
    init_distributed,
    make_mesh,
    rasterize_gaussian_sharded,
    rasterize_sharded,
)
from exavatar_release_tpu_torch.train import loop as tl
from exavatar_release_tpu_torch.train.optim import make_optimizer
from gs_scene import make_scene
from torch_frame_fixture import TwinFrame

torch.set_num_threads(2)

WORLD = 4
TIMEOUT_S = 300
RENDER_SETTINGS = {"ref": RasterizeSettings(backend="ref", tile_h=8, max_per_tile=256),
                   "pair_major": RasterizeSettings(tile_h=8, pair_major=True, chunk=128)}
RENDER_KEYS = ("img", "mask", "depth", "mean2d")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scene():
    sc = make_scene(np.random.default_rng(0), n=96, img=(64, 256))
    t = lambda x: torch.from_numpy(np.array(x))
    return {"args": [t(sc[k]) for k in ("means3d", "scales", "quats", "opacities", "rgbs",
                                        "live")],
            "cam": TCamera(*(t(x) for x in sc["cam"])), "img_shape": sc["img_shape"],
            "bg": t(sc["bg"])}


def _local_renders(sc):
    """The standalone renders over a local mesh of CPU devices, the loss
    undivided: the references of the in-context ones."""
    out = {}
    for d in (4, 2):
        mesh = make_mesh((d,), ("tile",), [torch.device("cpu")] * d)
        for mode, settings in RENDER_SETTINGS.items():
            for gs in (False, True):
                xs = [x.clone() for x in sc["args"]]
                for i in (0, 1, 3, 4):
                    xs[i].requires_grad_(True)
                fn = rasterize_gaussian_sharded if gs else rasterize_sharded
                r = fn(*xs, sc["cam"], sc["img_shape"], sc["bg"], mesh, "tile", settings)
                loss = (r["img"] ** 2).sum() + r["mask"].sum() + r["depth"].sum()
                loss.backward()
                out[d, mode, gs] = {"value": loss.detach(),
                                    **{k: r[k].detach() for k in RENDER_KEYS + ("radius",)},
                                    "grads": [xs[i].grad for i in (0, 1, 3, 4)]}
    return out


def _shared_update(inp):
    """One update on the mean of the two frames' ``loss_and_grads``."""
    tr = copy.deepcopy(inp["trainables"])
    opt = make_optimizer(tr, inp["cfg"], 3.0, 100)
    state = tl.init_train_state(tr, copy.deepcopy(inp["scene_aux"]), opt)
    outs = [tl.loss_and_grads(tr, state.scene_aux, inp["bundle"], f, bg, inp["cfg"], True,
                              settings=inp["settings"])
            for f, bg in zip(inp["frames"], inp["bgs"])]
    grads = {k: (outs[0][2][k] + outs[1][2][k]) / 2 for k in outs[0][2]}
    g_m2d = outs[0][3] + outs[1][3]
    vis = outs[0][1].scene_is_vis | outs[1][1].scene_is_vis
    radius = torch.maximum(outs[0][1].scene_radius, outs[1][1].scene_radius)
    img = inp["frames"][0].img
    state = tl.apply_update(state, grads, g_m2d, vis, radius, opt, inp["cfg"],
                            (int(img.shape[1]), int(img.shape[2])))
    return torch_dist_worker.step_result(state, {"total": (outs[0][0] + outs[1][0]) / 2})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Builds the inputs, runs the four ranks and, while they run, the
    single-process references; returns (inputs, references, per-rank
    results)."""
    tmp = tmp_path_factory.mktemp("dist")
    scene = {"scene": _scene(), "render_settings": RENDER_SETTINGS}
    torch.save(scene, str(tmp / "scene.pt"))
    avatar = str(tmp / "avatar.pt")
    ctx = mp.start_processes(torch_dist_worker.run,
                             args=(WORLD, _free_port(), str(tmp / "scene.pt"), avatar, str(tmp)),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        # the avatar and the references, while the ranks start and render
        twin = TwinFrame(H=32, W=48, capacity=128, n_scene=60, n_frames=2)
        inp = {"trainables": twin.t_trainables, "scene_aux": twin.t_scene_aux,
               "bundle": twin.t_bundle, "frames": [twin.t_frame(0), twin.t_frame(1)],
               "bgs": torch.from_numpy(np.random.default_rng(7).uniform(0, 1, (2, 3))
                                       .astype(np.float32)),
               "cfg": twin.t_cfg, "settings": dataclasses.replace(twin.t_settings, tile_h=8)}
        torch.save(inp, avatar + ".part")
        os.replace(avatar + ".part", avatar)
        ref = {"renders": _local_renders(scene["scene"]), "update": _shared_update(inp)}
        deadline = time.monotonic() + TIMEOUT_S
        while not ctx.join(timeout=0.2):  # raises when a rank fails
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    ranks = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return inp, ref, ranks


def test_init_distributed_is_a_noop_alone(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "RANK", "WORLD_SIZE", "MASTER_ADDR",
                "SLURM_JOB_NUM_NODES", "SLURM_JOB_NODELIST"):
        monkeypatch.delenv(var, raising=False)
    init_distributed(device="cpu")
    assert not dist.is_initialized()


def test_host_mesh_keeps_tile_rows_within_a_node(world):
    _, _, ranks = world
    for r in ranks:
        # two processes per node, ranks node-major: a tile row is one node
        assert r["layout"] == [[0, 1], [2, 3]]
        assert r["index"] == divmod(r["rank"], 2)
        assert any("spans 2 nodes" in w for w in r["span_warning"])


def _assert_grads(got, want):
    for g, w, k in zip(got, want, ("means3d", "scales", "opacities", "rgbs")):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("mode", list(RENDER_SETTINGS))
@pytest.mark.parametrize("gaussian_shard", [False, True], ids=["replicated", "gaussian_shard"])
@pytest.mark.parametrize("tile", [4, 2])
def test_in_context_render_vs_local_mesh(world, tile, gaussian_shard, mode):
    _, ref, ranks = world
    want = ref["renders"][tile, mode, gaussian_shard]
    for r in ranks:
        got = r[f"renders{tile}"][mode, gaussian_shard]
        for k, tol in zip(RENDER_KEYS, (1e-5, 1e-5, 1e-4, 1e-4)):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=tol, err_msg=k)
        np.testing.assert_array_equal(got["radius"].numpy(), want["radius"].numpy())
        assert int(got["n_dropped"]) == 0
        if gaussian_shard:
            assert int(got["exchange_overflow"]) == 0
        np.testing.assert_allclose(float(got["value"]), float(want["value"]), rtol=1e-5)
        _assert_grads(got["grads"], want["grads"])


def _assert_step(got, want):
    """Loss rtol 2e-4; trainables rtol 2e-3 / atol 2.2e-3 (one Adam quantum);
    both moments, each leaf within 1e-3 (mu) and 2e-3 (nu) of its own largest
    value, as tests/test_torch_train_step.py holds the moments to JAX's: Adam's
    first step does not see a gradient's scale, its moments do; the
    densification statistics as that file holds them (counts equal, radius
    atol 1e-3, the gradient sums 1e-3 of their largest)."""
    np.testing.assert_allclose(float(got["losses"]["total"]), float(want["losses"]["total"]),
                               rtol=2e-4, atol=1e-6)
    for k, w in want["trainables"].items():
        np.testing.assert_allclose(got["trainables"][k].numpy(), w.numpy(), rtol=2e-3,
                                   atol=2.2e-3, err_msg=k)
    assert set(got["mu"]) == set(want["mu"]) == set(want["trainables"])
    for m, tol in (("mu", 1e-3), ("nu", 2e-3)):
        for k, w in want[m].items():
            scale = max(float(w.abs().max()), 1e-30)
            assert float((got[m][k] - w).abs().max()) <= tol * scale, (m, k)
    np.testing.assert_array_equal(got["track_cnt"].numpy(), want["track_cnt"].numpy())
    np.testing.assert_allclose(got["radius_max"].numpy(), want["radius_max"].numpy(), atol=1e-3)
    np.testing.assert_allclose(got["xyz_grad_accum"].numpy(), want["xyz_grad_accum"].numpy(),
                               atol=1e-3 * float(want["xyz_grad_accum"].max()))


def test_dp_train_step_vs_one_shared_update(world):
    _, ref, ranks = world
    for r in ranks:
        _assert_step(r["dp"], ref["update"])
    assert float(ranks[0]["dp"]["track_cnt"].sum()) > 0  # densification statistics tracked
    assert float(ranks[0]["dp"]["xyz_grad_accum"].max()) > 0


@pytest.mark.parametrize("gaussian_shard", [False, True], ids=["replicated", "gaussian_shard"])
def test_dp_tile_train_step_vs_dp_train_step(world, gaussian_shard):
    _, _, ranks = world
    for r in ranks:
        _assert_step(r["dp_tile", gaussian_shard], r["dp"])
        assert float(r["dp_tile", gaussian_shard]["losses"]["raster_exchange_overflow"]) == 0


def test_replicate_to_mesh_gives_every_rank_rank0s_state(world):
    inp, _, ranks = world
    tr0, mu0, live0 = ranks[0]["replicated"]
    assert torch.equal(live0, inp["scene_aux"].live)  # rank 0 kept its own
    for r in ranks[1:]:
        tr, mu, live = r["replicated"]
        assert all(torch.equal(tr[k], tr0[k]) for k in tr0)
        assert torch.equal(mu, mu0) and not mu.any() and torch.equal(live, live0)


def test_every_rank_holds_the_same_trainables_after_two_steps(world):
    inp, _, ranks = world
    first = ranks[0]["second_step"][1]
    moved = [k for k, v in inp["trainables"].named_parameters()
             if not torch.equal(first[k], v.detach())]
    assert moved
    for r in ranks[1:]:
        for k, v in r["second_step"][1].items():
            assert torch.equal(v, first[k]), (r["rank"], k)
