"""The stage probes and the window build of the PyTorch port against the JAX
package's probe tools on the CPU.

* every variant of ``kernels.composite_tiles_fwd_variant`` /
  ``composite_tiles_bwd_variant`` (CPU tensors run the plain versions)
  against ``tools/kvariants.py``'s own ``build_fwd`` / ``build_bwd`` with the
  same options, run in Pallas interpret mode: the tool module's ``pl`` is
  swapped, in this test only, for a proxy whose ``pallas_call`` adds
  ``interpret=True``. 4 tiles of 8x32, K = 512 in chunks of 256 (the
  card's staging batch), opaque Gaussians that end pixels in the first
  chunk, one tile ending early with sentinel rows. Forward: each lane of
  accum and tfinal within 1e-5 of that lane's largest value; backward: each
  lane of dquad and dcolor within 5e-4 of its largest value, the tolerance
  of the row-major kernels' CPU tests. ``chunk`` (the TPU formulation with
  nothing stubbed) is held to the tool's base; ``noT+logsp`` to the tool's
  ``logsp`` (noT changes only the TPU layout, and the combination does not
  run in interpret mode);
* base and every exact variant against kernels 5 and 6 with origins;
* ``kernels.tile_windows`` (its plain version on the CPU) against
  ``tools/win_probe.py``'s ``windows_dma`` in interpret mode and
  ``windows_xla``, integer for integer.
"""
import importlib.util
import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn
from torch_port_fixture import FAST_COMPILE
from torch_windows import windows

torch.set_num_threads(2)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TILE = (8, 32)
T, K, CHUNK = 4, 512, 256
P = TILE[0] * TILE[1]

JAX_FWD = {"base": {}, "noexp": {"noexp": True}, "nomm": {"nomm": True},
           "noskip": {"noskip": True}, "logsp": {"logsp": True}, "pipe": {"pipe": True},
           "chunk": {}}
JAX_BWD = {"base": {}, "noexp": {"noexp": True}, "nomm": {"nomm": True},
           "nograd": {"nograd": True}, "fusedgrad": {"fusedgrad": True}, "noT": {"noT": True},
           "nodeloc": {"nodeloc": True}, "logsp": {"logsp": True},
           "noT+logsp": {"logsp": True}, "pipe": {"pipe": True}, "chunk": {}}


def _load_tool(name):
    """A module of tools/ loaded from its file, with Pallas calls interpreted."""
    spec = importlib.util.spec_from_file_location(f"_probe_{name}",
                                                  osp.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class _Interpret:
        def __init__(self, pl):
            self._pl = pl

        def __getattr__(self, attr):
            return getattr(self._pl, attr)

        def pallas_call(self, *args, **kwargs):
            kwargs["interpret"] = True
            return self._pl.pallas_call(*args, **kwargs)

    mod.pl = _Interpret(mod.pl)
    return mod


@pytest.fixture(scope="module")
def kv():
    return _load_tool("kvariants")


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(23)
    win, counts, origins = windows(rng, T=T, K=K, tile_shape=TILE, nx=2)
    win[:, 5] = np.where(win[:, 5] > -1e8, np.log(0.5 + 0.5 * rng.uniform(size=(T, K))),
                         win[:, 5]).astype(np.float32)
    quad = np.ascontiguousarray(win[:, :8].transpose(0, 2, 1))
    color = np.ascontiguousarray(win[:, 8:].transpose(0, 2, 1))
    t = torch.from_numpy
    accum, tfinal = kn.composite_tiles_fwd(t(quad), t(color), t(counts), TILE, t(origins))
    g_accum = rng.normal(size=(T, P, 4)).astype(np.float32)
    g_tfinal = rng.normal(size=(T, P, 1)).astype(np.float32)
    a = accum.numpy()
    # A_p in the kernels' order
    atot = (g_accum[..., 0] * a[..., 0] + g_accum[..., 1] * a[..., 1]
            + g_accum[..., 2] * a[..., 2] + g_accum[..., 3] * a[..., 3]
            + g_tfinal[..., 0] * tfinal.numpy()[..., 0])[..., None]
    return dict(quad=quad, color=color, counts=counts, origins=origins, accum=a,
                tfinal=tfinal.numpy(), g_accum=g_accum, g_tfinal=g_tfinal, atot=atot)


def _port_fwd(variant, s):
    t = torch.from_numpy
    return [x.numpy() for x in kn.composite_tiles_fwd_variant(
        variant, t(s["quad"]), t(s["color"]), t(s["counts"]), TILE, t(s["origins"]))]


def _port_bwd(variant, s):
    t = torch.from_numpy
    return [x.numpy() for x in kn.composite_tiles_bwd_variant(
        variant, t(s["quad"]), t(s["color"]), t(s["counts"]), t(s["g_accum"]),
        t(s["g_tfinal"]), t(s["accum"]), t(s["tfinal"]), TILE, t(s["origins"]))]


def _lanes_within(got, want, tol):
    """Each lane (last axis) of got within tol of that lane's largest |want|."""
    for lane in range(want.shape[-1]):
        scale = float(np.abs(want[..., lane]).max())
        err = float(np.abs(got[..., lane] - want[..., lane]).max())
        assert err <= tol * max(scale, 1e-30), (lane, err, scale)


def test_scene_terminates_pixels(scene):
    """The scene exercises the chunk carry: pixels end in the first chunk."""
    tf = scene["tfinal"]
    assert (tf < 1e-3).mean() > 0.5 and (tf > 1e-3).any()


@pytest.mark.parametrize("variant", kn.FWD_VARIANTS)
def test_fwd_variant_vs_jax(kv, scene, variant):
    s = scene
    run = kv.build_fwd(T, K, P, *TILE, CHUNK, **JAX_FWD[variant])
    args = [jnp.asarray(s[k]) for k in ("counts", "quad", "color", "origins")]
    want = [np.asarray(x) for x in run.lower(*args).compile(compiler_options=FAST_COMPILE)(*args)]
    got = _port_fwd(variant, s)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _lanes_within(g, w, 1e-5)


@pytest.mark.parametrize("variant", kn.BWD_VARIANTS)
def test_bwd_variant_vs_jax(kv, scene, variant):
    s = scene
    run = kv.build_bwd(T, K, P, *TILE, CHUNK, **JAX_BWD[variant])
    args = [jnp.asarray(s[k]) for k in ("counts", "quad", "color", "g_accum", "g_tfinal", "atot",
                                        "origins")]
    want = [np.asarray(x) for x in run.lower(*args).compile(compiler_options=FAST_COMPILE)(*args)]
    got = _port_bwd(variant, s)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if variant == "nograd":
            assert not g.any() and not w.any()
        else:
            _lanes_within(g[..., :6] if g.shape[-1] == 8 else g,
                          w[..., :6] if w.shape[-1] == 8 else w, 5e-4)
            assert not g[..., 6:8].any() if g.shape[-1] == 8 else True


def test_exact_variants_equal_kernels_5_and_6(scene):
    """base is kernels 5 and 6 themselves; every exact variant's plain
    version gives their output within the tolerances above."""
    s = scene
    t = torch.from_numpy
    f5 = [x.numpy() for x in kn.composite_tiles_fwd(t(s["quad"]), t(s["color"]),
                                                    t(s["counts"]), TILE, t(s["origins"]))]
    b6 = [x.numpy() for x in kn.composite_tiles_bwd(
        t(s["quad"]), t(s["color"]), t(s["counts"]), t(s["g_accum"]), t(s["g_tfinal"]),
        t(s["accum"]), t(s["tfinal"]), TILE, t(s["origins"]))]
    for g, w in zip(_port_fwd("base", s), f5):
        assert np.array_equal(g, w)
    for g, w in zip(_port_bwd("base", s), b6):
        assert np.array_equal(g, w)
    for v in kn.EXACT_VARIANTS:
        if v in kn.FWD_VARIANTS:
            for g, w in zip(_port_fwd(v, s), f5):
                _lanes_within(g, w, 1e-5)
        if v in kn.BWD_VARIANTS:
            for g, w in zip(_port_bwd(v, s), b6):
                _lanes_within(g, w, 5e-4)


def test_unknown_variant_raises(scene):
    s = scene
    t = torch.from_numpy
    with pytest.raises(ValueError):
        kn.composite_tiles_fwd_variant("nograd", t(s["quad"]), t(s["color"]), t(s["counts"]),
                                       TILE, t(s["origins"]))


def test_tile_windows_vs_jax():
    wp = _load_tool("win_probe")
    rng = np.random.default_rng(4)
    n, T_w, K_w, Pm = 1000, 24, 64, 1200
    starts = np.sort(rng.integers(0, Pm, (T_w + 1,)).astype(np.int32))
    starts[0], starts[-1] = 0, Pm
    starts[5] = starts[6]  # an empty tile
    rank = rng.integers(0, n, (Pm,)).astype(np.int32)
    rank_pad = np.concatenate([rank, [n]]).astype(np.int32)
    rank_pad2 = np.concatenate([rank, np.full(K_w, n)]).astype(np.int32).reshape(1, -1)
    got = kn.tile_windows(torch.from_numpy(starts), torch.from_numpy(rank_pad), K_w, n)
    assert got.dtype == torch.int32 and got.shape == (T_w, K_w)
    xla = np.asarray(wp.windows_xla(jnp.asarray(starts), jnp.asarray(rank_pad), K_w, n))
    dma = np.asarray(wp.windows_dma(jnp.asarray(starts), jnp.asarray(rank_pad2), K_w, n,
                                    interpret=True))
    assert np.array_equal(got.numpy(), xla) and np.array_equal(got.numpy(), dma)
    # windows wider than K clip, and an empty tile holds only the sentinel
    assert (np.diff(starts) > K_w).any() and (got[5] == n).all()
