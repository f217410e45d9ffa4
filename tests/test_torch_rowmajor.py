"""The row-major compositing path of the PyTorch port against the JAX package
on the CPU.

* ``pack_tile_quads``: values (rtol 1e-6 of each lane's scale) and the
  gradient through it; lane 6 carries log_op, lane 7 zeros;
* each row-major function (``composite_tiles_fwd_v2`` / ``_bwd_v2``,
  ``composite_tiles_fwd`` / ``_bwd`` with and without origins; CPU tensors
  run the plain versions) against the Pallas kernel of the same name in
  interpret mode on identical (T, K, 8) / (T, K, 4) inputs: forward 1e-5
  (depth, whose values reach 5, 1e-4), each gradient lane 5e-4 of that lane's largest value. Both sides sum the
  same float32 terms, the JAX side through log-space prefix products;
* ``rasterize(kernel_v=2)`` against the JAX package's, image 1e-4 and input
  gradients at the tolerance of the JAX package's own
  ``test_kernel_v2_matches_v1`` (atol 5e-4 of the gradient's scale, rtol
  2e-3); ``kernel_v=2`` against ``kernel_v=1`` inside the port at the same
  tolerances; ``pair_major`` and backend "ref" ignore ``kernel_v``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.core.camera import Camera as JCamera
from exavatar_release_tpu.ops.rasterizer import RasterizeSettings as JSettings
from exavatar_release_tpu.ops.rasterizer import pallas_kernels as pk
from exavatar_release_tpu.ops.rasterizer import rasterize as j_rasterize
from exavatar_release_tpu.ops.rasterizer.preprocess import pack_tile_quads as j_pack
from exavatar_release_tpu_torch.core.camera import Camera as TCamera
from exavatar_release_tpu_torch.ops.rasterizer import RasterizeSettings, api, rasterize
from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn
from exavatar_release_tpu_torch.ops.rasterizer.preprocess import pack_tile_quads
from torch_frame_fixture import fast_jit
from torch_windows import windows

torch.set_num_threads(2)

TILE = (8, 32)
t = torch.from_numpy
j = jnp.asarray


@pytest.fixture(scope="module")
def rows():
    """4 tiles of 8x32, K = 256 (two chunks of 128 on the JAX side); opaque
    Gaussians a quarter pixel off pixel centers clamp alpha and end pixels
    (exactly on a center q == log_op, and the packed form's rounding, whose
    order XLA does not fix, would decide the test q <= log_op); tile 1 ends
    early with garbage past its count."""
    rng = np.random.default_rng(31)
    win, counts, origins = windows(rng, T=4, K=256, tile_shape=TILE, nx=2)
    win[:, 5, ::9] = 0.0
    win[:, 3, ::9] = np.round(win[:, 3, ::9]) + 0.25
    win[:, 4, ::9] = np.round(win[:, 4, ::9]) + 0.25
    rows_g = np.ascontiguousarray(win[:, :8].transpose(0, 2, 1))  # (T, K, 8) global rows
    color = np.ascontiguousarray(win[:, 8:].transpose(0, 2, 1))
    packed = np.array(j_pack(j(rows_g), j(origins)[:, None, :]))
    # slots past the count must never be read
    n1 = int(counts[1])
    rows_g[1, n1:] = packed[1, n1:] = 7.0
    P = TILE[0] * TILE[1]
    g_accum = rng.normal(size=(4, P, 4)).astype(np.float32)
    g_tfinal = rng.normal(size=(4, P, 1)).astype(np.float32)
    return dict(rows_g=rows_g, packed=packed, color=color, counts=counts, origins=origins,
                g_accum=g_accum, g_tfinal=g_tfinal)


def test_pack_tile_quads(rows):
    g, o = rows["rows_g"][:, :100], rows["origins"]
    want = np.asarray(j_pack(j(g), j(o)[:, None, :]))
    tg = t(g.copy()).requires_grad_(True)
    got = pack_tile_quads(tg, t(o)[:, None, :])
    assert got.shape == want.shape
    for lane in range(8):
        scale = max(1.0, float(np.abs(want[..., lane]).max()))
        assert float(np.abs(got[..., lane].detach().numpy() - want[..., lane]).max()) \
            <= 1e-6 * scale, lane
    assert torch.equal(got[..., 6], tg[..., 5]) and not got[..., 7].any()
    # the transpose: a cotangent whose lane 6 is zero, as the kernels send
    ct = np.random.default_rng(5).normal(size=want.shape).astype(np.float32)
    ct[..., 6:] = 0.0
    got_g, = torch.autograd.grad((got * t(ct)).sum(), tg)
    want_g = jax.grad(lambda x: jnp.sum(j_pack(x, j(o)[:, None, :]) * j(ct)))(j(g))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_g).max()))


CASES = {
    "fwd_v2": ("v2", False), "fwd": ("v1", False), "fwd_origins": ("v1", True),
    "bwd_v2": ("v2", False), "bwd": ("v1", False), "bwd_origins": ("v1", True),
}


def _both_forward(rows, gen, localize):
    quad = rows["rows_g"] if localize else rows["packed"]
    args = (quad, rows["color"], rows["counts"])
    if gen == "v2":
        want = pk.composite_tiles_fwd_v2(*map(j, args), TILE, chunk=128, interpret=True)
        got = kn.composite_tiles_fwd_v2(*map(t, args), TILE)
    else:
        o = rows["origins"] if localize else None
        want = pk.composite_tiles_fwd(*map(j, args), TILE, chunk=128, interpret=True,
                                      tile_origins=None if o is None else j(o))
        got = kn.composite_tiles_fwd(*map(t, args), TILE, None if o is None else t(o))
    return args, got, want


@pytest.mark.parametrize("case", list(CASES))
def test_row_major_function_vs_pallas_interpret(rows, case):
    gen, localize = CASES[case]
    args, (accum, tfinal), (j_accum, j_tfinal) = _both_forward(rows, gen, localize)
    P = TILE[0] * TILE[1]
    assert tuple(accum.shape) == (4, P, 4) and tuple(tfinal.shape) == (4, P, 1)
    if case.startswith("fwd"):
        np.testing.assert_allclose(accum[..., :3].numpy(), np.asarray(j_accum)[..., :3],
                                   atol=1e-5)
        np.testing.assert_allclose(accum[..., 3].numpy(), np.asarray(j_accum)[..., 3], atol=1e-4)
        np.testing.assert_allclose(tfinal.numpy(), np.asarray(j_tfinal), atol=1e-5)
        assert float(tfinal.min()) < 2e-4  # some pixels terminated
        return
    cot = (rows["g_accum"], rows["g_tfinal"])
    # each backward replays its own forward's outputs
    if gen == "v2":
        want = pk.composite_tiles_bwd_v2(*map(j, args), *map(j, cot), j_accum, j_tfinal, TILE,
                                         chunk=128, interpret=True)
        got = kn.composite_tiles_bwd_v2(*map(t, args), *map(t, cot), accum, tfinal, TILE)
    else:
        o = rows["origins"] if localize else None
        want = pk.composite_tiles_bwd(*map(j, args), *map(j, cot), j_accum, j_tfinal, TILE,
                                      chunk=128, interpret=True,
                                      tile_origins=None if o is None else j(o))
        got = kn.composite_tiles_bwd(*map(t, args), *map(t, cot), accum, tfinal, TILE,
                                     None if o is None else t(o))
    n1 = int(rows["counts"][1])
    for name, g, w, lanes in (("dquad", got[0], np.asarray(want[0]), 6),
                              ("dcolor", got[1], np.asarray(want[1]), 4)):
        g = g.numpy()
        assert g.shape == w.shape
        # the JAX v2 kernel leaves dead regions unwritten; the port zeroes them
        live = np.ones(g.shape[:2], bool)
        live[1, n1:] = False
        assert not g[~live].any(), name
        for lane in range(lanes):
            err = float(np.abs(g[..., lane] - w[..., lane])[live].max())
            assert err <= 5e-4 * float(np.abs(w[..., lane][live]).max()), (name, lane, err)
        assert not g[..., lanes:].any(), name  # lanes 6-7 of dquad


def test_packed_and_localized_rows_agree(rows):
    """Kernel 5's two input forms are the same function up to the float32
    expression of q, and kernel 3 is kernel 5 without origins."""
    c = (t(rows["color"]), t(rows["counts"]))
    a_p, t_p = kn.composite_tiles_fwd(t(rows["packed"]), *c, TILE)
    a_g, t_g = kn.composite_tiles_fwd(t(rows["rows_g"]), *c, TILE, t(rows["origins"]))
    a_2, t_2 = kn.composite_tiles_fwd_v2(t(rows["packed"]), *c, TILE)
    assert torch.equal(a_p, a_2) and torch.equal(t_p, t_2)
    assert float((a_p - a_g).abs().max()) <= 2e-4 and float((t_p - t_g).abs().max()) <= 2e-4
    # and the localized form is the channel-major kernel's function
    win = torch.cat([t(rows["rows_g"]), t(rows["color"])], dim=2).transpose(1, 2).contiguous()
    bg = torch.tensor([0.2, 0.5, 0.9])
    full = kn.composite_tiles_fwd_cm(win, c[1], t(rows["origins"]), bg, TILE)
    mine = torch.cat([a_g[..., :3] + t_g * bg, a_g[..., 3:4], 1 - t_g], dim=2).transpose(1, 2)
    assert float((full - mine).abs().max()) <= 1e-6


def _scene(rng, n=150, H=32, W=128, focal=150.0):
    z = rng.uniform(2.0, 4.0, (n, 1))
    x = rng.uniform(-0.5, 0.5, (n, 1)) * (W / focal) * z / 2
    y = rng.uniform(-0.5, 0.5, (n, 1)) * (H / focal) * z / 2
    q = rng.normal(size=(n, 4))
    d = dict(means3d=np.concatenate([x, y, z], 1),
             scales=np.exp(rng.uniform(np.log(0.02), np.log(0.12), (n, 3))),
             quats=q / np.linalg.norm(q, axis=1, keepdims=True),
             opacities=rng.uniform(0.2, 0.95, (n, 1)), rgbs=rng.uniform(0, 1, (n, 3)))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    cam = dict(R=np.eye(3, dtype=np.float32), t=np.zeros(3, np.float32),
               focal=np.asarray([focal, focal], np.float32),
               princpt=np.asarray([W / 2.0, H / 2.0], np.float32))
    return d, cam, (H, W)


NAMES = ("means3d", "scales", "quats", "opacities", "rgbs")


def _t_render(d, cam, shape, settings):
    args = [t(d[k].copy()).requires_grad_(True) for k in NAMES]
    r = rasterize(*args, torch.ones(len(d["means3d"]), dtype=torch.bool),
                  TCamera(**{k: t(v) for k, v in cam.items()}), shape, torch.zeros(3), settings)
    loss = (r["img"] ** 2).sum() + r["mask"].sum() + r["depth"].sum()
    return r, [g.numpy() for g in torch.autograd.grad(loss, args)]


@pytest.fixture(scope="module")
def renders():
    d, cam, shape = _scene(np.random.default_rng(9))
    jc = JCamera(**{k: j(v) for k, v in cam.items()})
    js = JSettings(max_per_tile=64, chunk=16, backend="pallas", kernel_v=2, interpret=True)

    def loss(ms, ss, qs, os_, cs):
        r = j_rasterize(ms, ss, qs, os_, cs, jnp.ones(len(d["means3d"]), bool), jc, shape,
                        jnp.zeros(3), js)
        return jnp.sum(r["img"] ** 2) + jnp.sum(r["mask"]) + jnp.sum(r["depth"]), r

    vg = fast_jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True))
    (_, j_r), j_g = vg(*(j(d[k]) for k in NAMES))
    port = {kv: _t_render(d, cam, shape, RasterizeSettings(max_per_tile=64, kernel_v=kv))
            for kv in (1, 2)}
    return d, cam, shape, j_r, j_g, port


def _grads_close(got, want):
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        scale = max(1e-3, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=5e-4 * scale, rtol=2e-3, err_msg=name)


def test_rasterize_kernel_v2_vs_jax(renders):
    *_, j_r, j_g, port = renders
    r, grads = port[2]
    for k in ("img", "mask", "depth"):
        np.testing.assert_allclose(r[k].detach().numpy(), np.asarray(j_r[k]), atol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(r["tile_counts"].numpy(), np.asarray(j_r["tile_counts"]))
    assert int(r["n_truncated"]) == int(j_r["n_truncated"])
    _grads_close(grads, j_g)


def test_kernel_v2_vs_kernel_v1_in_the_port(renders):
    *_, port = renders
    (r1, g1), (r2, g2) = port[1], port[2]
    for k in ("img", "mask", "depth"):
        # depth values reach 4: the same relative error is a larger difference
        np.testing.assert_allclose(r2[k].detach().numpy(), r1[k].detach().numpy(), atol=1e-4,
                                   rtol=1e-4 if k == "depth" else 0, err_msg=k)
    _grads_close(g2, g1)


def test_kernel_v_is_validated_and_ignored_where_jax_ignores_it(renders):
    d, cam, shape, *_ = renders
    with pytest.raises(ValueError, match="kernel_v"):
        RasterizeSettings(kernel_v=3)
    for kw in (dict(pair_major=True), dict(backend="ref")):
        a, _ = _t_render(d, cam, shape, RasterizeSettings(max_per_tile=64, kernel_v=1, **kw))
        b, _ = _t_render(d, cam, shape, RasterizeSettings(max_per_tile=64, kernel_v=2, **kw))
        assert torch.equal(a["img"], b["img"]), kw


def test_row_major_boundary_takes_both_cotangents(rows):
    """``_CompositeRowMajor`` against autograd over the plain forward with a
    straight-through clamp is covered by the kernels' own tests; here: the
    boundary passes g_accum AND g_tfinal on, with and without origins."""
    for localize in (False, True):
        quad = t(rows["rows_g"] if localize else rows["packed"]).requires_grad_(True)
        color = t(rows["color"]).requires_grad_(True)
        o = t(rows["origins"]) if localize else None
        accum, tfinal = api._CompositeRowMajor.apply(quad, color, t(rows["counts"]), o, TILE, 1)
        ga, gt = t(rows["g_accum"]), t(rows["g_tfinal"])
        dq, dc = torch.autograd.grad((accum * ga).sum() + (tfinal * gt).sum(), (quad, color),
                                     retain_graph=True)
        wq, wc = kn.composite_tiles_bwd_plain(quad.detach(), color.detach(), t(rows["counts"]),
                                              ga, gt, accum.detach(), tfinal.detach(), TILE, o)
        assert torch.equal(dq, wq) and torch.equal(dc, wc)
        # a loss that reads tfinal only still reaches the coefficients
        dq_t, dc_t = torch.autograd.grad(tfinal.sum(), (quad, color))
        assert float(dq_t.abs().max()) > 0 and not dc_t.any()
