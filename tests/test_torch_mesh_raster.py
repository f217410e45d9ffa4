"""Mesh rasterizer of the PyTorch port against the JAX package on the CPU:
the pair-sort binning's integers, the z-buffer's winning faces, barycentrics
and depth, and the textured render with its -1 background and its gradients
to the vertices and the texture, on identical numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.ops import mesh_raster as jm
from exavatar_release_tpu.ops.rasterizer import binning as jb
from exavatar_release_tpu_torch.ops import mesh_raster as tm
from exavatar_release_tpu_torch.ops.rasterizer import binning as tb
from torch_frame_fixture import fast_jit

torch.set_num_threads(2)
ATOL = 1e-5


def _grid_mesh(rng, n=9, z0=2.0):
    """A bumpy (n x n)-vertex sheet in front of the camera, plus one triangle
    behind the near plane and a second sheet partly hidden by the first."""
    u, v = np.meshgrid(np.linspace(-0.5, 0.5, n), np.linspace(-0.4, 0.4, n))
    def sheet(z, shift):
        return np.stack([u.ravel() + shift, v.ravel(), z + 0.1 * rng.normal(size=n * n)], 1)
    verts = np.concatenate([sheet(z0, 0.0), sheet(z0 + 0.6, 0.15),
                            [[0, 0, -1.0], [0.1, 0, -1.0], [0, 0.1, -1.0]]]).astype(np.float32)
    idx = np.arange(n * n).reshape(n, n)
    quads = np.stack([idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]], -1).reshape(-1, 4)
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [2, 1, 3]]])
    faces = np.concatenate([tris, tris + n * n, [[2 * n * n, 2 * n * n + 1, 2 * n * n + 2]]])
    return verts, faces.astype(np.int32)


@pytest.fixture(scope="module")
def mesh():
    rng = np.random.default_rng(0)
    verts, faces = _grid_mesh(rng)
    H, W = 40, 72
    focal = np.asarray([70.0, 70.0], np.float32)
    princpt = np.asarray([W / 2.0, H / 2.0], np.float32)
    want = fast_jit(jm.rasterize_mesh, static_argnums=(4,), static_argnames=("max_per_tile",))(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(focal), jnp.asarray(princpt), (H, W),
        max_per_tile=256)
    return verts, faces, focal, princpt, (H, W), want


@pytest.mark.parametrize("cap", [64, 4], ids=["ample", "tight"])
def test_bin_gaussians_sorted_integers(cap):
    rng = np.random.default_rng(1)
    n = 150
    s = dict(mean2d=rng.uniform(-10, 140, (n, 2)), radius=np.ceil(rng.uniform(0.5, 30, n)),
             depth=rng.uniform(1, 5, n))
    s = {k: v.astype(np.float32) for k, v in s.items()}
    s["radius"][:7] = 0.0
    vis = rng.uniform(size=n) > 0.1
    kw = dict(img_shape=(64, 128), tile_h=16, tile_w=32, max_per_tile=12,
              max_tiles_per_gaussian=cap)
    want = jb.bin_gaussians_sorted(*(jnp.asarray(v) for v in s.values()), jnp.asarray(vis), **kw)
    got = tb.bin_gaussians_sorted(*(torch.from_numpy(v) for v in s.values()),
                                  torch.from_numpy(vis), **kw)
    assert tb.bin_gaussians is tb.bin_gaussians_sorted
    if cap == 4:
        assert int(want.n_dropped_pairs) > 0  # the per-Gaussian cap binds
    else:
        assert int(want.n_truncated) > 0  # the per-tile cap binds
    assert got.num_tiles == want.num_tiles
    for f in ("order", "tile_indices", "tile_counts", "n_dropped_pairs", "n_truncated"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_rasterize_mesh_fragments(mesh):
    verts, faces, focal, princpt, shape, want = mesh
    got = tm.rasterize_mesh(*map(torch.from_numpy, (verts, faces, focal, princpt)), shape,
                            max_per_tile=256)
    wf, gf = np.asarray(want.pix_to_face), got.pix_to_face.numpy()
    assert gf.dtype == wf.dtype and gf.shape == wf.shape
    agree = gf == wf
    assert agree.mean() >= 0.995, agree.mean()  # away from z ties, the same winner
    assert (wf >= 0).mean() > 0.3 and (wf < 0).any()  # both hits and background
    assert (gf != len(faces) - 1).all()  # the face behind the near plane is culled
    hit = agree & (wf >= 0)
    np.testing.assert_allclose(got.bary.numpy()[hit], np.asarray(want.bary)[hit], atol=ATOL)
    np.testing.assert_allclose(got.zbuf.numpy()[hit], np.asarray(want.zbuf)[hit], atol=ATOL)
    assert np.isinf(got.zbuf.numpy()[gf < 0]).all()
    assert (got.bary.numpy()[gf < 0] == 0).all()


def test_render_textured_mesh_and_grads(mesh):
    verts, faces, focal, princpt, shape, _ = mesh
    rng = np.random.default_rng(2)
    uvmap = rng.uniform(0, 1, (4, 16, 16)).astype(np.float32)
    vertex_uv = rng.uniform(0.05, 0.95, (len(verts), 2)).astype(np.float32)
    R = np.asarray(jax.random.orthogonal(jax.random.PRNGKey(1), 3), np.float32)
    R = np.eye(3, dtype=np.float32) * 0.98 + 0.02 * R  # near identity: the sheet stays in view
    t = np.asarray([0.02, -0.01, 0.1], np.float32)
    wgt = rng.normal(size=(4,) + shape).astype(np.float32)

    def j_loss(uvm, v):
        img = jm.render_textured_mesh(uvm, v, jnp.asarray(faces), jnp.asarray(R), jnp.asarray(t),
                                      jnp.asarray(focal), jnp.asarray(princpt), shape,
                                      jnp.asarray(faces), jnp.asarray(vertex_uv),
                                      max_per_tile=256)
        return jnp.sum(img * wgt), img

    vg = fast_jit(jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True))
    (_, want), (g_uv, g_v) = vg(jnp.asarray(uvmap), jnp.asarray(verts))
    tu = torch.from_numpy(uvmap).requires_grad_(True)
    tv = torch.from_numpy(verts).requires_grad_(True)
    got = tm.render_textured_mesh(tu, tv, *map(torch.from_numpy, (faces, R, t, focal, princpt)),
                                  shape, torch.from_numpy(faces), torch.from_numpy(vertex_uv),
                                  max_per_tile=256)
    (got * torch.from_numpy(wgt)).sum().backward()
    want = np.asarray(want)
    bg_w, bg_g = (want == -1).all(0), (got.detach().numpy() == -1).all(0)
    assert bg_w.any() and (bg_w == bg_g).mean() >= 0.995
    # background is -1 on ALL channels, the mask channel included
    assert (got.detach().numpy()[:, bg_g] == -1).all()
    close = np.abs(got.detach().numpy() - want).max(0) <= 1e-4
    assert close.mean() >= 0.995, close.mean()
    for g, w, name in ((tu.grad, g_uv, "texture"), (tv.grad, g_v, "vertices")):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy() / np.abs(w).max(), w / np.abs(w).max(), atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("texture", ["random", "ones"])
def test_grid_sample_2d_vs_jax(texture):
    """The texture sampler against the JAX package's on the same coordinates,
    out-of-range taps included: values within 1e-6 and F.grid_sample's
    semantics; on a texture of ones (the face texture's mask channel) every
    sample is exactly 1.0 where JAX's is, since the face loss tests it for
    == 1, and the gradient to the coordinates within 1e-5."""
    from exavatar_release_tpu.ops.grid_sample import grid_sample_2d as j_sample
    from exavatar_release_tpu_torch.ops.grid_sample import grid_sample_2d as t_sample

    rng = np.random.default_rng(3)
    feat = (rng.uniform(0, 1, (4, 13, 17)) if texture == "random"
            else np.ones((4, 13, 17))).astype(np.float32)
    coords = rng.uniform(-1.15, 1.15, (4000, 2)).astype(np.float32)
    want = np.asarray(fast_jit(j_sample)(jnp.asarray(feat), jnp.asarray(coords)))
    c = torch.from_numpy(coords).requires_grad_(True)
    got = t_sample(torch.from_numpy(feat), c)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    lib = torch.nn.functional.grid_sample(torch.from_numpy(feat)[None],
                                          torch.from_numpy(coords)[None, None],
                                          align_corners=False)[0, :, 0].T
    np.testing.assert_allclose(got.detach().numpy(), lib.numpy(), atol=1e-6)
    if texture == "ones":
        np.testing.assert_array_equal(got.detach().numpy() == 1.0, want == 1.0)
        assert (want == 1.0).mean() > 0.5
    w = rng.uniform(-1, 1, want.shape).astype(np.float32)
    g_want = jax.grad(lambda x: jnp.sum(j_sample(jnp.asarray(feat), x) * w))(
        jnp.asarray(coords))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(g_want), atol=1e-5)
