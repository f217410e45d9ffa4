"""Human Gaussians of the PyTorch port against the JAX package: the same
parameters (built in JAX, carried by ``human_params_from_jax``), the same
numpy poses, float32 on the CPU.

KNN ties: a subdivision midpoint is exactly equidistant from two low-res
vertices, so the k=1 skinning lookup may pick either when the two
frameworks round the expanded distance differently. ``knn`` itself must
agree exactly on identical inputs; in ``human_forward`` at most 2% of the
indices may flip, each between vertices whose squared distances differ by
< 1e-6, and every output is compared on the vertices whose index agrees.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.ops.knn import knn as j_knn
from exavatar_release_tpu_torch.avatar.human import clamp_warmup_scale
from exavatar_release_tpu_torch.avatar.human import human_forward as t_human_forward
from exavatar_release_tpu_torch.ops.grid_sample import triplane_sample as t_triplane
from exavatar_release_tpu_torch.ops.knn import knn as t_knn
from exavatar_release_tpu.ops.grid_sample import triplane_sample as j_triplane
from torch_port_fixture import TwinAvatar

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MAX_FLIP_SHARE = 0.02
TIE_D2 = 1e-6


@pytest.fixture(scope="module")
def twin():
    return TwinAvatar(seed=0, n_poses=1)


@pytest.fixture(scope="module")
def forwards(twin):
    j_cam, t_cam = twin.cameras(64, 256, 60.0)
    jo = twin.j_human_forward(0, j_cam)
    with torch.no_grad():
        to = t_human_forward(twin.t_human, twin.t_buffers, twin.t_prior, twin.t_pose(0),
                             twin.t_id, t_cam.R, t_cam.t, twin.t_cfg)
    return jo, to


def test_knn_exact_on_identical_inputs(rng):
    q = rng.normal(size=(500, 3)).astype(np.float32)
    r = rng.normal(size=(97, 3)).astype(np.float32)
    # exact ties too: midpoints of reference pairs
    q[:50] = 0.5 * (r[:50] + r[1:51])
    jr = j_knn(jnp.asarray(q), jnp.asarray(r), k=1, chunk=128)
    tr = t_knn(torch.from_numpy(q), torch.from_numpy(r), k=1, chunk=128)
    np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
    np.testing.assert_allclose(tr.dists.numpy(), np.asarray(jr.dists), atol=1e-6)


def test_triplane_sample(rng):
    tri = rng.normal(size=(3, 4, 16, 16)).astype(np.float32)
    xyz = rng.uniform(-1.3, 1.3, (300, 3)).astype(np.float32)  # some outside: zero pad
    half = np.asarray([1.0, 1.0, 1.0], np.float32)
    want = np.asarray(j_triplane(jnp.asarray(tri), jnp.asarray(xyz), jnp.asarray(half)))
    got = t_triplane(torch.from_numpy(tri), torch.from_numpy(xyz), torch.from_numpy(half))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _lookup_inputs(twin, jo, to):
    """Each side's k=1 lookup inputs, computed as its human_forward does:
    (大-pose mesh + mean offset) + expression offset, against the low-res
    neutral mesh (the first V rows of the upsampled one)."""
    V = twin.j_prior.assets.num_vertices
    j_expr = jnp.asarray(twin.poses[0]["expr"])
    t_expr = torch.from_numpy(twin.poses[0]["expr"])
    j_q = (jo.mesh_neutral_pose + jo.mean_offset
           + jnp.einsum("e,vce->vc", j_expr, twin.j_buffers.expr_dirs))
    t_q = (to.mesh_neutral_pose + to.mean_offset
           + torch.einsum("e,vce->vc", t_expr, twin.t_buffers.expr_dirs))
    return j_q, jo.mesh_neutral_pose[:V], t_q, to.mesh_neutral_pose[:V]


def test_human_forward(twin, forwards):
    jo, to = forwards
    b = twin.t_buffers
    own = (b.is_rhand | b.is_lhand | b.is_face).numpy()
    j_q, j_lr, t_q, t_lr = _lookup_inputs(twin, jo, to)
    ar = np.arange(own.size)
    j_idx = np.where(own, ar, np.asarray(j_knn(j_q, j_lr, k=1).idx)[:, 0])
    t_idx = np.where(own, ar, t_knn(t_q, t_lr, k=1).idx[:, 0].numpy())
    flips = np.nonzero(j_idx != t_idx)[0]
    print(f"{flips.size} of {j_idx.size} k=1 indices flipped")
    assert flips.size <= MAX_FLIP_SHARE * j_idx.size, flips.size
    q = np.asarray(j_q, np.float64)
    lr = np.asarray(j_lr, np.float64)
    for v in flips:
        d_j = ((q[v] - lr[j_idx[v]]) ** 2).sum()
        d_t = ((q[v] - lr[t_idx[v]]) ** 2).sum()
        assert abs(d_j - d_t) < TIE_D2, (v, d_j, d_t)
    agree = j_idx == t_idx

    for name, atol in (("mean_offset", 2e-5), ("mean_offset_offset", 2e-5),
                       ("scale_offset", 2e-5), ("rgb_offset", 2e-5),
                       ("mesh_neutral_pose", 2e-5), ("scale_wo_clamp", 2e-5),
                       ("scale_refined_wo_clamp", 2e-5)):
        np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                                   rtol=1e-4, atol=atol, err_msg=name)
    for which in ("assets", "assets_refined"):
        ja, ta = getattr(jo, which), getattr(to, which)
        for f in ("mean_3d", "scale", "rgb", "opacity", "rotation", "live"):
            got, want = getattr(ta, f).numpy(), np.asarray(getattr(ja, f))
            if f == "mean_3d":
                got, want = got[agree], want[agree]
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5, err_msg=f"{which}.{f}")


def test_clamp_warmup_scale(forwards):
    _, to = forwards
    c = clamp_warmup_scale(to, max_scale=0.001)
    for which in ("assets", "assets_refined"):
        np.testing.assert_array_equal(
            getattr(c, which).scale.numpy(),
            np.minimum(getattr(to, which).scale.numpy(), np.float32(0.001)),
        )
