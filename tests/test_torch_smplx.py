"""SMPL-X stack of the PyTorch port against the JAX package on the same
numpy inputs: rotations, synthetic assets (bit-identical), the prior and
its 2x upsampling, and smplx_forward. float32 on the CPU; tolerances allow
the two libraries' different summation orders. The rotations from axis-angle
(sin, cos; 2e-6) are held under the seam of tests/torch_xla_math.py (XLA's
transcendentals for the port's) and, as the ``torch_libm`` cases, on the
port's own libm, at the same bound."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.core import rotations as jrot
from exavatar_release_tpu.models.smplx import SMPLXParams as JParams
from exavatar_release_tpu.models.smplx import build_prior as j_build_prior
from exavatar_release_tpu.models.smplx import smplx_forward as j_forward
from exavatar_release_tpu.models.smplx import synthetic_smplx_assets as j_assets
from exavatar_release_tpu_torch.core import rotations as trot
from exavatar_release_tpu_torch.models.smplx import SMPLXParams as TParams
from exavatar_release_tpu_torch.models.smplx import build_prior as t_build_prior
from exavatar_release_tpu_torch.models.smplx import smplx_forward as t_forward
from exavatar_release_tpu_torch.models.smplx import synthetic_smplx_assets as t_assets
from torch_port_fixture import fast_jit
from torch_xla_math import seam_cases, xla_transcendentals

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KW = dict(rings=8, segs=12, num_shape=6, num_expr=4)


@pytest.fixture(scope="module")
def assets():
    return j_assets(**KW), t_assets(**KW, device="cpu")


def _aa(rng, n):
    aa = rng.normal(0, 1.2, (n, 3)).astype(np.float32)
    aa[0] = 0.0  # exact zero: the Taylor branch
    aa[1] = [1e-7, 0.0, 0.0]
    return aa


@pytest.mark.parametrize("fn, seam", seam_cases([
    "axis_angle_to_matrix", "axis_angle_to_quaternion", "axis_angle_to_rotation_6d"]))
def test_rotations_from_axis_angle(rng, fn, seam):
    aa = _aa(rng, 64)
    want = np.asarray(getattr(jrot, fn)(jnp.asarray(aa)))
    with xla_transcendentals(seam):  # sin, cos
        got = getattr(trot, fn)(torch.from_numpy(aa)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_rotations_round_trips(rng):
    aa = _aa(rng, 64)
    R = np.array(jrot.axis_angle_to_matrix(jnp.asarray(aa)))
    tR = torch.from_numpy(R)
    for name in ("matrix_to_quaternion", "matrix_to_axis_angle", "matrix_to_rotation_6d"):
        want = np.asarray(getattr(jrot, name)(jnp.asarray(R)))
        np.testing.assert_allclose(getattr(trot, name)(tR).numpy(), want, atol=5e-5, err_msg=name)
    d6 = rng.normal(size=(64, 6)).astype(np.float32)
    d6[0] = 0.0  # degenerate row: fallback axes
    np.testing.assert_allclose(
        trot.rotation_6d_to_matrix(torch.from_numpy(d6)).numpy(),
        np.asarray(jrot.rotation_6d_to_matrix(jnp.asarray(d6))), atol=2e-6,
    )
    q = rng.normal(size=(64, 4)).astype(np.float32)
    np.testing.assert_allclose(
        trot.quaternion_to_matrix(torch.from_numpy(q)).numpy(),
        np.asarray(jrot.quaternion_to_matrix(jnp.asarray(q))), atol=2e-6,
    )


def test_synthetic_assets_bit_identical(assets):
    ja, ta = assets
    assert ja.parents == ta.parents and ja.neck_kin_chain == ta.neck_kin_chain
    for f in dataclasses.fields(ta):
        if f.name in ("parents", "neck_kin_chain"):
            continue
        want = np.asarray(getattr(ja, f.name))
        got = getattr(ta, f.name).numpy()
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)


def test_prior_and_upsampling(assets, rng):
    ja, ta = assets
    jp, tp = j_build_prior(ja), t_build_prior(ta)
    assert jp.vertex_num_upsampled == tp.vertex_num_upsampled
    for name in ("faces_with_cavity", "is_cavity", "face_vertex_idx", "lhand_vertex_idx",
                 "rhand_vertex_idx", "expr_vertex_idx", "neutral_body_pose",
                 "neutral_jaw_pose", "faces_upsampled", "is_rhand_hr", "is_lhand_hr",
                 "is_face_hr", "is_face_expr_hr", "is_cavity_hr"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    feats = rng.normal(size=(ja.num_vertices, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tp.upsample_mesh(torch.from_numpy(feats)).numpy(),
        np.asarray(jp.upsample_mesh(jnp.asarray(feats))), atol=1e-6,
    )


def test_smplx_forward(assets, rng):
    ja, ta = assets
    S, E, V, J = ja.num_shape, ja.num_expr, ja.num_vertices, ja.num_joints
    p = dict(
        betas=rng.normal(0, 1, S), expr=rng.normal(0, 1, E),
        root_pose=rng.normal(0, 0.3, 3), body_pose=rng.normal(0, 0.3, (21, 3)),
        jaw_pose=rng.normal(0, 0.2, 3), leye_pose=rng.normal(0, 0.1, 3),
        reye_pose=rng.normal(0, 0.1, 3), lhand_pose=rng.normal(0, 0.3, (15, 3)),
        rhand_pose=rng.normal(0, 0.3, (15, 3)), trans=rng.normal(0, 0.5, 3),
    )
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    off = {k: rng.normal(0, 0.01, s).astype(np.float32)
           for k, s in (("face_offset", (V, 3)), ("joint_offset", (J, 3)),
                        ("locator_offset", (J, 3)))}
    jo = fast_jit(lambda p_, off_: j_forward(ja, p_, **off_))(
        JParams(**{k: jnp.asarray(v) for k, v in p.items()}),
        {k: jnp.asarray(v) for k, v in off.items()})
    to = t_forward(ta, TParams(**{k: torch.from_numpy(v) for k, v in p.items()}),
                   **{k: torch.from_numpy(v) for k, v in off.items()})
    for f in ("vertices", "joints", "landmarks", "v_shaped", "joints_zero_pose",
              "rel_transforms"):
        np.testing.assert_allclose(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                   atol=2e-5, err_msg=f)
