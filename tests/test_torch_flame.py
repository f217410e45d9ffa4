"""The port's FLAME head model (models/smplx/flame.py) against the JAX
package's on the CPU: the synthetic head's arrays bit for bit (the same numpy
code), and ``flame_forward`` on the same numpy parameters (float32; 1e-5
absolute on sub-metre coordinates, the summation orders of the two LBS
implementations differ)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exavatar_release_tpu.models.smplx import flame as jf
from exavatar_release_tpu_torch.models.smplx import flame as tf
from torch_port_fixture import fast_jit

torch.set_num_threads(2)

FIELDS = ("v_template", "shapedirs", "expr_dirs", "posedirs", "joint_regressor", "lbs_weights",
          "pose_mean", "faces", "lmk_faces_idx", "lmk_bary_coords", "dyn_lmk_faces_idx",
          "dyn_lmk_bary_coords")
TOL = 1e-5


@pytest.fixture(scope="module")
def heads():
    return jf.synthetic_flame_assets(), tf.synthetic_flame_assets(device="cpu")


def test_synthetic_assets_bit_for_bit(heads):
    (ja, jp), (ta, tp) = heads
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ta, k).numpy(), np.asarray(getattr(ja, k)), k)
    assert ta.parents == ja.parents == tf.FLAME_PARENTS
    assert ta.neck_kin_chain == ja.neck_kin_chain
    np.testing.assert_array_equal(tp.vertex_uv.numpy(), np.asarray(jp.vertex_uv))
    np.testing.assert_array_equal(tp.face_uv.numpy(), np.asarray(jp.face_uv))
    assert tp.vertex_num == jp.vertex_num


# the JAX forward as one program: run op by op it costs ~150 compiles
_J_FLAME_FORWARD = fast_jit(jf.flame_forward, static_argnames=("with_landmarks",
                                                                "use_face_contour"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flame_forward_matches_jax(heads, seed):
    (ja, _), (ta, _) = heads
    rng = np.random.default_rng(seed)
    sd = 0.3 if seed else 0.0  # seed 0: the zero pose through ``zeros``
    draw = {"betas": rng.normal(0, 1, ta.num_shape), "expr": rng.normal(0, 1, ta.num_expr),
            **{k: rng.normal(0, sd, 3) for k in ("root_pose", "neck_pose", "jaw_pose",
                                                  "leye_pose", "reye_pose")},
            "trans": rng.normal(0, 0.1, 3)}
    draw = {k: v.astype(np.float32) for k, v in draw.items()}
    if seed == 0:
        jparams = jf.FLAMEParams.zeros(ja.num_shape, ja.num_expr)
        tparams = tf.FLAMEParams.zeros(ta.num_shape, ta.num_expr, device="cpu")
    else:
        jparams = jf.FLAMEParams(**{k: jnp.asarray(v) for k, v in draw.items()})
        tparams = tf.FLAMEParams(**{k: torch.from_numpy(v) for k, v in draw.items()})
    offset = rng.normal(0, 0.002, (ta.num_vertices, 3)).astype(np.float32)
    for kw in ({}, {"use_face_contour": False}, {"with_landmarks": False},
               {"face_offset": offset}):
        jkw = {**kw, "face_offset": jnp.asarray(offset)} if "face_offset" in kw else kw
        tkw = {**kw, "face_offset": torch.from_numpy(offset)} if "face_offset" in kw else kw
        want = _J_FLAME_FORWARD(ja, jparams, **jkw)
        got = tf.flame_forward(ta, tparams, **tkw)
        for k in ("vertices", "joints", "landmarks", "v_shaped", "joints_zero_pose",
                  "rel_transforms"):
            w, g = getattr(want, k), getattr(got, k)
            if w is None:
                assert g is None, k
                continue
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, err_msg=f"{k} {kw}")
