"""Human Gaussian module: init, triplane features, full forward, posing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exavatar_release_tpu.avatar.config import AvatarConfig
from exavatar_release_tpu.avatar.human import (
    clamp_warmup_scale,
    extract_tri_feature,
    human_forward,
    neutral_pose_human,
    zero_pose_joints,
)
from exavatar_release_tpu.avatar.param_dict import (
    PosedSMPLXParams,
    SMPLXParamFrames,
    init_param_frames,
)
from exavatar_release_tpu.models.smplx import (
    SMPLXIDInfo,
    build_prior,
    synthetic_smplx_assets,
)
from avatar_fixture import fast_init_human
from fast_compile import fast_jit

CFG = AvatarConfig(triplane_ch=8, triplane_res=16)
# the forward as one program (eager JAX compiles every operation on its own)
_human_forward = fast_jit(
    human_forward, static_argnames=("cfg", "is_world_coord", "knn_chunk")
)


@pytest.fixture(scope="module")
def prior():
    return build_prior(synthetic_smplx_assets(rings=8, segs=12, num_shape=6, num_expr=4))


@pytest.fixture(scope="module")
def id_info(prior):
    a = prior.assets
    return SMPLXIDInfo.zeros(a.num_shape, a.num_vertices, a.num_joints)


@pytest.fixture(scope="module")
def human(prior, id_info):
    return fast_init_human(jax.random.PRNGKey(0), prior, id_info, CFG)


def _rand_pose(rng, num_expr, scale=0.3):
    return PosedSMPLXParams(
        root_pose=jnp.asarray(rng.normal(0, scale, 3), jnp.float32),
        body_pose=jnp.asarray(rng.normal(0, scale, (21, 3)), jnp.float32),
        jaw_pose=jnp.asarray(rng.normal(0, scale, 3), jnp.float32),
        leye_pose=jnp.zeros(3),
        reye_pose=jnp.zeros(3),
        lhand_pose=jnp.asarray(rng.normal(0, scale, (15, 3)), jnp.float32),
        rhand_pose=jnp.asarray(rng.normal(0, scale, (15, 3)), jnp.float32),
        expr=jnp.asarray(rng.normal(0, 1, 4), jnp.float32),
        trans=jnp.asarray([0.1, 0.2, 2.0], jnp.float32),
    )


class TestBuffersInit:
    def test_shapes(self, prior, human):
        params, buffers = human
        Vhr = prior.vertex_num_upsampled
        J = prior.joint_num
        assert buffers.pos_enc_mesh.shape == (Vhr, 3)
        assert buffers.skinning_weight.shape == (Vhr, J)
        assert buffers.pose_dirs.shape == ((J - 1) * 9, Vhr * 3)
        assert buffers.expr_dirs.shape == (Vhr, 3, prior.assets.num_expr)
        # skinning weights still sum to one after midpoint interpolation
        np.testing.assert_allclose(
            np.asarray(buffers.skinning_weight.sum(1)), 1.0, atol=1e-5
        )

    def test_neutral_pose_transform_inverts(self, prior, id_info):
        """大->zero transforms applied to 大-pose verts with the template's
        own skinning must land near the zero-pose verts."""
        from exavatar_release_tpu.models.smplx import SMPLXParams, smplx_forward

        mesh_hr, mesh_lr, joints, T = neutral_pose_human(
            prior, None, None, jaw_zero_pose=True
        )
        a = prior.assets
        W = a.lbs_weights
        J = a.num_joints
        T_vert = (W @ T.reshape(J, 16)).reshape(-1, 4, 4)
        undone = (
            jnp.einsum("vij,vj->vi", T_vert[:, :3, :3], mesh_lr) + T_vert[:, :3, 3]
        )
        zero_out = smplx_forward(
            a, SMPLXParams.zeros(a.num_shape, a.num_expr), with_landmarks=False
        )
        err = np.linalg.norm(
            np.asarray(undone) - np.asarray(zero_out.vertices), axis=1
        )
        # inverse-LBS (blend of inverses) is approximate on soft-blended
        # vertices — by construction, in the reference too; the bulk of the
        # mesh and all rigidly-bound vertices must be tight
        assert np.median(err) < 0.1
        # the most rigidly-bound decile must be much tighter than the median
        w_max = np.asarray(W.max(1))
        rigid = w_max >= np.quantile(w_max, 0.9)
        assert np.median(err[rigid]) < 0.02


class TestForward:
    def test_full_forward_shapes_and_flags(self, prior, id_info, human, rng):
        params, buffers = human
        pose = _rand_pose(rng, prior.assets.num_expr)
        out = _human_forward(
            params, buffers, prior, pose, id_info,
            jnp.eye(3), jnp.zeros(3), CFG, knn_chunk=512,
        )
        Vhr = prior.vertex_num_upsampled
        assert out.assets.mean_3d.shape == (Vhr, 3)
        assert out.assets.rgb.shape == (Vhr, 3)
        assert out.assets_refined.scale.shape == (Vhr, 3)
        assert np.asarray(out.assets.opacity).min() == 1.0
        assert (np.asarray(out.assets.rgb) >= 0).all()
        assert (np.asarray(out.assets.rgb) <= 1).all()
        assert np.isfinite(np.asarray(out.assets.mean_3d)).all()

    def test_zero_triplane_zero_pose_tracks_template(self, prior, id_info, human):
        """With zero triplanes + freshly-initialized heads at zero pose, the
        posed means must stay near the 大-pose template transformed to zero
        pose (offsets are small at init)."""
        params, buffers = human
        a = prior.assets
        zero = PosedSMPLXParams(
            root_pose=jnp.zeros(3), body_pose=jnp.zeros((21, 3)),
            jaw_pose=jnp.zeros(3), leye_pose=jnp.zeros(3), reye_pose=jnp.zeros(3),
            lhand_pose=jnp.zeros((15, 3)), rhand_pose=jnp.zeros((15, 3)),
            expr=jnp.zeros(a.num_expr), trans=jnp.zeros(3),
        )
        out = _human_forward(
            params, buffers, prior, zero, id_info,
            jnp.eye(3), jnp.zeros(3), CFG, is_world_coord=True, knn_chunk=512,
        )
        from exavatar_release_tpu.models.smplx import SMPLXParams, smplx_forward

        zero_mesh = smplx_forward(
            a, SMPLXParams.zeros(a.num_shape, a.num_expr), with_landmarks=False
        ).vertices
        zero_hr = prior.upsample_mesh(zero_mesh)
        med = np.median(
            np.linalg.norm(np.asarray(out.assets.mean_3d) - np.asarray(zero_hr), axis=1)
        )
        # deviation is bounded by the random-init network offset plus the
        # soft-skinning inverse-LBS slack of this synthetic blob
        max_net_offset = float(np.abs(np.asarray(out.mean_offset)).max())
        assert med < max_net_offset + 0.35

    def test_world_coord_transform(self, prior, id_info, human, rng):
        params, buffers = human
        pose = _rand_pose(rng, prior.assets.num_expr)
        R = jnp.asarray(
            np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
        )
        t = jnp.asarray([0.3, -0.2, 0.5])
        out_cam = _human_forward(
            params, buffers, prior, pose, id_info, R, t, CFG,
            is_world_coord=True, knn_chunk=512,
        )
        out_world = _human_forward(
            params, buffers, prior, pose, id_info, R, t, CFG,
            is_world_coord=False, knn_chunk=512,
        )
        expect = (np.asarray(out_cam.assets.mean_3d) - np.asarray(t)) @ np.asarray(R)
        np.testing.assert_allclose(
            np.asarray(out_world.assets.mean_3d), expect, atol=1e-4
        )

    def test_warmup_clamp(self, prior, id_info, human, rng):
        params, buffers = human
        pose = _rand_pose(rng, prior.assets.num_expr)
        out = _human_forward(
            params, buffers, prior, pose, id_info, jnp.eye(3), jnp.zeros(3),
            CFG, knn_chunk=512,
        )
        clamped = clamp_warmup_scale(out)
        assert float(clamped.assets.scale.max()) <= np.float32(0.001)
        np.testing.assert_array_equal(
            np.asarray(clamped.scale_wo_clamp), np.asarray(out.assets.scale)
        )

    def test_grad_to_triplane(self, prior, id_info, human, rng):
        params, buffers = human
        pose = _rand_pose(rng, prior.assets.num_expr)

        def loss(tp):
            out = human_forward(
                params.replace(triplane=tp), buffers, prior, pose, id_info,
                jnp.eye(3), jnp.zeros(3), CFG, knn_chunk=512,
            )
            return jnp.sum(out.assets.rgb ** 2) + jnp.sum(out.assets.mean_3d ** 2)

        g = fast_jit(jax.grad(loss))(params.triplane)
        assert np.isfinite(np.asarray(g)).all()
        assert np.any(np.asarray(g) != 0)


class TestParamFrames:
    def test_roundtrip(self, rng):
        frames = [
            {
                "root_pose": rng.normal(0, 0.5, 3),
                "body_pose": rng.normal(0, 0.5, (21, 3)),
                "jaw_pose": rng.normal(0, 0.2, 3),
                "leye_pose": rng.normal(0, 0.2, 3),
                "reye_pose": rng.normal(0, 0.2, 3),
                "lhand_pose": rng.normal(0, 0.3, (15, 3)),
                "rhand_pose": rng.normal(0, 0.3, (15, 3)),
                "expr": rng.normal(0, 1, 4),
                "trans": rng.normal(0, 1, 3),
            }
            for _ in range(3)
        ]
        store = init_param_frames(frames)
        assert store.num_frames == 3
        got = store.lookup(1)
        np.testing.assert_allclose(
            np.asarray(got.body_pose), frames[1]["body_pose"], atol=1e-5
        )
        np.testing.assert_allclose(np.asarray(got.trans), frames[1]["trans"], atol=1e-6)

    def test_lookup_traced(self, rng):
        frames = [
            {k: rng.normal(0, 0.3, s) for k, s in [
                ("root_pose", 3), ("body_pose", (21, 3)), ("jaw_pose", 3),
                ("leye_pose", 3), ("reye_pose", 3), ("lhand_pose", (15, 3)),
                ("rhand_pose", (15, 3)), ("expr", 4), ("trans", 3)]}
            for _ in range(4)
        ]
        store = init_param_frames(frames)
        f = jax.jit(lambda s, i: s.lookup(i).trans)
        np.testing.assert_allclose(
            np.asarray(f(store, jnp.asarray(2))), frames[2]["trans"], atol=1e-6
        )
