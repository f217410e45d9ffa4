"""Shared synthetic end-to-end avatar setup for model/train tests.

Its big initialisers run as one program each (tests/fast_compile.py): run op
by op they cost ~400 small XLA compiles (~25 s of every build)."""
import jax
import jax.numpy as jnp
import numpy as np

from exavatar_release_tpu.avatar import scene as sc
from exavatar_release_tpu.avatar.config import AvatarConfig
from exavatar_release_tpu.avatar.human import init_human
from exavatar_release_tpu.avatar.model import (
    AvatarStatics,
    AvatarTrainables,
    FrameData,
    build_statics,
    forward_frame,
)
from exavatar_release_tpu.avatar.param_dict import init_param_frames
from exavatar_release_tpu.core.camera import Camera
from exavatar_release_tpu.models.smplx import (
    SMPLXIDInfo,
    build_prior,
    synthetic_smplx_assets,
)
from exavatar_release_tpu.ops.lpips import init_lpips_random
from exavatar_release_tpu.ops.rasterizer.api import RasterizeSettings
from exavatar_release_tpu.train.loop import ModelBundle, train_step
from fast_compile import fast_jit

# forward_frame as one program: run op by op, it costs a compile per operation
forward_frame_program = fast_jit(
    forward_frame,
    static_argnames=("cfg", "is_warmup", "mode", "fit_pose_to_test", "settings"),
)
# the package's train_step fast-compiled, for the tests that run one step a
# compile: it compiles in ~60% of the time of the package's and runs ~7x slower
train_step_program = fast_jit(
    train_step.__wrapped__,
    static_argnames=("optimizer", "cfg", "is_warmup", "fit_pose_to_test", "settings"),
)
fast_init_human = fast_jit(init_human, static_argnums=(3,))
_init_lpips_random = fast_jit(init_lpips_random, static_argnums=(1,))
_init_from_point_cloud = fast_jit(sc.init_from_point_cloud, static_argnums=(4,))


def synthetic_face_mesh(prior):
    """FLAME-equivalent face mesh for synthetic assets: the SMPL-X faces
    fully inside the face region, re-indexed over face_vertex_idx order."""
    fv = np.asarray(prior.face_vertex_idx)
    faces = np.asarray(prior.assets.faces)
    inv = -np.ones(prior.assets.num_vertices, np.int64)
    inv[fv] = np.arange(fv.size)
    inside = (inv[faces] >= 0).all(axis=1)
    face_faces = inv[faces[inside]]
    if face_faces.size == 0:  # degenerate safeguard
        face_faces = np.zeros((1, 3), np.int64)
    # simple planar UV from template positions
    pts = np.asarray(prior.assets.v_template)[fv]
    lo, hi = pts.min(0), pts.max(0)
    uv = (pts[:, :2] - lo[:2]) / np.maximum(hi[:2] - lo[:2], 1e-6)
    return face_faces.astype(np.int32), uv.astype(np.float32), face_faces.astype(np.int32)


class AvatarSetup:
    def __init__(self, seed=0, H=48, W=64, n_frames=2, capacity=512,
                 n_scene=200, lpips_net="alex", rings=8, segs=12,
                 backend="ref", max_per_tile=512, focal=60.0,
                 init_human=fast_init_human):
        """``init_human``: the (jitted) initialiser of the human's weights."""
        self.cfg = AvatarConfig(
            triplane_ch=8, triplane_res=16, scene_capacity=capacity
        )
        self.H, self.W = H, W
        rng = np.random.default_rng(seed)
        self.prior = build_prior(
            synthetic_smplx_assets(
                rings=rings, segs=segs, num_shape=6, num_expr=4
            )
        )
        a = self.prior.assets
        self.id_info = SMPLXIDInfo.zeros(a.num_shape, a.num_vertices, a.num_joints)
        self.human_params, self.buffers = init_human(
            jax.random.PRNGKey(seed), self.prior, self.id_info, self.cfg
        )
        ff, uv, ffuv = synthetic_face_mesh(self.prior)
        self.statics = build_statics(self.prior, self.buffers, ff, uv, ffuv)

        pts = np.stack(
            [rng.uniform(-3, 3, n_scene), rng.uniform(-1.5, 2, n_scene),
             rng.uniform(3.0, 5, n_scene)], 1
        ).astype(np.float32)
        rgbs = rng.uniform(0, 1, (n_scene, 3)).astype(np.float32)
        self.scene_state = _init_from_point_cloud(
            jnp.asarray(pts), jnp.asarray(rgbs), jnp.zeros(3), jnp.asarray(3.0),
            capacity,
        )

        frames = [
            {
                "root_pose": np.asarray([np.pi, 0, 0]) + rng.normal(0, 0.05, 3),
                "body_pose": rng.normal(0, 0.1, (21, 3)),
                "jaw_pose": rng.normal(0, 0.05, 3),
                "leye_pose": np.zeros(3),
                "reye_pose": np.zeros(3),
                "lhand_pose": rng.normal(0, 0.1, (15, 3)),
                "rhand_pose": rng.normal(0, 0.1, (15, 3)),
                "expr": rng.normal(0, 0.5, a.num_expr),
                "trans": np.asarray([0.0, 0.1, 2.5]) + rng.normal(0, 0.02, 3),
            }
            for _ in range(n_frames)
        ]
        # its numpy stacking needs concrete poses: they enter as constants
        self.param_frames = fast_jit(lambda: init_param_frames(frames))()
        self.trainables = AvatarTrainables(
            scene=self.scene_state.params,
            human=self.human_params,
            frames=self.param_frames,
        )
        self.lpips = _init_lpips_random(jax.random.PRNGKey(1), lpips_net)
        self.face_texture = jnp.asarray(rng.uniform(0, 1, (3, 16, 16)).astype(np.float32))
        self.face_texture_mask = jnp.ones((1, 16, 16))
        self.init_joint_offset = jnp.zeros((a.num_joints, 3))
        self.settings = RasterizeSettings(
            backend=backend, max_per_tile=max_per_tile
        )

        self.frame_data = []
        for i in range(n_frames):
            img = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
            mask = np.zeros((1, H, W), np.float32)
            mask[:, H // 4 : 3 * H // 4, W // 4 : 3 * W // 4] = 1.0
            self.frame_data.append(
                FrameData(
                    img=jnp.asarray(img),
                    mask=jnp.asarray(mask),
                    bbox=jnp.asarray([W * 0.2, H * 0.2, W * 0.6, H * 0.6]),
                    cam=Camera(
                        R=jnp.eye(3),
                        t=jnp.zeros(3),
                        focal=jnp.asarray([focal, focal]),
                        princpt=jnp.asarray([W / 2.0, H / 2.0]),
                    ),
                    frame_row=jnp.asarray(i),
                )
            )

    def forward_inputs(self, bg, frame=0, trainables=None):
        """``forward_frame``'s arguments up to ``bg`` for frame ``frame``."""
        return (
            self.trainables if trainables is None else trainables,
            self.scene_state.aux, self.buffers, self.prior, self.statics,
            self.id_info, self.lpips, self.face_texture,
            self.face_texture_mask, self.init_joint_offset,
            self.frame_data[frame], jnp.asarray(bg),
        )

    def bundle(self):
        """The train steps' ModelBundle of this avatar."""
        return ModelBundle(
            buffers=self.buffers, prior=self.prior, statics=self.statics,
            id_info=self.id_info, lpips=self.lpips,
            face_texture=self.face_texture,
            face_texture_mask=self.face_texture_mask,
            init_joint_offset=self.init_joint_offset,
        )
