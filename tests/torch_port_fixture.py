"""One small synthetic avatar built twice, in the JAX package and in its
PyTorch port, from the same numpy inputs.

The JAX side draws its MLP weights with ``init_human``; triplanes are
numpy-seeded (JAX initialises them to zero, which would make every vertex
alike); the port receives both through ``human_params_from_jax``. Random
draws are never matched across frameworks: poses, too, are made with numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from exavatar_release_tpu.avatar.config import AvatarConfig as JCfg
from exavatar_release_tpu.avatar.human import human_forward, init_human
from exavatar_release_tpu.avatar.param_dict import PosedSMPLXParams as JPose
from exavatar_release_tpu.core.camera import Camera as JCamera
from exavatar_release_tpu.models.smplx import SMPLXIDInfo as JID
from exavatar_release_tpu.models.smplx import build_prior as j_build_prior
from exavatar_release_tpu.models.smplx import synthetic_smplx_assets as j_assets
from exavatar_release_tpu_torch.avatar.config import AvatarConfig as TCfg
from exavatar_release_tpu_torch.avatar.convert import human_params_from_jax
from exavatar_release_tpu_torch.avatar.human import HumanGaussians, init_human_buffers
from exavatar_release_tpu_torch.avatar.param_dict import PosedSMPLXParams as TPose
from exavatar_release_tpu_torch.core.camera import Camera as TCamera
from exavatar_release_tpu_torch.models.smplx import SMPLXIDInfo as TID
from exavatar_release_tpu_torch.models.smplx import build_prior as t_build_prior
from exavatar_release_tpu_torch.models.smplx import synthetic_smplx_assets as t_assets

ASSET_KW = dict(rings=8, segs=12, num_shape=6, num_expr=4)
CFG_KW = dict(triplane_ch=8, triplane_res=16)

# XLA options for the tests' one-shot programs: they run once at a tiny size,
# so LLVM's optimisation passes cost more than they save
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn, **kw):
    """``jax.jit(fn, **kw)`` compiled with ``FAST_COMPILE``: one program for a
    reference that would cost a compile per operation run op by op."""
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


# jit: one compile instead of eager JAX's many small ones
_j_init_human = fast_jit(init_human, static_argnums=(3,))
_j_human_forward = fast_jit(human_forward, static_argnums=(7,))


def numpy_pose(rng, num_expr):
    p = {
        "root_pose": np.asarray([np.pi, 0, 0]) + rng.normal(0, 0.05, 3),
        "body_pose": rng.normal(0, 0.1, (21, 3)),
        "jaw_pose": rng.normal(0, 0.05, 3),
        "leye_pose": np.zeros(3),
        "reye_pose": np.zeros(3),
        "lhand_pose": rng.normal(0, 0.1, (15, 3)),
        "rhand_pose": rng.normal(0, 0.1, (15, 3)),
        "expr": rng.normal(0, 0.5, num_expr),
        "trans": np.asarray([0.0, 0.1, 2.5]) + rng.normal(0, 0.02, 3),
    }
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def numpy_camera(H, W, focal):
    return dict(R=np.eye(3, dtype=np.float32), t=np.zeros(3, np.float32),
                focal=np.asarray([focal, focal], np.float32),
                princpt=np.asarray([W / 2.0, H / 2.0], np.float32))


def _last_layer(mlp, w_scale, bias):
    """Scale an MLPParams' last weight; set its bias (or scale it: None)."""
    ws, bs = list(mlp.weights), list(mlp.biases)
    ws[-1] = ws[-1] * w_scale
    bs[-1] = bs[-1] * w_scale if bias is None else jnp.full_like(bs[-1], bias)
    return mlp._replace(weights=tuple(ws), biases=tuple(bs))


class TwinAvatar:
    """``j_*``: the JAX package's objects; ``t_*``: the port's, on the CPU."""

    def __init__(self, seed=0, n_poses=2):
        rng = np.random.default_rng(seed)
        self.j_prior = j_build_prior(j_assets(**ASSET_KW))
        self.t_prior = t_build_prior(t_assets(**ASSET_KW, device="cpu"))
        a = self.j_prior.assets
        self.j_cfg, self.t_cfg = JCfg(**CFG_KW), TCfg(**CFG_KW)
        self.j_id = JID.zeros(a.num_shape, a.num_vertices, a.num_joints)
        self.t_id = TID.zeros(a.num_shape, a.num_vertices, a.num_joints, device="cpu")
        params, self.j_buffers = _j_init_human(
            jax.random.PRNGKey(seed), self.j_prior, self.j_id, self.j_cfg
        )
        shape = params.triplane.shape
        # a trained avatar's range: cm offsets, ~3 cm Gaussians (random
        # heads would emit meter-sized ones that cover the whole image)
        self.j_params = params.replace(
            triplane=jnp.asarray(rng.normal(0, 1, shape).astype(np.float32)),
            triplane_face=jnp.asarray(rng.normal(0, 1, shape).astype(np.float32)),
            mean_offset_net=_last_layer(params.mean_offset_net, 0.01, None),
            mean_offset_offset_net=_last_layer(params.mean_offset_offset_net, 0.01, None),
            scale_net=_last_layer(params.scale_net, 0.05, np.log(0.03)),
            scale_offset_net=_last_layer(params.scale_offset_net, 0.05, 0.0),
        )
        tree = {f.name: jax.tree.map(np.asarray, getattr(self.j_params, f.name))
                for f in dataclasses.fields(self.j_params)}
        self.t_human = HumanGaussians(self.t_cfg, a.num_shape, a.num_joints,
                                      generator=torch.Generator().manual_seed(seed),
                                      device="cpu")
        self.t_human.load_state_dict(human_params_from_jax(tree))
        self.t_buffers = init_human_buffers(self.t_prior)
        self.poses = [numpy_pose(rng, a.num_expr) for _ in range(n_poses)]

    def j_human_forward(self, i, cam):
        return _j_human_forward(self.j_params, self.j_buffers, self.j_prior, self.j_pose(i),
                                self.j_id, cam.R, cam.t, self.j_cfg)

    def j_pose(self, i):
        return JPose(**{k: jnp.asarray(v) for k, v in self.poses[i].items()})

    def t_pose(self, i):
        return TPose(**{k: torch.from_numpy(v) for k, v in self.poses[i].items()})

    @staticmethod
    def cameras(H, W, focal):
        c = numpy_camera(H, W, focal)
        return (JCamera(**{k: jnp.asarray(v) for k, v in c.items()}),
                TCamera(**{k: torch.from_numpy(v) for k, v in c.items()}))
