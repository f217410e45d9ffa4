"""The synthetic avatar of tests/avatar_fixture.py (scene, human, per-frame
poses, LPIPS, face texture, one training frame) built in the JAX package and
carried into the PyTorch port as numpy arrays, for the frame-level tests.

The human's heads are brought into a trained avatar's range (cm offsets,
~3 cm Gaussians) and its triplanes are numpy-seeded, as in
tests/torch_port_fixture.py: random heads would emit meter-sized Gaussians.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

import avatar_fixture
from avatar_fixture import AvatarSetup, synthetic_face_mesh
from exavatar_release_tpu.avatar.model import AvatarTrainables as JTrainables
from exavatar_release_tpu_torch.avatar import convert
from exavatar_release_tpu_torch.avatar.config import AvatarConfig as TCfg
from exavatar_release_tpu_torch.avatar.human import init_human_buffers
from exavatar_release_tpu_torch.avatar.model import FrameData as TFrame
from exavatar_release_tpu_torch.avatar.model import build_statics as t_build_statics
from exavatar_release_tpu_torch.core.camera import Camera as TCamera
from exavatar_release_tpu_torch.models.smplx import SMPLXIDInfo as TID
from exavatar_release_tpu_torch.models.smplx import build_prior as t_build_prior
from exavatar_release_tpu_torch.models.smplx import synthetic_smplx_assets as t_assets
from exavatar_release_tpu_torch.ops.rasterizer.api import RasterizeSettings as TSettings
from exavatar_release_tpu_torch.train.loop import ModelBundle as TBundle
from torch_port_fixture import FAST_COMPILE, _j_init_human, _last_layer, fast_jit

BG = np.asarray([0.3, 0.6, 0.9], np.float32)


def _jitted_avatar_setup(init_human=_j_init_human, **kw):
    """``AvatarSetup`` with its big eager initialisers jitted: run op by op
    they cost ~400 small XLA compiles (30 s). ``init_human``: the jitted
    initialiser of the human's weights."""
    names = ("init_human", "init_lpips_random", "init_param_frames", "sc")
    eager = {n: getattr(avatar_fixture, n) for n in names}
    avatar_fixture.init_human = init_human
    avatar_fixture.init_lpips_random = fast_jit(eager["init_lpips_random"], static_argnums=(1,))
    # its numpy stacking needs concrete poses: they enter as constants
    avatar_fixture.init_param_frames = lambda frames: fast_jit(
        lambda: eager["init_param_frames"](frames))()
    avatar_fixture.sc = types.SimpleNamespace(init_from_point_cloud=fast_jit(
        eager["sc"].init_from_point_cloud, static_argnums=(4,)))
    try:
        return AvatarSetup(**kw)
    finally:
        for n, f in eager.items():
            setattr(avatar_fixture, n, f)


def compile_once(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with ``FAST_COMPILE``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _fields(x):
    return {f.name: _np_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}


class TwinFrame:
    """``j``: the JAX package's AvatarSetup; ``t_*``: the port's objects on
    the CPU, built from the same numpy values."""

    def __init__(self, seed=0, lpips_net="alex", **kw):
        rng = np.random.default_rng(seed + 100)
        j = self.j = _jitted_avatar_setup(seed=seed, lpips_net=lpips_net, **kw)
        hp = j.human_params
        shape = hp.triplane.shape
        hp = hp.replace(
            triplane=jnp.asarray(rng.normal(0, 1, shape).astype(np.float32)),
            triplane_face=jnp.asarray(rng.normal(0, 1, shape).astype(np.float32)),
            mean_offset_net=_last_layer(hp.mean_offset_net, 0.01, None),
            mean_offset_offset_net=_last_layer(hp.mean_offset_offset_net, 0.01, None),
            scale_net=_last_layer(hp.scale_net, 0.05, np.log(0.03)),
            scale_offset_net=_last_layer(hp.scale_offset_net, 0.05, 0.0),
            joint_offset=jnp.asarray(rng.normal(0, 0.003, hp.joint_offset.shape)
                                     .astype(np.float32)),
        )
        # SH bands above 0 and a raised degree, so that the view direction counts
        sp = j.scene_state.params
        sp = sp.replace(feature_rest=jnp.asarray(
            rng.normal(0, 0.05, sp.feature_rest.shape).astype(np.float32)))
        j.scene_aux = j.scene_state.aux.replace(active_sh_degree=jnp.asarray(2.0))
        j.trainables = JTrainables(scene=sp, human=hp, frames=j.param_frames)

        self.t_cfg = TCfg(triplane_ch=j.cfg.triplane_ch, triplane_res=j.cfg.triplane_res,
                          scene_capacity=j.cfg.scene_capacity)
        a = j.prior.assets
        self.t_prior = t_build_prior(t_assets(rings=kw.get("rings", 8), segs=kw.get("segs", 12),
                                              num_shape=6, num_expr=4, device="cpu"))
        self.t_buffers = init_human_buffers(self.t_prior)
        self.t_trainables = convert.trainables_from_jax(
            _fields(sp), _fields(hp), _fields(j.param_frames), self.t_cfg, device="cpu")
        _, self.t_scene_aux = convert.scene_from_jax(_fields(sp), _fields(j.scene_aux),
                                                     device="cpu")
        lp = j.lpips
        ff, uv, ffuv = synthetic_face_mesh(j.prior)
        self.t_bundle = TBundle(
            buffers=self.t_buffers, prior=self.t_prior,
            statics=t_build_statics(self.t_prior, self.t_buffers, ff, uv, ffuv),
            id_info=TID.zeros(a.num_shape, a.num_vertices, a.num_joints, device="cpu"),
            lpips=convert.lpips_params_from_jax(*map(_np_tree, (lp.conv_weights, lp.conv_biases,
                                                               lp.lin_weights)), lp.net,
                                                device="cpu"),
            face_texture=torch.from_numpy(np.array(j.face_texture)),
            face_texture_mask=torch.from_numpy(np.array(j.face_texture_mask)),
            init_joint_offset=torch.from_numpy(np.array(j.init_joint_offset)),
        )
        self.t_settings = TSettings(backend=j.settings.backend,
                                    max_per_tile=j.settings.max_per_tile)
        self.j_bg, self.t_bg = jnp.asarray(BG), torch.from_numpy(BG)

    def t_frame(self, i=0):
        f = self.j.frame_data[i]
        t = lambda x: torch.from_numpy(np.array(x))
        return TFrame(img=t(f.img), mask=t(f.mask), bbox=t(f.bbox),
                      cam=TCamera(t(f.cam.R), t(f.cam.t), t(f.cam.focal), t(f.cam.princpt)),
                      frame_row=int(f.frame_row))
