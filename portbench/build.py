"""Builds one side of a cell, the program or the reference, from the same
``Inputs``. Both packages have the same module layout and entry points, so
one function builds either: ``pkg`` is ``"exavatar_release_tpu_torch"`` (the
program) or ``"reference"`` (the frozen plain copy beside this file). Each
side derives its own prior, subdivision, buffers, statics, scene and
optimizer state from the inputs.
"""
from __future__ import annotations

import dataclasses
import importlib
from types import SimpleNamespace

import numpy as np
import torch

from inputs import POSE_FIELDS, Inputs, avatar_config

PROGRAM = "exavatar_release_tpu_torch"
REFERENCE = "reference"


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _clone(x):
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


def build_avatar(pkg: str, inp: Inputs, device):
    """(prior, cfg, human, buffers, id_info) of ``pkg``."""
    smplx = _mod(pkg, "models.smplx")
    human_mod = _mod(pkg, "avatar.human")
    config = _mod(pkg, "avatar.config")
    a = inp.assets
    assets = smplx.SMPLXAssets(**{f.name: _clone(getattr(a, f.name))
                                  for f in dataclasses.fields(a)})
    prior = smplx.build_prior(assets)
    cfg = avatar_config(inp.cfg, config.AvatarConfig)
    human = human_mod.HumanGaussians(cfg, assets.num_shape, assets.num_joints, device=device)
    human.load_state_dict(inp.human)
    buffers = human_mod.init_human_buffers(prior)
    id_info = smplx.SMPLXIDInfo.zeros(assets.num_shape, assets.num_vertices, assets.num_joints,
                                      device=device)
    return prior, cfg, human, buffers, id_info


def camera(pkg: str, inp: Inputs):
    return _mod(pkg, "core.camera").Camera(**{k: _clone(v) for k, v in inp.camera.items()})


def posed(pkg: str, inp: Inputs, i: int):
    P = _mod(pkg, "avatar.param_dict").PosedSMPLXParams
    return P(**{k: _clone(inp.poses[k][i]) for k in POSE_FIELDS})


def synthetic_face_mesh(prior):
    """The face mesh of the synthetic body: the SMPL-X faces wholly inside
    the face region over ``face_vertex_idx`` order, with a planar UV from the
    template (the program's ``apps.common.synthetic_face_mesh``)."""
    fv = prior.face_vertex_idx.cpu().numpy()
    faces = prior.assets.faces.cpu().numpy()
    inv = -np.ones(prior.assets.num_vertices, np.int64)
    inv[fv] = np.arange(fv.size)
    inside = (inv[faces] >= 0).all(axis=1)
    face_faces = inv[faces[inside]].astype(np.int32)
    if face_faces.size == 0:
        face_faces = np.zeros((1, 3), np.int32)
    pts = prior.assets.v_template.cpu().numpy()[fv]
    lo, hi = pts.min(0), pts.max(0)
    uv = ((pts[:, :2] - lo[:2]) / np.maximum(hi[:2] - lo[:2], 1e-6)).astype(np.float32)
    return face_faces, uv, face_faces


def build_trainer(pkg: str, inp: Inputs, device, start_itr: int, tot_itr: int):
    """The train state at iteration ``start_itr`` (moments zero, step count
    ``start_itr``, SH degree of that iteration), the bundle, the frames and
    the optimizer of ``pkg``."""
    sc = _mod(pkg, "avatar.scene")
    model = _mod(pkg, "avatar.model")
    pdict = _mod(pkg, "avatar.param_dict")
    lpips = _mod(pkg, "ops.lpips")
    loop = _mod(pkg, "train.loop")
    optim = _mod(pkg, "train.optim")
    prior, cfg, human, buffers, id_info = build_avatar(pkg, inp, device)
    statics = model.build_statics(prior, buffers, *synthetic_face_mesh(prior))
    state = sc.init_from_point_cloud(_clone(inp.scene_xyz), _clone(inp.scene_rgb),
                                     torch.zeros(3, device=device), 6.0, cfg.scene_capacity)
    n_f = inp.frame_imgs.shape[0]
    frames = pdict.init_param_frames(
        [{k: inp.poses[k][i].cpu().numpy() for k in POSE_FIELDS} for i in range(n_f)],
        device=device)
    trainables = model.AvatarTrainables(state.params, human, frames)
    lp = inp.lpips
    bundle = loop.ModelBundle(
        buffers=buffers, prior=prior, statics=statics, id_info=id_info,
        lpips=lpips.LPIPSParams(tuple(map(_clone, lp["conv_weights"])),
                                tuple(map(_clone, lp["conv_biases"])),
                                tuple(map(_clone, lp["lin_weights"])), lp["net"]),
        face_texture=_clone(inp.face_texture),
        face_texture_mask=torch.ones(1, *inp.face_texture.shape[1:], device=device),
        init_joint_offset=torch.zeros(prior.assets.num_joints, 3, device=device))
    cam = camera(pkg, inp)
    frame_data = [model.FrameData(img=_clone(inp.frame_imgs[i]), mask=_clone(inp.frame_mask),
                                  bbox=_clone(inp.bbox), cam=cam, frame_row=i)
                  for i in range(n_f)]
    opt = optim.make_optimizer(trainables, cfg, float(state.aux.cam_dist_radius), tot_itr)
    ts = loop.init_train_state(trainables, state.aux, opt)
    ts.opt_state.count = start_itr
    aux = dataclasses.replace(ts.scene_aux, active_sh_degree=torch.tensor(
        float(cfg.sh_degree_at(start_itr)), device=device))
    ts = ts._replace(scene_aux=aux, itr=start_itr)
    return SimpleNamespace(state=ts, bundle=bundle, frames=frame_data, opt=opt, cfg=cfg,
                           loop=loop)
