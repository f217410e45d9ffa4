"""Carry weights and state from the JAX package into the port. Every function
takes numpy arrays only (the caller does the ``np.asarray`` on the JAX side)
and imports nothing of the JAX package.

``scene_from_jax``, ``param_frames_from_jax``, ``lpips_params_from_jax`` and
``statics_from_numpy`` take the JAX dataclasses' fields as dicts of numpy
arrays; ``trainables_from_jax`` assembles scene, human and frames.
``human_params_from_jax`` takes the JAX ``HumanParams`` as nested dicts of
numpy arrays (its field names; each MLP an ``MLPParams``-like 4-tuple of
(weights, biases, gn_scales, gn_biases) tuples) and returns a state dict for
``HumanGaussians``. JAX Linear weights are (C_in, C_out); ``nn.Linear``
wants (C_out, C_in), so they are transposed. An empty GroupNorm scale marks a
layer without a norm.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..ops.lpips import LPIPSParams
from .config import AvatarConfig
from .human import HumanGaussians
from .model import AvatarStatics, AvatarTrainables
from .param_dict import SMPLXParamFrames
from .scene import SceneAux, SceneParams

_MLP_FIELDS = (
    "geo_net", "mean_offset_net", "scale_net", "geo_offset_net",
    "mean_offset_offset_net", "scale_offset_net", "rgb_net", "rgb_offset_net",
)
_ARRAY_FIELDS = ("triplane", "triplane_face", "shape_param", "joint_offset")


def human_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    sd = {name: t(tree[name]) for name in _ARRAY_FIELDS}
    for name in _MLP_FIELDS:
        weights, biases, gn_scales, gn_biases = tree[name]
        for i, (w, b, gs, gb) in enumerate(zip(weights, biases, gn_scales, gn_biases)):
            sd[f"{name}.linears.{i}.weight"] = t(w).T.contiguous()
            sd[f"{name}.linears.{i}.bias"] = t(b)
            if np.size(gs):
                sd[f"{name}.norms.{i}.weight"] = t(gs)
                sd[f"{name}.norms.{i}.bias"] = t(gb)
    return sd


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _scene_params(params: Mapping, device) -> SceneParams:
    return SceneParams(**{k: _f32(params[k], device) for k in
                          ("mean", "scale", "rotation", "feature_dc", "feature_rest", "opacity")})


def scene_from_jax(params: Mapping, aux: Mapping, device="cuda") -> Tuple[SceneParams, SceneAux]:
    """``SceneParams`` and ``SceneAux`` from dicts of their fields."""
    p = _scene_params(params, device)
    a = SceneAux(
        live=torch.from_numpy(np.array(aux["live"], dtype=bool)).to(device),
        **{k: _f32(aux[k], device) for k in
           ("radius_max", "xyz_grad_accum", "track_cnt", "active_sh_degree", "cam_dist_trans",
            "cam_dist_radius")},
    )
    return p, a


def param_frames_from_jax(frames: Mapping, device="cuda") -> SMPLXParamFrames:
    """The 6D per-frame store from a dict of its nine stacked fields."""
    return SMPLXParamFrames(**{k: _f32(v, device) for k, v in frames.items()})


def lpips_params_from_jax(conv_weights, conv_biases, lin_weights, net: str,
                          device="cuda") -> LPIPSParams:
    """LPIPS weights; conv weights are (O, I, kh, kw) in both packages."""
    t = lambda xs: tuple(_f32(x, device) for x in xs)
    return LPIPSParams(t(conv_weights), t(conv_biases), t(lin_weights), str(net))


def statics_from_numpy(statics: Mapping, device="cuda") -> AvatarStatics:
    """``AvatarStatics`` from a dict of numpy tables: integer tables become
    int64 index tensors, the rest float32."""
    out = {}
    for k in AvatarStatics._fields:
        a = np.asarray(statics[k])
        if np.issubdtype(a.dtype, np.integer):
            out[k] = torch.from_numpy(a.astype(np.int64)).to(device)
        else:
            out[k] = _f32(a, device)
    return AvatarStatics(**out)


def trainables_from_jax(scene_params: Mapping, human_tree: Mapping, frames: Mapping,
                        cfg: AvatarConfig, device="cuda") -> AvatarTrainables:
    """The whole optimizable state. ``scene_params``, ``human_tree`` and
    ``frames`` as in ``scene_from_jax`` / ``human_params_from_jax`` /
    ``param_frames_from_jax``."""
    sd = human_params_from_jax(human_tree)
    human = HumanGaussians(cfg, sd["shape_param"].shape[0], sd["joint_offset"].shape[0],
                           device=device)
    human.load_state_dict(sd)
    return AvatarTrainables(_scene_params(scene_params, device), human,
                            param_frames_from_jax(frames, device))
