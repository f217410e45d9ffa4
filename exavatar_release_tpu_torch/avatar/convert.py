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

``train_state_from_jax`` / ``train_state_to_numpy`` carry a whole
``TrainState`` (trainables, both Adam moments, the step count, the scene's aux
and the iteration) as the flat list of leaves that
``jax.tree_util.tree_flatten`` gives for the JAX package's ``TrainState``:
``TRAIN_STATE_LEAVES`` names them in that order. It is the layout of the
checkpoints of both packages.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

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


def _scene_aux(aux: Mapping, device) -> SceneAux:
    return SceneAux(
        live=torch.from_numpy(np.array(aux["live"], dtype=bool)).to(device),
        **{k: _f32(aux[k], device) for k in
           ("radius_max", "xyz_grad_accum", "track_cnt", "active_sh_degree", "cam_dist_trans",
            "cam_dist_radius")},
    )


def scene_from_jax(params: Mapping, aux: Mapping, device="cuda") -> Tuple[SceneParams, SceneAux]:
    """``SceneParams`` and ``SceneAux`` from dicts of their fields."""
    return _scene_params(params, device), _scene_aux(aux, device)


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


# --------------------------------------------------------------------------
# the whole train state, as the JAX package flattens it
# --------------------------------------------------------------------------

_SCENE_FIELDS = ("mean", "scale", "rotation", "feature_dc", "feature_rest", "opacity")
_FRAME_FIELDS = ("root_pose", "body_pose", "jaw_pose", "leye_pose", "reye_pose", "lhand_pose",
                 "rhand_pose", "expr", "trans")
_AUX_FIELDS = ("live", "radius_max", "xyz_grad_accum", "track_cnt", "active_sh_degree",
               "cam_dist_trans", "cam_dist_radius")
# the JAX HumanParams' fields in order; for an MLP, whether each layer has a
# GroupNorm (a layer without one holds a zero-size placeholder leaf there)
_HUMAN_FIELDS = (
    ("triplane", None), ("triplane_face", None),
    ("geo_net", (True, True, True)), ("mean_offset_net", (False,)), ("scale_net", (False,)),
    ("geo_offset_net", (True, True, True)), ("mean_offset_offset_net", (False,)),
    ("scale_offset_net", (False,)), ("rgb_net", (True, True, True, False)),
    ("rgb_offset_net", (True, True, True, False)),
    ("shape_param", None), ("joint_offset", None),
)


def _trainable_leaves() -> List[Tuple[str, Optional[str], bool]]:
    """(JAX leaf path, the port's parameter name or None for a placeholder,
    whether the array is transposed between the two)."""
    out = [(f"scene.{f}", f"scene.{f}", False) for f in _SCENE_FIELDS]
    for name, gn in _HUMAN_FIELDS:
        if gn is None:
            out.append((f"human.{name}", f"human.{name}", False))
            continue
        n = len(gn)
        out += [(f"human.{name}.weights.{i}", f"human.{name}.linears.{i}.weight", True)
                for i in range(n)]
        out += [(f"human.{name}.biases.{i}", f"human.{name}.linears.{i}.bias", False)
                for i in range(n)]
        for field, attr in (("gn_scales", "weight"), ("gn_biases", "bias")):
            out += [(f"human.{name}.{field}.{i}",
                     f"human.{name}.norms.{i}.{attr}" if gn[i] else None, False)
                    for i in range(n)]
    out += [(f"frames.{f}", f"frames.{f}", False) for f in _FRAME_FIELDS]
    return out


_TRAINABLE_LEAVES = _trainable_leaves()

# every leaf of the JAX package's TrainState, in tree_flatten's order:
# trainables, (ScaleByAdamState(count, mu, nu), GroupLRState(count)), the
# scene's aux, itr
TRAIN_STATE_LEAVES: Tuple[str, ...] = tuple(
    [f"trainables.{j}" for j, _, _ in _TRAINABLE_LEAVES]
    + ["opt_state.0.count"]
    + [f"opt_state.0.{m}.{j}" for m in ("mu", "nu") for j, _, _ in _TRAINABLE_LEAVES]
    + ["opt_state.1.count"]
    + [f"scene_aux.{f}" for f in _AUX_FIELDS]
    + ["itr"]
)


def _tree_to_numpy(named: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for j, name, transpose in _TRAINABLE_LEAVES:
        if name is None:
            out[prefix + j] = np.zeros((0,), np.float32)
            continue
        a = named[name].detach().cpu().numpy()
        out[prefix + j] = np.ascontiguousarray(a.T) if transpose else a.copy()
    return out


def train_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """Every leaf of a ``train.loop.TrainState`` as numpy, keyed and ordered by
    ``TRAIN_STATE_LEAVES``, in the JAX package's shapes and dtypes."""
    out = _tree_to_numpy(dict(state.trainables.named_parameters()), "trainables.")
    count = np.asarray(state.opt_state.count, np.int32)
    out["opt_state.0.count"] = count
    out.update(_tree_to_numpy(state.opt_state.mu, "opt_state.0.mu."))
    out.update(_tree_to_numpy(state.opt_state.nu, "opt_state.0.nu."))
    out["opt_state.1.count"] = count
    for f in _AUX_FIELDS:
        out[f"scene_aux.{f}"] = getattr(state.scene_aux, f).cpu().numpy()
    out["itr"] = np.asarray(state.itr, np.int32)
    assert tuple(out) == TRAIN_STATE_LEAVES
    return out


def _tree_from_numpy(leaves: Mapping[str, np.ndarray], prefix: str,
                     device) -> Dict[str, torch.Tensor]:
    out = {}
    for j, name, transpose in _TRAINABLE_LEAVES:
        a = np.array(leaves[prefix + j], dtype=np.float32)
        if name is None:
            if a.size:
                raise ValueError(f"{prefix + j}: expected a zero-size placeholder")
            continue
        out[name] = torch.from_numpy(np.ascontiguousarray(a.T) if transpose else a).to(device)
    return out


def train_state_from_jax(leaves: Union[Sequence[np.ndarray], Mapping[str, np.ndarray]],
                         cfg: AvatarConfig, device="cuda"):
    """A ``train.loop.TrainState`` from the leaves of the JAX package's (a
    sequence in ``tree_flatten``'s order, or a mapping keyed by
    ``TRAIN_STATE_LEAVES``). The two step counts must agree: the port keeps
    one."""
    from ..train.loop import TrainState
    from ..train.optim import AdamState

    if not isinstance(leaves, Mapping):
        if len(leaves) != len(TRAIN_STATE_LEAVES):
            raise ValueError(f"{len(leaves)} leaves, expected {len(TRAIN_STATE_LEAVES)}")
        leaves = dict(zip(TRAIN_STATE_LEAVES, leaves))
    named = _tree_from_numpy(leaves, "trainables.", device)
    pick = lambda head, fields: {f: named[f"{head}.{f}"] for f in fields}
    human = HumanGaussians(cfg, named["human.shape_param"].shape[0],
                           named["human.joint_offset"].shape[0], device=device)
    human.load_state_dict({k[len("human."):]: v for k, v in named.items()
                           if k.startswith("human.")})
    trainables = AvatarTrainables(SceneParams(**pick("scene", _SCENE_FIELDS)), human,
                                  SMPLXParamFrames(**pick("frames", _FRAME_FIELDS)))
    counts = {int(leaves["opt_state.0.count"]), int(leaves["opt_state.1.count"])}
    if len(counts) != 1:
        raise ValueError(f"the two optimizer step counts differ: {sorted(counts)}")
    opt = AdamState(mu=_tree_from_numpy(leaves, "opt_state.0.mu.", device),
                    nu=_tree_from_numpy(leaves, "opt_state.0.nu.", device), count=counts.pop())
    aux = _scene_aux({f: leaves[f"scene_aux.{f}"] for f in _AUX_FIELDS}, device)
    return TrainState(trainables, opt, aux, int(leaves["itr"]))
