"""Carry human-avatar weights from the JAX package into the port.

``human_params_from_jax`` takes the JAX ``HumanParams`` as nested dicts of
numpy arrays (its field names; each MLP an ``MLPParams``-like 4-tuple of
(weights, biases, gn_scales, gn_biases) tuples) and returns a state dict for
``HumanGaussians``. JAX Linear weights are (C_in, C_out); ``nn.Linear``
wants (C_out, C_in), so they are transposed. An empty GroupNorm scale marks a
layer without a norm.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

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
