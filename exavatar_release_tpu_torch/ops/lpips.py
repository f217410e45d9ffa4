"""LPIPS perceptual distance, VGG16 / AlexNet backbones (counterpart of
exavatar_release_tpu/ops/lpips.py).

lpips v0.1 semantics: input in [-1, 1], imagenet-style shift and scale,
backbone features at 5 taps, channel unit normalisation, 1x1 linear heads,
spatial mean, sum over taps. Weights load from the ``.npz`` layout the JAX
package writes (conv weights are (O, I, kh, kw) in both packages); the
conversion from torchvision checkpoints waits for the apps slice.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# lpips ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# VGG16 conv plan: (out_channels, layers_in_block); taps after each block's relu
VGG16_PLAN: Tuple[Tuple[int, int], ...] = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


@dataclasses.dataclass(frozen=True)
class LPIPSParams:
    conv_weights: Tuple[torch.Tensor, ...]  # each (O, I, kh, kw)
    conv_biases: Tuple[torch.Tensor, ...]
    lin_weights: Tuple[torch.Tensor, ...]  # 5 heads, each (C_tap,)
    net: str  # 'vgg' | 'alex'


def vgg16_features(params: LPIPSParams, x: torch.Tensor) -> List[torch.Tensor]:
    """x: (N, 3, H, W) -> 5 tap activations (after the last relu per block)."""
    taps = []
    i = 0
    for block, (_, n_layers) in enumerate(VGG16_PLAN):
        for _ in range(n_layers):
            x = F.relu(F.conv2d(x, params.conv_weights[i], params.conv_biases[i], padding=1))
            i += 1
        taps.append(x)
        if block < len(VGG16_PLAN) - 1:
            x = F.max_pool2d(x, 2, 2)
    return taps


def alexnet_features(params: LPIPSParams, x: torch.Tensor) -> List[torch.Tensor]:
    """torchvision AlexNet.features taps after each of the 5 relus."""
    w, b = params.conv_weights, params.conv_biases
    taps = []
    x = F.relu(F.conv2d(x, w[0], b[0], stride=4, padding=2))
    taps.append(x)
    x = F.max_pool2d(x, 3, 2)
    x = F.relu(F.conv2d(x, w[1], b[1], padding=2))
    taps.append(x)
    x = F.max_pool2d(x, 3, 2)
    for i in (2, 3, 4):
        x = F.relu(F.conv2d(x, w[i], b[i], padding=1))
        taps.append(x)
    return taps


def _unit_normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(feat * feat, dim=1, keepdim=True))
    return feat / (norm + eps)


def _resize_linear(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(mask, (h, w), "linear")``: half-pixel bilinear
    with an antialiasing triangle filter when it shrinks."""
    return F.interpolate(mask[None, None], size=(h, w), mode="bilinear", align_corners=False,
                         antialias=True)[0, 0]


def lpips_distance(params: LPIPSParams, img0: torch.Tensor, img1: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LPIPS distance between (3, H, W) images in [-1, 1]; a scalar.
    ``mask`` (H, W): masked spatial mean of each tap's distance map, the
    mask resized to the tap's resolution."""
    x = torch.stack([img0, img1], dim=0)  # (2, 3, H, W)
    shift = torch.tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.tensor(_SCALE, device=x.device)[None, :, None, None]
    x = (x - shift) / scale
    feats = (vgg16_features if params.net == "vgg" else alexnet_features)(params, x)
    total = 0.0
    for tap, lin_w in zip(feats, params.lin_weights):
        f0 = _unit_normalize(tap[0:1])
        f1 = _unit_normalize(tap[1:2])
        diff = (f0 - f1) ** 2  # (1, C, h, w)
        dist = torch.sum(diff * torch.clamp(lin_w, min=0.0)[None, :, None, None], dim=1)[0]
        if mask is not None:
            m = _resize_linear(mask, *dist.shape)
            total = total + torch.sum(dist * m) / torch.clamp(torch.sum(m), min=1.0)
        else:
            total = total + torch.mean(dist)
    return total


def load_lpips(npz_path: str, device="cuda") -> LPIPSParams:
    """Load weights in the ``.npz`` layout of ``save_lpips``."""
    d = np.load(npz_path)
    n_conv = int(d["n_conv"])
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    return LPIPSParams(
        tuple(t(d[f"conv_w_{i}"]) for i in range(n_conv)),
        tuple(t(d[f"conv_b_{i}"]) for i in range(n_conv)),
        tuple(t(d[f"lin_{i}"]) for i in range(5)),
        str(d["net"]),
    )


def save_lpips(npz_path: str, params: LPIPSParams) -> None:
    """Write params in the ``.npz`` layout ``load_lpips`` reads."""
    out = {"n_conv": len(params.conv_weights), "net": params.net}
    for i, (w, b) in enumerate(zip(params.conv_weights, params.conv_biases)):
        out[f"conv_w_{i}"] = w.detach().cpu().numpy()
        out[f"conv_b_{i}"] = b.detach().cpu().numpy()
    for i, lin in enumerate(params.lin_weights):
        out[f"lin_{i}"] = lin.detach().cpu().numpy()
    np.savez(npz_path, **out)
