"""LPIPS perceptual distance, VGG16 / AlexNet backbones (counterpart of
exavatar_release_tpu/ops/lpips.py).

lpips v0.1 semantics: input in [-1, 1], imagenet-style shift and scale,
backbone features at 5 taps, channel unit normalisation, 1x1 linear heads,
spatial mean, sum over taps. Weights load from the ``.npz`` layout the JAX
package writes (conv weights are (O, I, kh, kw) in both packages);
``convert_torch_state_dicts`` writes that layout from a torchvision backbone's
``.features`` state dict and the lpips v0.1 head checkpoint, with no
torchvision or lpips import.
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


def init_lpips_random(seed: int = 1, net: str = "vgg", device="cuda") -> LPIPSParams:
    """Architecture-correct LPIPS with seeded random weights (He-normal
    convolutions, zero biases, small positive heads), for tests and for
    running without converted pretrained weights. The distribution is the
    JAX package's ``init_lpips_random``; the numbers, drawn from a
    ``torch.Generator`` seeded with ``seed``, are not."""
    if net == "vgg":
        shapes, cin = [], 3
        for ch, n_layers in VGG16_PLAN:
            for _ in range(n_layers):
                shapes.append((ch, cin, 3, 3))
                cin = ch
        tap_dims = [ch for ch, _ in VGG16_PLAN]
    else:
        shapes = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3), (256, 384, 3, 3),
                  (256, 256, 3, 3)]
        tap_dims = [64, 192, 384, 256, 256]
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = lambda *sh: torch.randn(*sh, generator=g).to(device)
    return LPIPSParams(
        tuple(n(*s) * (2.0 / (s[1] * s[2] * s[3])) ** 0.5 for s in shapes),
        tuple(torch.zeros(s[0], device=device) for s in shapes),
        tuple(torch.relu(n(d)) * 0.1 + 0.01 for d in tap_dims), net)


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


# torchvision nn.Sequential indices of the Conv2d layers in `.features`
_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_ALEX_CONV_IDX = (0, 3, 6, 8, 10)


def _sd_array(v) -> np.ndarray:
    """A state dict's value (tensor or numpy array) as float32 numpy."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def convert_torch_state_dicts(out_path: str, features_sd: dict, lins_sd: dict,
                              net: str = "vgg") -> None:
    """Write the ``.npz`` layout ``load_lpips`` reads from two plain state
    dicts:

    * ``features_sd``: ``torchvision.models.vgg16().features.state_dict()``
      (keys ``0.weight`` ...; a full model's, with ``features.`` prefixes,
      also works), or alexnet's ``.features`` equivalent;
    * ``lins_sd``: the lpips v0.1 head checkpoint
      (``lpips/weights/v0.1/{vgg,alex}.pth``, keys ``lin{i}.model.1.weight``
      of shape (1, C, 1, 1)).

    Raises KeyError naming the first missing convolution or head."""
    conv_idx = _VGG16_CONV_IDX if net == "vgg" else _ALEX_CONV_IDX

    def feat_key(i: int, leaf: str) -> str:
        for k in (f"{i}.{leaf}", f"features.{i}.{leaf}"):
            if k in features_sd:
                return k
        raise KeyError(f"state_dict missing conv {i} ({leaf}); expected torchvision "
                       f"`.features` layout with Conv2d at indices {conv_idx}")

    out = {"n_conv": len(conv_idx), "net": net}
    for j, i in enumerate(conv_idx):
        out[f"conv_w_{j}"] = _sd_array(features_sd[feat_key(i, "weight")])
        out[f"conv_b_{j}"] = _sd_array(features_sd[feat_key(i, "bias")])
    for i in range(5):
        for k in (f"lin{i}.model.1.weight", f"lin{i}.weight", f"lin_{i}"):
            if k in lins_sd:
                out[f"lin_{i}"] = _sd_array(lins_sd[k]).reshape(-1)
                break
        else:
            raise KeyError(f"lins state_dict missing head {i}; expected lpips-v0.1 keys "
                           f"lin{i}.model.1.weight")
    np.savez(out_path, **out)
