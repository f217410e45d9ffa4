"""Image metrics: windowed SSIM and PSNR (counterpart of
exavatar_release_tpu/ops/image_metrics.py).

SSIM: 11x11 Gaussian window, sigma 1.5, per-channel depthwise convolution
with zero padding, C1 = 0.01^2, C2 = 0.03^2. The 2D window is outer(g, g),
applied as two 1-D depthwise convolutions (zero padding commutes with a
separable kernel). The convolutions must run in full float32: SSIM's
variance E[x^2] - mu^2 is a cancellation, and TF32's three digits push the
denominator through zero on smooth images, so TF32 is switched off around
them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_window_1d(window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Normalized 1D Gaussian window."""
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return torch.from_numpy((g / g.sum()).astype(np.float32))


def gaussian_window(window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Normalized 2D Gaussian window."""
    g = gaussian_window_1d(window_size, sigma).numpy()
    return torch.from_numpy(np.outer(g, g).astype(np.float32))


def _depthwise_conv(img: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """img: (C, H, W); g: (k,) 1-D window; zero padding, along W then H."""
    C = img.shape[0]
    k = g.shape[0]
    kw = g[None, None, None, :].expand(C, 1, 1, k)
    kh = g[None, None, :, None].expand(C, 1, k, 1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = F.conv2d(img[None], kw, padding=(0, k // 2), groups=C)
        x = F.conv2d(x, kh, padding=(k // 2, 0), groups=C)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return x[0]


def ssim_map(img_out: torch.Tensor, img_target: torch.Tensor,
             mask: Optional[torch.Tensor] = None, window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM map of (C, H, W) images in [0, 1]. ``mask`` (1, H, W)
    or (H, W) multiplies both inputs BEFORE windowing."""
    if mask is not None:
        m = mask if mask.ndim == 3 else mask[None]
        img_out = img_out * m
        img_target = img_target * m
    w = gaussian_window_1d(window_size).to(img_out.device)
    mu1 = _depthwise_conv(img_out, w)
    mu2 = _depthwise_conv(img_target, w)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_conv(img_out * img_out, w) - mu1_sq
    sigma2_sq = _depthwise_conv(img_target * img_target, w) - mu2_sq
    sigma12 = _depthwise_conv(img_out * img_target, w) - mu1_mu2
    C1 = 0.01 ** 2
    C2 = 0.03 ** 2
    return ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )


def psnr(img_out: torch.Tensor, img_target: torch.Tensor,
         mask: Optional[torch.Tensor] = None, data_range: float = 1.0) -> torch.Tensor:
    """PSNR in dB; with a mask, MSE over masked pixels only."""
    err = (img_out - img_target) ** 2
    if mask is not None:
        m = (mask if mask.ndim == err.ndim else mask[None]).expand(err.shape)
        mse = torch.sum(err * m) / torch.clamp(torch.sum(m), min=1.0)
    else:
        mse = torch.mean(err)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def bbox_mask(img_shape, bbox: torch.Tensor) -> torch.Tensor:
    """(H, W) float mask of an [xmin, ymin, width, height] pixel bbox: the
    losses mask to the human bbox and take masked means."""
    H, W = img_shape
    dev = bbox.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    # xmax derives from the RAW xmin, before it is clamped to the image
    xmax = torch.clamp(torch.floor(bbox[0]) + torch.floor(bbox[2]), max=W)
    ymax = torch.clamp(torch.floor(bbox[1]) + torch.floor(bbox[3]), max=H)
    xmin = torch.clamp(torch.floor(bbox[0]), min=0.0)
    ymin = torch.clamp(torch.floor(bbox[1]), min=0.0)
    return ((xs >= xmin) & (xs < xmax) & (ys >= ymin) & (ys < ymax)).float()


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of (C, H, W) or (H, W) over mask (H, W); plain mean if None."""
    if mask is None:
        return torch.mean(x)
    m = (mask if x.ndim == mask.ndim else mask[None]).expand(x.shape)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)
