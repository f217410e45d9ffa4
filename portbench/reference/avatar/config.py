"""Avatar configuration (counterpart of exavatar_release_tpu/avatar/config.py):
one frozen dataclass; stage flags (warmup, SH degree) are functions of the
iteration number.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AvatarConfig:
    # triplane extents (meters) and size
    triplane_shape_3d: Tuple[float, float, float] = (2.0, 2.0, 2.0)
    triplane_face_shape_3d: Tuple[float, float, float] = (0.3, 0.3, 0.3)
    triplane_ch: int = 32
    triplane_res: int = 128

    # train schedule
    lr: float = 1e-3
    end_epoch: int = 5
    max_sh_degree: int = 3
    increase_sh_degree_interval: int = 1000
    densify_end_itr: int = 15000
    densify_start_itr: int = 500
    densify_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_grad_thr: float = 0.0002
    opacity_min: float = 0.005
    dense_percent_thr: float = 0.01
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scale_lr: float = 0.005
    rotation_lr: float = 0.001
    warmup_itr: int = 100
    smplx_param_lr: float = 1e-4  # 1e-3 when fitting pose to test frames

    # loss weights
    rgb_loss_weight: float = 0.8
    ssim_loss_weight: float = 0.2
    lpips_weight: float = 0.2
    # LPIPS runs on a fixed-size window centered on the human bbox (clamped
    # to the image), the JAX package's static-shape stand-in for a crop to
    # the bbox; kept so both packages compute the same loss. A window >= the
    # image means the full image.
    lpips_crop_h: int = 768
    lpips_crop_w: int = 512
    # The face mesh render covers a small screen region: it is rasterized in
    # a window centered on the projected face and embedded back at the -1
    # background, which is exact as long as the face fits the window. A
    # window >= the image means the full frame.
    face_render_h: int = 512
    face_render_w: int = 512

    # fixed-capacity scene buffer
    scene_capacity: int = 1 << 17

    def is_warmup(self, itr: int) -> bool:
        return itr < self.warmup_itr

    def sh_degree_at(self, itr: int) -> int:
        return min(itr // self.increase_sh_degree_interval, self.max_sh_degree)
