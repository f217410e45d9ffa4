"""Immutable fitting configuration (counterpart of
exavatar_release_tpu/fitting/config.py; reference fitting/main/config.py:5-63).

Stage logic becomes pure functions of (epoch, itr) instead of config
mutation (reference set_stage, config.py:47-62).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FittingConfig:
    face_img_shape: Tuple[int, int] = (256, 256)
    proj_shape: Tuple[int, int] = (8, 8)
    uvmap_shape: Tuple[int, int] = (512, 512)
    lr_dec_factor: float = 10.0
    end_epoch: int = 3
    batch_size: int = 64
    body_3d_size: float = 2.0  # meters

    def itr_opt_num(self, epoch: int) -> int:
        return 500 if epoch == 0 else 250

    def base_lr(self, epoch: int) -> float:
        return 1e-1 if epoch == 0 else 1e-2

    def lr_dec_itrs(self, epoch: int) -> Tuple[int, ...]:
        return (100, 250, 400) if epoch == 0 else (100, 200)

    def lr_at(self, epoch: int, itr: int) -> float:
        lr = self.base_lr(epoch)
        for dec in self.lr_dec_itrs(epoch):
            if itr >= dec:
                lr /= self.lr_dec_factor
        return lr

    # stage flags (reference config.py:47-62)
    def is_warmup(self, epoch: int, itr: int) -> bool:
        return epoch == 0 and itr < 100

    def root_only(self, epoch: int, itr: int) -> bool:
        """First 100 itrs of epoch 0: only root pose + translation move
        (reference fit.py:75-84)."""
        return epoch == 0 and itr < 100

    def hand_joint_offset(self, epoch: int, itr: int) -> bool:
        return not (epoch == 0 and itr < 250)

    def freeze_shared(self, epoch: int) -> bool:
        """Last epoch: freeze shared identity params (reference fit.py:86-90)."""
        return epoch == self.end_epoch - 1
