"""Avatar configuration (counterpart of exavatar_release_tpu/avatar/config.py).

Only the fields the render path reads are here; the training schedule,
loss weights and scene capacity arrive with the training slice.
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
