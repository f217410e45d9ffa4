"""Dataset layer: COLMAP parsing and the subject loader (counterpart of
exavatar_release_tpu/data/; the on-disk layout is the reference's)."""
from .colmap import parse_cameras_txt, parse_images_txt, parse_points3d_txt
from .subject import (
    SubjectData,
    bbox_from_keypoints,
    camera_distribution,
    load_subject,
)

__all__ = [
    "parse_cameras_txt",
    "parse_images_txt",
    "parse_points3d_txt",
    "SubjectData",
    "bbox_from_keypoints",
    "camera_distribution",
    "load_subject",
]
