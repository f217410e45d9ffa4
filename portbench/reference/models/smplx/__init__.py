"""SMPL-X and FLAME body models on torch tensors."""
from .assets_io import load_smplx_assets, synthetic_smplx_assets
from .flame import (
    FLAME_JOINT_NAMES,
    FLAME_PARENTS,
    FLAMEParams,
    FLAMEPrior,
    flame_forward,
    load_flame_assets,
    load_flame_uv,
    synthetic_flame_assets,
)
from .model import smplx_forward
from .prior import JOINT_PART, SMPLXIDInfo, SMPLXPrior, build_prior, load_prior_tables
from .structs import SMPLXAssets, SMPLXOutput, SMPLXParams

__all__ = [
    "FLAME_JOINT_NAMES", "FLAME_PARENTS", "FLAMEParams", "FLAMEPrior", "JOINT_PART",
    "SMPLXAssets", "SMPLXIDInfo", "SMPLXOutput", "SMPLXParams", "SMPLXPrior", "build_prior",
    "flame_forward", "load_flame_assets", "load_flame_uv", "load_prior_tables",
    "load_smplx_assets", "smplx_forward", "synthetic_flame_assets", "synthetic_smplx_assets",
]
