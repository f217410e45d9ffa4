"""SMPL-X body model on torch tensors."""
from .assets_io import synthetic_smplx_assets
from .model import smplx_forward
from .prior import JOINT_PART, SMPLXIDInfo, SMPLXPrior, build_prior
from .structs import SMPLXAssets, SMPLXOutput, SMPLXParams

__all__ = [
    "JOINT_PART", "SMPLXAssets", "SMPLXIDInfo", "SMPLXOutput", "SMPLXParams",
    "SMPLXPrior", "build_prior", "smplx_forward", "synthetic_smplx_assets",
]
