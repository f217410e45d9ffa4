"""Human (SMPL-X-anchored) Gaussians: triplane + MLP heads + LBS posing
(counterpart of exavatar_release_tpu/avatar/human.py).

Optimizable state is the ``HumanGaussians`` module (triplanes, MLP heads,
identity shape and joint offsets). The upsampled-template tables are a
separate ``HumanBuffers`` built once by ``init_human_buffers``. The forward
is a function of (module, buffers, prior, frame pose, camera).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..core.geometry import vertex_normals
from ..core.rotations import axis_angle_to_matrix, axis_angle_to_rotation_6d
from ..models.smplx.lbs import rigid_transform
from ..models.smplx.model import smplx_forward
from ..models.smplx.prior import JOINT_PART, SMPLXIDInfo, SMPLXPrior
from ..models.smplx.structs import SMPLXParams
from ..nn import MLP
from ..ops.grid_sample import triplane_sample
from ..ops.knn import knn
from ..utils.profiling import spanned
from .config import AvatarConfig
from .gaussians import GaussianAssets
from .param_dict import PosedSMPLXParams

N_BODY = len(JOINT_PART["body"]) - 1  # 21 body joints without the root


class HumanGaussians(nn.Module):
    """Optimizable human-avatar parameters. Triplanes start at zero, the MLP
    heads at torch-default ranges drawn from ``generator``."""

    def __init__(self, cfg: AvatarConfig, num_shape: int, num_joints: int,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        C, R = cfg.triplane_ch, cfg.triplane_res
        pose_in = N_BODY * 6
        mlp = lambda dims, **kw: MLP(dims, generator=generator, device=device, **kw)
        self.triplane = nn.Parameter(torch.zeros(3, C, R, R, device=device))
        self.triplane_face = nn.Parameter(torch.zeros(3, C, R, R, device=device))
        self.geo_net = mlp([C * 3, 128, 128, 128], use_gn=True)
        self.mean_offset_net = mlp([128, 3], relu_final=False)
        self.scale_net = mlp([128, 1], relu_final=False)
        self.geo_offset_net = mlp([C * 3 + pose_in, 128, 128, 128], use_gn=True)
        self.mean_offset_offset_net = mlp([128, 3], relu_final=False)
        self.scale_offset_net = mlp([128, 1], relu_final=False)
        self.rgb_net = mlp([C * 3, 128, 128, 128, 3], relu_final=False, use_gn=True)
        self.rgb_offset_net = mlp(
            [C * 3 + pose_in + 3, 128, 128, 128, 3], relu_final=False, use_gn=True
        )
        self.shape_param = nn.Parameter(torch.zeros(num_shape, device=device))
        self.joint_offset = nn.Parameter(torch.zeros(num_joints, 3, device=device))


@dataclasses.dataclass(frozen=True)
class HumanBuffers:
    """Upsampled-template tables, all at V_hr rows."""

    pos_enc_mesh: torch.Tensor  # (V_hr, 3) 大-pose mesh, no id info, open jaw
    skinning_weight: torch.Tensor  # (V_hr, J)
    pose_dirs: torch.Tensor  # ((J-1)*9, V_hr*3)
    expr_dirs: torch.Tensor  # (V_hr, 3, E)
    is_rhand: torch.Tensor  # (V_hr,) bool
    is_lhand: torch.Tensor
    is_face: torch.Tensor
    is_face_expr: torch.Tensor
    is_cavity: torch.Tensor


class HumanForwardOut(NamedTuple):
    assets: GaussianAssets
    assets_refined: GaussianAssets
    mean_offset: torch.Tensor  # (V_hr, 3)
    mean_offset_offset: torch.Tensor  # (V_hr, 3)
    scale_offset: torch.Tensor  # (V_hr, 1)
    rgb_offset: torch.Tensor  # (V_hr, 3)
    mesh_neutral_pose: torch.Tensor  # (V_hr, 3)
    scale_wo_clamp: torch.Tensor  # (V_hr, 3) pre-warmup-clamp scale
    scale_refined_wo_clamp: torch.Tensor


def init_human_buffers(prior: SMPLXPrior) -> HumanBuffers:
    """The buffer half of the JAX package's ``init_human``."""
    assets = prior.assets
    # position-encoding mesh: 大 pose with OPEN jaw, no identity info
    mesh_hr, _, _, _ = neutral_pose_human(prior, None, None, jaw_zero_pose=False)
    J, V, E = assets.num_joints, assets.num_vertices, assets.num_expr
    V_hr = prior.vertex_num_upsampled
    up = prior.upsample_mesh
    pose_dirs_v = assets.posedirs.T.reshape(V, 3 * (J - 1) * 9)
    pose_dirs_hr = up(pose_dirs_v).reshape(V_hr * 3, (J - 1) * 9).T.contiguous()
    return HumanBuffers(
        pos_enc_mesh=mesh_hr,
        skinning_weight=up(assets.lbs_weights),
        pose_dirs=pose_dirs_hr,
        expr_dirs=up(assets.expr_dirs.reshape(V, 3 * E)).reshape(V_hr, 3, E),
        is_rhand=prior.is_rhand_hr,
        is_lhand=prior.is_lhand_hr,
        is_face=prior.is_face_hr,
        is_face_expr=prior.is_face_expr_hr,
        is_cavity=prior.is_cavity_hr,
    )


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(n, 3, 3)


def neutral_pose_human(
    prior: SMPLXPrior,
    shape_param: Optional[torch.Tensor],
    id_info: Optional[SMPLXIDInfo],
    jaw_zero_pose: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """大-pose human + the 大->zero FK transforms.

    Returns (mesh_hr, mesh_lr, joints_neutral, transform_mat_neutral_pose).
    """
    assets = prior.assets
    nb = prior.neutral_body_pose
    jaw = torch.zeros_like(prior.neutral_jaw_pose) if jaw_zero_pose else prior.neutral_jaw_pose
    z = SMPLXParams.zeros(assets.num_shape, assets.num_expr, device=nb.device)
    params = z.replace(
        body_pose=nb, jaw_pose=jaw,
        betas=shape_param if shape_param is not None else z.betas,
    )
    face_offset = id_info.face_offset if id_info is not None else None
    joint_offset = (
        prior.apply_joint_offset_weight(id_info.joint_offset) if id_info is not None else None
    )
    out = smplx_forward(
        assets, params, face_offset=face_offset, joint_offset=joint_offset,
        with_landmarks=False,
    )
    mesh_lr = out.vertices
    mesh_hr = prior.upsample_mesh(mesh_lr)

    # FK of the INVERSE 大 pose at the 大-posed joints -> 大->zero transforms
    # (raw poses, no pose_mean)
    inv_body = axis_angle_to_matrix(nb).transpose(1, 2)
    inv_jaw = axis_angle_to_matrix(jaw).T[None]
    pose_mats = torch.cat(
        [_eye(1, nb), inv_body, inv_jaw, _eye(1, nb), _eye(1, nb), _eye(15, nb), _eye(15, nb)],
        dim=0,
    )
    _, transform_mat = rigid_transform(pose_mats, out.joints, assets.parents)
    return mesh_hr, mesh_lr, out.joints, transform_mat


def zero_pose_joints(prior: SMPLXPrior, shape_param: torch.Tensor,
                     id_info: SMPLXIDInfo) -> torch.Tensor:
    """Zero-pose joint locations with identity info; the full forward runs
    so the hand-mean pose shifts hand joints as the reference layer does."""
    assets = prior.assets
    params = SMPLXParams.zeros(
        assets.num_shape, assets.num_expr, device=shape_param.device
    ).replace(betas=shape_param)
    out = smplx_forward(
        assets, params,
        face_offset=id_info.face_offset,
        joint_offset=prior.apply_joint_offset_weight(id_info.joint_offset),
        with_landmarks=False,
    )
    return out.joints


def extract_tri_feature(human: HumanGaussians, buffers: HumanBuffers,
                        cfg: AvatarConfig) -> torch.Tensor:
    """Triplane features of all upsampled vertices; face vertices read the
    dedicated face triplane."""
    xyz = buffers.pos_enc_mesh
    dev = xyz.device
    center = torch.mean(xyz, dim=0, keepdim=True)
    half = torch.tensor(cfg.triplane_shape_3d, device=dev) / 2.0
    feat = triplane_sample(human.triplane, xyz - center, half)

    is_face = buffers.is_face
    face_w = is_face.float()[:, None]
    face_center = torch.sum(xyz * face_w, dim=0, keepdim=True) / torch.clamp(
        torch.sum(face_w), min=1.0
    )
    half_face = torch.tensor(cfg.triplane_face_shape_3d, device=dev) / 2.0
    feat_face = triplane_sample(human.triplane_face, xyz - face_center, half_face)
    return torch.where(is_face[:, None], feat_face, feat)


def get_mean_offset_offset(
    buffers: HumanBuffers,
    smplx_param: PosedSMPLXParams,
    regressed: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hands/expressive-face vertices take the analytic SMPL-X pose
    correctives, every other vertex the regressed offsets."""
    pose_aa = torch.cat(
        [
            smplx_param.body_pose,
            smplx_param.jaw_pose[None],
            smplx_param.leye_pose[None],
            smplx_param.reye_pose[None],
            smplx_param.lhand_pose,
            smplx_param.rhand_pose,
        ],
        dim=0,
    )  # (J-1, 3)
    pose_feat = (axis_angle_to_matrix(pose_aa) - _eye(1, pose_aa)).reshape(-1).detach()
    smplx_pose_offset = torch.matmul(pose_feat, buffers.pose_dirs).reshape(-1, 3)

    mask = (buffers.is_rhand | buffers.is_lhand | buffers.is_face_expr).float()[:, None]
    regressed = regressed * (1.0 - mask)
    return regressed + smplx_pose_offset * mask, regressed


@spanned("human.forward")
def human_forward(
    human: HumanGaussians,
    buffers: HumanBuffers,
    prior: SMPLXPrior,
    smplx_param: PosedSMPLXParams,
    id_info: SMPLXIDInfo,
    cam_R: torch.Tensor,
    cam_t: torch.Tensor,
    cfg: AvatarConfig,
    is_world_coord: bool = False,
    knn_chunk: int = 4096,
) -> HumanForwardOut:
    """Full human-Gaussian forward.

    ``smplx_param`` poses are in CAMERA coordinates; outputs are world-space
    unless ``is_world_coord``. Identity shape / joint offsets come from
    ``human``, the face offset from ``id_info``.
    """
    assets = prior.assets
    V_hr = prior.vertex_num_upsampled
    run_id = SMPLXIDInfo(
        shape_param=human.shape_param,
        face_offset=id_info.face_offset,
        joint_offset=human.joint_offset,
        locator_offset=id_info.locator_offset,
    )

    mesh_neutral_hr, mesh_neutral_lr, _, T_neutral = neutral_pose_human(
        prior, human.shape_param, run_id, jaw_zero_pose=True
    )
    joints_zero = zero_pose_joints(prior, human.shape_param, run_id)

    tri_feat = extract_tri_feature(human, buffers, cfg)

    # geometry heads
    geo_feat = human.geo_net(tri_feat)
    mean_offset = human.mean_offset_net(geo_feat)
    scale_raw = human.scale_net(geo_feat)
    rgb_raw = human.rgb_net(tri_feat)
    mean_3d = mesh_neutral_hr + mean_offset  # 大 pose

    # pose-dependent geometry heads (body pose input, detached)
    pose6d = axis_angle_to_rotation_6d(smplx_param.body_pose).reshape(-1).detach()
    pose_tiled = pose6d[None, :].expand(V_hr, pose6d.shape[0])
    geo_off_feat = human.geo_offset_net(torch.cat([tri_feat, pose_tiled], dim=1))
    mean_offset_offset = human.mean_offset_offset_net(geo_off_feat)
    scale_offset = human.scale_offset_net(geo_off_feat)

    # exp-overflow guard of the JAX package: a raw log-scale past 10 is
    # divergent already, and an inf scale would poison the regularizer
    scale = torch.exp(torch.clamp(scale_raw, max=10.0)).repeat(1, 3)
    scale_refined = torch.exp(torch.clamp(scale_raw + scale_offset, max=10.0)).repeat(1, 3)

    mean_combined_offset, mean_offset_offset = get_mean_offset_offset(
        buffers, smplx_param, mean_offset_offset
    )
    mean_3d_refined = mean_3d + mean_combined_offset

    # facial expression blendshape offset
    expr_offset = torch.einsum("e,vce->vc", smplx_param.expr, buffers.expr_dirs)
    mean_3d = mean_3d + expr_offset
    mean_3d_refined = mean_3d_refined + expr_offset

    # nearest low-res template vertex -> skinning weights; hands/face keep
    # their own vertex (low-res vertices come first in the upsampled order)
    nn_idx = knn(mean_3d.detach(), mesh_neutral_lr.detach(), k=1, chunk=knn_chunk).idx[:, 0]
    own = buffers.is_rhand | buffers.is_lhand | buffers.is_face
    nn_idx = torch.where(own, torch.arange(V_hr, device=nn_idx.device), nn_idx)

    # FK transform chain: 大 -> zero -> posed
    pose_aa = torch.cat(
        [
            smplx_param.root_pose[None],
            smplx_param.body_pose,
            smplx_param.jaw_pose[None],
            smplx_param.leye_pose[None],
            smplx_param.reye_pose[None],
            smplx_param.lhand_pose,
            smplx_param.rhand_pose,
        ],
        dim=0,
    )
    _, T_pose = rigid_transform(axis_angle_to_matrix(pose_aa), joints_zero, assets.parents)
    T_joint = torch.einsum("jab,jbc->jac", T_pose, T_neutral)  # (J, 4, 4)

    # per-vertex transform via skinning weights of the nearest vertex
    W = buffers.skinning_weight[nn_idx]  # (V_hr, J)
    J = T_joint.shape[0]
    T_vert = torch.matmul(W, T_joint.reshape(J, 16)).reshape(V_hr, 4, 4)

    def lbs_pose(x):
        posed = torch.einsum("vij,vj->vi", T_vert[:, :3, :3], x) + T_vert[:, :3, 3]
        return posed + smplx_param.trans[None, :]

    mean_posed = lbs_pose(mean_3d)
    mean_posed_refined = lbs_pose(mean_3d_refined)

    if not is_world_coord:
        mean_posed = (mean_posed - cam_t[None, :]) @ cam_R
        mean_posed_refined = (mean_posed_refined - cam_t[None, :]) @ cam_R

    # view/pose-dependent rgb refinement; cavity normals flip
    normal = vertex_normals(mean_posed_refined.detach(), prior.faces_upsampled)
    cav = buffers.is_cavity.float()[:, None]
    normal = normal * (1.0 - cav) - normal * cav
    rgb_offset = human.rgb_offset_net(torch.cat([tri_feat, pose_tiled, normal], dim=1))

    rgb = (torch.tanh(rgb_raw) + 1.0) / 2.0
    rgb_refined = (torch.tanh(rgb_raw + rgb_offset) + 1.0) / 2.0

    dev = mean_posed.device
    rotation = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).expand(V_hr, 4)
    opacity = torch.ones(V_hr, 1, device=dev)
    live = torch.ones(V_hr, dtype=torch.bool, device=dev)
    return HumanForwardOut(
        assets=GaussianAssets(mean_posed, opacity, scale, rotation, rgb, live),
        assets_refined=GaussianAssets(
            mean_posed_refined, opacity, scale_refined, rotation, rgb_refined, live
        ),
        mean_offset=mean_offset,
        mean_offset_offset=mean_offset_offset,
        scale_offset=scale_offset,
        rgb_offset=rgb_offset,
        mesh_neutral_pose=mesh_neutral_hr,
        scale_wo_clamp=scale,
        scale_refined_wo_clamp=scale_refined,
    )


def clamp_warmup_scale(out: HumanForwardOut, max_scale: float = 0.001) -> HumanForwardOut:
    """Warmup scale clamp: random-init nets emit huge scales that would
    explode tile occupancy."""
    a = out.assets._replace(scale=torch.clamp(out.assets.scale, max=max_scale))
    r = out.assets_refined._replace(scale=torch.clamp(out.assets_refined.scale, max=max_scale))
    return out._replace(assets=a, assets_refined=r)
