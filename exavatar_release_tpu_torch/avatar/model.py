"""Avatar model: composition of scene and human Gaussians, renders, losses
(counterpart of exavatar_release_tpu/avatar/model.py).

Per frame ``forward_frame`` produces five Gaussian renders (scene / human
over a random background / scene+human / the two refined variants), two
textured face-mesh renders and, in train mode, ~20 weighted loss terms. The
screen-space mean gradient that densification needs flows through the
explicit ``scene_mean2d_offset`` argument: the caller takes
d(loss)/d(offset) of a zero offset.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..core.camera import Camera
from ..core.geometry import vertex_normals
from ..models.smplx.prior import JOINT_PART, SMPLXIDInfo, SMPLXPrior
from ..models.smplx.structs import SMPLX_JOINT_NAMES
from ..ops.image_metrics import bbox_mask
from ..ops.lpips import LPIPSParams
from ..ops.mesh_raster import render_textured_mesh
from ..ops.rasterizer.api import RasterizeSettings, rasterize
from ..utils.profiling import span, spanned
from . import losses as L
from . import scene as sc
from .config import AvatarConfig
from .gaussians import GaussianAssets, concat_assets, detach_assets
from .human import HumanBuffers, HumanGaussians, clamp_warmup_scale, human_forward
from .param_dict import SMPLXParamFrames


class AvatarTrainables(nn.Module):
    """Everything an optimizer updates."""

    def __init__(self, scene: sc.SceneParams, human: HumanGaussians, frames: SMPLXParamFrames):
        super().__init__()
        self.scene = scene
        self.human = human
        self.frames = frames


class FrameData(NamedTuple):
    """One training frame."""

    img: torch.Tensor  # (3, H, W) in [0, 1]
    mask: torch.Tensor  # (1, H, W) human fg mask
    bbox: torch.Tensor  # (4,) xmin, ymin, w, h
    cam: Camera
    frame_row: int  # row in SMPLXParamFrames


class AvatarStatics(NamedTuple):
    """Tables resolved when the model is built; tensors on the model's device."""

    lap_idx: torch.Tensor  # (V_hr, 10) int64
    lap_w: torch.Tensor  # (V_hr, 10)
    right_joint_idx: torch.Tensor
    left_joint_idx: torch.Tensor
    upper_arm_idx: torch.Tensor  # static arm index lists
    lower_arm_idx: torch.Tensor
    joint_offset_weight: torch.Tensor  # (J, 3): 1, hands 10
    mean_reg_w: torch.Tensor  # (V_hr,) weight maps
    scale_reg_w: torch.Tensor
    lap_mean_w: torch.Tensor
    lap_scale_w: torch.Tensor
    lap_rgb_w: torch.Tensor
    face_vertex_idx: torch.Tensor  # (V_face,) low-res SMPLX<->FLAME table
    face_faces: torch.Tensor  # (F_face, 3) triangles over face_vertex order
    face_vertex_uv: torch.Tensor  # (Vt, 2)
    face_face_uv: torch.Tensor  # (F_face, 3)


def build_statics(prior: SMPLXPrior, buffers: HumanBuffers, face_faces: np.ndarray,
                  face_vertex_uv: np.ndarray, face_face_uv: np.ndarray) -> AvatarStatics:
    """Precompute all static tables, on the buffers' device. ``face_faces`` is
    the FLAME triangle list over ``prior.face_vertex_idx`` order."""
    dev = buffers.pos_enc_mesh.device
    V_hr = prior.vertex_num_upsampled
    lap_idx, lap_w = L.build_laplacian_neighbors(prior.faces_upsampled.cpu().numpy(), V_hr)
    right_idx, left_idx = L.symmetric_joint_pairs()

    npy = lambda t: t.cpu().numpy()
    is_rhand, is_lhand = npy(buffers.is_rhand), npy(buffers.is_lhand)
    is_face, is_face_expr = npy(buffers.is_face), npy(buffers.is_face_expr)
    is_cavity = npy(buffers.is_cavity)

    # arm split from the template neutral mesh at build time: normals move
    # negligibly under identity offsets and the assignment is not
    # differentiable, so a static split stands for the per-iteration one
    normal = npy(vertex_normals(buffers.pos_enc_mesh, prior.faces_upsampled))
    part = npy(buffers.skinning_weight).argmax(1)
    arm_joints = [SMPLX_JOINT_NAMES.index(n)
                  for n in ("R_Shoulder", "R_Elbow", "L_Shoulder", "L_Elbow")]
    is_arm = np.isin(part, arm_joints)
    thr = math.cos(math.pi / 3.0)
    upper = np.where(is_arm & (normal[:, 1] > thr))[0]
    lower = np.where(is_arm & (normal[:, 1] <= thr))[0]
    if upper.size == 0:
        upper = np.asarray([0], np.int64)
    if lower.size == 0:
        lower = np.asarray([0], np.int64)

    # weight maps: a base value, then sequential overwrites
    def wmap(base, assigns):
        w = np.full((V_hr,), float(base), np.float32)
        for mask, val in assigns:
            w[mask] = val
        return w

    mean_reg_w = wmap(10.0, [(is_rhand, 1000), (is_lhand, 1000), (is_face, 1), (is_face_expr, 10)])
    scale_reg_w = wmap(1.0, [(is_rhand, 1000), (is_lhand, 1000), (is_face_expr, 10), (is_cavity, 0)])
    lap_mean_w = wmap(1.0, [(is_face_expr, 50), (is_cavity, 0.1)])
    lap_scale_w = wmap(10.0, [(is_rhand, 10), (is_lhand, 10), (is_face_expr, 0)])
    lap_rgb_w = wmap(0.1, [(is_rhand, 100), (is_lhand, 100)])

    jw = np.ones((prior.assets.num_joints, 3), np.float32)
    jw[list(JOINT_PART["lhand"])] = 10.0
    jw[list(JOINT_PART["rhand"])] = 10.0

    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    i64 = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)
    return AvatarStatics(
        lap_idx=i64(lap_idx), lap_w=f32(lap_w),
        right_joint_idx=i64(right_idx), left_joint_idx=i64(left_idx),
        upper_arm_idx=i64(upper), lower_arm_idx=i64(lower),
        joint_offset_weight=f32(jw),
        mean_reg_w=f32(mean_reg_w), scale_reg_w=f32(scale_reg_w), lap_mean_w=f32(lap_mean_w),
        lap_scale_w=f32(lap_scale_w), lap_rgb_w=f32(lap_rgb_w),
        face_vertex_idx=prior.face_vertex_idx.long().to(dev),
        face_faces=i64(face_faces), face_vertex_uv=f32(face_vertex_uv),
        face_face_uv=i64(face_face_uv),
    )


class ForwardOutputs(NamedTuple):
    renders: Dict[str, torch.Tensor]
    losses: Dict[str, torch.Tensor]
    scene_radius: torch.Tensor  # (C,) densify stats of the scene render
    scene_is_vis: torch.Tensor  # (C,)
    # (gaussian, tile) pairs lost to the binning capacities, summed over this
    # frame's renders: dropped_pairs to the pair budget, truncated to
    # max_per_tile; a cropped footprint is a silent fault, so callers
    # surface nonzero values
    raster_dropped: Optional[torch.Tensor] = None
    raster_dropped_pairs: Optional[torch.Tensor] = None
    raster_truncated: Optional[torch.Tensor] = None
    # pairs the Gaussian-sharded renders' exchange found no bucket slot for
    # (settings.gaussian_shard); RasterCapacityGovernor grows exchange_cap
    raster_exchange_overflow: Optional[torch.Tensor] = None


def _window_origin(center: torch.Tensor, size: int, limit: int) -> int:
    """Origin of a ``size`` window centered on the scalar tensor ``center``,
    clipped into [0, limit - size]. The float32 difference truncates toward
    zero, like the JAX package's int32 cast. One host sync: the origin
    becomes a Python int, so the window is a plain slice."""
    with span("sync.window_origin"):
        return min(max(int(center - size * 0.5), 0), limit - size)


@spanned("model.forward")
def forward_frame(
    trainables: AvatarTrainables,
    scene_aux: sc.SceneAux,
    buffers: HumanBuffers,
    prior: SMPLXPrior,
    statics: AvatarStatics,
    id_info: SMPLXIDInfo,
    lpips_params: LPIPSParams,
    face_texture: torch.Tensor,  # (3, Ht, Wt)
    face_texture_mask: torch.Tensor,  # (1, Ht, Wt)
    init_joint_offset: torch.Tensor,  # (J, 3) fitting-stage value
    frame: FrameData,
    bg: torch.Tensor,  # (3,) human-render background (random in train)
    cfg: AvatarConfig,
    is_warmup: bool,
    mode: str = "train",
    fit_pose_to_test: bool = False,
    settings: RasterizeSettings = RasterizeSettings(),
    scene_mean2d_offset: Optional[torch.Tensor] = None,
) -> ForwardOutputs:
    """One frame through the full model, on the device of its tensors."""
    H, W = int(frame.img.shape[1]), int(frame.img.shape[2])
    cam = frame.cam
    dev = frame.img.device
    scene_state = sc.SceneState(trainables.scene, scene_aux)

    # ---- assets ------------------------------------------------------------
    scene_asset = sc.scene_assets(scene_state, cam.R, cam.t)
    smplx_param = trainables.frames.lookup(frame.frame_row)
    hout = human_forward(trainables.human, buffers, prior, smplx_param, id_info, cam.R, cam.t,
                         cfg)
    if mode == "train" and is_warmup:
        hout = clamp_warmup_scale(hout)
    human_asset, human_asset_ref = hout.assets, hout.assets_refined

    scene_human = concat_assets(detach_assets(scene_asset), human_asset)
    scene_human_ref = concat_assets(detach_assets(scene_asset), human_asset_ref)

    # ---- renders -----------------------------------------------------------
    ones_bg = torch.ones(3, device=dev)

    def render(assets: GaussianAssets, bg_color, mean2d_offset=None):
        return rasterize(assets.mean_3d, assets.scale, assets.rotation, assets.opacity,
                         assets.rgb, assets.live, cam, (H, W), bg_color, settings,
                         mean2d_offset=mean2d_offset)

    scene_render = render(scene_asset, ones_bg, scene_mean2d_offset)
    human_render = render(human_asset, bg)
    scene_human_render = render(scene_human, ones_bg)
    human_render_ref = render(human_asset_ref, bg)
    scene_human_render_ref = render(scene_human_ref, ones_bg)

    # face mesh render: FLAME-topology mesh over the posed face vertices
    uvmap = torch.cat([face_texture, face_texture_mask], dim=0)
    fv = statics.face_vertex_idx

    frh = min(cfg.face_render_h, H)
    frw = min(cfg.face_render_w, W)
    if frh < H or frw < W:
        # window origin from the projected face center (shared by the base
        # and refined assets: they differ in rgb only, not in geometry)
        with torch.no_grad():
            vc = human_asset.mean_3d[fv] @ cam.R.T + cam.t[None, :]
            fz = torch.clamp(vc[:, 2], min=1e-4)
            fpx = torch.mean(vc[:, 0] / fz * cam.focal[0] + cam.princpt[0])
            fpy = torch.mean(vc[:, 1] / fz * cam.focal[1] + cam.princpt[1])
        fcy = _window_origin(fpy, frh, H)
        fcx = _window_origin(fpx, frw, W)
        princpt_w = cam.princpt - torch.tensor([float(fcx), float(fcy)], device=dev)
    else:
        fcy = fcx = None
        princpt_w = cam.princpt

    def face_render_of(asset):
        with span("face.render"):
            patch = render_textured_mesh(
                uvmap, asset.mean_3d[fv], statics.face_faces, cam.R, cam.t, cam.focal,
                princpt_w, (frh, frw), statics.face_face_uv, statics.face_vertex_uv,
            )
            if fcy is None:
                return patch
            # embed at the -1 background that fills ALL channels: exact as
            # long as the face projects inside the window
            base = torch.full((patch.shape[0], H, W), -1.0, device=dev)
            base[:, fcy:fcy + frh, fcx:fcx + frw] = patch
            return base

    face_render = face_render_of(human_asset)
    face_render_ref = face_render_of(human_asset_ref)

    renders = {
        "scene_img": scene_render["img"],
        "human_img": human_render["img"],
        "human_mask": human_render["mask"],
        "scene_human_img": scene_human_render["img"],
        "human_img_refined": human_render_ref["img"],
        "human_mask_refined": human_render_ref["mask"],
        "scene_human_img_refined": scene_human_render_ref["img"],
        "face_render": face_render,
        "face_render_refined": face_render_ref,
    }

    if mode != "train":
        out = dict(renders)

        # composited outputs; the texture mask channel is a weight here
        def face_compose(base, fr):
            is_face = (fr[:3] != -1).float() * fr[3:4]
            return base * (1 - is_face) + fr[:3] * is_face

        # renders are (H, W, 3); face renders are (C, H, W)
        out["human_face_img"] = face_compose(
            renders["human_img"].permute(2, 0, 1), face_render).permute(1, 2, 0)
        out["human_face_img_refined"] = face_compose(
            renders["human_img_refined"].permute(2, 0, 1), face_render_ref).permute(1, 2, 0)
        is_fg = (human_render["mask"] > 0.9).float()[..., None]
        out["scene_human_img_composed"] = (
            is_fg * human_render["img"] + (1 - is_fg) * scene_human_render["img"]
        )
        is_fg = (human_render_ref["mask"] > 0.9).float()[..., None]
        out["scene_human_img_refined_composed"] = (
            is_fg * human_render_ref["img"] + (1 - is_fg) * scene_human_render_ref["img"]
        )
        return ForwardOutputs(out, {}, scene_render["radius"], scene_render["is_vis"])

    # ---- losses ------------------------------------------------------------
    all_renders = (scene_render, human_render, scene_human_render, human_render_ref,
                   scene_human_render_ref)
    dropped = sum(r["n_dropped"] for r in all_renders)
    dropped_pairs = sum(r["n_dropped_pairs"] for r in all_renders)
    truncated = sum(r["n_truncated"] for r in all_renders)
    xovf = sum(r["exchange_overflow"].sum() for r in all_renders if "exchange_overflow" in r)
    # all images as (3, H, W)
    img_t = frame.img
    mask_t = frame.mask
    region = bbox_mask((H, W), frame.bbox)
    chw = lambda hwc: hwc.permute(2, 0, 1)

    losses: Dict[str, torch.Tensor] = {}
    sh_img = chw(scene_human_render["img"])
    sh_img_ref = chw(scene_human_render_ref["img"])

    # LPIPS window: fixed-size crop centered on the bbox (see AvatarConfig)
    lch = min(cfg.lpips_crop_h, H)
    lcw = min(cfg.lpips_crop_w, W)
    lcy = _window_origin(frame.bbox[1] + frame.bbox[3] * 0.5, lch, H)
    lcx = _window_origin(frame.bbox[0] + frame.bbox[2] * 0.5, lcw, W)
    crop3 = lambda im: im[:, lcy:lcy + lch, lcx:lcx + lcw]
    img_t_lcrop = crop3(img_t)
    region_lcrop = region[lcy:lcy + lch, lcx:lcx + lcw]

    losses["rgb_human"] = L.rgb_l1(sh_img, img_t, region) * cfg.rgb_loss_weight
    losses["ssim_human"] = L.ssim_loss(sh_img, img_t, region) * cfg.ssim_loss_weight
    losses["lpips_human"] = L.lpips_loss(
        lpips_params, crop3(sh_img), img_t_lcrop, region_lcrop) * cfg.lpips_weight

    def face_composite_loss(base_img, fr):
        # the texture mask channel must be exactly 1 here, not a weight
        is_face = (fr[:3] != -1.0).float() * (fr[3:4] == 1.0).float()
        composed = base_img * (1 - is_face) + fr[:3] * is_face
        return L.rgb_l1(composed, img_t, region) * cfg.rgb_loss_weight

    losses["rgb_face"] = face_composite_loss(sh_img, face_render)
    losses["rgb_human_rand_bg"] = L.rgb_l1(
        chw(human_render["img"]), img_t, region, fg_mask=mask_t, bg=bg)

    losses["rgb_human_refined"] = L.rgb_l1(sh_img_ref, img_t, region) * cfg.rgb_loss_weight
    losses["ssim_human_refined"] = L.ssim_loss(sh_img_ref, img_t, region) * cfg.ssim_loss_weight
    losses["lpips_human_refined"] = L.lpips_loss(
        lpips_params, crop3(sh_img_ref), img_t_lcrop, region_lcrop) * cfg.lpips_weight
    losses["rgb_face_refined"] = face_composite_loss(sh_img_ref, face_render_ref)
    losses["rgb_human_refined_rand_bg"] = L.rgb_l1(
        chw(human_render_ref["img"]), img_t, region, fg_mask=mask_t, bg=bg)

    outputs = lambda: ForwardOutputs(
        renders, losses, scene_render["radius"], scene_render["is_vis"],
        raster_dropped=dropped, raster_dropped_pairs=dropped_pairs, raster_truncated=truncated,
        raster_exchange_overflow=xovf,
    )
    if fit_pose_to_test:
        return outputs()

    losses["rgb_scene"] = (
        L.rgb_l1_weighted_full(chw(scene_render["img"]), img_t, 1.0 - mask_t)
        * cfg.rgb_loss_weight
    )
    losses["ssim_scene"] = (
        L.ssim_loss(chw(scene_render["img"]), img_t, mul_mask=1.0 - mask_t)
        * cfg.ssim_loss_weight
    )

    mw = statics.mean_reg_w[:, None]
    losses["gaussian_mean_reg"] = torch.mean(
        (hout.mean_offset ** 2 + hout.mean_offset_offset ** 2) * mw)
    is_hand = buffers.is_rhand | buffers.is_lhand
    losses["gaussian_mean_hand_reg"] = L.hand_mean_reg(
        hout.mesh_neutral_pose, hout.mean_offset, prior.faces_upsampled, is_hand
    ) + L.hand_mean_reg(
        hout.mesh_neutral_pose, hout.mean_offset_offset, prior.faces_upsampled, is_hand
    )

    sw = statics.scale_reg_w[:, None]
    scale_for_reg = hout.scale_wo_clamp if is_warmup else human_asset.scale
    losses["gaussian_scale_reg"] = torch.mean((scale_for_reg ** 2 + hout.scale_offset ** 2) * sw)

    neutral_sg = hout.mesh_neutral_pose.detach()
    # all seven laplacian operands ride one neighbor gather
    (l_m1, l_m2, l_n, l_s, l_sr, l_r, l_rr) = L.laplacian_multi(
        [
            neutral_sg + hout.mean_offset,
            neutral_sg + hout.mean_offset + hout.mean_offset_offset,
            neutral_sg,
            human_asset.scale,
            human_asset_ref.scale,
            human_asset.rgb,
            human_asset_ref.rgb,
        ],
        statics.lap_idx,
        statics.lap_w,
    )

    def _lap_wmean(lap, wmap_):
        return torch.mean(lap ** 2 * wmap_[:, None])

    losses["lap_mean"] = (
        _lap_wmean(l_m1 - l_n, statics.lap_mean_w) + _lap_wmean(l_m2 - l_n, statics.lap_mean_w)
    ) * 100000.0
    losses["lap_scale"] = (
        _lap_wmean(l_s, statics.lap_scale_w) + _lap_wmean(l_sr, statics.lap_scale_w)
    ) * 100000.0
    losses["lap_rgb"] = _lap_wmean(l_r, statics.lap_rgb_w) + _lap_wmean(l_rr, statics.lap_rgb_w)

    losses["hand_rgb_reg"] = (
        L.hand_rgb_reg(human_asset.rgb, buffers.is_rhand, buffers.is_lhand)
        + L.hand_rgb_reg(human_asset_ref.rgb, buffers.is_rhand, buffers.is_lhand)
    ) * 0.01
    losses["arm_rgb_reg"] = (
        L.arm_rgb_reg(hout.mesh_neutral_pose, statics.upper_arm_idx, statics.lower_arm_idx,
                      human_asset.rgb)
        + L.arm_rgb_reg(hout.mesh_neutral_pose, statics.upper_arm_idx, statics.lower_arm_idx,
                        human_asset_ref.rgb)
    ) * 0.1

    losses["joint_offset_reg"] = torch.mean(
        (trainables.human.joint_offset - init_joint_offset) ** 2 * statics.joint_offset_weight)
    losses["joint_offset_sym_reg"] = L.joint_offset_symmetric_reg(
        trainables.human.joint_offset, statics.right_joint_idx, statics.left_joint_idx)
    return outputs()


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of the mean loss terms."""
    return sum(losses.values())
