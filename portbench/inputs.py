"""Everything a cell feeds the program and the reference, drawn from the
seed on the device, in a few large calls each.

The synthetic SMPL-X body is deterministic (the frozen copy of its maker in
``reference/``); the weights, the scene cloud, LPIPS, the face texture, the
training frames and the poses come from one ``torch.Generator`` on the card.
Both sides get the same tensors, each builds what it derives from them
(``build.py``), and neither is handed the other's derived state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

from reference.avatar.config import AvatarConfig
from reference.avatar.human import HumanGaussians
from reference.models.smplx import synthetic_smplx_assets
from reference.ops.lpips import VGG16_PLAN

POSE_FIELDS = ("root_pose", "body_pose", "jaw_pose", "leye_pose", "reye_pose", "lhand_pose",
               "rhand_pose", "expr", "trans")


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & ((1 << 63) - 1))


def avatar_config(cfg: dict, config_cls=AvatarConfig):
    return config_cls(triplane_ch=cfg["triplane_ch"], triplane_res=cfg["triplane_res"],
                      scene_capacity=cfg["scene_capacity"])


def body_assets(cfg: dict, device):
    b = cfg["smplx_body"]
    return synthetic_smplx_assets(rings=b["rings"], segs=b["segs"], num_shape=b["num_shape"],
                                  num_expr=b["num_expr"], device=device)


def human_weights(cfg: dict, assets, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The human heads and triplanes in a trained avatar's range: triplanes
    N(0, 1), linear layers uniform in +-1/sqrt(fan_in) (torch's default range),
    then mm offsets and ~6 mm scales, as a trained avatar has them."""
    shapes = HumanGaussians(avatar_config(cfg), assets.num_shape, assets.num_joints,
                            device="meta").state_dict()
    total = sum(t.numel() for t in shapes.values())
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, t in shapes.items():
        n = t.numel()
        if name.startswith("triplane"):
            w = normal[at:at + n]
        elif ".linears." in name:
            fan_in = shapes[name.rsplit(".", 1)[0] + ".weight"].shape[1]
            w = uniform[at:at + n] / math.sqrt(fan_in)
        elif ".norms." in name:
            w = torch.full((n,), 1.0 if name.endswith("weight") else 0.0, device=device)
        else:  # shape_param, joint_offset
            w = torch.zeros(n, device=device)
        out[name] = w.reshape(t.shape).clone()
        at += n
    for net in ("mean_offset_net", "mean_offset_offset_net"):
        for p in ("weight", "bias"):
            out[f"{net}.linears.0.{p}"].mul_(0.01)
    for net, bias in (("scale_net", math.log(0.006)), ("scale_offset_net", 0.0)):
        out[f"{net}.linears.0.weight"].mul_(0.05)
        out[f"{net}.linears.0.bias"].fill_(bias)
    return out


def poses(n: int, num_expr: int, g: torch.Generator, device, subject_z: float,
          smooth: float = 0.0) -> Dict[str, torch.Tensor]:
    """``n`` poses in camera coordinates about a standing subject at depth
    ``subject_z``: root rotated by pi about x, body and hands N(0, 0.1), jaw
    N(0, 0.05), expression N(0, 0.5), translation N(0, 0.02) about (0, 0.1,
    z). With ``smooth`` in (0, 1) consecutive poses are an AR(1) walk with
    the same spread, so a motion moves smoothly."""
    spec = {"root_pose": (3, 0.05), "body_pose": (63, 0.1), "jaw_pose": (3, 0.05),
            "leye_pose": (3, 0.0), "reye_pose": (3, 0.0), "lhand_pose": (45, 0.1),
            "rhand_pose": (45, 0.1), "expr": (num_expr, 0.5), "trans": (3, 0.02)}
    width = sum(d for d, _ in spec.values())
    z = torch.randn(n, width, generator=g, device=device)
    if smooth > 0.0:
        k = math.sqrt(1.0 - smooth * smooth)
        for i in range(1, n):
            z[i] = smooth * z[i - 1] + k * z[i]
    out, at = {}, 0
    for name, (d, std) in spec.items():
        out[name] = z[:, at:at + d] * std
        at += d
    out["root_pose"] = out["root_pose"] + torch.tensor([math.pi, 0.0, 0.0], device=device)
    out["trans"] = out["trans"] + torch.tensor([0.0, 0.1, subject_z], device=device)
    for name in ("body_pose", "lhand_pose", "rhand_pose"):
        out[name] = out[name].reshape(n, -1, 3)
    return out


def camera_tensors(cfg: dict, device) -> Dict[str, torch.Tensor]:
    H, W = cfg["image"]
    f = float(cfg["focal"])
    return {"R": torch.eye(3, device=device), "t": torch.zeros(3, device=device),
            "focal": torch.tensor([f, f], device=device),
            "princpt": torch.tensor([W / 2.0, H / 2.0], device=device)}


@dataclasses.dataclass
class Inputs:
    cfg: dict
    assets: object  # the synthetic body, fields handed to each side's SMPLXAssets
    human: Dict[str, torch.Tensor]
    camera: Dict[str, torch.Tensor]
    poses: Dict[str, torch.Tensor]  # (n, ...) per field
    scene_xyz: torch.Tensor = None
    scene_rgb: torch.Tensor = None
    lpips: dict = None
    face_texture: torch.Tensor = None
    frame_imgs: torch.Tensor = None  # (F, 3, H, W)
    frame_mask: torch.Tensor = None  # (1, H, W)
    bbox: torch.Tensor = None


def make_inputs(cfg: dict, seed: int, device, what: str) -> Inputs:
    """``what``: "train" (the avatar, the scene, LPIPS, the face texture and
    ``train_frames`` frames with a pose each) or "animate" (the avatar and a
    motion of ``motion_poses`` poses)."""
    g = generator(seed, device)
    assets = body_assets(cfg, device)
    human = human_weights(cfg, assets, g, device)
    H, W = cfg["image"]
    z = float(cfg["subject_z"])
    if what == "animate":
        return Inputs(cfg, assets, human, camera_tensors(cfg, device),
                      poses(cfg["motion_poses"], assets.num_expr, g, device, z, smooth=0.9))
    n_f = cfg["train_frames"]
    inp = Inputs(cfg, assets, human, camera_tensors(cfg, device),
                 poses(n_f, assets.num_expr, g, device, z))
    (x0, x1), (y0, y1), (z0, z1) = cfg["scene_box"]
    n = cfg["scene_live"]
    u = torch.rand(n, 6, generator=g, device=device)
    lo = torch.tensor([x0, y0, z0], device=device)
    hi = torch.tensor([x1, y1, z1], device=device)
    inp.scene_xyz = lo + (hi - lo) * u[:, :3]
    inp.scene_rgb = u[:, 3:].contiguous()
    inp.lpips = lpips_weights(cfg["lpips_net"], g, device)
    tex = cfg["face_texture"]
    inp.face_texture = torch.rand(3, tex, tex, generator=g, device=device)
    inp.frame_imgs = torch.rand(n_f, 3, H, W, generator=g, device=device)
    mask = torch.zeros(1, H, W, device=device)
    mask[:, H // 6: 5 * H // 6, W // 3: 2 * W // 3] = 1.0
    inp.frame_mask = mask
    inp.bbox = torch.tensor([W * 0.33, H * 0.16, W * 0.33, H * 0.68], device=device)
    return inp


def lpips_weights(net: str, g: torch.Generator, device) -> dict:
    """An architecture-correct LPIPS with He-normal convolutions and small
    positive heads (the pretrained file is not in the repository)."""
    if net == "vgg":
        shapes, cin = [], 3
        for ch, n_layers in VGG16_PLAN:
            for _ in range(n_layers):
                shapes.append((ch, cin, 3, 3))
                cin = ch
        taps = [ch for ch, _ in VGG16_PLAN]
    else:
        shapes = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3), (256, 384, 3, 3),
                  (256, 256, 3, 3)]
        taps = [64, 192, 384, 256, 256]
    sizes = [math.prod(s) for s in shapes]
    z = torch.randn(sum(sizes) + sum(taps), generator=g, device=device)
    convs, at = [], 0
    for s, n in zip(shapes, sizes):
        convs.append(z[at:at + n].reshape(s) * (2.0 / (s[1] * s[2] * s[3])) ** 0.5)
        at += n
    heads = []
    for d in taps:
        heads.append(torch.relu(z[at:at + d]) * 0.1 + 0.01)
        at += d
    return {"conv_weights": convs, "conv_biases": [torch.zeros(s[0], device=device) for s in shapes],
            "lin_weights": heads, "net": net}


def pose_list(p: Dict[str, torch.Tensor]) -> List[dict]:
    n = p["trans"].shape[0]
    return [{k: p[k][i] for k in POSE_FIELDS} for i in range(n)]
