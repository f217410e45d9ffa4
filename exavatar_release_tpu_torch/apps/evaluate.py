"""Quantitative evaluation (counterpart of exavatar_release_tpu/apps/evaluate.py;
reference avatar/tools/eval_neuman.py:27-65): PSNR / SSIM / LPIPS(alex) over
the test split, background masked by default, against the composed
scene+human render. Prints the means as one JSON line (and writes them to
``--out_json`` when given).

    python -m exavatar_release_tpu_torch.apps.evaluate --subject_root ... --ckpt ...
        [--no_mask_bkg] [--lpips_weights <npz>] [--out_json <path>] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    from ..ops.image_metrics import psnr, ssim_map
    from ..ops.lpips import lpips_distance
    from .common import add_common_args, resolve_lpips, settings_from_args
    from .test import load_for_render, render_test_frame

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--no_mask_bkg", action="store_true")
    ap.add_argument("--lpips_weights", default=None)
    ap.add_argument("--out_json", default=None)
    args = ap.parse_args(argv)

    cfg, subject, bundle, state, frame_row_of = load_for_render(args, "test")
    dev = torch.device(args.device)
    lpips_p = resolve_lpips(args.lpips_weights, "alex", device=dev)
    settings = settings_from_args(args)

    scores = {"psnr": [], "ssim": [], "lpips": []}
    for frame_idx in sorted(set(subject.frame_ids)):
        frame, out = render_test_frame(cfg, subject, bundle, state, frame_row_of, frame_idx,
                                       settings, dev)
        pred = out.renders["scene_human_img_refined_composed"].permute(2, 0, 1)
        gt = frame.img
        mask2d = None
        if not args.no_mask_bkg:
            pred, gt, mask2d = pred * frame.mask, gt * frame.mask, frame.mask[0]
        with torch.no_grad():
            scores["psnr"].append(float(psnr(pred, gt, mask=mask2d)))
            scores["ssim"].append(float(torch.mean(ssim_map(pred, gt))))
            scores["lpips"].append(float(lpips_distance(lpips_p, pred * 2 - 1, gt * 2 - 1)))
        print(f"frame {frame_idx}: psnr={scores['psnr'][-1]:.2f}")

    result = {k: float(np.mean(v)) for k, v in scores.items()}
    print(json.dumps(result))
    if args.out_json is not None:
        with open(args.out_json, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
