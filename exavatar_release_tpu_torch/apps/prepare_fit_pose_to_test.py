"""Prepare a trained snapshot for the pose-to-test refit stage (counterpart
of exavatar_release_tpu/apps/prepare_fit_pose_to_test.py; reference
avatar/tools/prepare_fit_pose_to_test.py:17-29: copy the final training
snapshot into the fit_pose_to_test run directory re-stamped as epoch -1 so
the refit run resumes from it at epoch 0). The npz layout is
``train/checkpoint.py``'s, the JAX package's.

    python -m exavatar_release_tpu_torch.apps.prepare_fit_pose_to_test \\
        --src output/model_dump/snapshot_4.npz --dst_dir output_fit/model_dump
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> str:
    """The CLI. Returns the path written."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst_dir", required=True)
    args = ap.parse_args(argv)

    with np.load(args.src) as f:
        data = dict(f)
    data["epoch"] = np.asarray(-1)
    os.makedirs(args.dst_dir, exist_ok=True)
    out = osp.join(args.dst_dir, "snapshot_-1.npz")
    np.savez(out, **data)
    print(f"wrote {out} (epoch re-stamped to -1)")
    return out


if __name__ == "__main__":
    main()
