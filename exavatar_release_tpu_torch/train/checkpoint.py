"""Checkpoints: snapshots of the train state as one npz file (counterpart of
exavatar_release_tpu/train/checkpoint.py).

The file has the JAX package's layout: ``leaf_0 .. leaf_{n-1}`` in the order
``jax.tree_util.tree_flatten`` gives for its ``TrainState``
(``avatar.convert.TRAIN_STATE_LEAVES`` names them), ``num_leaves`` and
``epoch``; Linear weights are stored (C_in, C_out) and layers without a
GroupNorm hold zero-size placeholders, as there. A snapshot written by
either package loads in the other. Because the scene lives in a fixed-capacity
buffer, a restored state has the shapes it was saved with.
"""
from __future__ import annotations

import glob
import os
import os.path as osp
import re
from typing import Optional, Tuple

import numpy as np

from ..avatar.config import AvatarConfig
from ..avatar.convert import TRAIN_STATE_LEAVES, train_state_from_jax, train_state_to_numpy
from .loop import TrainState


def save_checkpoint(directory: str, state: TrainState, epoch: int) -> str:
    """Save ``state`` as ``snapshot_{epoch}.npz`` (one file, atomic rename)."""
    os.makedirs(directory, exist_ok=True)
    leaves = train_state_to_numpy(state)
    payload = {f"leaf_{i}": leaves[k] for i, k in enumerate(TRAIN_STATE_LEAVES)}
    payload["num_leaves"] = np.asarray(len(TRAIN_STATE_LEAVES))
    payload["epoch"] = np.asarray(epoch)
    path = osp.join(directory, f"snapshot_{epoch}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """The snapshot with the largest epoch, or None."""
    files = glob.glob(osp.join(directory, "snapshot_*.npz"))
    if not files:
        return None

    def ep(f):
        m = re.search(r"snapshot_(-?\d+)\.npz$", f)
        return int(m.group(1)) if m else -1

    return max(files, key=ep)


def load_checkpoint(path: str, cfg: AvatarConfig, device="cuda") -> Tuple[TrainState, int]:
    """Restore (state, epoch) onto ``device``. ``cfg`` gives the human
    module's widths; every shape comes from the file."""
    with np.load(path) as data:
        n = int(data["num_leaves"])
        if n != len(TRAIN_STATE_LEAVES):
            raise ValueError(f"{path}: {n} leaves, expected {len(TRAIN_STATE_LEAVES)}")
        leaves = [data[f"leaf_{i}"] for i in range(n)]
        epoch = int(data["epoch"])
    return train_state_from_jax(leaves, cfg, device), epoch
