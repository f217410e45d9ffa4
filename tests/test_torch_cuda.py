"""The port's CUDA compositing kernels on the card: each against its plain
PyTorch version on the same CUDA tensors, the wrappers' input checks, and
their launch counters. Marked ``cuda``; skips where there is no GPU.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with PyTorch alone (tests/conftest.py imports JAX):

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from exavatar_release_tpu_torch.ops.rasterizer import kernels as kn
from torch_windows import ragged, windows

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

pytestmark = pytest.mark.cuda

TILE = (32, 128)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(dev):
    win, counts, origins = windows(np.random.default_rng(11), T=16, K=600, tile_shape=TILE,
                                   nx=4)
    rows, tid, flags = ragged(win, counts, 256)
    bg = np.asarray([1.0, 0.5, 0.25], np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return {k: to(v) for k, v in dict(win=win, counts=counts, origins=origins, rows=rows,
                                      tid=tid, flags=flags, bg=bg).items()}


def test_dense_kernel_equals_plain(scene):
    s = scene
    got = kn.composite_tiles_fwd_cm(s["win"], s["counts"], s["origins"], s["bg"], TILE)
    want = kn.composite_tiles_fwd_cm_plain(s["win"], s["counts"], s["origins"], s["bg"], TILE)
    torch.cuda.synchronize()
    # the kernel rounds every operation as the plain version does (-fmad=false)
    assert torch.equal(got, want)


def test_ragged_kernel_equals_plain_and_dense(scene):
    s = scene
    args = (s["rows"], s["tid"], s["flags"], s["bg"], 0.0, TILE, 16, 256, 4)
    got = kn.composite_pairs_fwd_rg(*args)
    assert torch.equal(got, kn.composite_pairs_fwd_rg_plain(*args))
    dense = kn.composite_tiles_fwd_cm(s["win"], s["counts"], s["origins"], s["bg"], TILE)
    assert torch.equal(got, dense)


def test_launch_counters(scene):
    s = scene
    n1, n2 = kn.composite_tiles_fwd_cm.launches, kn.composite_pairs_fwd_rg.launches
    kn.composite_tiles_fwd_cm(s["win"], s["counts"], s["origins"], s["bg"], TILE)
    kn.composite_tiles_fwd_cm_plain(s["win"], s["counts"], s["origins"], s["bg"], TILE)
    kn.composite_pairs_fwd_rg(s["rows"], s["tid"], s["flags"], s["bg"], 0.0, TILE, 16, 256, 4)
    assert kn.composite_tiles_fwd_cm.launches == n1 + 1
    assert kn.composite_pairs_fwd_rg.launches == n2 + 1


@pytest.mark.parametrize("bad", ["dtype", "strided", "shape", "device"])
def test_wrapper_rejects(scene, bad):
    s = dict(scene)
    if bad == "dtype":
        s["win"] = s["win"].double()
    elif bad == "strided":
        s["win"] = s["win"].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "shape":
        s["origins"] = s["origins"][:, :1].contiguous()
    else:
        s["counts"] = s["counts"].cpu()
    with pytest.raises((TypeError, ValueError)):
        kn.composite_tiles_fwd_cm(s["win"], s["counts"], s["origins"], s["bg"], TILE)
