"""Tile compositing: the CUDA kernels' wrappers and their plain PyTorch
versions (counterpart of exavatar_release_tpu/ops/rasterizer/pallas_kernels.py
for ``composite_tiles_fwd_cm`` and ``composite_pairs_fwd_rg``, and of
jax_ref.py).

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor goes
to the kernel (``csrc/composite.cu``), or the wrapper raises. There is no
fallback. Each wrapper counts its launches in ``<wrapper>.launches``.

Layouts are the JAX package's:
  win  (T, 12, K)  depth-sorted rows [A,B,C,gx,gy,log_op,0,0,r,g,b,depth]
                   in global pixel coordinates; sentinel rows log_op = -1e9
  rows (12, Pa)    the same rows as a chunk-aligned pair list; chunk slot j
                   holds rows [j*chunk, (j+1)*chunk) of tile tid[j]; flags[j]
                   bit0 first slot of its tile, bit1 last, bit2 valid
  out  (T, 5, P)   [rgb over bg, depth, mask = 1 - T_final], P = th*tw,
                   pixel i of a tile at (i % tw + ox, i // tw + oy)
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ... import cuda_build

# renderCUDA's compositing constants
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
TERM_EPS = 1e-4


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------


def composite_plain_with_visits(
    win: torch.Tensor, counts: torch.Tensor, origins: torch.Tensor,
    bg: torch.Tensor, tile_shape: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense composite as a sequential scan over each tile's rows
    [0, min(count, K)), all tiles and pixels at once. Returns (out (T,5,P),
    visits (T,P)): visits counts the rows each pixel evaluates before it
    terminates, the trigger included — the work the kernel must do."""
    T, _, K = win.shape
    th, tw = tile_shape
    P = th * tw
    dev = win.device
    i = torch.arange(P, device=dev)
    px = (i % tw).float()[None, :] + origins[:, 0:1].float()  # (T, P)
    py = (i // tw).float()[None, :] + origins[:, 1:2].float()
    n = torch.clamp(counts.long(), max=K)
    acc = torch.zeros(4, T, P, device=dev)
    Tr = torch.ones(T, P, device=dev)
    done = torch.zeros(T, P, dtype=torch.bool, device=dev)
    visits = torch.zeros(T, P, dtype=torch.int64, device=dev)
    for k in range(int(n.max()) if T else 0):
        row = win[:, :, k]  # (T, 12)
        live = (k < n)[:, None]
        visits += live & ~done
        A, B, C = row[:, 0:1], row[:, 1:2], row[:, 2:3]
        dx = px - row[:, 3:4]
        dy = py - row[:, 4:5]
        log_op = row[:, 5:6]
        q = log_op - 0.5 * (A * (dx * dx) + C * (dy * dy)) - B * (dx * dy)
        alpha_un = torch.exp(q)
        valid = (q <= log_op) & (alpha_un >= ALPHA_MIN) & live
        alpha = torch.where(valid, torch.clamp(alpha_un, max=ALPHA_MAX), 0.0)
        # sticky termination, excluding the triggering Gaussian
        done = done | (Tr * (1.0 - alpha) < TERM_EPS)
        alpha = torch.where(done, 0.0, alpha)
        w = alpha * Tr
        acc = acc + w[None] * row[:, 8:12].T[:, :, None]
        Tr = Tr * (1.0 - alpha)
    out = torch.stack(
        [acc[0] + Tr * bg[0], acc[1] + Tr * bg[1], acc[2] + Tr * bg[2], acc[3], 1.0 - Tr],
        dim=1,
    )
    return out, visits


def composite_tiles_fwd_cm_plain(win, counts, origins, bg, tile_shape) -> torch.Tensor:
    """Plain version of ``composite_tiles_fwd_cm``."""
    return composite_plain_with_visits(win, counts, origins, bg, tile_shape)[0]


def ragged_tile_slots(tid: torch.Tensor, flags: torch.Tensor,
                      num_tiles: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each tile's first chunk slot (the slot whose bit0 is set) and its
    number of valid slots (bit2), as int32 (T,) tensors."""
    tid = tid.long()
    valid = (flags & 4) != 0
    first = ((flags & 1) != 0) & valid
    j = torch.arange(tid.shape[0], device=tid.device)
    start = torch.zeros(num_tiles + 1, dtype=torch.int64, device=tid.device)
    start.scatter_(0, torch.where(first, tid, num_tiles), j)
    count = torch.zeros(num_tiles, dtype=torch.int64, device=tid.device)
    count.scatter_add_(0, tid, valid.long())
    return start[:num_tiles].int(), count.int()


def composite_pairs_fwd_rg_plain(rows, tid, flags, bg, oy_off: float, tile_shape,
                                 num_tiles: int, chunk: int, nx: int) -> torch.Tensor:
    """Plain version of ``composite_pairs_fwd_rg``: gathers each tile's slot
    range into a dense window and composites it like the dense version."""
    start, count = ragged_tile_slots(tid, flags, num_tiles)
    width = count.long() * chunk
    k = torch.arange(int(width.max()), device=rows.device)
    idx = torch.where(k[None, :] < width[:, None], start.long()[:, None] * chunk + k[None, :], 0)
    win = rows[:, idx].permute(1, 0, 2)  # (T, 12, kmax)
    th, tw = tile_shape
    t = torch.arange(num_tiles, device=rows.device)
    origins = torch.stack([((t % nx) * tw).float(), ((t // nx) * th).float() + oy_off], dim=1)
    return composite_tiles_fwd_cm_plain(win, width, origins, bg, tile_shape)


# --------------------------------------------------------------------------
# CUDA kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("composite")
    lib.composite_tiles_fwd_cm.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.composite_tiles_fwd_cm.restype = _I
    lib.composite_pairs_fwd_rg.argtypes = [
        _P, _P, _P, _P, ctypes.c_float, _P, _I, ctypes.c_longlong, _I, _I, _I, _I, _P,
    ]
    lib.composite_pairs_fwd_rg.restype = _I
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no compositing kernel for device {x.device}")
    return False


def composite_tiles_fwd_cm(win, counts, origins, bg, tile_shape) -> torch.Tensor:
    """Dense composite. win (T, 12, K) f32, counts (T,) i32, origins (T, 2)
    f32, bg (3,) f32 -> (T, 5, th*tw). Replaces
    pallas_kernels.composite_tiles_fwd_cm (its ``chunk``/``sub`` were TPU
    tiling knobs and do not change the result)."""
    if _on_cpu(win):
        return composite_tiles_fwd_cm_plain(win, counts, origins, bg, tile_shape)
    T, _, K = win.shape
    th, tw = tile_shape
    dev = win.device
    _check("win", win, torch.float32, (T, 12, K), dev)
    _check("counts", counts, torch.int32, (T,), dev)
    _check("origins", origins, torch.float32, (T, 2), dev)
    _check("bg", bg, torch.float32, (3,), dev)
    out = torch.empty(T, 5, th * tw, device=dev)
    if T == 0:
        return out
    with torch.cuda.device(dev):
        rc = _lib().composite_tiles_fwd_cm(
            win.data_ptr(), counts.data_ptr(), origins.data_ptr(), bg.data_ptr(),
            out.data_ptr(), T, K, th, tw, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "composite_tiles_fwd_cm")
    composite_tiles_fwd_cm.launches += 1
    return out


composite_tiles_fwd_cm.launches = 0


def composite_pairs_fwd_rg(rows, tid, flags, bg, oy_off: float, tile_shape,
                           num_tiles: int, chunk: int, nx: int) -> torch.Tensor:
    """Ragged pair-major composite. rows (12, Pa) f32, tid/flags (NC,) i32,
    bg (3,) f32, oy_off the global row of tile row 0 -> (T, 5, th*tw).
    Every tile emits background, also a tile without pairs. Replaces
    pallas_kernels.composite_pairs_fwd_rg."""
    if _on_cpu(rows):
        return composite_pairs_fwd_rg_plain(
            rows, tid, flags, bg, oy_off, tile_shape, num_tiles, chunk, nx
        )
    NC = tid.shape[0]
    th, tw = tile_shape
    dev = rows.device
    _check("rows", rows, torch.float32, (12, NC * chunk), dev)
    _check("tid", tid, torch.int32, (NC,), dev)
    _check("flags", flags, torch.int32, (NC,), dev)
    _check("bg", bg, torch.float32, (3,), dev)
    start, count = ragged_tile_slots(tid, flags, num_tiles)
    out = torch.empty(num_tiles, 5, th * tw, device=dev)
    if num_tiles == 0:
        return out
    with torch.cuda.device(dev):
        rc = _lib().composite_pairs_fwd_rg(
            rows.data_ptr(), start.data_ptr(), count.data_ptr(), bg.data_ptr(),
            float(oy_off), out.data_ptr(), num_tiles, NC * chunk, chunk, th, tw, nx,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "composite_pairs_fwd_rg")
    composite_pairs_fwd_rg.launches += 1
    return out


composite_pairs_fwd_rg.launches = 0
