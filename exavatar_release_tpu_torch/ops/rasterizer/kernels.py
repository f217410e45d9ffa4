"""Tile compositing: the CUDA kernels' wrappers and their plain PyTorch
versions (counterpart of exavatar_release_tpu/ops/rasterizer/pallas_kernels.py
for ``composite_tiles_fwd_cm`` / ``composite_tiles_bwd_cm`` and
``composite_pairs_fwd_rg`` / ``composite_pairs_bwd_rg``, and of jax_ref.py).

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor goes
to the kernel (``csrc/composite.cu``, ``csrc/composite_bwd.cu``), or the
wrapper raises. There is no fallback. Each wrapper counts its launches in
``<wrapper>.launches``.

The backward functions return the cotangent of the rows from the saved
output ``full`` and its cotangent ``g_full``, with renderCUDA's rule
d alpha / d q = exp(q) also where alpha was clamped to 0.99:
  dwin  (T, 12, K)  rows [dA,dB,dC,dgx,dgy,dlog_op,0,0,dr,dg,db,ddepth]
  drows (12, Pa)    the same per pair slot; padding and invalid slots zero

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
from typing import NamedTuple, Tuple

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


def _ragged_as_dense(rows, tid, flags, oy_off: float, tile_shape, num_tiles: int, chunk: int,
                     nx: int):
    """Each tile's slot range gathered into a dense window: (win (T, 12,
    kmax), width (T,), origins (T, 2), idx (T, kmax) pair slots, 0 past the
    width)."""
    start, count = ragged_tile_slots(tid, flags, num_tiles)
    width = count.long() * chunk
    k = torch.arange(int(width.max()) if num_tiles else 0, device=rows.device)
    idx = torch.where(k[None, :] < width[:, None], start.long()[:, None] * chunk + k[None, :], 0)
    win = rows[:, idx].permute(1, 0, 2)  # (T, 12, kmax)
    th, tw = tile_shape
    t = torch.arange(num_tiles, device=rows.device)
    origins = torch.stack([((t % nx) * tw).float(), ((t // nx) * th).float() + oy_off], dim=1)
    return win, width, origins, idx


def composite_pairs_fwd_rg_plain(rows, tid, flags, bg, oy_off: float, tile_shape,
                                 num_tiles: int, chunk: int, nx: int) -> torch.Tensor:
    """Plain version of ``composite_pairs_fwd_rg``: gathers each tile's slot
    range into a dense window and composites it like the dense version."""
    win, width, origins, _ = _ragged_as_dense(rows, tid, flags, oy_off, tile_shape, num_tiles,
                                              chunk, nx)
    return composite_tiles_fwd_cm_plain(win, width, origins, bg, tile_shape)


class BackwardStats(NamedTuple):
    """Work counts of one backward replay, for the kernels' bound."""

    visits: int  # rows evaluated per pixel before termination, trigger included
    hits: int  # (pixel, row) pairs that contribute a gradient


def composite_bwd_plain_with_stats(
    win: torch.Tensor, counts: torch.Tensor, origins: torch.Tensor, bg: torch.Tensor,
    full: torch.Tensor, g_full: torch.Tensor, tile_shape: Tuple[int, int],
) -> Tuple[torch.Tensor, BackwardStats]:
    """Dense backward as an explicit replay of the forward scan, all tiles
    and pixels at once. Per pixel, with g_acc = g_full[0:4], tfinal =
    1 - full[4], g_tf = bg . g_full[0:3] - g_full[4] and A_p = g_acc . accum +
    g_tf tfinal: every live row i with weight w_i = alpha_i T_i gets
      cg_i = g_acc . color_i,  P_i = sum_{j<=i} w_j cg_j,
      dalpha_i = T_i cg_i - (A_p - P_i) / (1 - alpha_i),  dq_i = dalpha_i exp(q_i),
    and the row's gradient is the sum over the tile's pixels of dq_i times
    dq/d(row) and of w_i g_acc for the colors. Returns (dwin, stats)."""
    T, _, K = win.shape
    th, tw = tile_shape
    P = th * tw
    dev = win.device
    i = torch.arange(P, device=dev)
    px = (i % tw).float()[None, :] + origins[:, 0:1].float()  # (T, P)
    py = (i // tw).float()[None, :] + origins[:, 1:2].float()
    n = torch.clamp(counts.long(), max=K)
    tfinal = 1.0 - full[:, 4]
    g_acc = [g_full[:, c] for c in range(4)]
    g_tf = bg[0] * g_full[:, 0] + bg[1] * g_full[:, 1] + bg[2] * g_full[:, 2] - g_full[:, 4]
    A_p = (g_acc[0] * (full[:, 0] - bg[0] * tfinal) + g_acc[1] * (full[:, 1] - bg[1] * tfinal)
           + g_acc[2] * (full[:, 2] - bg[2] * tfinal) + g_acc[3] * full[:, 3] + g_tf * tfinal)
    Tr = torch.ones(T, P, device=dev)
    Pr = torch.zeros(T, P, device=dev)
    done = torch.zeros(T, P, dtype=torch.bool, device=dev)
    visits = torch.zeros((), dtype=torch.int64, device=dev)
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    dwin = torch.zeros(T, 12, K, device=dev)
    for k in range(int(n.max()) if T else 0):
        row = win[:, :, k]  # (T, 12)
        live = (k < n)[:, None]
        visits += (live & ~done).sum()
        A, B, C = row[:, 0:1], row[:, 1:2], row[:, 2:3]
        dx = px - row[:, 3:4]
        dy = py - row[:, 4:5]
        log_op = row[:, 5:6]
        q = log_op - 0.5 * (A * (dx * dx) + C * (dy * dy)) - B * (dx * dy)
        alpha_un = torch.exp(q)
        valid = (q <= log_op) & (alpha_un >= ALPHA_MIN) & live
        alpha = torch.where(valid, torch.clamp(alpha_un, max=ALPHA_MAX), 0.0)
        done = done | (Tr * (1.0 - alpha) < TERM_EPS)
        hit = valid & ~done
        hits += hit.sum()
        alpha = torch.where(done, 0.0, alpha)
        w = alpha * Tr
        cg = (g_acc[0] * row[:, 8:9] + g_acc[1] * row[:, 9:10] + g_acc[2] * row[:, 10:11]
              + g_acc[3] * row[:, 11:12])
        Pr = Pr + w * cg
        dalpha = Tr * cg - (A_p - Pr) / (1.0 - alpha)
        dq = torch.where(hit, dalpha * alpha_un, 0.0)  # unclamped d alpha / d q
        dwin[:, 0, k] = (-0.5 * (dx * dx) * dq).sum(1)
        dwin[:, 1, k] = (-(dx * dy) * dq).sum(1)
        dwin[:, 2, k] = (-0.5 * (dy * dy) * dq).sum(1)
        dwin[:, 3, k] = ((A * dx + B * dy) * dq).sum(1)
        dwin[:, 4, k] = ((B * dx + C * dy) * dq).sum(1)
        dwin[:, 5, k] = dq.sum(1)
        for c in range(4):
            dwin[:, 8 + c, k] = (w * g_acc[c]).sum(1)
        Tr = Tr * (1.0 - alpha)
    return dwin, BackwardStats(int(visits), int(hits))


def composite_tiles_bwd_cm_plain(win, counts, origins, bg, full, g_full,
                                 tile_shape) -> torch.Tensor:
    """Plain version of ``composite_tiles_bwd_cm``."""
    return composite_bwd_plain_with_stats(win, counts, origins, bg, full, g_full, tile_shape)[0]


def composite_pairs_bwd_rg_plain(rows, tid, flags, bg, oy_off: float, full, g_full, tile_shape,
                                 num_tiles: int, chunk: int, nx: int) -> torch.Tensor:
    """Plain version of ``composite_pairs_bwd_rg``: the dense replay on each
    tile's gathered slot range, scattered back to the pair slots."""
    win, width, origins, idx = _ragged_as_dense(rows, tid, flags, oy_off, tile_shape, num_tiles,
                                                chunk, nx)
    dwin = composite_tiles_bwd_cm_plain(win, width, origins, bg, full, g_full, tile_shape)
    inside = torch.arange(idx.shape[1], device=rows.device)[None, :] < width[:, None]
    drows = torch.zeros_like(rows)
    drows[:, idx[inside]] = dwin.permute(1, 0, 2)[:, inside]
    return drows


def bwd_row_errors(got: torch.Tensor, want: torch.Tensor,
                   row_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A backward output against a reference, row by row: (max |got - want|,
    max |want|), each (12,). The rows carry different units (dA, dB and dC
    scale with squared pixel distances, dlog_op and the colors with none), so
    a difference is judged against its own row's largest value, never
    against the whole tensor's: that would hide a wrong color row behind the
    conic rows."""
    other = [d for d in range(want.dim()) if d != row_dim % want.dim()]
    return (got - want).abs().amax(other), want.abs().amax(other)


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


def _lib_bwd() -> ctypes.CDLL:
    lib = cuda_build.load("composite_bwd")
    lib.composite_tiles_bwd_cm.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.composite_tiles_bwd_cm.restype = _I
    lib.composite_pairs_bwd_rg.argtypes = [
        _P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _I, ctypes.c_longlong, _I, _I, _I, _I, _P,
    ]
    lib.composite_pairs_bwd_rg.restype = _I
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


def composite_tiles_bwd_cm(win, counts, origins, bg, full, g_full, tile_shape) -> torch.Tensor:
    """Backward of the dense composite w.r.t. ``win``. full, g_full (T, 5,
    th*tw) f32: the forward's output and its cotangent -> dwin (T, 12, K).
    Replaces pallas_kernels.composite_tiles_bwd_cm."""
    if _on_cpu(win):
        return composite_tiles_bwd_cm_plain(win, counts, origins, bg, full, g_full, tile_shape)
    T, _, K = win.shape
    th, tw = tile_shape
    dev = win.device
    _check("win", win, torch.float32, (T, 12, K), dev)
    _check("counts", counts, torch.int32, (T,), dev)
    _check("origins", origins, torch.float32, (T, 2), dev)
    _check("bg", bg, torch.float32, (3,), dev)
    _check("full", full, torch.float32, (T, 5, th * tw), dev)
    _check("g_full", g_full, torch.float32, (T, 5, th * tw), dev)
    # the kernel adds its blocks' partial sums into dwin with atomics
    dwin = torch.zeros(T, 12, K, device=dev)
    if T == 0 or K == 0:
        return dwin
    with torch.cuda.device(dev):
        rc = _lib_bwd().composite_tiles_bwd_cm(
            win.data_ptr(), counts.data_ptr(), origins.data_ptr(), bg.data_ptr(),
            full.data_ptr(), g_full.data_ptr(), dwin.data_ptr(), T, K, th, tw,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "composite_tiles_bwd_cm")
    composite_tiles_bwd_cm.launches += 1
    return dwin


composite_tiles_bwd_cm.launches = 0


def composite_pairs_bwd_rg(rows, tid, flags, bg, oy_off: float, full, g_full, tile_shape,
                           num_tiles: int, chunk: int, nx: int) -> torch.Tensor:
    """Backward of the ragged composite w.r.t. ``rows`` -> drows (12, Pa);
    sentinel rows and slots without the valid bit get exact zeros. Replaces
    pallas_kernels.composite_pairs_bwd_rg."""
    if _on_cpu(rows):
        return composite_pairs_bwd_rg_plain(
            rows, tid, flags, bg, oy_off, full, g_full, tile_shape, num_tiles, chunk, nx
        )
    NC = tid.shape[0]
    th, tw = tile_shape
    dev = rows.device
    _check("rows", rows, torch.float32, (12, NC * chunk), dev)
    _check("tid", tid, torch.int32, (NC,), dev)
    _check("flags", flags, torch.int32, (NC,), dev)
    _check("bg", bg, torch.float32, (3,), dev)
    _check("full", full, torch.float32, (num_tiles, 5, th * tw), dev)
    _check("g_full", g_full, torch.float32, (num_tiles, 5, th * tw), dev)
    start, count = ragged_tile_slots(tid, flags, num_tiles)
    drows = torch.zeros_like(rows)
    if num_tiles == 0 or NC == 0:
        return drows
    with torch.cuda.device(dev):
        rc = _lib_bwd().composite_pairs_bwd_rg(
            rows.data_ptr(), start.data_ptr(), count.data_ptr(), bg.data_ptr(), float(oy_off),
            full.data_ptr(), g_full.data_ptr(), drows.data_ptr(), num_tiles, NC * chunk, chunk,
            th, tw, nx, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "composite_pairs_bwd_rg")
    composite_pairs_bwd_rg.launches += 1
    return drows


composite_pairs_bwd_rg.launches = 0
