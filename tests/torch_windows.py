"""Seeded compositing windows in numpy, shared by the port's CPU tests and
its tests on the card (no JAX here: the GPU machine has none)."""
import numpy as np


def windows(rng, T=2, K=256, tile_shape=(8, 32), nx=2):
    """Random windows (T, 12, K) at a tiling (default: 2 tiles of 8x32, K =
    2 chunks of 128). Opaque Gaussians terminate pixels; tile 1 ends early
    (count < K) with sentinel rows past its count."""
    th, tw = tile_shape
    t = np.arange(T)
    origins = np.stack([(t % nx) * tw, (t // nx) * th], 1).astype(np.float32)
    u = lambda: rng.uniform(size=(T, K))
    sx, sy = 0.7 + 5 * u(), 0.7 + 5 * u()
    rho = 1.6 * u() - 0.8
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    gx = origins[:, :1] - 4 + (tw + 8) * u()
    gy = origins[:, 1:] - 4 + (th + 8) * u()
    log_op = np.log(0.1 + 0.9 * u())
    z = np.zeros((T, K))
    win = np.stack([sy ** 2 / det, -rho * sx * sy / det, sx ** 2 / det, gx, gy, log_op,
                    z, z, u(), u(), u(), 1 + 4 * u()], 1).astype(np.float32)
    counts = np.full(T, K, np.int32)
    counts[1] = K - 77
    win[1, 5, K - 77:] = -1e9
    return win, counts, origins


def ragged(win, counts, chunk):
    """The same rows as a chunk-aligned pair list with slot metadata."""
    T, _, K = win.shape
    nslots = np.maximum(-(-counts // chunk), 1)
    first = np.cumsum(nslots) - nslots
    total = int(nslots.sum())
    NC = total + 1  # one trailing invalid slot
    tid = np.concatenate([np.repeat(np.arange(T), nslots), [T - 1]]).astype(np.int32)
    jc = np.arange(NC)
    valid = jc < total
    flags = ((valid & (jc == first[tid])).astype(np.int32)
             + 2 * (valid & (jc == first[tid] + nslots[tid] - 1))
             + 4 * valid).astype(np.int32)
    rows = np.zeros((12, NC * chunk), np.float32)
    rows[5] = -1e9
    for t in range(T):
        rows[:, first[t] * chunk: first[t] * chunk + counts[t]] = win[t, :, :counts[t]]
    return rows, tid, flags


def chunk_edge_windows(rng, T=4, K=300, tile_shape=(32, 128), nx=2):
    """Windows (T, 12, K) where the stage probes' chunk bookkeeping meets the
    pair bodies' cull. Counts 300, 256, 257 and 290 (the first chunk, one
    256-row staging batch, ends at row 255, the second at the tile's last
    row); each tile's row 255 and last row small Gaussians (sigma 0.5 px) at
    the tile's corner, whose boxes miss every 8 x 8 patch but the first;
    twelve opaque Gaussians (opacity 1, sigmas a quarter of the tile) among
    rows 8-40 over the tile's left half, which end pixels inside the first
    chunk; the other rows of sigma 0.3-2 px and opacity 0.02-1 anywhere on
    the tile, past each count the -1e9 sentinel."""
    th, tw = tile_shape
    t = np.arange(T)
    origins = np.stack([(t % nx) * tw, (t // nx) * th], 1).astype(np.float32)
    u = lambda: rng.uniform(size=(T, K))
    sx, sy = 0.3 + 1.7 * u(), 0.3 + 1.7 * u()
    rho = 1.8 * u() - 0.9
    gx = origins[:, :1] - 4 + (tw + 8) * u()
    gy = origins[:, 1:] - 4 + (th + 8) * u()
    log_op = np.log(0.02 + 0.98 * u())
    opaque = rng.choice(np.arange(8, 41), 12, replace=False)
    sx[:, opaque], sy[:, opaque], rho[:, opaque] = tw / 4, th / 4, 0.0
    gx[:, opaque] = origins[:, :1] + (tw / 2) * u()[:, :12]
    gy[:, opaque] = origins[:, 1:] + th * u()[:, :12]
    log_op[:, opaque] = 0.0
    counts = np.resize(np.asarray([300, 256, 257, 290], np.int32), T)
    counts = np.minimum(counts, K)
    for i in range(T):
        for k in (255, counts[i] - 1):
            sx[i, k] = sy[i, k] = 0.5
            rho[i, k] = 0.0
            gx[i, k], gy[i, k] = origins[i] + 0.25
            log_op[i, k] = np.log(0.9)
    log_op[np.arange(K)[None, :] >= counts[:, None]] = -1e9
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    z = np.zeros((T, K))
    win = np.stack([sy ** 2 / det, -rho * sx * sy / det, sx ** 2 / det, gx, gy, log_op, z, z,
                    u(), u(), u(), 1 + 4 * u()], 1).astype(np.float32)
    return win, counts, origins
