// Backward tile compositing kernels for Hopper (sm_90a): the gradient of the
// 3DGS rasterizer's front-to-back alpha blend with respect to the
// depth-sorted rows.
//
// Replaces four Pallas TPU kernels of
// exavatar_release_tpu/ops/rasterizer/pallas_kernels.py:
//   composite_tiles_bwd_cm   (dense (T, 12, K) windows   -> dwin  (T, 12, K))
//   composite_pairs_bwd_rg   (ragged (12, Pa) pair list  -> drows (12, Pa))
//   composite_tiles_bwd_v2   (kernel_v=2 packed (T, K, 8) rows and (T, K, 4)
//                             colors -> dquad (T, K, 8), dcolor (T, K, 4))
//   composite_tiles_bwd      (global conic (T, K, 8) rows with tile origins
//                             -> dquad, dcolor; without origins, packed
//                             rows: kernel_v=2's body)
// Conic output rows are [dA, dB, dC, dgx, dgy, dlog_op, 0, 0, dr, dg, db,
// ddepth] (row-major: dquad [dA..dlog_op, 0, 0] and dcolor [dr, dg, db,
// ddepth]); packed ones [dc0..dc5, 0, 0] and [dr, dg, db, ddepth].
//
// What is computed. Per pixel, from the forward's saved output and its
// cotangent: for conic rows `full` and `g_full`,
//   tfinal = 1 - full[4];  g_acc = g_full[0:4];
//   g_tf = bg . g_full[0:3] - g_full[4];  accum_rgb = full[0:3] - bg tfinal;
//   A_p = g_acc . accum + g_tf tfinal;
// for row-major rows A_p = g_accum . accum + g_tfinal tfinal from the two
// cotangents and the forward's own accum and tfinal.
// The forward is replayed front to back with the forward kernel's own rules
// and arithmetic: both go through composite_common.cuh (the direct conic
// or the packed q, the 1/255 floor, the 0.99 clamp, sticky termination at T
// (1 - alpha) < 1e-4 that excludes the Gaussian that triggers it). Every
// Gaussian i that contributed with weight w_i = alpha_i T_i gets
//   cg_i = g_acc . color_i;   P_i = sum_{j<=i} w_j cg_j   (inclusive prefix)
//   dalpha_i = T_i cg_i - (A_p - P_i) / (1 - alpha_i)
//   dq_i = dalpha_i exp(q_i)        (renderCUDA's rule: unclamped, also
//                                    where alpha was clamped to 0.99)
// and, summed over the tile's pixels, dcolor_i = sum w_i g_acc and the
// gradient of q: for conic rows q = log_op - 0.5 (A dx^2 + C dy^2) - B dx dy,
//   dA = -0.5 dx^2 dq, dB = -dx dy dq, dC = -0.5 dy^2 dq,
//   dgx = (A dx + B dy) dq, dgy = (B dx + C dy) dq, dlog_op = dq;
// for packed rows the tile-local basis [dq, dq lx, dq ly, dq lx^2, dq lx ly,
// dq ly^2] (log_op reaches them through c0 only: lanes 6 and 7 stay zero).
// No per-Gaussian transmittance is stored: A_p - P_i is what lies behind
// Gaussian i, so the replay runs in the forward's order and ends where the
// forward ended. 1 - alpha >= 0.01 by the clamp, so the division is safe.
// The TPU kernels reach the conic gradient through a pixel-basis matmul and
// a de-localisation; that was a device for the TPU's matrix unit.
//
// Design, one body (composite_pairs_range_bwd) for the four kernels,
// templated on the row kind as the forward's: the dense kernel hands it a
// tile's window (stride K, begin 0, n = min(count, K), the tile's dwin as
// output), the pair-major kernel the tile's slot range of the pair list, the
// row-major kernels a tile's rows (packed at origin (0, 0), or global conic
// rows at the tile's origin) and its dquad and dcolor. The
// reduction over pixels has three levels: a warp sums its
// pixels' ten gradient values with __shfl_down_sync, and only for rows that
// some pixel of the warp hits (one ballot per row otherwise); lane 0 adds
// the warp's sum into the batch's accumulators in shared memory; after the
// batch the block adds its nonzero accumulators into the output with
// atomicAdd, where the tile's other blocks add theirs. The output must
// arrive zeroed. Atomics make the order of summation differ from run to
// run: the result agrees with the plain PyTorch version within float32
// summation error, not bit for bit.
// The time went to the reduction over pixels (half of it in the
// one-pixel-a-thread design this body replaced, as the stage probes measured
// it; PERF.md): not to the instruction count of one reduction but to their
// number, one ballot, a five-deep shuffle chain and a shared atomic per
// (warp, row) hit. So the body
// reduces few times, with the forward's schedule (composite.cu): a thread
// owns R = kPairsR = 2 pixels of a compact warp patch and first adds its
// two pixels' ten values in registers, so one warp reduction serves 64
// pixels and 8 blocks of a 32x128 tile add each row into device memory;
// rows whose pixel box misses the warp's patch are skipped before any exp,
// and the exp gate skips the rest of the far ones without an expf. Both are
// exact: the replay takes the forward's decisions.
//
// Bound: ~13 f32 operations per (pixel, Gaussian) visit plus ~37 per visit
// that contributes, against 40 bytes per live row read (48 row-major), 40 per
// pixel read (full, g_full; accum, tfinal and their cotangents) and 40 (48)
// per live row written: bound by operations at the avatar's shapes (PERF.md
// holds the bound and the measured times).
//
// The stage probes of kernel 6 (composite_tiles_bwd_variant_kernel<V>,
// replacing the Pallas kernel of tools/kvariants.py build_bwd) launch kernel
// 6's grid on this body under a variant V: `if constexpr` hooks that stub or
// reformulate one stage, described in composite_probes.cuh.
//
// Build with -fmad=false and without fast math, like composite.cu: the
// replay must take the forward's skip and termination decisions, which sit
// on thresholds that see last bits.

#include "composite_probes.cuh"

namespace {

using namespace composite;

// Gradient of rows [begin, begin + n) of a row table from the pixels of one
// tile, kPairsR pixels a thread (pair_pixels, blk the block's index within
// the tile). kConicCM: a channel-major table (stride), full_tile and
// gfull_tile (5, P), drows in the table's layout. Row-major kinds: a tile's
// rows (rows = quad (K, 8), color (K, 4), begin 0; packed rows at origin (0,
// 0)), full_tile = accum (P, 4), gfull_tile = g_accum (P, 4), tf_tile =
// tfinal (P,), gtf_tile = g_tfinal (P,), drows = dquad (K, 8), dcolor (K, 4).
// V: a stage probe's variant (composite_probes.cuh), on global conic
// row-major rows only; at kBase every hook below folds away.
template <RowKind KIND, int V = kBase>
__device__ __forceinline__ void composite_pairs_range_bwd(
    const float* __restrict__ rows, const float* __restrict__ color, long long stride, int blk,
    long long begin, int n, float ox, float oy, int th, int tw, const float* __restrict__ bg,
    const float* __restrict__ full_tile, const float* __restrict__ gfull_tile,
    const float* __restrict__ tf_tile, const float* __restrict__ gtf_tile,
    float* __restrict__ drows, float* __restrict__ dcolor) {
  constexpr int R = kPairsR;
  constexpr bool PACKED = packed_q(KIND);
  constexpr bool RM = row_major(KIND);
  static_assert(V == kBase || KIND == RowKind::kConicRM,
                "the stage probes run on global conic row-major rows");
  constexpr bool PIPE = V == kPipe;
  constexpr bool CHUNKED = kChunked<V>;
  constexpr bool STUB = V == kNoExp;
  constexpr bool LOG = kLogT<V>;
  // pipe: the batch that replays and the next one
  __shared__ RowsOf<KIND> s_buf[PIPE ? 2 : 1];
  __shared__ float acc[kChannels][kBlock];
  // the warp's patch bounds, read with each row's box: kept in registers
  // they took the kernel to 72 registers and 3 blocks an SM
  __shared__ float4 patch[kWarps];
  const int P = th * tw;
  const int lane = threadIdx.x & 31;
  const PairPixels pp = pair_pixels(blk, tw, ox, oy);
  if (lane == 0) patch[threadIdx.x >> 5] = pp.patch;  // read after the first barrier
  const float px = (float)pp.x + ox;
  float py[R];
#pragma unroll
  for (int r = 0; r < R; ++r) py[r] = (float)(pp.y + r) + oy;
  // packed rows: each pixel's basis lx^2, lx ly, ly^2
  float xx = 0.0f, xy[R], yy[R];
  if constexpr (PACKED) {
    xx = px * px;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      xy[r] = px * py[r];
      yy[r] = py[r] * py[r];
    }
  }

  // T: logsp its log; the chunk forms T0, prefix and done at the chunk's start
  bool done[R];
  float g0[R], g1[R], g2[R], g3[R], A_p[R], T[R], prefix[R];
  bool all_done = true;
  float bg0 = 0.0f, bg1 = 0.0f, bg2 = 0.0f;
  if constexpr (!RM) {
    bg0 = bg[0];
    bg1 = bg[1];
    bg2 = bg[2];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int x = pp.x, y = pp.y + r;
    done[r] = x >= tw || y >= th;
    all_done = all_done && done[r];
    T[r] = LOG ? 0.0f : 1.0f;
    prefix[r] = 0.0f;
    g0[r] = g1[r] = g2[r] = g3[r] = A_p[r] = 0.0f;
    if (done[r]) continue;
    const int i = y * tw + x;
    if constexpr (RM) {
      // the order of the plain version and of the TPU kernel's prologue
      const float4 g = reinterpret_cast<const float4*>(gfull_tile)[i];
      const float4 a = reinterpret_cast<const float4*>(full_tile)[i];
      g0[r] = g.x;
      g1[r] = g.y;
      g2[r] = g.z;
      g3[r] = g.w;
      A_p[r] = g.x * a.x + g.y * a.y + g.z * a.z + g.w * a.w + gtf_tile[i] * tf_tile[i];
    } else {
      const float f0 = full_tile[0 * P + i], f1 = full_tile[1 * P + i];
      const float f2 = full_tile[2 * P + i], f3 = full_tile[3 * P + i];
      const float tfinal = 1.0f - full_tile[4 * P + i];
      g0[r] = gfull_tile[0 * P + i];
      g1[r] = gfull_tile[1 * P + i];
      g2[r] = gfull_tile[2 * P + i];
      g3[r] = gfull_tile[3 * P + i];
      const float g_tf = bg0 * g0[r] + bg1 * g1[r] + bg2 * g2[r] - gfull_tile[4 * P + i];
      A_p[r] = g0[r] * (f0 - bg0 * tfinal) + g1[r] * (f1 - bg1 * tfinal) +
               g2[r] * (f2 - bg2 * tfinal) + g3[r] * f3 + g_tf * tfinal;
    }
  }

  [[maybe_unused]] float sink = 0.0f;  // nograd: keeps the replay's results alive
  [[maybe_unused]] ConicRowRegs next;  // pipe: this thread's row of the next batch
  if constexpr (PIPE) {
    stage_rows<KIND>(s_buf[0], rows, color, stride, begin, threadIdx.x, n, th, tw);
#pragma unroll
    for (int c = 0; c < kChannels; ++c) acc[c][threadIdx.x] = 0.0f;
  }
  for (int b = 0, buf = 0; b < n; b += kBlock, buf ^= 1) {
    RowsOf<KIND>& s = s_buf[PIPE ? buf : 0];
    // barrier before overwriting the batch; also the block's exit test
    if (__syncthreads_count(all_done) == kBlock) break;
    const int k = b + threadIdx.x;
    if constexpr (PIPE) {
      load_conic_rm_row(next, rows, color, k + kBlock, n);
    } else {
      stage_rows<KIND>(s, rows, color, stride, begin, k, n, th, tw);
#pragma unroll
      for (int c = 0; c < kChannels; ++c) acc[c][threadIdx.x] = 0.0f;
      __syncthreads();
    }
    const int m = min(kBlock, n - b);
    // the chunk forms: the chunk's sums of wlog (all, and of the rows not
    // dead) and its prefix carry (nomm: the last row's w cg); the dead of
    // the last row a pixel evaluated, and whether that row ends the chunk
    [[maybe_unused]] float cum[R], kept[R], carry[R];
    [[maybe_unused]] bool dead[R], last[R];
    if constexpr (CHUNKED) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        cum[r] = kept[r] = carry[r] = 0.0f;
        dead[r] = last[r] = false;
      }
    }
    for (int j = 0; j < m; ++j) {
      // the chunk forms: all_done stays the chunk start's
      if (__all_sync(kFullWarp, all_done)) break;
      // warp-uniform: every lane reads the same box and patch
      if (misses(s.box[j], patch[threadIdx.x >> 5])) continue;
      const float4 g = s.lo[j];
      const auto h = s.hi[j];
      const float4 col = s.col[j];
      float v[kChannels];
#pragma unroll
      for (int c = 0; c < kChannels; ++c) v[c] = 0.0f;
      bool hit = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (done[r]) continue;
        float dx, dy, alpha_un, w, dq;
        if constexpr (CHUNKED) {
          const float q = conic_q(g.x, g.y, g.z, g.w, h.x, h.y, px, py[r], dx, dy);
          if (q < kQGate) continue;
          alpha_un = exp_v<STUB>(q);
          if (!(q <= h.y && alpha_un >= kAlphaMin)) continue;
          const float alpha = clamped(alpha_un);
          const float wlog = log1p_v<STUB>(-alpha);
          const float T_raw = exp_v<STUB>(V == kNoMM ? wlog : cum[r]) * T[r];
          dead[r] = ends_pixel(T_raw * (1.0f - alpha));
          last[r] = j == m - 1;
          cum[r] = cum[r] + wlog;
          if (dead[r]) continue;
          hit = true;
          w = alpha * T_raw;
          const float cg = g0[r] * col.x + g1[r] * col.y + g2[r] * col.z + g3[r] * col.w;
          float P_incl;
          if constexpr (V == kNoMM) {
            P_incl = prefix[r] + w * cg;
            if (j == m - 1) carry[r] = w * cg;
          } else {
            carry[r] = carry[r] + w * cg;
            P_incl = prefix[r] + carry[r];
          }
          dq = (T_raw * cg - (A_p[r] - P_incl) / (1.0f - alpha)) * alpha_un;
          kept[r] = kept[r] + wlog;
        } else {
          if constexpr (PACKED) {
            if (!reaches_packed_gated(g, h, px, py[r], xx, xy[r], yy[r], alpha_un)) continue;
          } else {
            if (!reaches_gated(g.x, g.y, g.z, g.w, h.x, h.y, px, py[r], dx, dy, alpha_un))
              continue;
          }
          const float alpha = clamped(alpha_un);
          const float one_m = 1.0f - alpha;
          const float test_T = LOG ? T[r] + log1pf(-alpha) : T[r] * one_m;
          if (LOG ? test_T < kLnTermEps : ends_pixel(test_T)) {
            done[r] = true;
            continue;
          }
          hit = true;
          const float T_c = LOG ? expf(T[r]) : T[r];
          w = alpha * T_c;
          const float cg = g0[r] * col.x + g1[r] * col.y + g2[r] * col.z + g3[r] * col.w;
          prefix[r] = prefix[r] + w * cg;
          const float dalpha = T_c * cg - (A_p[r] - prefix[r]) / one_m;
          dq = dalpha * alpha_un;
          T[r] = test_T;
        }
        if constexpr (V == kNoGrad) {
          sink = sink + dq + w;
        } else {
          if constexpr (PACKED) {
            v[0] += dq;
            v[1] += dq * px;
            v[2] += dq * py[r];
            v[3] += dq * xx;
            v[4] += dq * xy[r];
            v[5] += dq * yy[r];
          } else if constexpr (V == kNoDeloc) {
            // the packed basis at the tile-local pixel
            const float lx = (float)pp.x, ly = (float)(pp.y + r);
            v[0] += dq;
            v[1] += dq * lx;
            v[2] += dq * ly;
            v[3] += dq * (lx * lx);
            v[4] += dq * (lx * ly);
            v[5] += dq * (ly * ly);
          } else {
            v[0] += -0.5f * (dx * dx) * dq;
            v[1] += -(dx * dy) * dq;
            v[2] += -0.5f * (dy * dy) * dq;
            v[3] += (g.x * dx + g.y * dy) * dq;
            v[4] += (g.y * dx + g.z * dy) * dq;
            v[5] += dq;
          }
          v[6] += w * g0[r];
          v[7] += w * g1[r];
          v[8] += w * g2[r];
          v[9] += w * g3[r];
        }
      }
      all_done = true;
#pragma unroll
      for (int r = 0; r < R; ++r) all_done = all_done && done[r];
      if constexpr (V == kFusedGrad) {
        reduce_butterfly(v, hit, acc, j, lane);
      } else if constexpr (V == kNoT || V == kNoTLogSp) {
        __shared__ float xs[kWarps][kChannels][33];  // each warp's transpose
        reduce_transpose(v, hit, acc, xs[threadIdx.x >> 5], j, lane);
      } else if constexpr (V != kNoGrad) {
        // warp-uniform: skip the reduction of a row no pixel of the warp hits
        if (__ballot_sync(kFullWarp, hit) == 0u) continue;
#pragma unroll
        for (int c = 0; c < kChannels; ++c) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v[c] += __shfl_down_sync(kFullWarp, v[c], off);
        }
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < kChannels; ++c) atomicAdd(&acc[c][j], v[c]);
        }
      }
    }
    if constexpr (CHUNKED) {
      // the chunk's end; a last row the pixel skipped has alpha = 0
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (done[r]) continue;
        if (!last[r]) dead[r] = ends_pixel(V == kNoMM ? T[r] : exp_v<STUB>(cum[r]) * T[r]);
        T[r] = T[r] * exp_v<STUB>(kept[r]);
        prefix[r] = prefix[r] + carry[r];
        done[r] = dead[r];
      }
      all_done = true;
#pragma unroll
      for (int r = 0; r < R; ++r) all_done = all_done && done[r];
    }
    __syncthreads();
    if (V != kNoGrad && k < n) {
      if constexpr (RM) {
        float* dq = drows + (long long)k * 8;
        float* dc = dcolor + (long long)k * 4;
#pragma unroll
        for (int c = 0; c < kChannels; ++c) {
          const float a = acc[c][threadIdx.x];
          // dquad lanes 0-5, then dcolor
          if (a != 0.0f) atomicAdd(c < 6 ? dq + c : dc + (c - 6), a);
        }
      } else {
        float* d = drows + begin + k;
#pragma unroll
        for (int c = 0; c < kChannels; ++c) {
          const float a = acc[c][threadIdx.x];
          // channels 0-5 keep their row, the four colors go to rows 8-11
          if (a != 0.0f) atomicAdd(d + (c < 6 ? c : c + 2) * stride, a);
        }
      }
    }
    if constexpr (PIPE) {
#pragma unroll
      for (int c = 0; c < kChannels; ++c) acc[c][threadIdx.x] = 0.0f;
      store_conic_rm_row(s_buf[buf ^ 1], next, k + kBlock, n);
    }
  }
  if constexpr (V == kNoGrad) keep_alive(sink, drows);
}

// All four kernels: 4 blocks an SM (64 registers for the pair-major one, no
// spills) measured 6-7% faster than 3 for it on an H100
__global__ void __launch_bounds__(kBlock, 4)
composite_tiles_bwd_cm_kernel(const float* __restrict__ win, const int* __restrict__ counts,
                              const float* __restrict__ origins, const float* __restrict__ bg,
                              const float* __restrict__ full, const float* __restrict__ g_full,
                              float* __restrict__ dwin, int K, int th, int tw) {
  const int nb = pair_blocks(th, tw);
  const int t = blockIdx.x / nb;
  const int blk = blockIdx.x - t * nb;
  const long long tile = (long long)t * 5 * th * tw;
  // tile t's window and its gradient: channel c of row k at [t * 12 K + c K + k]
  composite_pairs_range_bwd<RowKind::kConicCM>(win + (long long)t * 12 * K, nullptr, K, blk, 0,
                                               min(counts[t], K), origins[2 * t],
                                               origins[2 * t + 1], th, tw, bg, full + tile,
                                               g_full + tile, nullptr, nullptr,
                                               dwin + (long long)t * 12 * K, nullptr);
}

__global__ void __launch_bounds__(kBlock, 4)
composite_pairs_bwd_rg_kernel(const float* __restrict__ rows, const int* __restrict__ slot_start,
                              const int* __restrict__ slot_count, const float* __restrict__ bg,
                              float oy_off, const float* __restrict__ full,
                              const float* __restrict__ g_full, float* __restrict__ drows,
                              long long Pa, int chunk, int th, int tw, int nx) {
  const int nb = pair_blocks(th, tw);
  const int t = blockIdx.x / nb;
  const int blk = blockIdx.x - t * nb;
  const float ox = (float)((t % nx) * tw);
  const float oy = (float)((t / nx) * th) + oy_off;
  const long long tile = (long long)t * 5 * th * tw;
  composite_pairs_range_bwd<RowKind::kConicCM>(rows, nullptr, Pa, blk,
                                               (long long)slot_start[t] * chunk,
                                               slot_count[t] * chunk, ox, oy, th, tw, bg,
                                               full + tile, g_full + tile, nullptr, nullptr,
                                               drows, nullptr);
}

// the first min(counts[t], K) packed rows of tile t: quad (T, K, 8), color
// (T, K, 4), the forward's accum (T, P, 4) and tfinal (T, P, 1) and their
// cotangents -> dquad (T, K, 8), dcolor (T, K, 4)
__global__ void __launch_bounds__(kBlock, 4)
composite_tiles_bwd_v2_kernel(const float* __restrict__ quad, const float* __restrict__ color,
                              const int* __restrict__ counts, const float* __restrict__ g_accum,
                              const float* __restrict__ g_tfinal, const float* __restrict__ accum,
                              const float* __restrict__ tfinal, float* __restrict__ dquad,
                              float* __restrict__ dcolor, int K, int th, int tw) {
  const int nb = pair_blocks(th, tw);
  const int t = blockIdx.x / nb;
  const int blk = blockIdx.x - t * nb;
  const long long P = (long long)th * tw;
  const long long rows8 = (long long)t * K * 8, rows4 = (long long)t * K * 4;
  composite_pairs_range_bwd<RowKind::kPackedRM>(quad + rows8, color + rows4, 0, blk, 0,
                                                min(counts[t], K), 0.0f, 0.0f, th, tw, nullptr,
                                                accum + t * P * 4, g_accum + t * P * 4,
                                                tfinal + t * P, g_tfinal + t * P, dquad + rows8,
                                                dcolor + rows4);
}

// the first min(counts[t], K) global conic rows of tile t at its origin
// origins[t] (passed through, not rebuilt from the tile grid): quad (T, K,
// 8), color (T, K, 4), the forward's accum (T, P, 4) and tfinal (T, P, 1)
// and their cotangents -> dquad (T, K, 8) [dA, dB, dC, dgx, dgy, dlog_op, 0,
// 0], dcolor (T, K, 4)
__global__ void __launch_bounds__(kBlock, 4)
composite_tiles_bwd_kernel(const float* __restrict__ quad, const float* __restrict__ color,
                           const int* __restrict__ counts, const float* __restrict__ origins,
                           const float* __restrict__ g_accum, const float* __restrict__ g_tfinal,
                           const float* __restrict__ accum, const float* __restrict__ tfinal,
                           float* __restrict__ dquad, float* __restrict__ dcolor, int K, int th,
                           int tw) {
  const int nb = pair_blocks(th, tw);
  const int t = blockIdx.x / nb;
  const int blk = blockIdx.x - t * nb;
  const long long P = (long long)th * tw;
  const long long rows8 = (long long)t * K * 8, rows4 = (long long)t * K * 4;
  composite_pairs_range_bwd<RowKind::kConicRM>(quad + rows8, color + rows4, 0, blk, 0,
                                               min(counts[t], K), origins[2 * t],
                                               origins[2 * t + 1], th, tw, nullptr,
                                               accum + t * P * 4, g_accum + t * P * 4,
                                               tfinal + t * P, g_tfinal + t * P, dquad + rows8,
                                               dcolor + rows4);
}

// Stage probe V (composite_probes.cuh) of kernel 6: kernel 6's grid and
// arguments, and its body under V. V = kBase is kernel 6's code.
template <int V>
__global__ void __launch_bounds__(kBlock, 4)
composite_tiles_bwd_variant_kernel(const float* __restrict__ quad,
                                   const float* __restrict__ color,
                                   const int* __restrict__ counts,
                                   const float* __restrict__ origins,
                                   const float* __restrict__ g_accum,
                                   const float* __restrict__ g_tfinal,
                                   const float* __restrict__ accum,
                                   const float* __restrict__ tfinal, float* __restrict__ dquad,
                                   float* __restrict__ dcolor, int K, int th, int tw) {
  const int nb = pair_blocks(th, tw);
  const int t = blockIdx.x / nb;
  const int blk = blockIdx.x - t * nb;
  const long long P = (long long)th * tw;
  const long long rows8 = (long long)t * K * 8, rows4 = (long long)t * K * 4;
  composite_pairs_range_bwd<RowKind::kConicRM, V>(quad + rows8, color + rows4, 0, blk, 0,
                                                  min(counts[t], K), origins[2 * t],
                                                  origins[2 * t + 1], th, tw, nullptr,
                                                  accum + t * P * 4, g_accum + t * P * 4,
                                                  tfinal + t * P, g_tfinal + t * P,
                                                  dquad + rows8, dcolor + rows4);
}

template <int V>
int launch_bwd_variant(const float* quad, const float* color, const int* counts,
                       const float* origins, const float* g_accum, const float* g_tfinal,
                       const float* accum, const float* tfinal, float* dquad, float* dcolor,
                       int T, int K, int th, int tw, void* stream) {
  const dim3 grid(T * pair_blocks(th, tw));
  composite_tiles_bwd_variant_kernel<V><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      quad, color, counts, origins, g_accum, g_tfinal, accum, tfinal, dquad, dcolor, K, th, tw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// win (T, 12, K) f32; counts (T,) i32; origins (T, 2) f32; bg (3,) f32; full,
// g_full (T, 5, th*tw) f32; dwin (T, 12, K) f32, zeroed by the caller.
// Returns cudaGetLastError() after the launch.
int composite_tiles_bwd_cm(const float* win, const int* counts, const float* origins,
                           const float* bg, const float* full, const float* g_full, float* dwin,
                           int T, int K, int th, int tw, void* stream) {
  const dim3 grid(T * pair_blocks(th, tw));
  composite_tiles_bwd_cm_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      win, counts, origins, bg, full, g_full, dwin, K, th, tw);
  return (int)cudaGetLastError();
}

// rows (12, Pa) f32; slot_start, slot_count (T,) i32 (chunk slots of each
// tile); bg (3,) f32; full, g_full (T, 5, th*tw) f32; drows (12, Pa) f32,
// zeroed by the caller: slots of no tile and padding rows stay zero.
int composite_pairs_bwd_rg(const float* rows, const int* slot_start, const int* slot_count,
                           const float* bg, float oy_off, const float* full, const float* g_full,
                           float* drows, int T, long long Pa, int chunk, int th, int tw, int nx,
                           void* stream) {
  const dim3 grid(T * pair_blocks(th, tw));
  composite_pairs_bwd_rg_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      rows, slot_start, slot_count, bg, oy_off, full, g_full, drows, Pa, chunk, th, tw, nx);
  return (int)cudaGetLastError();
}

// quad (T, K, 8) f32 packed rows; color (T, K, 4) f32; counts (T,) i32;
// g_accum, accum (T, th*tw, 4) f32; g_tfinal, tfinal (T, th*tw, 1) f32: the
// cotangents and the forward's own outputs. dquad (T, K, 8), dcolor (T, K, 4)
// f32, zeroed by the caller: dead slots and lanes 6-7 stay zero. quad, color,
// g_accum, accum, dquad and dcolor 16-byte aligned.
int composite_tiles_bwd_v2(const float* quad, const float* color, const int* counts,
                           const float* g_accum, const float* g_tfinal, const float* accum,
                           const float* tfinal, float* dquad, float* dcolor, int T, int K, int th,
                           int tw, void* stream) {
  const dim3 grid(T * pair_blocks(th, tw));
  composite_tiles_bwd_v2_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      quad, color, counts, g_accum, g_tfinal, accum, tfinal, dquad, dcolor, K, th, tw);
  return (int)cudaGetLastError();
}

// quad (T, K, 8) f32: global conic rows when origins (T, 2) f32 are given,
// packed rows when origins is null (then composite_tiles_bwd_v2's kernel);
// the rest as composite_tiles_bwd_v2's. With origins dquad comes in the
// global row layout [dA, dB, dC, dgx, dgy, dlog_op, 0, 0].
int composite_tiles_bwd(const float* quad, const float* color, const int* counts,
                        const float* origins, const float* g_accum, const float* g_tfinal,
                        const float* accum, const float* tfinal, float* dquad, float* dcolor,
                        int T, int K, int th, int tw, void* stream) {
  if (origins == nullptr)
    return composite_tiles_bwd_v2(quad, color, counts, g_accum, g_tfinal, accum, tfinal, dquad,
                                  dcolor, T, K, th, tw, stream);
  const dim3 grid(T * pair_blocks(th, tw));
  composite_tiles_bwd_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      quad, color, counts, origins, g_accum, g_tfinal, accum, tfinal, dquad, dcolor, K, th, tw);
  return (int)cudaGetLastError();
}

// The stage probes of kernel 6 under `variant` (composite_probes.cuh enum
// Variant; kBase is kernel 6 itself, launched as a probe): the arguments of
// composite_tiles_bwd with origins, which must be given; dquad and dcolor
// zeroed by the caller. Every pointer 16-byte aligned. Returns
// cudaGetLastError() after the launch; an unknown variant returns
// cudaErrorInvalidValue.
int composite_rm_bwd_variant(int variant, const float* quad, const float* color, const int* counts,
                             const float* origins, const float* g_accum, const float* g_tfinal,
                             const float* accum, const float* tfinal, float* dquad, float* dcolor,
                             int T, int K, int th, int tw, void* stream) {
#define BWD(V)                                                                            \
  launch_bwd_variant<V>(quad, color, counts, origins, g_accum, g_tfinal, accum, tfinal, \
                        dquad, dcolor, T, K, th, tw, stream)
  switch (variant) {
    case kBase: return BWD(kBase);
    case kNoExp: return BWD(kNoExp);
    case kNoMM: return BWD(kNoMM);
    case kLogSp: return BWD(kLogSp);
    case kPipe: return BWD(kPipe);
    case kNoGrad: return BWD(kNoGrad);
    case kFusedGrad: return BWD(kFusedGrad);
    case kNoT: return BWD(kNoT);
    case kNoDeloc: return BWD(kNoDeloc);
    case kNoTLogSp: return BWD(kNoTLogSp);
    case kChunk: return BWD(kChunk);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD
}

}  // extern "C"
