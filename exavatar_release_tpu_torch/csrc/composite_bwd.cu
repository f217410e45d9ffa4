// Backward tile compositing kernels for Hopper (sm_90a): the gradient of the
// 3DGS rasterizer's front-to-back alpha blend with respect to the
// depth-sorted rows.
//
// Replaces two Pallas TPU kernels of
// exavatar_release_tpu/ops/rasterizer/pallas_kernels.py:
//   composite_tiles_bwd_cm   (dense (T, 12, K) windows   -> dwin  (T, 12, K))
//   composite_pairs_bwd_rg   (ragged (12, Pa) pair list  -> drows (12, Pa))
// Output rows are [dA, dB, dC, dgx, dgy, dlog_op, 0, 0, dr, dg, db, ddepth].
//
// What is computed. Per pixel, from the forward's saved output `full` and
// its cotangent `g_full`:
//   tfinal = 1 - full[4];  g_acc = g_full[0:4];
//   g_tf = bg . g_full[0:3] - g_full[4];  accum_rgb = full[0:3] - bg tfinal;
//   A_p = g_acc . accum + g_tf tfinal.
// The forward is replayed front to back with the forward kernel's own rules
// and arithmetic: both go through composite_common.cuh (the direct conic
// q, the 1/255 floor, the 0.99 clamp, sticky termination at T (1 - alpha) <
// 1e-4 that excludes the Gaussian that triggers it). Every Gaussian i that
// contributed with weight w_i = alpha_i T_i gets
//   cg_i = g_acc . color_i;   P_i = sum_{j<=i} w_j cg_j   (inclusive prefix)
//   dalpha_i = T_i cg_i - (A_p - P_i) / (1 - alpha_i)
//   dq_i = dalpha_i exp(q_i)        (renderCUDA's rule: unclamped, also
//                                    where alpha was clamped to 0.99)
// and, summed over the tile's pixels, dcolor_i = sum w_i g_acc and the
// gradient of q = log_op - 0.5 (A dx^2 + C dy^2) - B dx dy:
//   dA = -0.5 dx^2 dq, dB = -dx dy dq, dC = -0.5 dy^2 dq,
//   dgx = (A dx + B dy) dq, dgy = (B dx + C dy) dq, dlog_op = dq.
// No per-Gaussian transmittance is stored: A_p - P_i is what lies behind
// Gaussian i, so the replay runs in the forward's order and ends where the
// forward ended. 1 - alpha >= 0.01 by the clamp, so the division is safe.
// The TPU kernels reach the conic gradient through a pixel-basis matmul and
// a de-localisation; that was a device for the TPU's matrix unit.
//
// Design of composite_tiles_bwd_cm. A block owns 256 pixels of one tile,
// one thread per pixel, and stages 256 rows at a time in shared memory, as
// the forward does. The reduction over pixels has three levels: a warp sums
// its 32 pixels' ten gradient values with __shfl_down_sync, and only for
// rows that some pixel of the warp hits (one ballot per row otherwise);
// lane 0 adds the warp's sum into the batch's accumulators in shared memory;
// after the batch the block adds its nonzero accumulators into the output
// with atomicAdd, where the tile's other blocks (16 at 32x128) add theirs.
// The output must arrive zeroed. Atomics make the order of summation differ
// from run to run: the result agrees with the plain PyTorch version within
// float32 summation error, not bit for bit.
//
// Design of composite_pairs_bwd_rg. Its time went to the reduction over
// pixels (half of it in the probes of kernel 6, which runs the same loop):
// not to the instruction count of one reduction but to their number, one
// ballot, a five-deep shuffle chain and a shared atomic per (warp, row)
// hit. So it reduces fewer times, with the forward's schedule
// (composite.cu): a thread owns R = kPairsR = 2 pixels of a compact warp
// patch and first adds its two pixels' ten values in registers, so one warp
// reduction serves 64 pixels and 8 blocks of a 32x128 tile add each row
// into device memory, not 16; rows whose pixel box misses the warp's
// patch are skipped before any exp, and the exp gate skips the rest of the
// far ones without an expf. Both are exact: the replay takes the forward's
// decisions. The three levels of the reduction and the zeroed output stay.
//
// Bound: ~13 f32 operations per (pixel, Gaussian) visit plus ~37 per visit
// that contributes, against 40 bytes per live row read, 40 per pixel read
// (full, g_full) and 40 per live row written: bound by operations at the
// avatar's shapes (PERF.md holds the bound and the measured times).
//
// Build with -fmad=false and without fast math, like composite.cu: the
// replay must take the forward's skip and termination decisions, which sit
// on thresholds that see last bits.

#include "composite_common.cuh"

namespace {

using namespace composite;

constexpr unsigned kFullWarp = 0xffffffffu;

// Gradient of rows [begin, begin + n) of a channel-major row table (channel
// c of row r at rows[c * stride + r]) from the pixels of one tile; drows has
// the table's layout. The block's threads own pixels blockIdx.y * kBlock +
// threadIdx.x of that tile.
__device__ void composite_range_bwd(const float* __restrict__ rows, long long stride,
                                    long long begin, int n, float ox, float oy, int th, int tw,
                                    const float* __restrict__ bg,
                                    const float* __restrict__ full_tile,
                                    const float* __restrict__ gfull_tile,
                                    float* __restrict__ drows) {
  __shared__ float s[kChannels][kBlock];
  __shared__ float acc[kChannels][kBlock];
  const int P = th * tw;
  const int i = blockIdx.y * kBlock + threadIdx.x;
  const bool inside = i < P;
  const float px = (float)(i % tw) + ox;
  const float py = (float)(i / tw) + oy;
  const int lane = threadIdx.x & 31;

  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, g3 = 0.0f, A_p = 0.0f;
  if (inside) {
    const float bg0 = bg[0], bg1 = bg[1], bg2 = bg[2];
    const float f0 = full_tile[0 * P + i], f1 = full_tile[1 * P + i];
    const float f2 = full_tile[2 * P + i], f3 = full_tile[3 * P + i];
    const float tfinal = 1.0f - full_tile[4 * P + i];
    g0 = gfull_tile[0 * P + i];
    g1 = gfull_tile[1 * P + i];
    g2 = gfull_tile[2 * P + i];
    g3 = gfull_tile[3 * P + i];
    const float g_tf = bg0 * g0 + bg1 * g1 + bg2 * g2 - gfull_tile[4 * P + i];
    A_p = g0 * (f0 - bg0 * tfinal) + g1 * (f1 - bg1 * tfinal) + g2 * (f2 - bg2 * tfinal) +
          g3 * f3 + g_tf * tfinal;
  }

  bool done = !inside;
  float T = 1.0f, prefix = 0.0f;
  for (int b = 0; b < n; b += kBlock) {
    // barrier before overwriting the batch; also the block's exit test
    if (__syncthreads_count(done) == kBlock) break;
    const int k = b + threadIdx.x;
    stage_row(s, rows, stride, begin, k, n);
#pragma unroll
    for (int c = 0; c < kChannels; ++c) acc[c][threadIdx.x] = 0.0f;
    __syncthreads();
    const int m = min(kBlock, n - b);
    for (int j = 0; j < m; ++j) {
      if (__all_sync(kFullWarp, done)) break;
      float v[kChannels];
#pragma unroll
      for (int c = 0; c < kChannels; ++c) v[c] = 0.0f;
      bool hit = false;
      if (!done) {
        float dx, dy, alpha_un;
        if (reaches(s, j, px, py, dx, dy, alpha_un)) {
          const float alpha = clamped(alpha_un);
          const float one_m = 1.0f - alpha;
          const float test_T = T * one_m;
          if (ends_pixel(test_T)) {
            done = true;
          } else {
            hit = true;
            const float A = s[0][j], B = s[1][j], C = s[2][j];
            const float w = alpha * T;
            const float cg = g0 * s[6][j] + g1 * s[7][j] + g2 * s[8][j] + g3 * s[9][j];
            prefix = prefix + w * cg;
            const float dalpha = T * cg - (A_p - prefix) / one_m;
            const float dq = dalpha * alpha_un;
            v[0] = -0.5f * (dx * dx) * dq;
            v[1] = -(dx * dy) * dq;
            v[2] = -0.5f * (dy * dy) * dq;
            v[3] = (A * dx + B * dy) * dq;
            v[4] = (B * dx + C * dy) * dq;
            v[5] = dq;
            v[6] = w * g0;
            v[7] = w * g1;
            v[8] = w * g2;
            v[9] = w * g3;
            T = test_T;
          }
        }
      }
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
    __syncthreads();
    if (k < n) {
      float* d = drows + begin + k;
#pragma unroll
      for (int c = 0; c < kChannels; ++c) {
        const float a = acc[c][threadIdx.x];
        // channels 0-5 keep their row, the four colors go to rows 8-11
        if (a != 0.0f) atomicAdd(d + (c < 6 ? c : c + 2) * stride, a);
      }
    }
  }
}

__global__ void __launch_bounds__(kBlock)
composite_tiles_bwd_cm_kernel(const float* __restrict__ win, const int* __restrict__ counts,
                              const float* __restrict__ origins, const float* __restrict__ bg,
                              const float* __restrict__ full, const float* __restrict__ g_full,
                              float* __restrict__ dwin, int K, int th, int tw) {
  const int t = blockIdx.x;
  const int n = min(counts[t], K);
  const long long tile = (long long)t * 5 * th * tw;
  composite_range_bwd(win + (long long)t * 12 * K, K, 0, n, origins[2 * t], origins[2 * t + 1],
                      th, tw, bg, full + tile, g_full + tile, dwin + (long long)t * 12 * K);
}

// Gradient of rows [begin, begin + n) of a channel-major row table from the
// pixels of one tile, kPairsR pixels a thread (pair_pixels, blk the block's
// index within the tile); drows has the table's layout.
__device__ void composite_pairs_range_bwd(const float* __restrict__ rows, long long stride,
                                          int blk, long long begin, int n, float ox, float oy,
                                          int th, int tw, const float* __restrict__ bg,
                                          const float* __restrict__ full_tile,
                                          const float* __restrict__ gfull_tile,
                                          float* __restrict__ drows) {
  constexpr int R = kPairsR;
  __shared__ PairRows s;
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

  bool done[R];
  float g0[R], g1[R], g2[R], g3[R], A_p[R], T[R], prefix[R];
  bool all_done = true;
  const float bg0 = bg[0], bg1 = bg[1], bg2 = bg[2];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int x = pp.x, y = pp.y + r;
    done[r] = x >= tw || y >= th;
    all_done = all_done && done[r];
    T[r] = 1.0f;
    prefix[r] = 0.0f;
    g0[r] = g1[r] = g2[r] = g3[r] = A_p[r] = 0.0f;
    if (done[r]) continue;
    const int i = y * tw + x;
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

  for (int b = 0; b < n; b += kBlock) {
    // barrier before overwriting the batch; also the block's exit test
    if (__syncthreads_count(all_done) == kBlock) break;
    const int k = b + threadIdx.x;
    stage_pair_row(s, rows, stride, begin, k, n);
#pragma unroll
    for (int c = 0; c < kChannels; ++c) acc[c][threadIdx.x] = 0.0f;
    __syncthreads();
    const int m = min(kBlock, n - b);
    for (int j = 0; j < m; ++j) {
      if (__all_sync(kFullWarp, all_done)) break;
      // warp-uniform: every lane reads the same box and patch
      if (misses(s.box[j], patch[threadIdx.x >> 5])) continue;
      const float4 g = s.abcx[j];
      const float2 h = s.ylo[j];
      const float4 col = s.col[j];
      float v[kChannels];
#pragma unroll
      for (int c = 0; c < kChannels; ++c) v[c] = 0.0f;
      bool hit = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (done[r]) continue;
        float dx, dy, alpha_un;
        if (!reaches_gated(g.x, g.y, g.z, g.w, h.x, h.y, px, py[r], dx, dy, alpha_un))
          continue;
        const float alpha = clamped(alpha_un);
        const float one_m = 1.0f - alpha;
        const float test_T = T[r] * one_m;
        if (ends_pixel(test_T)) {
          done[r] = true;
          continue;
        }
        hit = true;
        const float w = alpha * T[r];
        const float cg = g0[r] * col.x + g1[r] * col.y + g2[r] * col.z + g3[r] * col.w;
        prefix[r] = prefix[r] + w * cg;
        const float dalpha = T[r] * cg - (A_p[r] - prefix[r]) / one_m;
        const float dq = dalpha * alpha_un;
        v[0] += -0.5f * (dx * dx) * dq;
        v[1] += -(dx * dy) * dq;
        v[2] += -0.5f * (dy * dy) * dq;
        v[3] += (g.x * dx + g.y * dy) * dq;
        v[4] += (g.y * dx + g.z * dy) * dq;
        v[5] += dq;
        v[6] += w * g0[r];
        v[7] += w * g1[r];
        v[8] += w * g2[r];
        v[9] += w * g3[r];
        T[r] = test_T;
      }
      all_done = true;
#pragma unroll
      for (int r = 0; r < R; ++r) all_done = all_done && done[r];
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
    __syncthreads();
    if (k < n) {
      float* d = drows + begin + k;
#pragma unroll
      for (int c = 0; c < kChannels; ++c) {
        const float a = acc[c][threadIdx.x];
        // channels 0-5 keep their row, the four colors go to rows 8-11
        if (a != 0.0f) atomicAdd(d + (c < 6 ? c : c + 2) * stride, a);
      }
    }
  }
}

// 4 blocks an SM (64 registers, no spills), 6-7% faster than 3 on an H100
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
  composite_pairs_range_bwd(rows, Pa, blk, (long long)slot_start[t] * chunk,
                            slot_count[t] * chunk, ox, oy, th, tw, bg, full + tile,
                            g_full + tile, drows);
}

}  // namespace

extern "C" {

// win (T, 12, K) f32; counts (T,) i32; origins (T, 2) f32; bg (3,) f32; full,
// g_full (T, 5, th*tw) f32; dwin (T, 12, K) f32, zeroed by the caller.
// Returns cudaGetLastError() after the launch.
int composite_tiles_bwd_cm(const float* win, const int* counts, const float* origins,
                           const float* bg, const float* full, const float* g_full, float* dwin,
                           int T, int K, int th, int tw, void* stream) {
  const dim3 grid(T, (th * tw + kBlock - 1) / kBlock);
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

}  // extern "C"
