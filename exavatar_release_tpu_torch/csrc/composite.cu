// Tile compositing kernels for Hopper (sm_90a): the forward of the 3DGS
// rasterizer's front-to-back alpha blend.
//
// Replaces two Pallas TPU kernels of
// exavatar_release_tpu/ops/rasterizer/pallas_kernels.py:
//   composite_tiles_fwd_cm   (dense (T, 12, K) depth-sorted windows)
//   composite_pairs_fwd_rg   (ragged chunk-aligned (12, Pa) pair list)
// Both compute renderCUDA's rules, as jax_ref.py states them:
//   q = log_op - 0.5 (A dx^2 + C dy^2) - B dx dy   (direct conic form)
//   skip when q > log_op or exp(q) < 1/255;  alpha = min(0.99, exp(q))
//   test_T = T (1 - alpha); test_T < 1e-4 ends the pixel, excluding the
//   Gaussian that triggers it;  C += col alpha T;  T = test_T
//   out = [rgb + bg T, depth, 1 - T]
// T is a sequential f32 product, as in the plain PyTorch twin
// (ops/rasterizer/kernels.py). The TPU kernels' log-space triangular-matmul
// prefix was a device for the TPU's matrix unit and is not carried over.
// The TPU kernel carried acc/T/done across sequential grid steps over chunk
// slots (the ragged kernel's output-block revisit); blocks here run in no
// order, so that carry is the loop over the tile's slot range inside one
// block.
//
// Bound: the work is ~13 f32 operations (one exp) per (pixel, Gaussian)
// visit before termination, against 40 bytes per live row and 20 per output
// pixel, so on this card the kernels are bound by operations (PERF.md holds
// the bound and the measured times at the avatar's shapes).
//
// composite_tiles_fwd_cm (renderCUDA's design): a block owns 256 pixels of
// one tile, one thread per pixel. It stages 256 rows at a time in shared
// memory (10 used channels x 256 floats = 10 KB), each channel a coalesced
// load, and every thread walks the batch in depth order.
// __syncthreads_count ends the block once all its pixels are done.
//
// composite_pairs_fwd_rg cuts the per-visit cost that is not the blend's
// arithmetic: shared-memory reads, exps of Gaussians that are skipped, and
// visits of Gaussians far from the pixels.
// - A thread owns R = kPairsR = 2 pixels (a column of two), and a warp a
//   compact patch (8 x 8 pixels): a block covers 512 pixels, so each row is
//   staged 8 times per 32 x 128 tile, not 16 times. A visit reads the row
//   from shared memory once for both pixels (three broadcast vector loads),
//   and the two pixels' chains are independent.
// - Each staged row carries a conservative pixel box (composite_common.cuh
//   pixel_box); a warp whose patch misses it skips the row with one
//   warp-uniform test, before any exp. This is exact: every pixel of the
//   patch would skip that row.
// - The exp gate (reaches_gated): q < kQGate skips without an expf (at the
//   avatar's train render about 70% of the visits contribute nothing).
// Each pixel keeps its own sticky termination; a thread leaves the batch
// when both its pixels are done, the block when all are.
//
// The thresholds, the row staging and the blend of one Gaussian at one pixel
// are in composite_common.cuh, which the backward kernels share. Build with
// -fmad=false and without fast math (see there).

#include "composite_common.cuh"

namespace {

using namespace composite;

// Composite rows [begin, begin + n) of a channel-major row table (channel c
// of row r at rows[c * stride + r]) into the pixels of one tile. The block's
// threads own pixels blockIdx.y * kBlock + threadIdx.x of that tile.
__device__ void composite_range(const float* __restrict__ rows, long long stride,
                                long long begin, int n, float ox, float oy,
                                int th, int tw, const float* __restrict__ bg,
                                float* __restrict__ out_tile) {
  __shared__ float s[kChannels][kBlock];
  const int P = th * tw;
  const int i = blockIdx.y * kBlock + threadIdx.x;
  const bool inside = i < P;
  const float px = (float)(i % tw) + ox;
  const float py = (float)(i / tw) + oy;

  bool done = !inside;
  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
  for (int b = 0; b < n; b += kBlock) {
    // barrier before overwriting the batch; also the block's exit test
    if (__syncthreads_count(done) == kBlock) break;
    stage_row(s, rows, stride, begin, b + threadIdx.x, n);
    __syncthreads();
    const int m = min(kBlock, n - b);
    for (int j = 0; !done && j < m; ++j) {
      float dx, dy, alpha_un;
      if (!reaches(s, j, px, py, dx, dy, alpha_un)) continue;
      const float alpha = clamped(alpha_un);
      const float test_T = T * (1.0f - alpha);
      if (ends_pixel(test_T)) {
        done = true;
        break;
      }
      const float w = alpha * T;
      c0 = c0 + w * s[6][j];
      c1 = c1 + w * s[7][j];
      c2 = c2 + w * s[8][j];
      c3 = c3 + w * s[9][j];
      T = test_T;
    }
  }
  if (inside) {
    out_tile[0 * P + i] = c0 + T * bg[0];
    out_tile[1 * P + i] = c1 + T * bg[1];
    out_tile[2 * P + i] = c2 + T * bg[2];
    out_tile[3 * P + i] = c3;
    out_tile[4 * P + i] = 1.0f - T;
  }
}

__global__ void __launch_bounds__(kBlock)
composite_tiles_fwd_cm_kernel(const float* __restrict__ win, const int* __restrict__ counts,
                              const float* __restrict__ origins, const float* __restrict__ bg,
                              float* __restrict__ out, int K, int th, int tw) {
  const int t = blockIdx.x;
  const int n = min(counts[t], K);
  composite_range(win + (long long)t * 12 * K, K, 0, n, origins[2 * t],
                  origins[2 * t + 1], th, tw, bg, out + (long long)t * 5 * th * tw);
}

// Composite rows [begin, begin + n) of a channel-major row table into the
// pixels of one tile, kPairsR pixels a thread (pair_pixels, blk the block's
// index within the tile).
__device__ void composite_pairs_range(const float* __restrict__ rows, long long stride, int blk,
                                      long long begin, int n, float ox, float oy, int th,
                                      int tw, const float* __restrict__ bg,
                                      float* __restrict__ out_tile) {
  constexpr int R = kPairsR;
  __shared__ PairRows s;
  const int P = th * tw;
  const PairPixels pp = pair_pixels(blk, tw, ox, oy);
  const float px = (float)pp.x + ox;
  float py[R];
#pragma unroll
  for (int r = 0; r < R; ++r) py[r] = (float)(pp.y + r) + oy;

  bool done[R];
  float T[R], c0[R], c1[R], c2[R], c3[R];
  bool all_done = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    done[r] = pp.x >= tw || pp.y + r >= th;
    all_done = all_done && done[r];
    T[r] = 1.0f;
    c0[r] = c1[r] = c2[r] = c3[r] = 0.0f;
  }
  for (int b = 0; b < n; b += kBlock) {
    // barrier before overwriting the batch; also the block's exit test
    if (__syncthreads_count(all_done) == kBlock) break;
    stage_pair_row(s, rows, stride, begin, b + threadIdx.x, n);
    __syncthreads();
    const int m = min(kBlock, n - b);
    for (int j = 0; !all_done && j < m; ++j) {
      if (misses(s.box[j], pp.patch)) continue;
      const float4 g = s.abcx[j];
      const float2 h = s.ylo[j];
      const float4 col = s.col[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (done[r]) continue;
        float dx, dy, alpha_un;
        if (!reaches_gated(g.x, g.y, g.z, g.w, h.x, h.y, px, py[r], dx, dy, alpha_un))
          continue;
        const float alpha = clamped(alpha_un);
        const float test_T = T[r] * (1.0f - alpha);
        if (ends_pixel(test_T)) {
          done[r] = true;
          continue;
        }
        const float w = alpha * T[r];
        c0[r] = c0[r] + w * col.x;
        c1[r] = c1[r] + w * col.y;
        c2[r] = c2[r] + w * col.z;
        c3[r] = c3[r] + w * col.w;
        T[r] = test_T;
      }
      all_done = true;
#pragma unroll
      for (int r = 0; r < R; ++r) all_done = all_done && done[r];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int x = pp.x, y = pp.y + r;
    if (x >= tw || y >= th) continue;
    const int i = y * tw + x;
    out_tile[0 * P + i] = c0[r] + T[r] * bg[0];
    out_tile[1 * P + i] = c1[r] + T[r] * bg[1];
    out_tile[2 * P + i] = c2[r] + T[r] * bg[2];
    out_tile[3 * P + i] = c3[r];
    out_tile[4 * P + i] = 1.0f - T[r];
  }
}

__global__ void __launch_bounds__(kBlock, 2)
composite_pairs_fwd_rg_kernel(const float* __restrict__ rows, const int* __restrict__ slot_start,
                              const int* __restrict__ slot_count, const float* __restrict__ bg,
                              float oy_off, float* __restrict__ out, long long Pa, int chunk,
                              int th, int tw, int nx) {
  const int nb = pair_blocks(th, tw);
  const int t = blockIdx.x / nb;
  const int blk = blockIdx.x - t * nb;
  const float ox = (float)((t % nx) * tw);
  const float oy = (float)((t / nx) * th) + oy_off;
  composite_pairs_range(rows, Pa, blk, (long long)slot_start[t] * chunk,
                        slot_count[t] * chunk, ox, oy, th, tw, bg,
                        out + (long long)t * 5 * th * tw);
}

}  // namespace

extern "C" {

// win (T, 12, K) f32; counts (T,) i32; origins (T, 2) f32; bg (3,) f32;
// out (T, 5, th*tw) f32. Returns cudaGetLastError() after the launch.
int composite_tiles_fwd_cm(const float* win, const int* counts, const float* origins,
                           const float* bg, float* out, int T, int K, int th, int tw,
                           void* stream) {
  const dim3 grid(T, (th * tw + kBlock - 1) / kBlock);
  composite_tiles_fwd_cm_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      win, counts, origins, bg, out, K, th, tw);
  return (int)cudaGetLastError();
}

// rows (12, Pa) f32; slot_start, slot_count (T,) i32 (chunk slots of each
// tile); bg (3,) f32; out (T, 5, th*tw) f32.
int composite_pairs_fwd_rg(const float* rows, const int* slot_start, const int* slot_count,
                           const float* bg, float oy_off, float* out, int T, long long Pa,
                           int chunk, int th, int tw, int nx, void* stream) {
  const dim3 grid(T * pair_blocks(th, tw));
  composite_pairs_fwd_rg_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      rows, slot_start, slot_count, bg, oy_off, out, Pa, chunk, th, tw, nx);
  return (int)cudaGetLastError();
}

}  // extern "C"
