// Row-major tile compositing kernels for Hopper (sm_90a): forward and
// backward of the 3DGS front-to-back alpha blend on (T, K, 8) coefficient
// rows and (T, K, 4) color rows, one thread per pixel.
//
// Replaces four Pallas TPU kernels of
// exavatar_release_tpu/ops/rasterizer/pallas_kernels.py:
//   composite_tiles_fwd_v2 / composite_tiles_bwd_v2   (pre-packed rows)
//   composite_tiles_fwd    / composite_tiles_bwd      (pre-packed rows, or
//                                                      global conic rows +
//                                                      tile origins)
// Two kernels, each templated on LOCALIZE:
//   LOCALIZE = false: rows are [c0, c1, c2, c3, c4, c5, log_op, 0] and
//     q = c0 + c1 lx + c2 ly + c3 lx^2 + c4 lx ly + c5 ly^2 at the tile-local
//     pixel (lx, ly) = (i % tw, i / tw), summed in this order;
//   LOCALIZE = true: rows are [A, B, C, gx, gy, log_op, _, _] in global pixel
//     coordinates and q is the direct conic form of composite.cu at
//     (lx + ox, ly + oy).
// Both give accum (T, P, 4) = sum of w_i [r, g, b, depth], NOT composited over
// a background, and tfinal (T, P, 1), the transmittance where the pixel
// ended. The blend rules (1/255 floor, 0.99 clamp, sticky termination at
// T (1 - alpha) < 1e-4 that excludes the Gaussian that triggers it) are
// composite_common.cuh's, shared with the channel-major kernels. Slots at or
// past min(count, K) are never read.
//
// Backward. Per pixel, A_p = g_accum . accum + g_tfinal tfinal is formed in
// the prologue from the two cotangents and the forward's own outputs; the
// forward is replayed front to back and every contributing Gaussian i gets
//   cg_i = g_accum . color_i;  P_i = sum_{j<=i} w_j cg_j
//   dalpha_i = T_i cg_i - (A_p - P_i) / (1 - alpha_i);  dq_i = dalpha_i exp(q_i)
// (unclamped d alpha / d q, also where alpha was clamped). Summed over the
// tile's pixels: dcolor_i = sum w_i g_accum, and
//   packed rows:  dquad = [sum dq, sum dq lx, sum dq ly, sum dq lx^2,
//                          sum dq lx ly, sum dq ly^2, 0, 0]
//                 (log_op is reached through c0 only: lanes 6, 7 stay zero);
//   LOCALIZE:     dquad = [dA, dB, dC, dgx, dgy, dlog_op, 0, 0], each visit's
//                 term taken directly from dx, dy as in composite_bwd.cu.
// The TPU kernel gets the LOCALIZE gradient by summing the packed form and
// applying the packing's transpose once per row. In float32 that transpose
// cancels terms of size dq lx^2 against each other to leave dq dx^2 (lx up to
// 128 pixels, dx a few): on an H100 it left dA 1.8e-4 of the row's largest
// value away from the plain version. The direct terms have no cancellation.
//
// What is not carried over from the TPU kernels: the (T, K / chunk) grid
// with block revisiting and scalar-prefetched counts (blocks here run in no
// order; the walk over a tile's rows is a loop inside the block), the
// triangular-matmul prefixes and their bf16 option, the VMEM cap, and the v2
// backward's unwritten dead regions: the caller zeroes dquad and dcolor and
// the kernel adds to live rows only.
//
// Design: that of composite.cu and composite_bwd.cu with a row-major load. A
// block owns 256 pixels of one tile and stages 256 rows at a time in shared
// memory (three 16-byte loads per thread, transposed into 11 channel rows);
// the backward reduces over pixels by warp shuffle, shared-memory atomics per
// batch, then global atomics across the tile's blocks. Bound: ~13 f32
// operations per (pixel, Gaussian) visit plus ~45 per contributing visit of
// the backward, against 48 bytes per live row and 20 (forward) or 40
// (backward) per pixel: bound by operations at the avatar's shapes (PERF.md
// holds the bound and the measured times).
//
// Build with -fmad=false and without fast math (see composite_common.cuh).

#include "composite_common.cuh"

namespace {

using namespace composite;

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kStaged = 11;  // 6 coefficients, 4 colors, log_op of packed rows

// Thread x stages row k (k < n) of a tile's (K, 8) and (K, 4) row tables as
// s[.][x] = [quad 0-5, r, g, b, depth, quad 6].
__device__ __forceinline__ void stage_row_rm(float (*s)[kBlock], const float* __restrict__ quad,
                                             const float* __restrict__ color, int k, int n) {
  if (k >= n) return;
  const float4 a = reinterpret_cast<const float4*>(quad)[2 * k];
  const float4 b = reinterpret_cast<const float4*>(quad)[2 * k + 1];
  const float4 c = reinterpret_cast<const float4*>(color)[k];
  const int x = threadIdx.x;
  s[0][x] = a.x; s[1][x] = a.y; s[2][x] = a.z; s[3][x] = a.w;
  s[4][x] = b.x; s[5][x] = b.y; s[10][x] = b.z;
  s[6][x] = c.x; s[7][x] = c.y; s[8][x] = c.z; s[9][x] = c.w;
}

// Staged Gaussian j at the block's pixel: false when the pixel skips it.
// With LOCALIZE also dx, dy, the pixel's offset from the Gaussian's center.
template <bool LOCALIZE>
__device__ __forceinline__ bool reaches_rm(float (*s)[kBlock], int j, float lx, float ly,
                                           float ox, float oy, float& dx, float& dy,
                                           float& alpha_un) {
  if (LOCALIZE) return reaches(s, j, lx + ox, ly + oy, dx, dy, alpha_un);
  return reaches_packed(s, j, lx, ly, alpha_un);
}

template <bool LOCALIZE>
__global__ void __launch_bounds__(kBlock)
composite_rm_fwd_kernel(const float* __restrict__ quad, const float* __restrict__ color,
                        const int* __restrict__ counts, const float* __restrict__ origins,
                        float* __restrict__ accum, float* __restrict__ tfinal, int K, int th,
                        int tw) {
  __shared__ float s[kStaged][kBlock];
  const int t = blockIdx.x;
  const int n = min(counts[t], K);
  const int P = th * tw;
  const int i = blockIdx.y * kBlock + threadIdx.x;
  const bool inside = i < P;
  const float lx = (float)(i % tw), ly = (float)(i / tw);
  const float ox = LOCALIZE ? origins[2 * t] : 0.0f;
  const float oy = LOCALIZE ? origins[2 * t + 1] : 0.0f;
  const float* q_tile = quad + (long long)t * K * 8;
  const float* c_tile = color + (long long)t * K * 4;

  bool done = !inside;
  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
  for (int b = 0; b < n; b += kBlock) {
    // barrier before overwriting the batch; also the block's exit test
    if (__syncthreads_count(done) == kBlock) break;
    stage_row_rm(s, q_tile, c_tile, b + threadIdx.x, n);
    __syncthreads();
    const int m = min(kBlock, n - b);
    for (int j = 0; !done && j < m; ++j) {
      float dx, dy, alpha_un;
      if (!reaches_rm<LOCALIZE>(s, j, lx, ly, ox, oy, dx, dy, alpha_un)) continue;
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
    const long long p = (long long)t * P + i;
    reinterpret_cast<float4*>(accum)[p] = make_float4(c0, c1, c2, c3);
    tfinal[p] = T;
  }
}

template <bool LOCALIZE>
__global__ void __launch_bounds__(kBlock)
composite_rm_bwd_kernel(const float* __restrict__ quad, const float* __restrict__ color,
                        const int* __restrict__ counts, const float* __restrict__ origins,
                        const float* __restrict__ g_accum, const float* __restrict__ g_tfinal,
                        const float* __restrict__ accum, const float* __restrict__ tfinal,
                        float* __restrict__ dquad, float* __restrict__ dcolor, int K, int th,
                        int tw) {
  __shared__ float s[kStaged][kBlock];
  __shared__ float acc[kChannels][kBlock];
  const int t = blockIdx.x;
  const int n = min(counts[t], K);
  const int P = th * tw;
  const int i = blockIdx.y * kBlock + threadIdx.x;
  const bool inside = i < P;
  const float lx = (float)(i % tw), ly = (float)(i / tw);
  const float ox = LOCALIZE ? origins[2 * t] : 0.0f;
  const float oy = LOCALIZE ? origins[2 * t + 1] : 0.0f;
  const int lane = threadIdx.x & 31;
  const float* q_tile = quad + (long long)t * K * 8;
  const float* c_tile = color + (long long)t * K * 4;

  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, g3 = 0.0f, A_p = 0.0f;
  if (inside) {
    const long long p = (long long)t * P + i;
    const float4 g = reinterpret_cast<const float4*>(g_accum)[p];
    const float4 a = reinterpret_cast<const float4*>(accum)[p];
    g0 = g.x; g1 = g.y; g2 = g.z; g3 = g.w;
    A_p = g0 * a.x + g1 * a.y + g2 * a.z + g3 * a.w + g_tfinal[p] * tfinal[p];
  }

  bool done = !inside;
  float T = 1.0f, prefix = 0.0f;
  for (int b = 0; b < n; b += kBlock) {
    if (__syncthreads_count(done) == kBlock) break;
    const int k = b + threadIdx.x;
    stage_row_rm(s, q_tile, c_tile, k, n);
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
        float dx = 0.0f, dy = 0.0f, alpha_un;
        if (reaches_rm<LOCALIZE>(s, j, lx, ly, ox, oy, dx, dy, alpha_un)) {
          const float alpha = clamped(alpha_un);
          const float one_m = 1.0f - alpha;
          const float test_T = T * one_m;
          if (ends_pixel(test_T)) {
            done = true;
          } else {
            hit = true;
            const float w = alpha * T;
            const float cg = g0 * s[6][j] + g1 * s[7][j] + g2 * s[8][j] + g3 * s[9][j];
            prefix = prefix + w * cg;
            const float dalpha = T * cg - (A_p - prefix) / one_m;
            const float dq = dalpha * alpha_un;
            if (LOCALIZE) {
              const float A = s[0][j], B = s[1][j], C = s[2][j];
              v[0] = -0.5f * (dx * dx) * dq;
              v[1] = -(dx * dy) * dq;
              v[2] = -0.5f * (dy * dy) * dq;
              v[3] = (A * dx + B * dy) * dq;
              v[4] = (B * dx + C * dy) * dq;
              v[5] = dq;
            } else {
              v[0] = dq;
              v[1] = dq * lx;
              v[2] = dq * ly;
              v[3] = dq * (lx * lx);
              v[4] = dq * (lx * ly);
              v[5] = dq * (ly * ly);
            }
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
      const int x = threadIdx.x;
      float* dq_row = dquad + ((long long)t * K + k) * 8;
      float* dc_row = dcolor + ((long long)t * K + k) * 4;
#pragma unroll
      for (int c = 0; c < kChannels; ++c) {
        const float a = acc[c][x];
        if (a != 0.0f) atomicAdd(c < 6 ? dq_row + c : dc_row + (c - 6), a);
      }
    }
  }
}

template <bool LOCALIZE>
int launch_fwd(const float* quad, const float* color, const int* counts, const float* origins,
               float* accum, float* tfinal, int T, int K, int th, int tw, void* stream) {
  const dim3 grid(T, (th * tw + kBlock - 1) / kBlock);
  composite_rm_fwd_kernel<LOCALIZE><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      quad, color, counts, origins, accum, tfinal, K, th, tw);
  return (int)cudaGetLastError();
}

template <bool LOCALIZE>
int launch_bwd(const float* quad, const float* color, const int* counts, const float* origins,
               const float* g_accum, const float* g_tfinal, const float* accum,
               const float* tfinal, float* dquad, float* dcolor, int T, int K, int th, int tw,
               void* stream) {
  const dim3 grid(T, (th * tw + kBlock - 1) / kBlock);
  composite_rm_bwd_kernel<LOCALIZE><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      quad, color, counts, origins, g_accum, g_tfinal, accum, tfinal, dquad, dcolor, K, th, tw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// quad (T, K, 8) f32 packed rows; color (T, K, 4) f32; counts (T,) i32;
// accum (T, th*tw, 4) f32; tfinal (T, th*tw, 1) f32. Every pointer 16-byte
// aligned. Returns cudaGetLastError() after the launch.
int composite_tiles_fwd_v2(const float* quad, const float* color, const int* counts,
                           float* accum, float* tfinal, int T, int K, int th, int tw,
                           void* stream) {
  return launch_fwd<false>(quad, color, counts, nullptr, accum, tfinal, T, K, th, tw, stream);
}

// The same with optional origins (T, 2) f32: when given, quad holds global
// conic rows; when null, packed rows as above.
int composite_tiles_fwd(const float* quad, const float* color, const int* counts,
                        const float* origins, float* accum, float* tfinal, int T, int K, int th,
                        int tw, void* stream) {
  if (origins != nullptr)
    return launch_fwd<true>(quad, color, counts, origins, accum, tfinal, T, K, th, tw, stream);
  return launch_fwd<false>(quad, color, counts, nullptr, accum, tfinal, T, K, th, tw, stream);
}

// g_accum, accum (T, th*tw, 4) f32; g_tfinal, tfinal (T, th*tw, 1) f32: the
// cotangents and the forward's own outputs. dquad (T, K, 8), dcolor (T, K, 4)
// f32, zeroed by the caller: dead slots and lanes 6-7 stay zero.
int composite_tiles_bwd_v2(const float* quad, const float* color, const int* counts,
                           const float* g_accum, const float* g_tfinal, const float* accum,
                           const float* tfinal, float* dquad, float* dcolor, int T, int K, int th,
                           int tw, void* stream) {
  return launch_bwd<false>(quad, color, counts, nullptr, g_accum, g_tfinal, accum, tfinal, dquad,
                           dcolor, T, K, th, tw, stream);
}

// The same with optional origins: when given, dquad comes in the global row
// layout [dA, dB, dC, dgx, dgy, dlog_op, 0, 0].
int composite_tiles_bwd(const float* quad, const float* color, const int* counts,
                        const float* origins, const float* g_accum, const float* g_tfinal,
                        const float* accum, const float* tfinal, float* dquad, float* dcolor,
                        int T, int K, int th, int tw, void* stream) {
  if (origins != nullptr)
    return launch_bwd<true>(quad, color, counts, origins, g_accum, g_tfinal, accum, tfinal, dquad,
                            dcolor, T, K, th, tw, stream);
  return launch_bwd<false>(quad, color, counts, nullptr, g_accum, g_tfinal, accum, tfinal, dquad,
                           dcolor, T, K, th, tw, stream);
}

}  // extern "C"
