// Tile compositing kernels for Hopper (sm_90a): the forward of the 3DGS
// rasterizer's front-to-back alpha blend.
//
// Replaces four Pallas TPU kernels of
// exavatar_release_tpu/ops/rasterizer/pallas_kernels.py:
//   composite_tiles_fwd_cm   (dense (T, 12, K) depth-sorted windows)
//   composite_pairs_fwd_rg   (ragged chunk-aligned (12, Pa) pair list)
//   composite_tiles_fwd_v2   (kernel_v=2: packed (T, K, 8) rows, (T, K, 4) colors)
//   composite_tiles_fwd      (global conic (T, K, 8) rows with tile origins;
//                             without origins, packed rows: kernel_v=2's body)
// All compute renderCUDA's rules, as jax_ref.py states them:
//   q = log_op - 0.5 (A dx^2 + C dy^2) - B dx dy   (direct conic form), or
//   q = c0 + c1 lx + c2 ly + c3 lx^2 + c4 lx ly + c5 ly^2 at the tile-local
//       pixel, summed in this order (packed rows, kernel_v=2)
//   skip when q > log_op or exp(q) < 1/255;  alpha = min(0.99, exp(q))
//   test_T = T (1 - alpha); test_T < 1e-4 ends the pixel, excluding the
//   Gaussian that triggers it;  C += col alpha T;  T = test_T
//   out = [rgb + bg T, depth, 1 - T]  (row-major rows: accum = C, NOT over a
//   background, and tfinal = T)
// T is a sequential f32 product, as in the plain PyTorch twin
// (ops/rasterizer/kernels.py). The TPU kernels' log-space triangular-matmul
// prefix was a device for the TPU's matrix unit and is not carried over.
// The TPU kernel carried acc/T/done across sequential grid steps over chunk
// slots (the ragged kernel's output-block revisit); blocks here run in no
// order, so that carry is the loop over the tile's slot range inside one
// block.
//
// Bound: the work is ~13 f32 operations (one exp) per (pixel, Gaussian)
// visit before termination, against 40 bytes per live row (48 row-major)
// and 20 per output pixel, so on this card the kernels are bound by
// operations (PERF.md holds the bound and the measured times at the avatar's
// shapes).
//
// Design, one body (composite_pairs_range) for the four kernels, templated
// on the row kind (composite_common.cuh RowKind): a block composites rows
// [begin, begin + n) of a row table into its part of one tile, staging 256
// rows at a time in shared memory. The dense kernel hands it the tile's
// window (stride K, begin 0, n = min(count, K)), the pair-major kernel the
// tile's slot range of the pair list, the row-major kernels a tile's rows
// (n = min(count, K)): packed rows at origin (0, 0), whose pixels, patches
// and boxes are tile-local, or global conic rows at the tile's origin. The
// kind changes the staging (three 16-byte loads a row for row-major
// tables), q and its box (pixel_box, packed_pixel_box), and the output; the
// schedule is one. The body cuts the per-visit cost that is not the blend's
// arithmetic: shared-memory reads, exps of Gaussians that are skipped, and
// visits of Gaussians far from the pixels.
// - A thread owns R = kPairsR = 2 pixels (a column of two), and a warp a
//   compact patch (8 x 8 pixels): a block covers 512 pixels, so each row is
//   staged 8 times per 32 x 128 tile, not 16 times. A visit reads the row
//   from shared memory once for both pixels (three broadcast vector loads),
//   and the two pixels' chains are independent.
// - Each staged row carries a conservative pixel box (composite_common.cuh
//   pixel_box, packed_pixel_box); a warp whose patch misses it skips the row
//   with one warp-uniform test, before any exp. This is exact: every pixel
//   of the patch would skip that row.
// - The exp gate (reaches_gated, reaches_packed_gated): q < kQGate skips
//   without an expf (at the avatar's train render about 70% of the visits
//   contribute nothing).
// Each pixel keeps its own sticky termination; a thread leaves the batch
// when both its pixels are done, the block when all are. The grid is
// one-dimensional, pair_blocks(th, tw) adjacent blocks a tile.
//
// The stage probes of kernel 5 (composite_tiles_fwd_variant_kernel<V>,
// replacing the Pallas kernel of tools/kvariants.py build_fwd) launch kernel
// 5's grid on this body under a variant V: `if constexpr` hooks that stub or
// reformulate one stage, described in composite_probes.cuh.
//
// The thresholds, the row staging and the blend of one Gaussian at one pixel
// are in composite_common.cuh, which the backward kernels share. Build with
// -fmad=false and without fast math (see there).

#include "composite_probes.cuh"

namespace {

using namespace composite;

// Composite rows [begin, begin + n) of a row table into the pixels of one
// tile, kPairsR pixels a thread (pair_pixels, blk the block's index within
// the tile). kConicCM: a channel-major table (stride), out_tile (5, P) over
// the background bg. Row-major kinds: a tile's rows (rows = quad (K, 8),
// color (K, 4), begin 0; packed rows at origin (0, 0)), out_tile = accum (P,
// 4) and tf_tile = tfinal (P,). V: a stage probe's variant
// (composite_probes.cuh), on global conic row-major rows only; at kBase
// every hook below folds away.
template <RowKind KIND, int V = kBase>
__device__ __forceinline__ void composite_pairs_range(const float* __restrict__ rows,
                                                     const float* __restrict__ color,
                                                     long long stride, int blk, long long begin,
                                                     int n, float ox, float oy, int th, int tw,
                                                     const float* __restrict__ bg,
                                                     float* __restrict__ out_tile,
                                                     float* __restrict__ tf_tile) {
  constexpr int R = kPairsR;
  constexpr bool PACKED = packed_q(KIND);
  static_assert(V == kBase || KIND == RowKind::kConicRM,
                "the stage probes run on global conic row-major rows");
  constexpr bool PIPE = V == kPipe;
  constexpr bool STUB = V == kNoExp;
  // pipe: the batch that blends and the next one
  __shared__ RowsOf<KIND> s_buf[PIPE ? 2 : 1];
  const int P = th * tw;
  const PairPixels pp = pair_pixels(blk, tw, ox, oy);
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

  // T: logsp its log; the chunk forms T0, at the chunk's start, and done there
  bool done[R];
  float T[R], c0[R], c1[R], c2[R], c3[R];
  bool all_done = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    done[r] = pp.x >= tw || pp.y + r >= th;
    all_done = all_done && done[r];
    T[r] = kLogT<V> ? 0.0f : 1.0f;
    c0[r] = c1[r] = c2[r] = c3[r] = 0.0f;
  }
  [[maybe_unused]] ConicRowRegs next;  // pipe: this thread's row of the next batch
  if constexpr (PIPE)
    stage_rows<KIND>(s_buf[0], rows, color, stride, begin, threadIdx.x, n, th, tw);
  for (int b = 0, buf = 0; b < n; b += kBlock, buf ^= 1) {
    RowsOf<KIND>& s = s_buf[PIPE ? buf : 0];
    // barrier before overwriting the batch; also the block's exit test
    if constexpr (V == kNoSkip) {
      __syncthreads();
    } else if (__syncthreads_count(all_done) == kBlock) {
      break;
    }
    if constexpr (PIPE) {
      load_conic_rm_row(next, rows, color, b + kBlock + threadIdx.x, n);
    } else {
      stage_rows<KIND>(s, rows, color, stride, begin, b + threadIdx.x, n, th, tw);
      __syncthreads();
    }
    const int m = min(kBlock, n - b);
    if constexpr (kChunked<V>) {
      // the chunk's sums of wlog (all, and of the rows not dead); the dead of
      // the last row a pixel evaluated, and whether that row ends the chunk
      float cum[R], kept[R];
      bool dead[R], last[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        cum[r] = kept[r] = 0.0f;
        dead[r] = last[r] = false;
      }
      // all_done stays the chunk start's: no pixel ends inside the chunk
      for (int j = 0; !all_done && j < m; ++j) {
        if (misses(s.box[j], pp.patch)) continue;
        const float4 g = s.lo[j];
        const float2 h = s.hi[j];
        const float4 col = s.col[j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (done[r]) continue;
          float dx, dy;
          const float q = conic_q(g.x, g.y, g.z, g.w, h.x, h.y, px, py[r], dx, dy);
          if (q < kQGate) continue;
          const float e = exp_v<STUB>(q);
          if (!(q <= h.y && e >= kAlphaMin)) continue;
          const float alpha = clamped(e);
          const float wlog = log1p_v<STUB>(-alpha);
          const float T_raw = exp_v<STUB>(V == kNoMM ? wlog : cum[r]) * T[r];
          dead[r] = ends_pixel(T_raw * (1.0f - alpha));
          last[r] = j == m - 1;
          cum[r] = cum[r] + wlog;
          if (dead[r]) continue;
          const float w = alpha * T_raw;
          c0[r] = c0[r] + w * col.x;
          c1[r] = c1[r] + w * col.y;
          c2[r] = c2[r] + w * col.z;
          c3[r] = c3[r] + w * col.w;
          kept[r] = kept[r] + wlog;
        }
      }
      // the chunk's end; a last row the pixel skipped has alpha = 0
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (done[r]) continue;
        if (!last[r]) dead[r] = ends_pixel(V == kNoMM ? T[r] : exp_v<STUB>(cum[r]) * T[r]);
        T[r] = T[r] * exp_v<STUB>(kept[r]);
        done[r] = dead[r];
      }
      all_done = true;
#pragma unroll
      for (int r = 0; r < R; ++r) all_done = all_done && done[r];
    } else if constexpr (V == kNoSkip) {
      for (int j = 0; j < m; ++j) {
        const float4 g = s.lo[j];
        const float2 h = s.hi[j];
        const float4 col = s.col[j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float dx, dy;
          const float q = conic_q(g.x, g.y, g.z, g.w, h.x, h.y, px, py[r], dx, dy);
          const float alpha_un = expf(q);
          const bool hit = q <= h.y && alpha_un >= kAlphaMin && !done[r];
          const float alpha = clamped(alpha_un);
          const float test_T = T[r] * (1.0f - alpha);
          const bool end = hit && ends_pixel(test_T);
          const bool add = hit && !end;
          done[r] = done[r] || end;
          const float w = add ? alpha * T[r] : 0.0f;
          c0[r] = c0[r] + w * col.x;
          c1[r] = c1[r] + w * col.y;
          c2[r] = c2[r] + w * col.z;
          c3[r] = c3[r] + w * col.w;
          T[r] = add ? test_T : T[r];
        }
      }
    } else {
      for (int j = 0; !all_done && j < m; ++j) {
        if (misses(s.box[j], pp.patch)) continue;
        const float4 g = s.lo[j];
        const auto h = s.hi[j];
        const float4 col = s.col[j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (done[r]) continue;
          if constexpr (kLogT<V>) {
            float dx, dy;
            const float q = conic_q(g.x, g.y, g.z, g.w, h.x, h.y, px, py[r], dx, dy);
            if (q < kQGate) continue;
            const float alpha_un = expf(q);
            if (!(q <= h.y && alpha_un >= kAlphaMin)) continue;
            const float wl = log1pf(-clamped(alpha_un));
            if (T[r] + wl < kLnTermEps) {
              done[r] = true;
              continue;
            }
            const float w = expf(fminf(q, kLnAlphaMax) + T[r]);
            c0[r] = c0[r] + w * col.x;
            c1[r] = c1[r] + w * col.y;
            c2[r] = c2[r] + w * col.z;
            c3[r] = c3[r] + w * col.w;
            T[r] = T[r] + wl;
          } else {
            float alpha_un;
            if constexpr (PACKED) {
              if (!reaches_packed_gated(g, h, px, py[r], xx, xy[r], yy[r], alpha_un)) continue;
            } else {
              float dx, dy;
              if (!reaches_gated(g.x, g.y, g.z, g.w, h.x, h.y, px, py[r], dx, dy, alpha_un))
                continue;
            }
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
        }
        all_done = true;
#pragma unroll
        for (int r = 0; r < R; ++r) all_done = all_done && done[r];
      }
    }
    if constexpr (PIPE) store_conic_rm_row(s_buf[buf ^ 1], next, b + kBlock + threadIdx.x, n);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int x = pp.x, y = pp.y + r;
    if (x >= tw || y >= th) continue;
    const int i = y * tw + x;
    if constexpr (row_major(KIND)) {
      reinterpret_cast<float4*>(out_tile)[i] = make_float4(c0[r], c1[r], c2[r], c3[r]);
      tf_tile[i] = kLogT<V> ? expf(T[r]) : T[r];
    } else {
      out_tile[0 * P + i] = c0[r] + T[r] * bg[0];
      out_tile[1 * P + i] = c1[r] + T[r] * bg[1];
      out_tile[2 * P + i] = c2[r] + T[r] * bg[2];
      out_tile[3 * P + i] = c3[r];
      out_tile[4 * P + i] = 1.0f - T[r];
    }
  }
}

// the first min(counts[t], K) rows of tile t's window win[t] (12, K)
__global__ void __launch_bounds__(kBlock, 2)
composite_tiles_fwd_cm_kernel(const float* __restrict__ win, const int* __restrict__ counts,
                              const float* __restrict__ origins, const float* __restrict__ bg,
                              float* __restrict__ out, int K, int th, int tw) {
  const int nb = pair_blocks(th, tw);
  const int t = blockIdx.x / nb;
  const int blk = blockIdx.x - t * nb;
  composite_pairs_range<RowKind::kConicCM>(win + (long long)t * 12 * K, nullptr, K, blk, 0,
                                           min(counts[t], K), origins[2 * t],
                                           origins[2 * t + 1], th, tw, bg,
                                           out + (long long)t * 5 * th * tw, nullptr);
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
  composite_pairs_range<RowKind::kConicCM>(rows, nullptr, Pa, blk,
                                           (long long)slot_start[t] * chunk,
                                           slot_count[t] * chunk, ox, oy, th, tw, bg,
                                           out + (long long)t * 5 * th * tw, nullptr);
}

// the first min(counts[t], K) packed rows of tile t: quad (T, K, 8), color
// (T, K, 4) -> accum (T, P, 4), tfinal (T, P, 1)
__global__ void __launch_bounds__(kBlock, 2)
composite_tiles_fwd_v2_kernel(const float* __restrict__ quad, const float* __restrict__ color,
                              const int* __restrict__ counts, float* __restrict__ accum,
                              float* __restrict__ tfinal, int K, int th, int tw) {
  const int nb = pair_blocks(th, tw);
  const int t = blockIdx.x / nb;
  const int blk = blockIdx.x - t * nb;
  const long long P = (long long)th * tw;
  composite_pairs_range<RowKind::kPackedRM>(quad + (long long)t * K * 8,
                                            color + (long long)t * K * 4, 0, blk, 0,
                                            min(counts[t], K), 0.0f, 0.0f, th, tw, nullptr,
                                            accum + t * P * 4, tfinal + t * P);
}

// the first min(counts[t], K) global conic rows of tile t at its origin
// origins[t]: quad (T, K, 8), color (T, K, 4) -> accum (T, P, 4), tfinal
// (T, P, 1). The origin is passed through, not rebuilt from the tile grid:
// a caller may shift it (a band offset, half a pixel).
__global__ void __launch_bounds__(kBlock, 2)
composite_tiles_fwd_kernel(const float* __restrict__ quad, const float* __restrict__ color,
                           const int* __restrict__ counts, const float* __restrict__ origins,
                           float* __restrict__ accum, float* __restrict__ tfinal, int K, int th,
                           int tw) {
  const int nb = pair_blocks(th, tw);
  const int t = blockIdx.x / nb;
  const int blk = blockIdx.x - t * nb;
  const long long P = (long long)th * tw;
  composite_pairs_range<RowKind::kConicRM>(quad + (long long)t * K * 8,
                                           color + (long long)t * K * 4, 0, blk, 0,
                                           min(counts[t], K), origins[2 * t], origins[2 * t + 1],
                                           th, tw, nullptr, accum + t * P * 4, tfinal + t * P);
}

// Stage probe V (composite_probes.cuh) of kernel 5: kernel 5's grid and
// arguments, and its body under V. V = kBase is kernel 5's code.
template <int V>
__global__ void __launch_bounds__(kBlock, 2)
composite_tiles_fwd_variant_kernel(const float* __restrict__ quad,
                                   const float* __restrict__ color,
                                   const int* __restrict__ counts,
                                   const float* __restrict__ origins, float* __restrict__ accum,
                                   float* __restrict__ tfinal, int K, int th, int tw) {
  const int nb = pair_blocks(th, tw);
  const int t = blockIdx.x / nb;
  const int blk = blockIdx.x - t * nb;
  const long long P = (long long)th * tw;
  composite_pairs_range<RowKind::kConicRM, V>(quad + (long long)t * K * 8,
                                              color + (long long)t * K * 4, 0, blk, 0,
                                              min(counts[t], K), origins[2 * t],
                                              origins[2 * t + 1], th, tw, nullptr,
                                              accum + t * P * 4, tfinal + t * P);
}

template <int V>
int launch_fwd_variant(const float* quad, const float* color, const int* counts,
                       const float* origins, float* accum, float* tfinal, int T, int K, int th,
                       int tw, void* stream) {
  const dim3 grid(T * pair_blocks(th, tw));
  composite_tiles_fwd_variant_kernel<V><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      quad, color, counts, origins, accum, tfinal, K, th, tw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// win (T, 12, K) f32; counts (T,) i32; origins (T, 2) f32; bg (3,) f32;
// out (T, 5, th*tw) f32. Returns cudaGetLastError() after the launch.
int composite_tiles_fwd_cm(const float* win, const int* counts, const float* origins,
                           const float* bg, float* out, int T, int K, int th, int tw,
                           void* stream) {
  const dim3 grid(T * pair_blocks(th, tw));
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

// quad (T, K, 8) f32 packed rows [c0..c5, log_op, 0]; color (T, K, 4) f32;
// counts (T,) i32; accum (T, th*tw, 4) f32; tfinal (T, th*tw, 1) f32. quad,
// color and accum 16-byte aligned.
int composite_tiles_fwd_v2(const float* quad, const float* color, const int* counts,
                           float* accum, float* tfinal, int T, int K, int th, int tw,
                           void* stream) {
  const dim3 grid(T * pair_blocks(th, tw));
  composite_tiles_fwd_v2_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      quad, color, counts, accum, tfinal, K, th, tw);
  return (int)cudaGetLastError();
}

// quad (T, K, 8) f32: global conic rows [A, B, C, gx, gy, log_op, _, _] when
// origins (T, 2) f32 are given, packed rows [c0..c5, log_op, 0] when origins
// is null (then composite_tiles_fwd_v2's kernel); color (T, K, 4) f32;
// counts (T,) i32; accum (T, th*tw, 4) f32; tfinal (T, th*tw, 1) f32. quad,
// color and accum 16-byte aligned.
int composite_tiles_fwd(const float* quad, const float* color, const int* counts,
                        const float* origins, float* accum, float* tfinal, int T, int K, int th,
                        int tw, void* stream) {
  if (origins == nullptr)
    return composite_tiles_fwd_v2(quad, color, counts, accum, tfinal, T, K, th, tw, stream);
  const dim3 grid(T * pair_blocks(th, tw));
  composite_tiles_fwd_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      quad, color, counts, origins, accum, tfinal, K, th, tw);
  return (int)cudaGetLastError();
}

// The stage probes of kernel 5 under `variant` (composite_probes.cuh enum
// Variant; kBase is kernel 5 itself, launched as a probe): the arguments of
// composite_tiles_fwd with origins, which must be given. Every pointer
// 16-byte aligned. Returns cudaGetLastError() after the launch; a variant
// the forward has not returns cudaErrorInvalidValue.
int composite_rm_fwd_variant(int variant, const float* quad, const float* color, const int* counts,
                             const float* origins, float* accum, float* tfinal, int T, int K,
                             int th, int tw, void* stream) {
#define FWD(V) \
  launch_fwd_variant<V>(quad, color, counts, origins, accum, tfinal, T, K, th, tw, stream)
  switch (variant) {
    case kBase: return FWD(kBase);
    case kNoExp: return FWD(kNoExp);
    case kNoMM: return FWD(kNoMM);
    case kNoSkip: return FWD(kNoSkip);
    case kLogSp: return FWD(kLogSp);
    case kPipe: return FWD(kPipe);
    case kChunk: return FWD(kChunk);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FWD
}

}  // extern "C"
