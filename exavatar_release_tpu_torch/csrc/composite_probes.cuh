// The stage probes (kernels 9 and 10: composite_tiles_fwd_variant_kernel in
// composite.cu, composite_tiles_bwd_variant_kernel in composite_bwd.cu):
// instruments that attribute the time of the pair bodies to their stages.
// They replace the probes of tools/kvariants.py (build_fwd, build_bwd), which
// stub or reformulate stages of the Pallas TPU kernels composite_tiles_fwd /
// composite_tiles_bwd with tile origins. A variant V is a set of `if
// constexpr` hooks of composite_pairs_range<RowKind::kConicRM, V> or
// composite_pairs_range_bwd<RowKind::kConicRM, V>; at V = kBase every hook
// folds away and the body is kernel 5's or 6's own, the base every probe
// delta is taken against. No main path launches a variant.
//
// What each variant means on the pair body (two pixels a thread, an 8 x 8
// patch a warp, the box cull, the exp gate). Exact variants give base's
// output:
//   noskip     (forward) no box cull, no exp gate, no per-thread done test
//              and no block exit: every thread evaluates every row for both
//              pixels; a finished pixel adds zero by selects
//   logsp      log T carried per pixel: w = exp(min(q, log 0.99) + log T),
//              the test log T + log1p(-alpha) < log 1e-4
//   pipe       two staging buffers: the next batch's three 16-byte loads go
//              into registers while the current batch blends, its rows and
//              their boxes are stored afterwards; one barrier per batch in
//              the forward
//   fusedgrad  (backward) a thread's two-pixel sums of the ten values summed
//              over the warp by one butterfly (reduce_butterfly): 16
//              shuffles instead of 50, and ten lanes add to shared memory
//   noT        (backward) the warp's values transposed through a per-warp
//              (10, 33) scratch and summed by ten lanes, no shuffles
//   noT+logsp  both
// Stubs, and their baseline, follow the Pallas kernels' chunk formulation
// with chunk = the 256-row staging batch. Per pixel, T0 and done hold at the
// chunk start: no pixel ends inside a chunk. Row i of the chunk has T_raw =
// E(cum_i) T0, cum_i the sum of wlog = L(-alpha) over the chunk's rows before
// i, and dead_i = T_raw (1 - alpha_i) < 1e-4, not sticky inside the chunk.
// At its end T0 *= E(sum of the wlog of the rows not dead), done = dead of
// the chunk's last row, and the backward's prefix carry takes that row's
// P_incl. A pixel that skips the last row (culled, gated or invalid: alpha
// = 0) still takes done = E(cum) T0 < 1e-4 from it.
//   chunk      E = exp, L = log1p: the TPU formulation itself, the baseline
//              of the two below (equal to base in exact arithmetic)
//   noexp      E(x) = 0.25 x + 1 and L(x) = 0.5 x, alpha_un too
//   nomm       cum_i := wlog_i; the backward's P_incl := carry + w cg (no
//              serial prefix inside the chunk)
// and, in base's sequential form:
//   nograd     (backward) the replay without the reduction over pixels (no
//              ballot, shuffles or atomics): dquad = dcolor = 0
//   nodeloc    (backward) dquad the packed-basis sums [dq, dq lx, dq ly,
//              dq lx^2, dq lx ly, dq ly^2] at the tile-local pixel
// The cull stays exact under every variant that keeps it: outside its box
// a row has q < -ln 255, and the gate skips q < -5.55, where alpha is 0
// under exp and under the stub alike (0.25 q + 1 >= 1/255 needs q >= -3.98).
// Build with -fmad=false and without fast math, like the bodies.
#pragma once

#include "composite_common.cuh"

namespace composite {

// ops/rasterizer/kernels.py VARIANT_IDS
enum Variant : int {
  kBase = 0, kNoExp = 1, kNoMM = 2, kNoSkip = 3, kLogSp = 4, kPipe = 5, kNoGrad = 6,
  kFusedGrad = 7, kNoT = 8, kNoDeloc = 9, kNoTLogSp = 10, kChunk = 11,
};

// log(0.99) and log(1e-4), rounded as PyTorch rounds the doubles
constexpr float kLnAlphaMax = (float)-0.01005033585350145;
constexpr float kLnTermEps = (float)-9.210340371976182;

template <int V>
constexpr bool kChunked = V == kNoExp || V == kNoMM || V == kChunk;
template <int V>
constexpr bool kLogT = V == kLogSp || V == kNoTLogSp;

// E and L of the chunk forms: exp and log1p, or the noexp stub's
template <bool STUB>
__device__ __forceinline__ float exp_v(float x) {
  return STUB ? x * 0.25f + 1.0f : expf(x);
}

template <bool STUB>
__device__ __forceinline__ float log1p_v(float x) {
  return STUB ? x * 0.5f : log1pf(x);
}

// One step of the butterfly: lanes whose bit 2 HALF is set keep the upper
// HALF of their 2 HALF values, the others the lower, each adding the copy of
// the partner lane across that bit.
template <int HALF>
__device__ __forceinline__ void butterfly_step(float (&u)[16], int lane) {
  const bool upper = (lane & (2 * HALF)) != 0;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = upper ? u[k] : u[k + HALF];
    const float keep = upper ? u[k + HALF] : u[k];
    u[k] = keep + __shfl_xor_sync(kFullWarp, send, 2 * HALF);
  }
}

// fusedgrad: the warp's ten values summed over its lanes by one butterfly
// and added to acc[.][j]; nothing when no lane of the warp hit row j. After
// four steps lane l holds slot l >> 1 (16 slots, six zero) summed over the
// 16 lanes that differ from it in bits 1-4.
__device__ __forceinline__ void reduce_butterfly(const float (&v)[kChannels], bool hit,
                                                 float (*acc)[kBlock], int j, int lane) {
  if (__ballot_sync(kFullWarp, hit) == 0u) return;
  float u[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) u[c] = c < kChannels ? v[c] : 0.0f;
  butterfly_step<8>(u, lane);
  butterfly_step<4>(u, lane);
  butterfly_step<2>(u, lane);
  butterfly_step<1>(u, lane);
  u[0] += __shfl_xor_sync(kFullWarp, u[0], 1);
  const int slot = lane >> 1;
  if ((lane & 1) == 0 && slot < kChannels) atomicAdd(&acc[slot][j], u[0]);
}

// noT: the same sum through the warp's (kChannels, 33) scratch xs, each of
// ten lanes adding up one value's 32 lanes in lane order.
__device__ __forceinline__ void reduce_transpose(const float (&v)[kChannels], bool hit,
                                                 float (*acc)[kBlock], float (*xs)[33], int j,
                                                 int lane) {
  if (__ballot_sync(kFullWarp, hit) == 0u) return;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) xs[c][lane] = v[c];
  __syncwarp();
  if (lane < kChannels) {
    float sum = 0.0f;
#pragma unroll 8
    for (int x = 0; x < 32; ++x) sum += xs[lane][x];
    atomicAdd(&acc[lane][j], sum);
  }
  __syncwarp();
}

// nograd: a NaN anywhere in the replay adds zero to out, so the output stays
// zero and the compiler cannot drop the replay's arithmetic.
__device__ __forceinline__ void keep_alive(float sink, float* out) {
  if (isnan(sink)) atomicAdd(out, 0.0f);
}

}  // namespace composite
