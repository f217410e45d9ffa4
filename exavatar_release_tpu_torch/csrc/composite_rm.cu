// The stage probes of the row-major compositing kernels with origins
// (kernels 9 and 10) for Hopper (sm_90a): instruments that attribute the
// time of the one-pixel-a-thread design to its stages. They replace the
// probes of tools/kvariants.py (build_fwd, build_bwd), which stub or
// reformulate stages of the Pallas TPU kernels composite_tiles_fwd /
// composite_tiles_bwd (exavatar_release_tpu/ops/rasterizer/pallas_kernels.py)
// with tile origins. The product kernels 5 and 6 run the pair bodies of
// composite.cu and composite_bwd.cu; the design here is the one those
// bodies replaced (PERF.md), kept as the instrument's own base until the
// probes are re-pointed at the pair bodies.
//
// Two kernel templates, forward and backward, on global conic rows
// [A, B, C, gx, gy, log_op, _, _] (T, K, 8) with tile origins (T, 2) and
// colors (T, K, 4), q in the direct conic form at the pixel (lx + ox, ly +
// oy), (lx, ly) = (i % tw, i / tw). The forward gives accum (T, P, 4) = sum
// of w_i [r, g, b, depth], NOT composited over a background, and tfinal (T,
// P, 1), the transmittance where the pixel ended. The blend rules (1/255
// floor, 0.99 clamp, sticky termination at T (1 - alpha) < 1e-4 that excludes
// the Gaussian that triggers it) are composite_common.cuh's, shared with the
// pair bodies. Slots at or past min(count, K) are never read.
//
// Backward. Per pixel, A_p = g_accum . accum + g_tfinal tfinal is formed in
// the prologue from the two cotangents and the forward's own outputs; the
// forward is replayed front to back and every contributing Gaussian i gets
//   cg_i = g_accum . color_i;  P_i = sum_{j<=i} w_j cg_j
//   dalpha_i = T_i cg_i - (A_p - P_i) / (1 - alpha_i);  dq_i = dalpha_i exp(q_i)
// (unclamped d alpha / d q, also where alpha was clamped). Summed over the
// tile's pixels: dcolor_i = sum w_i g_accum and dquad = [dA, dB, dC, dgx,
// dgy, dlog_op, 0, 0], each visit's term taken directly from dx, dy as in
// composite_bwd.cu. The caller zeroes dquad and dcolor and the kernel adds
// to live rows only.
//
// Design: one pixel a thread. A block owns 256 pixels of one tile (a (T,
// ceil(P / 256)) grid) and stages 256 rows at a time in shared memory (three
// 16-byte loads per thread, transposed into 11 channel rows); the backward
// reduces over pixels by warp shuffle, shared-memory atomics per batch, then
// global atomics across the tile's blocks.
//
// Build with -fmad=false and without fast math (see composite_common.cuh).
//
// Both templates take <bool LOCALIZE, int VARIANT>. LOCALIZE is always true
// here (it once also selected packed rows; the probes' mangled names keep
// it). VARIANT stubs or reformulates one stage by `if constexpr` hooks (see
// "Stage probes" below); VARIANT = kBase folds every hook away and is the
// design itself, the base every probe delta is taken against.

#include "composite_common.cuh"

namespace {

using namespace composite;

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kStaged = 11;  // row lanes 0-5, 4 colors, row lane 6

// Row k of a tile's (K, 8) and (K, 4) row tables, as three 16-byte loads.
struct RowRM {
  float4 a, b, c;
};

__device__ __forceinline__ void load_row_rm(const float* __restrict__ quad,
                                            const float* __restrict__ color, int k, int n,
                                            RowRM& r) {
  if (k >= n) return;
  r.a = reinterpret_cast<const float4*>(quad)[2 * k];
  r.b = reinterpret_cast<const float4*>(quad)[2 * k + 1];
  r.c = reinterpret_cast<const float4*>(color)[k];
}

// Thread x stores its row (k < n) as s[.][x] = [quad 0-5, r, g, b, depth, quad 6].
__device__ __forceinline__ void store_row_rm(float (*s)[kBlock], const RowRM& r, int k, int n) {
  if (k >= n) return;
  const int x = threadIdx.x;
  s[0][x] = r.a.x; s[1][x] = r.a.y; s[2][x] = r.a.z; s[3][x] = r.a.w;
  s[4][x] = r.b.x; s[5][x] = r.b.y; s[10][x] = r.b.z;
  s[6][x] = r.c.x; s[7][x] = r.c.y; s[8][x] = r.c.z; s[9][x] = r.c.w;
}

// Thread x stages row k (k < n).
__device__ __forceinline__ void stage_row_rm(float (*s)[kBlock], const float* __restrict__ quad,
                                             const float* __restrict__ color, int k, int n) {
  RowRM r;
  load_row_rm(quad, color, k, n, r);
  store_row_rm(s, r, k, n);
}

// Staged Gaussian j at the block's pixel (lx + ox, ly + oy): false when the
// pixel skips it; else also dx, dy, the pixel's offset from the Gaussian's
// center.
template <bool LOCALIZE>
__device__ __forceinline__ bool reaches_rm(float (*s)[kBlock], int j, float lx, float ly,
                                           float ox, float oy, float& dx, float& dy,
                                           float& alpha_un) {
  static_assert(LOCALIZE, "the stage probes take global conic rows");
  return reaches(s, j, lx + ox, ly + oy, dx, dy, alpha_un);
}

// The ten values a contributing visit adds to its row: dquad's six, as
// direct conic terms from dx, dy (CONIC) or in the packed basis at the
// tile-local pixel, then dcolor's four, w g_accum.
template <bool CONIC>
__device__ __forceinline__ void visit_values(float (&v)[kChannels], float (*s)[kBlock], int j,
                                             float dq, float w, float dx, float dy, float lx,
                                             float ly, float g0, float g1, float g2, float g3) {
  if (CONIC) {
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
}

// --------------------------------------------------------------------------
// Stage probes (replace tools/kvariants.py:build_fwd and build_bwd): the
// kernels below under a VARIANT other than kBase. The variants are
// measuring instruments; no main path launches any of these kernels.
//
// Exact variants give the output of base:
//   noskip     no block exit and no per-thread break: every thread evaluates
//              every row; a finished pixel's rows add zero (selects, no branch)
//   logsp      log T carried; w = exp(min(q, log 0.99) + log T), the test
//              log T + log1p(-alpha) < log 1e-4
//   pipe       the next 256-row batch is loaded into registers while the
//              current one blends, then stored into the second of two staging
//              buffers: one barrier per batch (forward) instead of two
//   fusedgrad  (backward) the ten values of a visit summed over the warp by
//              one butterfly: each step halves the values a lane keeps, so 16
//              shuffles replace 50, and ten lanes add their pair's sum to
//              shared memory at once instead of lane 0 adding all ten
//   noT        (backward) the warp's values transposed through shared memory
//              and summed by ten lanes, no shuffles
//   noT+logsp  both
// Stubs follow the Pallas kernels' chunk formulation with chunk = the
// 256-row staging batch. Per pixel, T0 and done0 hold at the chunk start;
// row i of the chunk has T_raw = E(cum_i) T0 with cum_i the sum of wlog =
// log1p(-alpha) over the chunk's rows before i, dead_i = T_raw (1 - alpha_i)
// < 1e-4 or done0, not sticky inside the chunk; at its end T0 *= E(sum of
// the live rows' wlog), done0 = dead of its last row, and the backward's
// prefix carry takes the last row's P_incl:
//   chunk      nothing stubbed: the TPU formulation itself, a baseline for the
//              two below (equal to base in exact arithmetic)
//   noexp      exp -> 0.25 x + 1 and log1p -> 0.5 x everywhere, alpha_un too
//   nomm       cum_i := wlog_i; backward P_incl := pcarry + w cg (no serial
//              prefix inside the chunk)
// and, in base's sequential form (exp exact, so the chunk form would equal it):
//   nograd     (backward) the replay without the reduction over pixels:
//              dquad = dcolor = 0
//   nodeloc    (backward) dquad the packed-basis sums [dq, dq lx, dq ly, dq lx^2,
//              dq lx ly, dq ly^2, 0, 0] at the tile-local pixel
// --------------------------------------------------------------------------

enum Variant : int {
  kBase = 0, kNoExp = 1, kNoMM = 2, kNoSkip = 3, kLogSp = 4, kPipe = 5, kNoGrad = 6,
  kFusedGrad = 7, kNoT = 8, kNoDeloc = 9, kNoTLogSp = 10, kChunk = 11,
};

// log(0.99) and log(1e-4), rounded as PyTorch rounds the doubles
constexpr float kLnAlphaMax = (float)-0.01005033585350145;
constexpr float kLnTermEps = (float)-9.210340371976182;

template <bool STUB>
__device__ __forceinline__ float exp_v(float x) {
  return STUB ? x * 0.25f + 1.0f : expf(x);
}

template <bool STUB>
__device__ __forceinline__ float log1p_v(float x) {
  return STUB ? x * 0.5f : log1pf(x);
}

template <int V>
constexpr bool kChunked = V == kNoExp || V == kNoMM || V == kChunk;

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

// fusedgrad: a visit's ten values summed over the warp's 32 pixels by one
// butterfly and added to acc[.][j]; nothing when no lane of the warp hit
// row j. After four steps lane l holds slot l >> 1 (16 slots, six zero)
// summed over the 16 lanes that differ from it in bits 1-4.
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
// ten lanes adding up one value's 32 pixels.
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

template <bool LOCALIZE, int V = kBase>
__global__ void __launch_bounds__(kBlock)
composite_rm_fwd_kernel(const float* __restrict__ quad, const float* __restrict__ color,
                        const int* __restrict__ counts, const float* __restrict__ origins,
                        float* __restrict__ accum, float* __restrict__ tfinal, int K, int th,
                        int tw) {
  static_assert(LOCALIZE, "the stage probes take global conic rows");
  constexpr bool kPiped = V == kPipe;
  constexpr bool kStub = V == kNoExp;
  __shared__ float s_buf[kPiped ? 2 : 1][kStaged][kBlock];
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
  float T = V == kLogSp ? 0.0f : 1.0f;  // logsp: log T; chunk forms: T at the chunk start
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
  RowRM next;  // pipe: this thread's row of the next batch, in flight while one blends
  if constexpr (kPiped) stage_row_rm(s_buf[0], q_tile, c_tile, threadIdx.x, n);
  for (int b = 0, buf = 0; b < n; b += kBlock, buf ^= 1) {
    float(*s)[kBlock] = s_buf[kPiped ? buf : 0];
    // barrier before overwriting the batch; also the block's exit test
    if constexpr (V == kNoSkip) {
      __syncthreads();
    } else if (__syncthreads_count(done) == kBlock) {
      break;
    }
    if constexpr (kPiped) {
      load_row_rm(q_tile, c_tile, b + kBlock + threadIdx.x, n, next);
    } else {
      stage_row_rm(s, q_tile, c_tile, b + threadIdx.x, n);
      __syncthreads();
    }
    const int m = min(kBlock, n - b);
    if constexpr (kChunked<V>) {
      if (!done) {
        float cum = 0.0f, kept = 0.0f;
        bool dead = false;
        for (int j = 0; j < m; ++j) {
          float dx, dy;
          const float q = conic_q(s, j, lx + ox, ly + oy, dx, dy);
          const float e = exp_v<kStub>(q);
          const float alpha = (q <= s[5][j] && e >= kAlphaMin) ? clamped(e) : 0.0f;
          const float wlog = log1p_v<kStub>(-alpha);
          const float T_raw = exp_v<kStub>(V == kNoMM ? wlog : cum) * T;
          dead = ends_pixel(T_raw * (1.0f - alpha));
          if (!dead) {
            const float w = alpha * T_raw;
            c0 = c0 + w * s[6][j];
            c1 = c1 + w * s[7][j];
            c2 = c2 + w * s[8][j];
            c3 = c3 + w * s[9][j];
            kept = kept + wlog;
          }
          cum = cum + wlog;
        }
        T = T * exp_v<kStub>(kept);
        done = dead;
      }
    } else if constexpr (V == kNoSkip) {
      for (int j = 0; j < m; ++j) {
        float dx, dy, alpha_un;
        const bool hit = reaches_rm<LOCALIZE>(s, j, lx, ly, ox, oy, dx, dy, alpha_un) && !done;
        const float alpha = clamped(alpha_un);
        const float test_T = T * (1.0f - alpha);
        const bool end = hit && ends_pixel(test_T);
        const bool add = hit && !end;
        done = done || end;
        const float w = add ? alpha * T : 0.0f;
        c0 = c0 + w * s[6][j];
        c1 = c1 + w * s[7][j];
        c2 = c2 + w * s[8][j];
        c3 = c3 + w * s[9][j];
        T = add ? test_T : T;
      }
    } else if constexpr (V == kLogSp) {
      for (int j = 0; !done && j < m; ++j) {
        float dx, dy;
        const float q = conic_q(s, j, lx + ox, ly + oy, dx, dy);
        if (!(q <= s[5][j] && expf(q) >= kAlphaMin)) continue;
        const float wl = log1pf(-clamped(expf(q)));
        if (T + wl < kLnTermEps) {
          done = true;
          break;
        }
        const float w = expf(fminf(q, kLnAlphaMax) + T);
        c0 = c0 + w * s[6][j];
        c1 = c1 + w * s[7][j];
        c2 = c2 + w * s[8][j];
        c3 = c3 + w * s[9][j];
        T = T + wl;
      }
    } else {
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
    if constexpr (kPiped) store_row_rm(s_buf[buf ^ 1], next, b + kBlock + threadIdx.x, n);
  }
  if (inside) {
    const long long p = (long long)t * P + i;
    reinterpret_cast<float4*>(accum)[p] = make_float4(c0, c1, c2, c3);
    tfinal[p] = V == kLogSp ? expf(T) : T;
  }
}

template <bool LOCALIZE, int V = kBase>
__global__ void __launch_bounds__(kBlock)
composite_rm_bwd_kernel(const float* __restrict__ quad, const float* __restrict__ color,
                        const int* __restrict__ counts, const float* __restrict__ origins,
                        const float* __restrict__ g_accum, const float* __restrict__ g_tfinal,
                        const float* __restrict__ accum, const float* __restrict__ tfinal,
                        float* __restrict__ dquad, float* __restrict__ dcolor, int K, int th,
                        int tw) {
  static_assert(LOCALIZE, "the stage probes take global conic rows");
  constexpr bool kPiped = V == kPipe;
  constexpr bool kStub = V == kNoExp;
  constexpr bool kLog = V == kLogSp || V == kNoTLogSp;
  constexpr bool kReduce = V != kNoGrad;
  __shared__ float s_buf[kPiped ? 2 : 1][kStaged][kBlock];
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
  float T = kLog ? 0.0f : 1.0f, prefix = 0.0f;  // logsp: log T; chunk forms: at the chunk start
  float sink = 0.0f;  // nograd: keeps the replay's results alive
  RowRM next;  // pipe: this thread's row of the next batch
  if constexpr (kPiped) {
    stage_row_rm(s_buf[0], q_tile, c_tile, threadIdx.x, n);
#pragma unroll
    for (int c = 0; c < kChannels; ++c) acc[c][threadIdx.x] = 0.0f;
  }
  for (int b = 0, buf = 0; b < n; b += kBlock, buf ^= 1) {
    float(*s)[kBlock] = s_buf[kPiped ? buf : 0];
    if (__syncthreads_count(done) == kBlock) break;
    const int k = b + threadIdx.x;
    if constexpr (kPiped) {
      load_row_rm(q_tile, c_tile, k + kBlock, n, next);
    } else {
      stage_row_rm(s, q_tile, c_tile, k, n);
#pragma unroll
      for (int c = 0; c < kChannels; ++c) acc[c][threadIdx.x] = 0.0f;
      __syncthreads();
    }
    const int m = min(kBlock, n - b);
    // the chunk forms' running sums, and the carry their chunk ends with
    float cum = 0.0f, kept = 0.0f, chunk_prefix = 0.0f, last_prefix = prefix;
    bool dead = done;
    for (int j = 0; j < m; ++j) {
      if (__all_sync(kFullWarp, done)) break;
      float v[kChannels];
#pragma unroll
      for (int c = 0; c < kChannels; ++c) v[c] = 0.0f;
      bool hit = false;
      if (!done) {
        float dx = 0.0f, dy = 0.0f, alpha_un;
        if constexpr (kChunked<V>) {
          const float q = conic_q(s, j, lx + ox, ly + oy, dx, dy);
          const float e = exp_v<kStub>(q);
          const bool valid = q <= s[5][j] && e >= kAlphaMin;
          const float alpha = valid ? clamped(e) : 0.0f;
          const float wlog = log1p_v<kStub>(-alpha);
          const float T_raw = exp_v<kStub>(V == kNoMM ? wlog : cum) * T;
          dead = ends_pixel(T_raw * (1.0f - alpha));
          const float alpha_eff = dead ? 0.0f : alpha;
          const float w = alpha_eff * T_raw;
          const float cg = g0 * s[6][j] + g1 * s[7][j] + g2 * s[8][j] + g3 * s[9][j];
          float P_incl;
          if (V == kNoMM) {
            P_incl = prefix + w * cg;
          } else {
            chunk_prefix = chunk_prefix + w * cg;
            P_incl = prefix + chunk_prefix;
          }
          last_prefix = P_incl;
          if (!dead && valid) {
            hit = true;
            const float dalpha = T_raw * cg - (A_p - P_incl) / (1.0f - alpha_eff);
            visit_values<true>(v, s, j, dalpha * e, w, dx, dy, lx, ly, g0, g1, g2, g3);
            kept = kept + wlog;
          }
          cum = cum + wlog;
        } else if (reaches_rm<LOCALIZE>(s, j, lx, ly, ox, oy, dx, dy, alpha_un)) {
          const float alpha = clamped(alpha_un);
          const float one_m = 1.0f - alpha;
          const float test_T = kLog ? T + log1pf(-alpha) : T * one_m;
          if (kLog ? test_T < kLnTermEps : ends_pixel(test_T)) {
            done = true;
          } else {
            hit = true;
            const float T_c = kLog ? expf(T) : T;
            const float w = alpha * T_c;
            const float cg = g0 * s[6][j] + g1 * s[7][j] + g2 * s[8][j] + g3 * s[9][j];
            prefix = prefix + w * cg;
            const float dalpha = T_c * cg - (A_p - prefix) / one_m;
            const float dq = dalpha * alpha_un;
            if constexpr (kReduce) {
              visit_values<LOCALIZE && V != kNoDeloc>(v, s, j, dq, w, dx, dy, lx, ly, g0, g1,
                                                      g2, g3);
            } else {
              sink = sink + dq + w;
            }
            T = test_T;
          }
        }
      }
      if constexpr (V == kFusedGrad) {
        reduce_butterfly(v, hit, acc, j, lane);
      } else if constexpr (V == kNoT || V == kNoTLogSp) {
        __shared__ float xs[kBlock / 32][kChannels][33];  // each warp's transpose
        reduce_transpose(v, hit, acc, xs[threadIdx.x / 32], j, lane);
      } else if constexpr (kReduce) {
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
    if constexpr (kChunked<V>) {
      if (!done) {
        T = T * exp_v<kStub>(kept);
        prefix = last_prefix;
        done = dead;
      }
    }
    __syncthreads();
    if (kReduce && k < n) {
      const int x = threadIdx.x;
      float* dq_row = dquad + ((long long)t * K + k) * 8;
      float* dc_row = dcolor + ((long long)t * K + k) * 4;
#pragma unroll
      for (int c = 0; c < kChannels; ++c) {
        const float a = acc[c][x];
        if (a != 0.0f) atomicAdd(c < 6 ? dq_row + c : dc_row + (c - 6), a);
      }
    }
    if constexpr (kPiped) {
#pragma unroll
      for (int c = 0; c < kChannels; ++c) acc[c][threadIdx.x] = 0.0f;
      store_row_rm(s_buf[buf ^ 1], next, k + kBlock, n);
    }
  }
  // nograd: a NaN anywhere in the replay adds zero, so the output stays zero
  // and the compiler cannot drop the replay's arithmetic
  if constexpr (!kReduce) {
    if (isnan(sink)) atomicAdd(dquad + (long long)t * K * 8, 0.0f);
  }
}

template <int V>
int launch_fwd(const float* quad, const float* color, const int* counts, const float* origins,
               float* accum, float* tfinal, int T, int K, int th, int tw, void* stream) {
  const dim3 grid(T, (th * tw + kBlock - 1) / kBlock);
  composite_rm_fwd_kernel<true, V><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      quad, color, counts, origins, accum, tfinal, K, th, tw);
  return (int)cudaGetLastError();
}

template <int V>
int launch_bwd(const float* quad, const float* color, const int* counts, const float* origins,
               const float* g_accum, const float* g_tfinal, const float* accum,
               const float* tfinal, float* dquad, float* dcolor, int T, int K, int th, int tw,
               void* stream) {
  const dim3 grid(T, (th * tw + kBlock - 1) / kBlock);
  composite_rm_bwd_kernel<true, V><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      quad, color, counts, origins, g_accum, g_tfinal, accum, tfinal, dquad, dcolor, K, th, tw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The stage probes on global conic rows with origins, under `variant` (enum
// Variant above; kBase is the one-pixel-a-thread design itself): quad (T, K,
// 8), origins (T, 2), color (T, K, 4), counts (T,), accum (T, th*tw, 4),
// tfinal (T, th*tw, 1); the backward's g_accum, g_tfinal, dquad and dcolor as
// composite_tiles_bwd's (composite_bwd.cu), dquad and dcolor zeroed by the
// caller. Every pointer 16-byte aligned. Returns cudaGetLastError() after
// the launch; an unknown variant returns cudaErrorInvalidValue.
int composite_rm_fwd_variant(int variant, const float* quad, const float* color, const int* counts,
                             const float* origins, float* accum, float* tfinal, int T, int K,
                             int th, int tw, void* stream) {
#define FWD(V) launch_fwd<V>(quad, color, counts, origins, accum, tfinal, T, K, th, tw, stream)
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

int composite_rm_bwd_variant(int variant, const float* quad, const float* color, const int* counts,
                             const float* origins, const float* g_accum, const float* g_tfinal,
                             const float* accum, const float* tfinal, float* dquad, float* dcolor,
                             int T, int K, int th, int tw, void* stream) {
#define BWD(V)                                                                         \
  launch_bwd<V>(quad, color, counts, origins, g_accum, g_tfinal, accum, tfinal, dquad, \
                dcolor, T, K, th, tw, stream)
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
