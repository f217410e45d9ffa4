// What the compositing kernels must share to the last bit (composite.cu and
// composite_bwd.cu: kernels 1-8 and the stage probes 9, 10): the block size,
// renderCUDA's thresholds, and the skip, clamp and termination rules of one
// Gaussian at one pixel; then the schedule of the pair bodies that every
// kernel runs (the row tables they take, the staging of
// rows in shared memory with their pixel boxes, the pixels of a thread and
// the patch of its warp, the exp gate). The backward replays the forward
// from its saved output, and its `A_p - P_i` cancels only if both take the
// same skip and termination decisions from the same arithmetic, so neither
// file spells these out for itself.
//
// Build with -fmad=false and without fast math: the thresholds turn
// last-bit differences into skipped or kept Gaussians, and every operation
// here rounds as the plain PyTorch version's does.
//
// The rules are small functions and the callers keep the branches (skip ->
// next Gaussian, end -> leave the loop). One function returning a struct and
// a three-way code measured 16-27% slower in all four kernels on an H100:
// most visits skip, and that path must stay one compare and a jump.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace composite {

constexpr int kBlock = 256;  // pixels of a block, and rows of a staged batch
constexpr int kChannels = 10;  // used channels of a row: 0-5 and 8-11
// The plain version compares float32 tensors against these Python doubles,
// which PyTorch rounds to float32: round the double the same way here.
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = (float)0.99;
constexpr float kTermEps = (float)1e-4;
constexpr unsigned kFullWarp = 0xffffffffu;

// alpha = min(0.99, exp(q))
__device__ __forceinline__ float clamped(float alpha_un) { return fminf(alpha_un, kAlphaMax); }

// test_T = T (1 - alpha) of a Gaussian that reaches the pixel: below 1e-4
// the pixel ends, and the Gaussian that triggers it does not contribute.
__device__ __forceinline__ bool ends_pixel(float test_T) { return test_T < kTermEps; }

// ---------------------------------------------------------------------------
// The schedule of the pair bodies (composite.cu composite_pairs_range,
// composite_bwd.cu composite_pairs_range_bwd): one body each way for the
// eight product kernels, on three kinds of row table (RowKind below), and
// for the stage probes, whose variants are `if constexpr` hooks of the same
// bodies (composite_probes.cuh).
//
// A thread owns kPairsR = 2 pixels, a column of two; a warp's 8 x 4 lanes
// own a patch of kPatchW x kPatchH = 8 x 8 pixels, and patches are numbered
// row-major over the tile, kWarps to a block. Two pixels a thread were
// faster than four (a 2 x 2 quad) on an H100 at the avatar's renders
// (PERF.md).
constexpr int kPairsR = 2;
constexpr int kLanesW = 8, kLanesH = 4;
constexpr int kPatchW = kLanesW, kPatchH = kLanesH * kPairsR;
constexpr int kWarps = kBlock / 32;

// Blocks of one tile: ceil(patches / kWarps). The grid is one-dimensional,
// block b working on tile b / pair_blocks, so the blocks of one tile are
// dispatched together and read its rows while they are in L2 (measured 3-5%
// faster for kernel 7 than a grid that puts the tiles first).
__host__ __device__ inline int pair_blocks(int th, int tw) {
  const int patches = ((tw + kPatchW - 1) / kPatchW) * ((th + kPatchH - 1) / kPatchH);
  return (patches + kWarps - 1) / kWarps;
}

// q below kQGate skips without an expf: expf(-5.55) = 3.887e-3 < 1/255 (ln
// 1/255 = -5.5413), so such a Gaussian fails the 1/255 floor anyway.
// Mirrored by ops/rasterizer/kernels.py:Q_GATE, which
// tests/test_torch_pair_cull.py sweeps.
constexpr float kQGate = (float)-5.55;

// The conservative pixel box of a row, mirrored operation for operation by
// ops/rasterizer/kernels.py:row_pixel_box (which holds the derivation):
// alpha >= 1/255 needs 0.5 d^T [[A, B], [B, C]] d <= L = log_op + ln 255, an
// ellipse of half-extents sqrt(2 L Sxx), sqrt(2 L Syy) with Sxx = C / det,
// Syy = A / det, det = AC - B^2. L gets an absolute and a relative slack
// (growing with k = AC / det, which scales the float32 error of q), the
// extents 1/1024 and one pixel more. Empty when L < 0 (also the -1e9
// padding rows); the whole plane when det <= 0, k >= 1e5 or an extent is not
// finite, where the per-pixel test decides alone.
constexpr float kBoxLn255 = (float)5.5413;  // above ln 255 = 5.541264
constexpr float kBoxMaxK = (float)1e5;
constexpr float kBoxSlackK = (float)1e-5;
constexpr float kBoxSlackAbs = (float)1e-5;
constexpr float kBoxRel = 1.0f + 1.0f / 1024.0f;
constexpr float kBoxPad = 1.0f;

// [xmin, xmax, ymin, ymax] in global pixel coordinates
__device__ __forceinline__ float4 pixel_box(float A, float B, float C, float gx, float gy,
                                            float log_op) {
  const float inf = __int_as_float(0x7f800000);
  const float L = log_op + kBoxLn255;
  if (L < 0.0f) return make_float4(inf, -inf, inf, -inf);
  const float det = A * C - B * B;
  const float k = (A * C) / det;
  const float Lb = L * (1.0f + kBoxSlackK * k) + kBoxSlackAbs * (1.0f + fabsf(log_op));
  const float ex = sqrtf(2.0f * Lb * (C / det)) * kBoxRel + kBoxPad;
  const float ey = sqrtf(2.0f * Lb * (A / det)) * kBoxRel + kBoxPad;
  if (!(det > 0.0f) || !(k < kBoxMaxK) || !isfinite(ex) || !isfinite(ey))
    return make_float4(-inf, inf, -inf, inf);
  return make_float4(gx - ex, gx + ex, gy - ey, gy + ey);
}

// The row tables of the pair bodies. The kind fixes two things that vary
// apart: the table's layout and the body's output (channel-major with the
// (5, P) output over a background, or row-major (K, 8) rows and (K, 4)
// colors with accum and tfinal), and the form of q (a direct conic at global
// pixels, or packed coefficients at tile-local pixels).
//   kConicCM   conic rows [A, B, C, gx, gy, log_op, _, _, r, g, b, depth] in
//              a channel-major table: kernels 1, 2 (dense windows) and 7, 8
//              (the pair list)
//   kPackedRM  packed rows [c0..c5, log_op, 0] and colors, tile-local
//              (origin (0, 0)): kernels 3 and 4 (kernel_v=2)
//   kConicRM   global conic rows [A, B, C, gx, gy, log_op, _, _] and colors
//              at the tile's origin: kernels 5 and 6
enum class RowKind { kConicCM, kPackedRM, kConicRM };
__host__ __device__ constexpr bool packed_q(RowKind k) { return k == RowKind::kPackedRM; }
__host__ __device__ constexpr bool row_major(RowKind k) { return k != RowKind::kConicCM; }

// A batch of kBlock rows staged for the pair bodies, as vectors that one
// broadcast LDS reads for both pixels of a thread. Conic rows keep hi as a
// float2, packed rows as a float4.
template <class Hi>
struct StagedRows {
  float4 box[kBlock];  // pixel_box / packed_pixel_box
  float4 lo[kBlock];  // conic: A, B, C, gx; packed: c0, c1, c2, c3
  float4 col[kBlock];  // r, g, b, depth
  Hi hi[kBlock];  // conic: gy, log_op; packed: c4, c5, log_op, 0
};
using PairRows = StagedRows<float2>;
using PackedRows = StagedRows<float4>;
template <RowKind KIND>
using RowsOf = std::conditional_t<packed_q(KIND), PackedRows, PairRows>;

// Thread x of the block stages row begin + k (k < n) of a channel-major row
// table (channel c of row r at rows[c * stride + r]), with its box.
__device__ __forceinline__ void stage_pair_row(PairRows& s, const float* __restrict__ rows,
                                               long long stride, long long begin, int k, int n) {
  if (k >= n) return;
  const float* r = rows + begin + k;
  const float A = r[0], B = r[stride], C = r[2 * stride], gx = r[3 * stride];
  const float gy = r[4 * stride], log_op = r[5 * stride];
  s.lo[threadIdx.x] = make_float4(A, B, C, gx);
  s.hi[threadIdx.x] = make_float2(gy, log_op);
  s.col[threadIdx.x] = make_float4(r[8 * stride], r[9 * stride], r[10 * stride], r[11 * stride]);
  s.box[threadIdx.x] = pixel_box(A, B, C, gx, gy, log_op);
}

// The pixels of this thread and the patch of its warp (patch blk * kWarps +
// warp, blk the block's index within its tile) in a th x tw tile at origin
// (ox, oy): the column's first tile-local pixel (x, y) and the patch's
// bounds [x0, x1, y0, y1] in global pixel coordinates (tile-local for packed
// rows, whose callers pass the origin (0, 0)).
struct PairPixels {
  int x, y;
  float4 patch;
};

__device__ __forceinline__ PairPixels pair_pixels(int blk, int tw, float ox, float oy) {
  const int lane = threadIdx.x & 31;
  const int p = blk * kWarps + (threadIdx.x >> 5);
  const int npx = (tw + kPatchW - 1) / kPatchW;
  const int x0 = (p % npx) * kPatchW, y0 = (p / npx) * kPatchH;
  PairPixels q;
  q.x = x0 + lane % kLanesW;
  q.y = y0 + (lane / kLanesW) * kPairsR;
  q.patch = make_float4((float)x0 + ox, (float)(x0 + kPatchW - 1) + ox, (float)y0 + oy,
                        (float)(y0 + kPatchH - 1) + oy);
  return q;
}

// Warp-uniform: no pixel of the patch lies in the row's box, so every pixel
// of the warp would skip the row.
__device__ __forceinline__ bool misses(float4 box, float4 patch) {
  return box.y < patch.x || box.x > patch.y || box.w < patch.z || box.z > patch.w;
}

// q of a conic row at the pixel (px, py), and the pixel's offset dx, dy:
// the plain version's (kernels.py _conic_q), in its operation order. Then
// whether the pixel composites the row, behind the exp gate: false without
// an expf when q < kQGate (such a Gaussian fails the 1/255 floor anyway),
// else false when q > log_op or exp(q) < 1/255; also alpha_un = exp(q), the
// alpha before its clamp.
__device__ __forceinline__ float conic_q(float A, float B, float C, float gx, float gy,
                                        float log_op, float px, float py, float& dx,
                                        float& dy) {
  dx = px - gx;
  dy = py - gy;
  return log_op - 0.5f * (A * (dx * dx) + C * (dy * dy)) - B * (dx * dy);
}

__device__ __forceinline__ bool reaches_gated(float A, float B, float C, float gx, float gy,
                                              float log_op, float px, float py, float& dx,
                                              float& dy, float& alpha_un) {
  const float q = conic_q(A, B, C, gx, gy, log_op, px, py, dx, dy);
  if (q < kQGate) return false;
  alpha_un = expf(q);
  return (q <= log_op) && (alpha_un >= kAlphaMin);
}

// The same for a packed row held in registers (lo = c0..c3, hi = c4, c5,
// log_op) at the tile-local pixel (lx, ly), with the pixel's basis xx = lx lx,
// xy = lx ly, yy = ly ly: exact integers (at most 127^2 < 2^24), so computed
// once they give the plain version's q (kernels.py _packed_q) bit for bit,
// summed in its order.
__device__ __forceinline__ bool reaches_packed_gated(float4 lo, float4 hi, float lx, float ly,
                                                     float xx, float xy, float yy,
                                                     float& alpha_un) {
  const float q = lo.x + lo.y * lx + lo.z * ly + lo.w * xx + hi.x * xy + hi.y * yy;
  if (q < kQGate) return false;
  alpha_un = expf(q);
  return (q <= hi.z) && (alpha_un >= kAlphaMin);
}

// ---------------------------------------------------------------------------
// The pixel box of a packed row, mirrored operation for operation by
// ops/rasterizer/kernels.py:packed_row_pixel_box (which holds the
// derivation). It bounds the packed q that reaches_packed_gated evaluates in
// float32 at the pixels of a th x tw tile, not the conic the row was packed
// from: the conic is recovered exactly (A = -2 c3, B = -c4, C = -2 c5), the
// center m solves Q m = (c1, c2), the peak is q* = c0 + (c1 mx + c2 my) / 2,
// and L = q* + ln 255 gets an absolute slack of kBoxPackSlack times the sum
// of the terms' magnitudes at the tile's far corner (the float32 error of q
// at any of its pixels) and at the center (the error of q*), plus the center's
// error times |(c1, c2)|. The extents take pixel_box's k slack, 1/1024 and
// one pixel, and the center's error. One reciprocal of det, not seven
// divisions: they took kernel 3 from 64 to 70 registers and cost it 15% on
// an H100 (PERF.md). Empty when log_op + ln 255 < 0 (no pixel
// passes q <= log_op and the 1/255 floor together) or when the widened L <
// 0; the whole plane where pixel_box gives up, and where A <= 0 (with det > 0
// Q is then negative definite and q* a minimum).
constexpr float kBoxPackSlack = (float)4e-6;

// [xmin, xmax, ymin, ymax] in tile-local pixel coordinates
__device__ __forceinline__ float4 packed_pixel_box(float4 lo, float4 hi, int th, int tw) {
  const float inf = __int_as_float(0x7f800000);
  const float c0 = lo.x, c1 = lo.y, c2 = lo.z, c3 = lo.w, c4 = hi.x, c5 = hi.y;
  if (hi.z + kBoxLn255 < 0.0f) return make_float4(inf, -inf, inf, -inf);
  const float A = -2.0f * c3, B = -c4, C = -2.0f * c5;
  const float det = A * C - B * B;
  const float inv = 1.0f / det;
  const float k = (A * C) * inv;
  const float mx = (C * c1 - B * c2) * inv;
  const float my = (A * c2 - B * c1) * inv;
  const float dmx = kBoxPackSlack * ((fabsf(C * c1) + fabsf(B * c2)) * inv + k * fabsf(mx));
  const float dmy = kBoxPackSlack * ((fabsf(A * c2) + fabsf(B * c1)) * inv + k * fabsf(my));
  const float qs = c0 + 0.5f * (c1 * mx + c2 * my);
  const float fx = (float)(tw - 1), fy = (float)(th - 1);
  const float far = fabsf(c0) + fabsf(c1) * fx + fabsf(c2) * fy + fabsf(c3) * (fx * fx) +
                    fabsf(c4) * (fx * fy) + fabsf(c5) * (fy * fy);
  const float peak = fabsf(c0) + fabsf(c1 * mx) + fabsf(c2 * my);
  const float Lb = qs + kBoxLn255 + kBoxSlackAbs + kBoxPackSlack * (far + peak) +
                   0.5f * (fabsf(c1) * dmx + fabsf(c2) * dmy);
  if (!(A > 0.0f) || !(det > 0.0f) || !(k < kBoxMaxK) || !isfinite(Lb) || !isfinite(dmx) ||
      !isfinite(dmy))
    return make_float4(-inf, inf, -inf, inf);
  if (Lb < 0.0f) return make_float4(inf, -inf, inf, -inf);
  const float Lk = Lb * (1.0f + kBoxSlackK * k);
  const float ex = sqrtf(2.0f * Lk * (C * inv)) * kBoxRel + kBoxPad + dmx;
  const float ey = sqrtf(2.0f * Lk * (A * inv)) * kBoxRel + kBoxPad + dmy;
  if (!isfinite(ex) || !isfinite(ey)) return make_float4(-inf, inf, -inf, inf);
  return make_float4(mx - ex, mx + ex, my - ey, my + ey);
}

// Thread x of the block stages row k (k < n) of a tile's packed rows quad (K,
// 8) = [c0..c5, log_op, 0] and colors (K, 4), three 16-byte loads, with its
// box for a th x tw tile.
__device__ __forceinline__ void stage_packed_row(PackedRows& s, const float* __restrict__ quad,
                                                 const float* __restrict__ color, int k, int n,
                                                 int th, int tw) {
  if (k >= n) return;
  const float4 lo = reinterpret_cast<const float4*>(quad)[2 * k];
  const float4 hi = reinterpret_cast<const float4*>(quad)[2 * k + 1];
  s.lo[threadIdx.x] = lo;
  s.hi[threadIdx.x] = hi;
  s.col[threadIdx.x] = reinterpret_cast<const float4*>(color)[k];
  s.box[threadIdx.x] = packed_pixel_box(lo, hi, th, tw);
}

// Row k (k < n) of a tile's global conic rows quad (K, 8) = [A, B, C, gx,
// gy, log_op, _, _] and colors (K, 4): three 16-byte loads into registers,
// then thread x's store of it as PairRows with its box in global pixel
// coordinates. stage_conic_rm_row does both; the pipe probe keeps a row in
// registers while a batch blends.
struct ConicRowRegs {
  float4 lo, hi, col;
};

__device__ __forceinline__ void load_conic_rm_row(ConicRowRegs& r, const float* __restrict__ quad,
                                                  const float* __restrict__ color, int k, int n) {
  if (k >= n) return;
  r.lo = reinterpret_cast<const float4*>(quad)[2 * k];
  r.hi = reinterpret_cast<const float4*>(quad)[2 * k + 1];
  r.col = reinterpret_cast<const float4*>(color)[k];
}

__device__ __forceinline__ void store_conic_rm_row(PairRows& s, const ConicRowRegs& r, int k,
                                                   int n) {
  if (k >= n) return;
  s.lo[threadIdx.x] = r.lo;
  s.hi[threadIdx.x] = make_float2(r.hi.x, r.hi.y);
  s.col[threadIdx.x] = r.col;
  s.box[threadIdx.x] = pixel_box(r.lo.x, r.lo.y, r.lo.z, r.lo.w, r.hi.x, r.hi.y);
}

__device__ __forceinline__ void stage_conic_rm_row(PairRows& s, const float* __restrict__ quad,
                                                   const float* __restrict__ color, int k,
                                                   int n) {
  ConicRowRegs r;
  load_conic_rm_row(r, quad, color, k, n);
  store_conic_rm_row(s, r, k, n);
}

// Thread x stages row k (k < n) of the batch, as its row kind lays it out:
// for kConicCM row begin + k of the channel-major table rows (stride), else
// row k of a tile's rows (K, 8) and color (K, 4).
template <RowKind KIND>
__device__ __forceinline__ void stage_rows(RowsOf<KIND>& s, const float* __restrict__ rows,
                                           const float* __restrict__ color, long long stride,
                                           long long begin, int k, int n, int th, int tw) {
  if constexpr (KIND == RowKind::kConicCM) {
    stage_pair_row(s, rows, stride, begin, k, n);
  } else if constexpr (KIND == RowKind::kPackedRM) {
    stage_packed_row(s, rows, color, k, n, th, tw);
  } else {
    stage_conic_rm_row(s, rows, color, k, n);
  }
}

}  // namespace composite
