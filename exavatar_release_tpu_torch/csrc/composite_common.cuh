// What the forward and the backward compositing kernels must share to the
// last bit (composite.cu, composite_bwd.cu, composite_rm.cu): the block size, renderCUDA's
// thresholds, the staging of rows in shared memory, and the skip, clamp
// and termination rules of one Gaussian at one pixel. The backward replays the forward from its saved
// output, and its `A_p - P_i` cancels only if both take the same skip and
// termination decisions from the same arithmetic, so neither file spells
// these out for itself.
//
// Build with -fmad=false and without fast math: the thresholds turn
// last-bit differences into skipped or kept Gaussians, and every operation
// here rounds as the plain PyTorch version's does.
//
// The rules are three small functions and the callers keep the branches
// (skip -> next Gaussian, end -> leave the loop). One function returning a
// struct and a three-way code measured 16-27% slower in all four kernels on
// an H100: most visits skip, and that path must stay one compare and a jump.
#pragma once

#include <cuda_runtime.h>

namespace composite {

constexpr int kBlock = 256;  // pixels of a block, and rows of a staged batch
constexpr int kChannels = 10;  // used channels of a row: 0-5 and 8-11
// The plain version compares float32 tensors against these Python doubles,
// which PyTorch rounds to float32: round the double the same way here.
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = (float)0.99;
constexpr float kTermEps = (float)1e-4;

// Thread x of the block stages row begin + k (k < n) of a channel-major row
// table (channel c of row r at rows[c * stride + r]) as s[.][x] = [A, B, C,
// gx, gy, log_op, r, g, b, depth]: the row without its unused channels 6
// and 7. Each channel is a coalesced load across the block.
__device__ __forceinline__ void stage_row(float (*s)[kBlock], const float* __restrict__ rows,
                                          long long stride, long long begin, int k, int n) {
  if (k >= n) return;
  const float* r = rows + begin + k;
#pragma unroll
  for (int c = 0; c < 6; ++c) s[c][threadIdx.x] = r[c * stride];
#pragma unroll
  for (int c = 8; c < 12; ++c) s[c - 2][threadIdx.x] = r[c * stride];
}

// Staged Gaussian j at pixel (px, py), in the direct conic form:
//   q = log_op - 0.5 (A dx^2 + C dy^2) - B dx dy,  dx = px - gx, dy = py - gy
__device__ __forceinline__ float conic_q(float (*s)[kBlock], int j, float px, float py,
                                         float& dx, float& dy) {
  const float A = s[0][j], B = s[1][j], C = s[2][j];
  dx = px - s[3][j];
  dy = py - s[4][j];
  return s[5][j] - 0.5f * (A * (dx * dx) + C * (dy * dy)) - B * (dx * dy);
}

// Returns false when the pixel skips staged Gaussian j (q > log_op, or
// exp(q) < 1/255); else dx, dy and alpha_un = exp(q), the alpha before its
// clamp.
__device__ __forceinline__ bool reaches(float (*s)[kBlock], int j, float px, float py,
                                        float& dx, float& dy, float& alpha_un) {
  const float q = conic_q(s, j, px, py, dx, dy);
  alpha_un = expf(q);
  return (q <= s[5][j]) && (alpha_un >= kAlphaMin);
}

// The same test for a row of pre-packed tile-local coefficients, staged as
// s[.][j] = [c0, c1, c2, c3, c4, c5, r, g, b, depth, log_op], at the
// tile-local pixel (lx, ly):
//   q = c0 + c1 lx + c2 ly + c3 lx^2 + c4 lx ly + c5 ly^2
// summed left to right, the order of the plain PyTorch version.
__device__ __forceinline__ bool reaches_packed(float (*s)[kBlock], int j, float lx, float ly,
                                               float& alpha_un) {
  const float q = s[0][j] + s[1][j] * lx + s[2][j] * ly + s[3][j] * (lx * lx) +
                  s[4][j] * (lx * ly) + s[5][j] * (ly * ly);
  alpha_un = expf(q);
  return (q <= s[10][j]) && (alpha_un >= kAlphaMin);
}

// alpha = min(0.99, exp(q))
__device__ __forceinline__ float clamped(float alpha_un) { return fminf(alpha_un, kAlphaMax); }

// test_T = T (1 - alpha) of a Gaussian that `reaches` the pixel: below 1e-4
// the pixel ends, and the Gaussian that triggers it does not contribute.
__device__ __forceinline__ bool ends_pixel(float test_T) { return test_T < kTermEps; }

// ---------------------------------------------------------------------------
// The pair-major kernels (composite_pairs_fwd_rg, composite_pairs_bwd_rg)
// only. The kernels above do not use anything below.
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
// 1/255 = -5.5413), so such a Gaussian fails `reaches` anyway. Mirrored by
// ops/rasterizer/kernels.py:Q_GATE, which tests/test_torch_pair_cull.py
// sweeps.
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

// A batch of kBlock rows staged for the pair-major kernels, as vectors that
// one broadcast LDS reads for both pixels of a thread.
struct PairRows {
  float4 box[kBlock];  // pixel_box
  float4 abcx[kBlock];  // A, B, C, gx
  float4 col[kBlock];  // r, g, b, depth
  float2 ylo[kBlock];  // gy, log_op
};

// Thread x of the block stages row begin + k (k < n) of a channel-major row
// table (channel c of row r at rows[c * stride + r]), with its box.
__device__ __forceinline__ void stage_pair_row(PairRows& s, const float* __restrict__ rows,
                                               long long stride, long long begin, int k, int n) {
  if (k >= n) return;
  const float* r = rows + begin + k;
  const float A = r[0], B = r[stride], C = r[2 * stride], gx = r[3 * stride];
  const float gy = r[4 * stride], log_op = r[5 * stride];
  s.abcx[threadIdx.x] = make_float4(A, B, C, gx);
  s.ylo[threadIdx.x] = make_float2(gy, log_op);
  s.col[threadIdx.x] = make_float4(r[8 * stride], r[9 * stride], r[10 * stride], r[11 * stride]);
  s.box[threadIdx.x] = pixel_box(A, B, C, gx, gy, log_op);
}

// The pixels of this thread and the patch of its warp (patch blk * kWarps +
// warp, blk the block's index within its tile) in a th x tw tile at origin
// (ox, oy): the column's first tile-local pixel (x, y) and the patch's
// bounds [x0, x1, y0, y1] in global pixel coordinates.
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

// `reaches` for a row held in registers, behind the exp gate: false without
// an expf when q < kQGate, else exactly what `reaches` returns, from the same
// q in the same operation order.
__device__ __forceinline__ bool reaches_gated(float A, float B, float C, float gx, float gy,
                                              float log_op, float px, float py, float& dx,
                                              float& dy, float& alpha_un) {
  dx = px - gx;
  dy = py - gy;
  const float q = log_op - 0.5f * (A * (dx * dx) + C * (dy * dy)) - B * (dx * dy);
  if (q < kQGate) return false;
  alpha_un = expf(q);
  return (q <= log_op) && (alpha_un >= kAlphaMin);
}

}  // namespace composite
