// What the forward and the backward compositing kernels must share to the
// last bit (composite.cu, composite_bwd.cu): the block size, renderCUDA's
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

// Staged Gaussian j at pixel (px, py):
//   q = log_op - 0.5 (A dx^2 + C dy^2) - B dx dy   (direct conic form)
// Returns false when the pixel skips it (q > log_op, or exp(q) < 1/255);
// else dx, dy and alpha_un = exp(q), the alpha before its clamp.
__device__ __forceinline__ bool reaches(float (*s)[kBlock], int j, float px, float py,
                                        float& dx, float& dy, float& alpha_un) {
  const float A = s[0][j], B = s[1][j], C = s[2][j];
  dx = px - s[3][j];
  dy = py - s[4][j];
  const float log_op = s[5][j];
  const float q = log_op - 0.5f * (A * (dx * dx) + C * (dy * dy)) - B * (dx * dy);
  alpha_un = expf(q);
  return (q <= log_op) && (alpha_un >= kAlphaMin);
}

// alpha = min(0.99, exp(q))
__device__ __forceinline__ float clamped(float alpha_un) { return fminf(alpha_un, kAlphaMax); }

// test_T = T (1 - alpha) of a Gaussian that `reaches` the pixel: below 1e-4
// the pixel ends, and the Gaussian that triggers it does not contribute.
__device__ __forceinline__ bool ends_pixel(float test_T) { return test_T < kTermEps; }

}  // namespace composite
