// Pair expansion of the compact and ragged binnings for Hopper (sm_90a).
//
// expand_pairs: for every slot j < Pm of the pair budget, the depth rank g
// that owns it, the last one whose exclusive offset is <= j (offsets is
// non-decreasing; a zero-span rank shares its successor's offset, so the
// last one is the rank whose segment holds j). The slot is valid iff
// j < offsets[g] + span[g]; it then gets the tile key
// (y_lo[g] + e / w[g]) * nx + x_lo[g] + e % w[g], e = j - offsets[g], and the
// rank g; otherwise num_tiles and n. Both outputs int64, one slot a thread.
//
// chunk_slots: for every chunk slot c < NC of the ragged binning, the tile
// that owns it, the last t < T with bounds[t] <= c (bounds (T + 1,) is the
// strictly increasing exclusive sum of each tile's chunks, its total last),
// and its flags: bit0 c == bounds[t], bit1 c == bounds[t + 1] - 1 and c is
// valid, bit2 c < bounds[T] (valid). Both outputs int32.
//
// Replaces no TPU kernel: the JAX package (and the port before it) built
// the same integers by scattering per-Gaussian values at each segment's
// first slot and forward-filling them with lax.cummax / torch.cummax, four
// fills over the whole budget a render; torch.cummax over one long row runs
// on one block, linear in Pm whatever the pairs. Bound: bytes, 16 B a slot
// written (40 B a Gaussian read once); at Pm = 2.63M-4.73M, 0.014-0.025 ms
// at 3.35 TB/s.
//
// Design. One thread a slot, so a warp stores 256 contiguous bytes of each
// output. Each thread finds its owner by binary search over offsets (8 B a
// step, from L2: offsets is 8 n bytes, <= 2.4 MB at n = 295k), narrowed per
// block: two threads of different warps search the owners of the block's
// first and last slot over the whole array, and the others search only
// between them, a few steps in lines that the block shares. On an H100 this
// beat a search over the whole array for every slot by 21-26% (0.028 /
// 0.033 / 0.047 ms against 0.035 / 0.042 / 0.063 at Pm = 2.63M / 3.15M /
// 4.73M, about twice the bound). The per-Gaussian fields are then read at
// g, the same address across most of a warp. e and w fit 32 bits (e < span
// <= num_tiles < 2^31), so the division is 32-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The last index g in [lo, hi) with a[g] <= v, for a non-decreasing a with
// a[lo] <= v.
__device__ __forceinline__ int last_at_most(const long long* __restrict__ a, int lo, int hi,
                                            long long v) {
  while (hi - lo > 1) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) <= v)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
expand_pairs_kernel(const long long* __restrict__ offsets, const long long* __restrict__ span,
                    const long long* __restrict__ x_lo, const long long* __restrict__ y_lo,
                    const long long* __restrict__ w, long long* __restrict__ tile,
                    long long* __restrict__ rank, int n, long long Pm, int nx, int num_tiles) {
  const long long j0 = (long long)blockIdx.x * kThreads;
  const long long j = j0 + threadIdx.x;
  __shared__ int range[2];  // the owners of the block's first and last slot, the last + 1
  if (threadIdx.x == 0) range[0] = last_at_most(offsets, 0, n, j0);
  if (threadIdx.x == 32) {
    const long long j_last = (j0 + kThreads < Pm ? j0 + kThreads : Pm) - 1;
    range[1] = last_at_most(offsets, 0, n, j_last) + 1;
  }
  __syncthreads();
  if (j >= Pm) return;
  const int g = last_at_most(offsets, range[0], range[1], j);
  const long long e = j - __ldg(offsets + g);
  long long t = num_tiles, r = n;
  if (e < __ldg(span + g)) {
    const int wg = (int)__ldg(w + g);  // >= 1 wherever the span is not empty
    const int ei = (int)e;
    t = (long long)((int)__ldg(y_lo + g) + ei / wg) * nx + (int)__ldg(x_lo + g) + ei % wg;
    r = g;
  }
  tile[j] = t;
  rank[j] = r;
}

__global__ void __launch_bounds__(kThreads)
chunk_slots_kernel(const long long* __restrict__ bounds, int* __restrict__ tid,
                   int* __restrict__ flags, int T, int NC) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= NC) return;
  const int t = last_at_most(bounds, 0, T, c);
  const bool valid = c < __ldg(bounds + T);
  const bool first = c == __ldg(bounds + t);
  const bool last = valid && c == __ldg(bounds + t + 1) - 1;
  tid[c] = t;
  flags[c] = (int)first + 2 * (int)last + 4 * (int)valid;
}

}  // namespace

extern "C" {

// offsets, span, x_lo, y_lo, w (n,) i64, offsets non-decreasing from 0;
// tile, rank (Pm,) i64. n >= 1, Pm >= 1, Pm / 256 < 2^31. Returns
// cudaGetLastError() after the launch.
int expand_pairs(const long long* offsets, const long long* span, const long long* x_lo,
                 const long long* y_lo, const long long* w, long long* tile, long long* rank,
                 int n, long long Pm, int nx, int num_tiles, void* stream) {
  const int blocks = (int)((Pm + kThreads - 1) / kThreads);
  expand_pairs_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      offsets, span, x_lo, y_lo, w, tile, rank, n, Pm, nx, num_tiles);
  return (int)cudaGetLastError();
}

// bounds (T + 1,) i64 strictly increasing from 0; tid, flags (NC,) i32.
// T >= 1, NC >= 1. Returns cudaGetLastError() after the launch.
int chunk_slots(const long long* bounds, int* tid, int* flags, int T, int NC, void* stream) {
  chunk_slots_kernel<<<(NC + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      bounds, tid, flags, T, NC);
  return (int)cudaGetLastError();
}

}  // extern "C"
