// Per-tile window build for Hopper (sm_90a): out[t, k] = rank[starts[t] + k]
// for k < starts[t + 1] - starts[t], else the sentinel n; (T, K) int32.
//
// Replaces the Pallas TPU kernel of tools/win_probe.py:windows_dma, a
// scalar-prefetched dynamic-offset DMA per tile. Here one block per tile
// reads its slice of rank with coalesced int32 loads (neighbouring threads
// on neighbouring addresses) and writes its row of the window; nothing is
// read past the tile's count, so rank needs no padding. Bound: bytes, the
// tile's live entries read and T K entries written (4 B each) at 3.35 TB/s;
// at the 1080p tiling that is microseconds, so the launch is the cost.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
tile_windows_kernel(const int* __restrict__ starts, const int* __restrict__ rank,
                    int* __restrict__ out, int K, int n) {
  const int t = blockIdx.x;
  const long long s0 = starts[t];
  const int cnt = (int)(starts[t + 1] - s0);
  int* row = out + (long long)t * K;
  for (int k = threadIdx.x; k < K; k += kThreads) row[k] = k < cnt ? rank[s0 + k] : n;
}

}  // namespace

extern "C" {

// starts (T + 1,) i32 non-decreasing; rank (>= starts[T],) i32; out (T, K)
// i32. Returns cudaGetLastError() after the launch.
int tile_windows(const int* starts, const int* rank, int* out, int T, int K, int n, void* stream) {
  tile_windows_kernel<<<T, kThreads, 0, (cudaStream_t)stream>>>(starts, rank, out, K, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
