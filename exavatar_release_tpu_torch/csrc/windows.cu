// Per-tile window build for Hopper (sm_90a): out[t, k] = rank[starts[t] + k]
// for k < starts[t + 1] - starts[t], else the sentinel n; (T, K) int32.
//
// Replaces the Pallas TPU kernel of tools/win_probe.py:windows_dma, a
// scalar-prefetched dynamic-offset DMA per tile. Bound: bytes, each live
// entry read once, T K entries written and T + 1 starts read (4 B each) at
// 3.35 TB/s; the (T, K) output is nearly all of it.
//
// Design. Block (t, s) writes segment s of row t: it reads the row's starts
// pair once (through the read-only path) and walks its segment in 16-byte
// vectors (int4), a warp writing 512 contiguous bytes, each thread issuing
// the rank loads of its kUnroll vectors before its stores. A row of K % 4
// != 0 entries does not start on 16 bytes, and is written 4 bytes a thread.
// The row is the grid's x (T may pass 65,535) and its offset 64-bit (T K may
// pass 2^31), so no thread divides. Nothing is read past a tile's count, so
// rank needs no padding and no entry past starts[T] is read. On an H100 this
// beat a flat grid over the output's vectors (one division a vector) by 10%
// at K = 16,384, and 128 threads a block beat 256 by 4-17% at K = 1,024 (4 KB
// rows: one block a row, all resident at once), with 256 the same at 16,384.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 2;
constexpr int kChunk = kThreads * kUnroll;  // vectors a block's pass writes

__global__ void __launch_bounds__(kThreads)
tile_windows_kernel(const int* __restrict__ starts, const int* __restrict__ rank,
                    int* __restrict__ out, int K, int n) {
  const int t = blockIdx.x;
  const int s0 = __ldg(starts + t);
  const int cnt = min(__ldg(starts + t + 1) - s0, K);
  int* row = out + (long long)t * K;
  if (K % 4) {
    for (int k = blockIdx.y * kThreads + threadIdx.x; k < K; k += gridDim.y * kThreads)
      row[k] = k < cnt ? __ldg(rank + s0 + k) : n;
    return;
  }
  const int K4 = K / 4;
  int4* row4 = reinterpret_cast<int4*>(row);
  for (int v0 = blockIdx.y * kChunk + threadIdx.x; v0 < K4; v0 += gridDim.y * kChunk) {
    int4 val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = 4 * (v0 + u * kThreads);
      int e[4] = {n, n, n, n};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j < cnt) e[j] = __ldg(rank + s0 + k + j);
      val[u] = make_int4(e[0], e[1], e[2], e[3]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v0 + u * kThreads < K4) row4[v0 + u * kThreads] = val[u];
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// starts (T + 1,) i32 non-decreasing; rank (>= starts[T],) i32; out (T, K)
// i32, 16-byte aligned. T, K > 0. Returns cudaGetLastError() after the launch.
int tile_windows(const int* starts, const int* rank, int* out, int T, int K, int n, void* stream) {
  int segs = (K / 4 + kChunk - 1) / kChunk;  // the blocks' loops stride past 65,535
  segs = segs < 1 ? 1 : segs > 65535 ? 65535 : segs;
  tile_windows_kernel<<<dim3(T, segs), kThreads, 0, (cudaStream_t)stream>>>(starts, rank, out,
                                                                           K, n);
  return (int)cudaGetLastError();
}

// One empty kernel of one block: the launch floor that tile_windows' time is
// read against. Returns cudaGetLastError() after the launch.
int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
