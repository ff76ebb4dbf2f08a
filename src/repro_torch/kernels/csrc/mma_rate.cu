// Tensor-core rate microbenchmark for Hopper (sm_90a): how many SM cycles
// one warp-wide `mma.sync` takes, for the two ways a ternary x binary
// product can run on the tensor cores.
//
//   u8: mma.sync.m16n8k32.row.col.s32.u8.s8.s32 -- 16 x 8 x 32 = 4,096
//       MACs; a ternary conv on {0,1} bytes takes one per 32 of depth
//       (B.1/B.2, B.4, B.5 run on it);
//   b1: mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc -- 16 x 8 x 256
//       = 32,768 bit MACs; a ternary conv on packed words takes two per 256
//       of depth (popc(x & wp) and popc(x & wn)).
//
// Each warp runs `chains` independent accumulator chains for `iters`
// rounds; thread 0 of each block stamps clock64 around the loop.  With one
// block of 8 warps on every SM and 4 chains a warp the issue rate shows
// (cycles per MMA per SM = block cycles / (iters * chains * warps)); with
// one warp and one chain, the latency.  Used by chip_smoke.py's `mma rate`
// line, not by any path of the port.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma.cuh"

template <bool B1, int CHAINS>
__global__ void mma_rate_kernel(long long* cycles, int iters, int* sink) {
  const unsigned t = threadIdx.x * 0x9e3779b9u;
  const unsigned a0 = t, a1 = t ^ 0x55u, a2 = t + 7u, a3 = ~t;
  const unsigned b0 = t * 3u, b1 = t >> 3;
  int acc[CHAINS][4];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = (int)threadIdx.x + 4 * c + e;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (B1)
        mma_b1(acc[c], a0, a1, a2, a3, b0, b1);
      else
        mma_u8s8(acc[c], a0, a1, a2, a3, b0, b1);
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  int s = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += acc[c][e];
  if (s == 0x7fffffff) sink[0] = s;  // keeps the chains live
}

// kind 0: u8, 1: b1; chains 1 or 4.  Writes each block's cycles.
extern "C" int mma_rate_launch(int kind, int chains, int iters, int blocks,
                               int threads, void* cycles, void* sink,
                               void* stream) {
  void (*kern)(long long*, int, int*) =
      kind == 1 ? (chains == 4 ? mma_rate_kernel<true, 4>
                               : mma_rate_kernel<true, 1>)
                : (chains == 4 ? mma_rate_kernel<false, 4>
                               : mma_rate_kernel<false, 1>);
  kern<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (long long*)cycles, iters, (int*)sink);
  return (int)cudaGetLastError();
}
