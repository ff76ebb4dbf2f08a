// Shared pieces of the port's tensor-core kernels for Hopper (sm_90a):
// asynchronous copies into shared memory, the u8 x s8 and 1-bit
// `mma.sync` tiles, the A-fragment word loads, and the two-slot weight ring
// that streams a layer's weights (laid out on the host in fragment order)
// through shared memory.  Included by hop_megakernel.cu (B.1/B.2),
// bnn_conv1d.cu (B.4, B.5) and mma_rate.cu.
//
// The u8 fragment order is `hop_megakernel.fragment_layout`'s: lane 4 g + t
// of n-tile j and k-step s holds the 8 bytes of column 8 j + g at depths
// 32 s + 4 t .. +3 and 32 s + 16 + 4 t .. +3, the B fragment of
// `mma.m16n8k32.row.col` for that lane, so a lane's B fragment is one
// 8-byte load and a warp's is 256 contiguous bytes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// One pass of the weight stream: a layer's weights of one model, in chunks
// of `chunk_tiles` n-tiles.
struct Pass {
  const int8_t* w;
  int nchunks, chunk_bytes, last_bytes, unused;
};

// The helpers below are not all inlined, and a pointer parameter loses the
// knowledge that it points into shared memory: without this hint every
// access through it compiles to a generic load or store.
#define ASSUME_SHARED(p) __builtin_assume(__isShared(p))

// ---- asynchronous copies and the MMA -------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait2() {
  asm volatile("cp.async.wait_group 2;\n" ::);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// D += A (16x32 u8, row) * B (32x8 s8, col), int32 accumulators.
__device__ __forceinline__ void mma_u8s8(int (&c)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// D += popc(A (16x256 bits, row) & B (256x8 bits, col)), int32
// accumulators: lane (g, t) holds bits 32 t .. 32 t + 31 of rows g (a0) and
// g + 8 (a1) and bits 128 + 32 t .. of both (a2, a3); of column g, bits
// 32 t .. (b0) and 128 + 32 t .. (b1).
__device__ __forceinline__ void mma_b1(int (&c)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---- the weight ring -----------------------------------------------------
//
// Two slots; chunk n lives in slot n & 1.  Invariant between calls: chunks
// `used` and `used + 1` have been issued (each as one commit group, empty
// past the end of the stream), so waiting until one group is pending
// leaves chunk `used` landed.

struct Ring {
  unsigned char* buf;
  int slot_bytes, used, issued;
  int lp, lc, np;  // load cursor: pass, chunk; number of passes
};

__device__ __forceinline__ void ring_issue(Ring& R, const Pass* passes) {
  if (R.lp < R.np) {
    const Pass& p = passes[R.lp];
    const int bytes = R.lc + 1 == p.nchunks ? p.last_bytes : p.chunk_bytes;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(p.w) +
        (size_t)R.lc * p.chunk_bytes;
    unsigned char* dst = R.buf + (size_t)(R.issued & 1) * R.slot_bytes;
    for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
      cp_async16(dst + i, src + i);
    if (++R.lc == p.nchunks) {
      R.lc = 0;
      ++R.lp;
    }
  }
  ++R.issued;
  cp_async_commit();
}

__device__ __forceinline__ const int8_t* ring_acquire(Ring& R) {
  cp_async_wait1();
  __syncthreads();
  return reinterpret_cast<const int8_t*>(R.buf +
                                         (size_t)(R.used & 1) * R.slot_bytes);
}

__device__ __forceinline__ void ring_release(Ring& R, const Pass* passes) {
  __syncthreads();  // every warp is done with the slot: refill it
  ++R.used;
  ring_issue(R, passes);
}

template <bool ALIGNED>
__device__ __forceinline__ unsigned a_word(const unsigned char* p) {
  if (ALIGNED) return *reinterpret_cast<const unsigned*>(p);
  return (unsigned)p[0] | ((unsigned)p[1] << 8) | ((unsigned)p[2] << 16) |
         ((unsigned)p[3] << 24);
}
