// TWM macro read as a GEMM, for Hopper (sm_90a): the bit-packed popcount
// GEMM (B.7) and the int8 tensor-core GEMM (B.8), each with the SA
// epilogue, each with two tiles picked from the shape by the host.
//
// Replaces the reference's Pallas kernels
//   src/repro/kernels/twm_matmul.py::twm_matmul      (B.7)
//   src/repro/kernels/twm_matmul.py::twm_matmul_mxu  (B.8)
// which the reference's kernel library launches once per dense layer
// (ops.twm_linear, ops.twm_linear_mxu; ops.pick_path chooses between
// them from the shape).  Every call is one launch of one of the kernels
// below: the pure host functions _popcount_tile and _mxu_tile in
// kernels/twm_matmul.py pick which, with the thresholds measured there
// (chip_smoke.py's tile sweep on an H100).  A tile that fails to build
// or launch raises; nothing falls back to another tile or to the plain
// version.
//
// B.7: x (m, kw) packed activation words against the (kw, n) positive /
// negative weight planes: out = sum_k popc(x & wp) - popc(x & wn), raw
// int32 or SA'd {0,1}.  Popcount has no tensor-core path; the SM issues
// 16 popc a clock, two per word pair, and that bounds a large product.
//  * twm_matmul_gemv_kernel, while 64 x 64 tiles would fill less than
//    two waves of the SMs (m <= 16 always; POPCOUNT_TILE64_MIN_WAVES: at
//    136 tiles, a second nearly empty wave, the 64 x 64 tile took 0.0228
//    ms against this tile's 0.0144; at 256 they tie, 0.0230 / 0.0234):
//    one thread per output column and k-slice, lanes on neighbouring
//    columns so plane loads coalesce; cb columns per
//    256-thread CTA (32, fewer when n is under a warp) and 256 / cb
//    k-slices splitting each column's words; up to 16 rows per CTA, their
//    words staged in shared memory and broadcast (a single row is read
//    beside the planes instead: it has no reuse, and staging would add a
//    barrier).  Sums are reduced by shuffle where a warp holds several
//    k-slices of a column (fc2's n = 12), then through shared memory,
//    then SA'd.  Small m is latency: one round of loads, all in flight,
//    and many warps with short loops (a lone warp looping over its words
//    measured slower).  Mid m (e.g. 256 rows: 32 tiles of 64 x 64 on 132
//    SMs) takes 16-row blocks over many CTAs, up to the popcount bound.
//  * twm_matmul_kernel, once 64 x 64 tiles fill two waves: one CTA of 256
//    threads per 64 x 64 output tile, K in chunks of 32 words (1,024
//    wordlines, the macro's height) staged in shared memory; each thread
//    owns a 4 x 4 register tile, 32 popcount pairs per word, at the
//    popcount bound.
//
// B.8: x (m, kp) int8 {0,1} against the weights transposed to (n, kp)
// int8 {-1,0,1} (both K-major, as int8 wgmma requires), kp a multiple of
// 32 zero-padded by the caller; int32 sums are exact as |acc| <= K; then
// the SA.  Bound on H100: 2 m n k int8 operations at 1,979 TOP/s against
// the bytes, of which the m x n int32 output dominates at large m.
//  * twm_matmul_mxu_gemv_kernel (m <= 12, the measured crossover): each
//    warp takes one column's weight row (16-byte coalesced loads, each
//    row read once), wpc warps split its K and a CTA holds 8 / wpc
//    columns, so the columns spread over about one CTA per SM; the <= 16
//    activation rows sit in shared memory; s8 dots by __dp4a; shuffle and
//    shared-memory reduction in the CTA, then the SA.  No second pass, no
//    atomics.  Latency-bound.
//  * twm_matmul_mxu_wgmma_kernel (m > 12): wgmma.mma_async m64nNk32
//    s32.s8.s8, both operands K-major in shared memory, fed by a TMA ring
//    (cp.async.bulk.tensor, 128-byte swizzle matching the wgmma
//    descriptors) of 128-byte K slices under full / empty mbarriers: one
//    producer thread issues the loads, two consumer warpgroups issue
//    wgmma and release each stage once the next slice's products are in
//    flight.  Two tiles: 128 x 256 (two 64-row consumers,
//    setmaxnreg for their 128 accumulators, 3 stages) once there are 64
//    of them (MXU_WIDE_MIN_TILES: 64 x 64 won at 32 tiles of 128 x 256,
//    0.0070 against 0.0101 ms, 128 x 256 at 64, 0.0101 against 0.0116),
//    else 64 x 64 with the K slices split between the consumers and
//    summed in the epilogue (8 stages; 256 rows x 512 columns are 4 tiles
//    of 128 x 256 on 132 SMs, 32 of 64 x 64).  The grid is persistent,
//    min(tiles, SMs) CTAs walking the tiles, so the producer loads a
//    tile's slices during the previous tile's epilogue.
//    Epilogue: the SA parameters go to shared memory during the K loop;
//    where n % 4 == 0 (16-byte output rows), each consumer writes its
//    SA'd 64-column round into one of two 128-byte-swizzled buffers and
//    one thread stores it by TMA, which drains while the next tile's
//    products run;
//    otherwise (and for the K-split sums) the raw sums are staged with a
//    padded pitch and stored with 16-byte stores, or 4-byte ones where
//    rows are not 16-byte aligned.  Ragged m, n and k are zero-filled by
//    TMA on load and clipped or masked on store.  At large m the output
//    stores and the operand traffic from L2 are what remain.

#include <atomic>
#include <cstdint>
#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled_v12000
#include <cuda_runtime.h>

__device__ __forceinline__ int sa_bit(int acc, float thr, int flip) {
  return (int)((__int2float_rn(acc) >= thr) != (flip != 0));
}

// ---- B.7: packed popcount GEMM --------------------------------------------
// B.7 large-m tile: 64 x 64 outputs per CTA

#define TM_BM 64
#define TM_BN 64
#define TM_KC 32
#define TM_THREADS 256

__global__ void __launch_bounds__(TM_THREADS) twm_matmul_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ wp,
    const uint32_t* __restrict__ wn, const float* __restrict__ thr,
    const int32_t* __restrict__ flip, int32_t* __restrict__ out, int m,
    int kw, int n, int sa) {
  __shared__ uint32_t x_s[TM_BM][TM_KC + 1];  // +1: rows on distinct banks
  __shared__ uint32_t wp_s[TM_KC][TM_BN];
  __shared__ uint32_t wn_s[TM_KC][TM_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TM_BM, n0 = blockIdx.x * TM_BN;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  for (int k0 = 0; k0 < kw; k0 += TM_KC) {
    const int kc = min(TM_KC, kw - k0);
    for (int i = tid; i < TM_BM * TM_KC; i += TM_THREADS) {
      const int r = i / TM_KC, c = i % TM_KC;
      x_s[r][c] = (m0 + r < m && c < kc)
                      ? __ldg(x + (size_t)(m0 + r) * kw + k0 + c) : 0u;
    }
    for (int i = tid; i < TM_KC * TM_BN; i += TM_THREADS) {
      const int r = i / TM_BN, c = i % TM_BN;
      const bool in = r < kc && n0 + c < n;
      const size_t g = (size_t)(k0 + r) * n + n0 + c;
      wp_s[r][c] = in ? __ldg(wp + g) : 0u;
      wn_s[r][c] = in ? __ldg(wn + g) : 0u;
    }
    __syncthreads();
    for (int j = 0; j < kc; ++j) {
      uint32_t xv[4], vp[4], vn[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = x_s[ty + 16 * i][j];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        vp[c] = wp_s[j][tx + 16 * c];
        vn[c] = wn_s[j][tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[i][c] += __popc(xv[i] & vp[c]) - __popc(xv[i] & vn[c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = n0 + tx + 16 * c;
      if (col >= n) continue;
      int y = acc[i][c];
      if (sa) y = sa_bit(y, __ldg(thr + col), __ldg(flip + col));
      out[(size_t)row * n + col] = y;
    }
  }
}

// B.7 small-m tile: one thread per (column, k-slice)

#define PG_THREADS 256
#define PG_XW 256  // activation words staged in shared memory per chunk
#define PG_PW 4    // plane words a thread keeps in flight

template <int MB>
__global__ void __launch_bounds__(PG_THREADS) twm_matmul_gemv_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ wp,
    const uint32_t* __restrict__ wn, const float* __restrict__ thr,
    const int32_t* __restrict__ flip, int32_t* __restrict__ out, int m,
    int kw, int n, int cb, int sa) {
  __shared__ uint32_t xs[MB][PG_XW];
  __shared__ int red[PG_THREADS * MB];
  const int tid = threadIdx.x, lane = tid % 32;
  const int ci = tid % cb, ks = tid / cb, nks = PG_THREADS / cb;
  const int col = blockIdx.x * cb + ci, r0 = blockIdx.y * MB;
  const int rows = min(MB, m - r0);
  // the SA parameters of this thread's column (the one it stores at the
  // end, as PG_THREADS % cb == 0), fetched while the sums are taken
  float tc = 0.f;
  int fc = 0;
  if (sa && col < n) {
    tc = __ldg(thr + col);
    fc = __ldg(flip + col);
  }
  int acc[MB];
#pragma unroll
  for (int r = 0; r < MB; ++r) acc[r] = 0;
  for (int k0 = 0; k0 < kw; k0 += PG_XW) {
    const int kc = min(PG_XW, kw - k0);
    uint32_t vp[PG_PW], vn[PG_PW], xv1[PG_PW];
    auto load = [&](int j) {
#pragma unroll
      for (int u = 0; u < PG_PW; ++u) {
        const int jj = j + u * nks;
        const bool in = col < n && jj < kc;
        const size_t gi = (size_t)(k0 + jj) * n + col;
        vp[u] = in ? __ldg(wp + gi) : 0u;
        vn[u] = in ? __ldg(wn + gi) : 0u;
        // one row: its words are read straight from global memory beside
        // the planes (a thread uses each once), with no staging barrier
        if (MB == 1) xv1[u] = in ? __ldg(x + (size_t)r0 * kw + k0 + jj) : 0u;
      }
    };
    load(ks);  // the first plane words load while the activations stage
    if (MB > 1) {
      for (int i = tid; i < MB * kc; i += PG_THREADS) {
        const int r = i / kc, c = i % kc;
        xs[r][c] = r < rows ? __ldg(x + (size_t)(r0 + r) * kw + k0 + c) : 0u;
      }
      __syncthreads();
    }
    for (int j = ks; j < kc; j += PG_PW * nks) {
      if (j != ks) load(j);
#pragma unroll
      for (int u = 0; u < PG_PW; ++u) {
        const int jj = j + u * nks;
        if (jj >= kc) break;
#pragma unroll
        for (int r = 0; r < MB; ++r) {
          const uint32_t xv = MB == 1 ? xv1[u] : xs[r][jj];
          acc[r] += __popc(xv & vp[u]) - __popc(xv & vn[u]);
        }
      }
    }
    if (MB > 1) __syncthreads();
  }
  // k-slices of one column: inside the warp by shuffle (cb < 32), then
  // across the warps through shared memory
  int groups = nks, gid = ks;
  if (cb < 32) {
    for (int off = cb; off < 32; off <<= 1)
#pragma unroll
      for (int r = 0; r < MB; ++r)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    groups = PG_THREADS / 32;
    gid = tid / 32;
  }
  if (cb >= 32 || lane < cb)
#pragma unroll
    for (int r = 0; r < MB; ++r) red[(gid * MB + r) * cb + ci] = acc[r];
  __syncthreads();
  if (col >= n) return;
  for (int r = ks; r < rows; r += nks) {  // rows of this thread's column
    int y = 0;
    for (int g = 0; g < groups; ++g) y += red[(g * MB + r) * cb + ci];
    out[(size_t)(r0 + r) * n + col] = sa ? sa_bit(y, tc, fc) : y;
  }
}

// ---- B.8 large-m tile: wgmma fed by a TMA ring ---------------------------

#define MX_BK 128          // bytes of K per ring slice: one 128-byte swizzle row
#define MX_EC 64           // output columns staged per epilogue round
#define MX_EP (MX_EC + 8)  // staging pitch in words: conflict-free int2 writes
#define MX_THREADS 384     // producer warpgroup + two consumer warpgroups
#define MX_OUT_BOX 32      // int32 columns of one output TMA box (128 bytes)
#define MX_OUT_BUF (64 * MX_EC * 4)  // one consumer's 64 x 64 output round
#define MX_MAX_DEVICES 64  // cards a process may launch the wgmma tiles on

template <int BN, bool KSPLIT>
struct MxuCfg {
  static constexpr int BM = KSPLIT ? 64 : 128;
  static constexpr int A_BYTES = BM * MX_BK;
  static constexpr int B_BYTES = BN * MX_BK;
  static constexpr int STAGE = A_BYTES + B_BYTES;  // a multiple of 1,024
  static constexpr int STAGES = KSPLIT ? 8 : 3;
  static constexpr int RING = STAGES * STAGE;
  // epilogue staging: raw sums with a padded pitch (K-split, or n % 4 !=
  // 0), or per consumer two buffers of 64 rows x 64 SA'd columns in the
  // 128-byte swizzle the output tensor map stores from
  static constexpr int STAGING_RAW = 2 * 64 * MX_EP * 4;
  static constexpr int STAGING_TMA = KSPLIT ? 0 : 2 * 2 * MX_OUT_BUF;
  static constexpr int STAGING =
      STAGING_RAW > STAGING_TMA ? STAGING_RAW : STAGING_TMA;
  static constexpr int SA_PARAMS = 2 * BN * 8;  // per consumer thr, flip
  static constexpr int SMEM =
      1024 + RING + STAGING + SA_PARAMS + 2 * STAGES * 8;
  static_assert(KSPLIT ? BN == 64 : BN == 256, "the two wgmma tiles");
  static_assert(!KSPLIT || STAGES % 2 == 0, "K-split needs even stages");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni LAB_DONE;\nbra.uni LAB_WAIT;\nLAB_DONE:\n}\n" ::"r"(
          smem_u32(bar)), "r"(parity) : "memory");
}

// one box of a 2-D tensor map into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle TMA writes: 8-row groups 1,024 bytes apart (SBO), the
// leading offset unused under swizzle, layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// the 128 threads of consumer warpgroup c (barriers 2 and 3)
__device__ __forceinline__ void consumer_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
}

// one box of shared memory to the 2-D tensor map at (c0, c1); the part
// outside the tensor is not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"((uint64_t)map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N committed store groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// makes this thread's shared-memory writes visible to the TMA unit
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_n64(int* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN, bool KSPLIT>
__global__ void __launch_bounds__(MX_THREADS, 1) twm_matmul_mxu_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap omap, const float* __restrict__ thr,
    const int32_t* __restrict__ flip, int32_t* __restrict__ out, int m,
    int kp, int n, int tma_out) {
  using C = MxuCfg<BN, KSPLIT>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle wants each tile on a 1,024-byte boundary
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  int32_t* stg = reinterpret_cast<int32_t*>(smem + C::RING);
  float* sa_thr = reinterpret_cast<float*>(smem + C::RING + C::STAGING);
  int* sa_flip = reinterpret_cast<int*>(sa_thr + 2 * BN);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::RING + C::STAGING +
                                               C::SA_PARAMS);
  uint64_t* empty = full + C::STAGES;
  const int tid = threadIdx.x, wg = tid / 128;
  const int tiles_n = (n + BN - 1) / BN;
  const int n_tiles = ((m + C::BM - 1) / C::BM) * tiles_n;
  const int nk = (kp + MX_BK - 1) / MX_BK;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], KSPLIT ? 1 : 2);  // one arrival per reader
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread keeps the ring full
    if constexpr (BN == 256) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int row0 = (tile / tiles_n) * C::BM;
        const int col0 = (tile % tiles_n) * BN;
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int s = it % C::STAGES;
          mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
          uint8_t* a = smem + s * C::STAGE;
          mbar_expect_tx(&full[s], C::STAGE);
          tma_load(a, &xmap, &full[s], ks * MX_BK, row0);
          tma_load(a + C::A_BYTES, &wmap, &full[s], ks * MX_BK, col0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c takes rows 64c.. of the tile (or, K-split,
  // the slices it % 2 == c of a 64-row tile: with an even number of
  // stages each stage has one reader, so its phases are waited in order)
  if constexpr (BN == 256) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, ct = tid - 128;
  const int w = (tid / 32) % 4, lane = tid % 32, g = lane >> 2, t = lane & 3;
  // one thread per consumer releases its stages and issues its stores
  const bool issuer = (tid & 127) == 0;
  int acc[BN / 2];
  int it = 0, round = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = (tile / tiles_n) * C::BM;
    const int col0 = (tile % tiles_n) * BN;
    // the tile's SA parameters, fetched during the K loop into this
    // consumer's shared copy (its previous epilogue has read the old one;
    // its epilogue's first barrier publishes the new one)
    float* my_thr = sa_thr + c * BN;
    int* my_flip = sa_flip + c * BN;
    for (int i = tid & 127; i < BN; i += 128) {
      const int gcol = col0 + i;
      my_thr[i] = gcol < n ? __ldg(thr + gcol) : 0.f;
      my_flip[i] = gcol < n ? __ldg(flip + gcol) : 0;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    fence_acc<BN / 2>(acc);
    int held = -1;  // the stage the last issued products still read
    for (int ks = 0; ks < nk; ++ks, ++it) {
      if (KSPLIT && (it & 1) != c) continue;  // a stage keeps its reader
      const int s = it % C::STAGES;
      mbar_wait(&full[s], (it / C::STAGES) & 1);
      const uint8_t* a = smem + s * C::STAGE + (KSPLIT ? 0 : c * 64 * MX_BK);
      const uint8_t* b = smem + s * C::STAGE + C::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < MX_BK; kk += 32) {
        const uint64_t da = sw128_desc(a + kk);
        if constexpr (BN == 64) {
          wgmma_n64(acc, da, sw128_desc(b + kk));
        } else {
#pragma unroll
          for (int h = 0; h < BN / 128; ++h)
            wgmma_n128(acc + 64 * h, da, sw128_desc(b + h * 128 * MX_BK + kk));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done
      if (held >= 0 && issuer) mbar_arrive(&empty[held]);
      held = s;
    }
    wgmma_wait<0>();
    fence_acc<BN / 2>(acc);
    if (held >= 0 && issuer) mbar_arrive(&empty[held]);

    // accumulator e of column block j: row g + 8 (e / 2) of warp w's 16,
    // column 8 j + 2 t + e % 2
    if (!KSPLIT && tma_out) {
      // epilogue by TMA store, each consumer on its own 64 rows, 64
      // columns a round: SA in registers -> a free one of its two
      // swizzled buffers -> two 32-column boxes stored asynchronously,
      // which drain while the next tile's products run
#pragma unroll
      for (int ch = 0; ch < BN / MX_EC; ++ch, ++round) {
        uint8_t* buf = reinterpret_cast<uint8_t*>(stg) +
                       (c * 2 + (round & 1)) * MX_OUT_BUF;
        if (issuer) bulk_wait_read<1>();  // the buffer's last store read it
        consumer_sync(c);
#pragma unroll
        for (int j = 0; j < MX_EC / 8; ++j) {
          const int cl = 8 * j + 2 * t;  // column in the round
          const float2 th = *reinterpret_cast<const float2*>(
              my_thr + ch * MX_EC + cl);
          const int2 fl = *reinterpret_cast<const int2*>(
              my_flip + ch * MX_EC + cl);
          const int* d = acc + (ch * (MX_EC / 8) + j) * 4;
          uint8_t* box = buf + (cl / MX_OUT_BOX) * (MX_OUT_BUF / 2);
          const int cx = cl % MX_OUT_BOX;  // column in the box
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * w + g + 8 * h;
            *reinterpret_cast<int2*>(
                box + r * 128 + (((cx >> 2) ^ (r & 7)) << 4) + (cx & 3) * 4) =
                make_int2(sa_bit(d[2 * h], th.x, fl.x),
                          sa_bit(d[2 * h + 1], th.y, fl.y));
          }
        }
        fence_async_smem();
        consumer_sync(c);
        if (issuer) {
          for (int b = 0; b < MX_EC / MX_OUT_BOX; ++b)
            tma_store(&omap, buf + b * (MX_OUT_BUF / 2),
                      col0 + ch * MX_EC + b * MX_OUT_BOX, row0 + 64 * c);
          bulk_commit();
        }
      }
      continue;
    }
    // otherwise 64 columns a round: raw fragments -> staging, then each
    // row's 64 columns as 16 coalesced 16-byte stores (4-byte stores
    // where n % 4 != 0)
    int32_t* mine = stg + c * 64 * MX_EP;
#pragma unroll
    for (int ch = 0; ch < BN / MX_EC; ++ch) {
#pragma unroll
      for (int j = 0; j < MX_EC / 8; ++j) {
        const int* d = acc + (ch * (MX_EC / 8) + j) * 4;
        int32_t* p = mine + (16 * w + g) * MX_EP + 8 * j + 2 * t;
        *reinterpret_cast<int2*>(p) = make_int2(d[0], d[1]);
        *reinterpret_cast<int2*>(p + 8 * MX_EP) = make_int2(d[2], d[3]);
      }
      consumers_sync();
      for (int i = ct; i < C::BM * (MX_EC / 4); i += 256) {
        const int r = i / (MX_EC / 4), q = i % (MX_EC / 4);
        const int grow = row0 + r, gcol = col0 + ch * MX_EC + 4 * q;
        if (grow >= m || gcol >= n) continue;
        // split-M: rows 64..127 are the second consumer's region, which
        // follows the first; K-split: the two regions are added
        int4 v = *reinterpret_cast<const int4*>(stg + r * MX_EP + 4 * q);
        if (KSPLIT) {
          const int4 u = *reinterpret_cast<const int4*>(
              stg + (64 + r) * MX_EP + 4 * q);
          v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
        }
        const int cl = ch * MX_EC + 4 * q;
        const float4 th = *reinterpret_cast<const float4*>(my_thr + cl);
        const int4 fl = *reinterpret_cast<const int4*>(my_flip + cl);
        const int y[4] = {sa_bit(v.x, th.x, fl.x), sa_bit(v.y, th.y, fl.y),
                          sa_bit(v.z, th.z, fl.z), sa_bit(v.w, th.w, fl.w)};
        int32_t* o = out + (size_t)grow * n + gcol;
        if ((n & 3) == 0) {
          *reinterpret_cast<int4*>(o) = make_int4(y[0], y[1], y[2], y[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (gcol + e < n) o[e] = y[e];
        }
      }
      consumers_sync();
    }
  }
  if (issuer) bulk_wait_read<0>();  // the CTA's shared memory outlives them
}

// ---- B.8 small-m tile: GEMV-shaped, __dp4a -------------------------------

#define GV_THREADS 256
#define GV_XB 2048  // activation bytes of K staged per chunk and row
#define GV_PW 2     // 16-byte weight chunks a lane keeps in flight

template <int MB>
__global__ void __launch_bounds__(GV_THREADS) twm_matmul_mxu_gemv_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
    const float* __restrict__ thr, const int32_t* __restrict__ flip,
    int32_t* __restrict__ out, int m, int kp, int n, int wpc) {
  __shared__ int4 xs[MB][GV_XB / 16];
  __shared__ int red[GV_THREADS / 32][MB];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cpc = (GV_THREADS / 32) / wpc;  // columns per CTA
  const int col = blockIdx.x * cpc + warp / wpc, part = warp % wpc;
  const int r0 = blockIdx.y * MB, rows = min(MB, m - r0);
  // the SA parameters of the column this thread stores at the end
  // (GV_THREADS % cpc == 0), fetched while the sums are taken
  const int scol = blockIdx.x * cpc + tid % cpc;
  float tc = 0.f;
  int fc = 0;
  if (scol < n) {
    tc = __ldg(thr + scol);
    fc = __ldg(flip + scol);
  }
  const int first = part * 32 + lane, step = wpc * 32;
  int acc[MB];
#pragma unroll
  for (int r = 0; r < MB; ++r) acc[r] = 0;
  for (int k0 = 0; k0 < kp; k0 += GV_XB) {
    const int nc = min(GV_XB, kp - k0) / 16;  // 16-byte chunks
    const int4* row = reinterpret_cast<const int4*>(
        wt + (size_t)min(col, n - 1) * kp + k0);
    int4 b[GV_PW];
    auto load = [&](int c) {
#pragma unroll
      for (int u = 0; u < GV_PW; ++u) {
        const int cc = c + u * step;
        b[u] = (col < n && cc < nc) ? __ldg(row + cc) : make_int4(0, 0, 0, 0);
      }
    };
    load(first);  // the first weight chunks load while the activations stage
    for (int i = tid; i < MB * nc; i += GV_THREADS) {
      const int r = i / nc, c = i % nc;
      xs[r][c] = r < rows ? __ldg(reinterpret_cast<const int4*>(
                                      x + (size_t)(r0 + r) * kp + k0) + c)
                          : make_int4(0, 0, 0, 0);
    }
    __syncthreads();
    for (int c = first; c < nc; c += GV_PW * step) {
      if (c != first) load(c);
#pragma unroll
      for (int u = 0; u < GV_PW; ++u) {
        const int cc = c + u * step;
        if (cc >= nc) break;
#pragma unroll
        for (int r = 0; r < MB; ++r) {
          const int4 a = xs[r][cc];
          acc[r] = __dp4a(a.x, b[u].x, acc[r]);
          acc[r] = __dp4a(a.y, b[u].y, acc[r]);
          acc[r] = __dp4a(a.z, b[u].z, acc[r]);
          acc[r] = __dp4a(a.w, b[u].w, acc[r]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < MB; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < MB; ++r) red[warp][r] = acc[r];
  __syncthreads();
  if (scol >= n) return;
  const int cc = tid % cpc;
  for (int r = tid / cpc; r < rows; r += GV_THREADS / cpc) {
    int y = 0;
    for (int p = 0; p < wpc; ++p) y += red[cc * wpc + p][r];
    out[(size_t)(r0 + r) * n + scol] = sa_bit(y, tc, fc);
  }
}

// ---- plain C interface (ctypes) -------------------------------------------
// The host (kernels/twm_matmul.py) picks the tile and the grid and passes
// them in; a bad choice is refused with cudaErrorInvalidValue.

template <int MB>
static void launch_popcount_gemv(dim3 grid, cudaStream_t st, const void* x,
                                 const void* wp, const void* wn,
                                 const void* thr, const void* flip, void* out,
                                 int m, int kw, int n, int cb, int sa) {
  twm_matmul_gemv_kernel<MB><<<grid, PG_THREADS, 0, st>>>(
      (const uint32_t*)x, (const uint32_t*)wp, (const uint32_t*)wn,
      (const float*)thr, (const int32_t*)flip, (int32_t*)out, m, kw, n, cb,
      sa);
}

// tile 0: twm_matmul_gemv_kernel<mb> with cb columns per CTA; tile 1: the
// 64 x 64 twm_matmul_kernel
extern "C" int twm_matmul_launch(const void* x, const void* wp,
                                 const void* wn, const void* thr,
                                 const void* flip, void* out, int m, int kw,
                                 int n, int sa, int tile, int mb, int cb,
                                 int gx, int gy, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(gx, gy);
  if (tile == 1) {
    twm_matmul_kernel<<<grid, TM_THREADS, 0, st>>>(
        (const uint32_t*)x, (const uint32_t*)wp, (const uint32_t*)wn,
        (const float*)thr, (const int32_t*)flip, (int32_t*)out, m, kw, n,
        sa);
    return (int)cudaGetLastError();
  }
  if (tile != 0 || cb < 8 || cb > PG_THREADS || (cb & (cb - 1)))
    return (int)cudaErrorInvalidValue;
  switch (mb) {
    case 1: launch_popcount_gemv<1>(grid, st, x, wp, wn, thr, flip, out, m, kw, n, cb, sa); break;
    case 2: launch_popcount_gemv<2>(grid, st, x, wp, wn, thr, flip, out, m, kw, n, cb, sa); break;
    case 4: launch_popcount_gemv<4>(grid, st, x, wp, wn, thr, flip, out, m, kw, n, cb, sa); break;
    case 8: launch_popcount_gemv<8>(grid, st, x, wp, wn, thr, flip, out, m, kw, n, cb, sa); break;
    case 16: launch_popcount_gemv<16>(grid, st, x, wp, wn, thr, flip, out, m, kw, n, cb, sa); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled is a driver-API call; it is taken through the
// runtime's entry-point query, so the library links nothing beyond cudart
// (once per process: a function-local static is initialised under the
// compiler's guard, so concurrent first calls are safe)
static PFN_cuTensorMapEncodeTiled_v12000 lookup_tensor_map_encoder() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t e = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
  return e == cudaSuccess && q == cudaDriverEntryPointSuccess
             ? (PFN_cuTensorMapEncodeTiled_v12000)p
             : nullptr;
}

static PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn =
      lookup_tensor_map_encoder();
  return fn;
}

// (rows, kp) int8, K-contiguous, read in boxes of 128 bytes of K by
// box_rows rows with the 128-byte swizzle; out-of-range elements read 0
static int k_major_map(CUtensorMap* map, const void* base, int rows, int kp,
                       int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kp};
  const cuuint32_t box[2] = {MX_BK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// (m, n) int32 output written in boxes of 32 columns x 64 rows from the
// 128-byte swizzle of the staging buffers
static int output_map(CUtensorMap* map, void* base, int m, int n) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};
  const cuuint32_t box[2] = {MX_OUT_BOX, 64};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, base, dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN, bool KSPLIT>
static int launch_mxu_wgmma(int grid, cudaStream_t st, const void* x,
                            const void* wt, const void* thr,
                            const void* flip, void* out, int m, int kp,
                            int n) {
  using C = MxuCfg<BN, KSPLIT>;
  // the shared-memory opt-in, once per device (the caller has made the
  // tensors' device current); a repeated opt-in is harmless, so a race
  // between two host threads costs nothing
  static std::atomic<bool> ready[MX_MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MX_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev].load()) {
    e = cudaFuncSetAttribute(twm_matmul_mxu_wgmma_kernel<BN, KSPLIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready[dev].store(true);
  }
  // maps are built per call and passed by value (__grid_constant__), so a
  // captured CUDA graph holds its own copy
  CUtensorMap xmap, wmap, omap = {};
  int rc = k_major_map(&xmap, x, m, kp, C::BM);
  if (rc) return rc;
  rc = k_major_map(&wmap, wt, n, kp, BN);
  if (rc) return rc;
  // the TMA store needs 16-byte row strides: n % 4 == 0
  const int tma_out = !KSPLIT && n % 4 == 0;
  if (tma_out && (rc = output_map(&omap, out, m, n))) return rc;
  twm_matmul_mxu_wgmma_kernel<BN, KSPLIT><<<grid, MX_THREADS, C::SMEM, st>>>(
      xmap, wmap, omap, (const float*)thr, (const int32_t*)flip,
      (int32_t*)out, m, kp, n, tma_out);
  return (int)cudaGetLastError();
}

template <int MB>
static void launch_mxu_gemv(dim3 grid, cudaStream_t st, const void* x,
                            const void* wt, const void* thr,
                            const void* flip, void* out, int m, int kp,
                            int n, int wpc) {
  twm_matmul_mxu_gemv_kernel<MB><<<grid, GV_THREADS, 0, st>>>(
      (const int8_t*)x, (const int8_t*)wt, (const float*)thr,
      (const int32_t*)flip, (int32_t*)out, m, kp, n, wpc);
}

// tile 0: twm_matmul_mxu_gemv_kernel<mb>, wpc warps per column, grid
// (gx, gy); tiles 1 and 2: the wgmma kernel at 128 x 256 and 64 x 64
// K-split, gx persistent CTAs
extern "C" int twm_matmul_mxu_launch(const void* x, const void* wt,
                                     const void* thr, const void* flip,
                                     void* out, int m, int kp, int n,
                                     int tile, int mb, int wpc, int gx,
                                     int gy, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (kp % 32) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 1: return launch_mxu_wgmma<256, false>(gx, st, x, wt, thr, flip, out, m, kp, n);
    case 2: return launch_mxu_wgmma<64, true>(gx, st, x, wt, thr, flip, out, m, kp, n);
    case 0: break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (wpc != 1 && wpc != 2 && wpc != 4 && wpc != 8)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(gx, gy);
  switch (mb) {
    case 1: launch_mxu_gemv<1>(grid, st, x, wt, thr, flip, out, m, kp, n, wpc); break;
    case 2: launch_mxu_gemv<2>(grid, st, x, wt, thr, flip, out, m, kp, n, wpc); break;
    case 4: launch_mxu_gemv<4>(grid, st, x, wt, thr, flip, out, m, kp, n, wpc); break;
    case 8: launch_mxu_gemv<8>(grid, st, x, wt, thr, flip, out, m, kp, n, wpc); break;
    case 16: launch_mxu_gemv<16>(grid, st, x, wt, thr, flip, out, m, kp, n, wpc); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
