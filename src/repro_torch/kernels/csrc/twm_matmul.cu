// TWM macro read as a GEMM, for Hopper (sm_90a): the bit-packed popcount
// GEMM and the int8 tensor-core GEMM, each with the SA epilogue.
//
// Replaces the reference's Pallas kernels
//   src/repro/kernels/twm_matmul.py::twm_matmul      (B.7)
//   src/repro/kernels/twm_matmul.py::twm_matmul_mxu  (B.8)
// which the reference's kernel library launches once per dense layer
// (ops.twm_linear, ops.twm_linear_mxu; ops.pick_path chooses between
// them from the shape).
//
// B.7, twm_matmul_kernel.  x (m, kw) packed activation words against the
// (kw, n) positive / negative weight planes: out = sum_k popc(x & wp) -
// popc(x & wn), raw int32 or SA'd {0,1}.  One CTA of 256 threads per
// 64 x 64 output tile; the contraction runs in chunks of 32 words (1,024
// wordlines, the macro's height), each chunk's x tile and plane tiles
// staged in shared memory, so any kw is taken.  Each thread owns a 4 x 4
// register tile (rows ty + 16 i, columns tx + 16 j): per word it loads 4
// activation words and 4 + 4 plane words from shared memory and does 32
// popcount pairs.  Bound on H100: the packed operands are 32x smaller
// than int32 ones, so at the library's shapes the work is the bound:
// m * n * kw popcount pairs on the CUDA cores (no tensor-core path for
// popcount), or for small m the output and weight bytes.
//
// B.8, twm_matmul_mxu_kernel.  x (m, kp) int8 {0,1} against the weights
// transposed to (n, kp) int8 {-1,0,1} (both K-contiguous, the row.col
// layout of the int8 MMA), kp a multiple of 32 zero-padded by the caller:
// int32 accumulators through warp-level
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, exact since
// |acc| <= K, then the SA epilogue.  One CTA of 4 warps per 64 x 64 tile,
// each warp a 32 x 32 quarter (2 x 4 MMA tiles); the K loop stages
// 64-byte slices of both operands in shared memory with a row pitch of 80
// bytes, so each fragment load of a warp touches all 32 banks once.
// Bound on H100: 2 * m * n * k int8 operations at 1,979 TOP/s against
// the bytes, of which the m * n int32 output dominates at large m.
// wgmma, TMA and a multi-stage pipeline are later work.

#include <cstdint>
#include <cuda_runtime.h>

// ---- B.7: packed popcount GEMM --------------------------------------------

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
      if (sa)
        y = (int)((__int2float_rn(y) >= __ldg(thr + col)) !=
                  (__ldg(flip + col) != 0));
      out[(size_t)row * n + col] = y;
    }
  }
}

// ---- B.8: int8 tensor-core GEMM with the SA epilogue ----------------------

#define MX_BM 64
#define MX_BN 64
#define MX_BK 64
#define MX_LDS 80  // shared row pitch in bytes: 16-B aligned, bank-spread
#define MX_THREADS 128

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(MX_THREADS) twm_matmul_mxu_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
    const float* __restrict__ thr, const int32_t* __restrict__ flip,
    int32_t* __restrict__ out, int m, int kp, int n) {
  __shared__ __align__(16) int8_t a_s[MX_BM * MX_LDS];
  __shared__ __align__(16) int8_t b_s[MX_BN * MX_LDS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // MMA group and thread in group
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * MX_BM, n0 = blockIdx.x * MX_BN;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  for (int k0 = 0; k0 < kp; k0 += MX_BK) {
    // 64 rows x 4 chunks of 16 bytes per operand; a chunk past kp, or a
    // row past m / n, is zero (numerically inert)
    for (int i = tid; i < MX_BM * (MX_BK / 16); i += MX_THREADS) {
      const int r = i >> 2, c = (i & 3) * 16;
      int4 va = make_int4(0, 0, 0, 0), vb = make_int4(0, 0, 0, 0);
      if (k0 + c < kp) {
        if (m0 + r < m)
          va = __ldg(reinterpret_cast<const int4*>(
              x + (size_t)(m0 + r) * kp + k0 + c));
        if (n0 + r < n)
          vb = __ldg(reinterpret_cast<const int4*>(
              wt + (size_t)(n0 + r) * kp + k0 + c));
      }
      *reinterpret_cast<int4*>(a_s + r * MX_LDS + c) = va;
      *reinterpret_cast<int4*>(b_s + r * MX_LDS + c) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MX_BK; kk += 32) {
      if (k0 + kk < kp) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int8_t* p = a_s + (wm + mi * 16 + g) * MX_LDS + kk + 4 * t;
          af[mi][0] = lds32(p);                   // row g,     k 4t..4t+3
          af[mi][1] = lds32(p + 8 * MX_LDS);      // row g + 8
          af[mi][2] = lds32(p + 16);              // row g,     k + 16
          af[mi][3] = lds32(p + 8 * MX_LDS + 16); // row g + 8, k + 16
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int8_t* p = b_s + (wn + ni * 8 + g) * MX_LDS + kk + 4 * t;
          bf[ni][0] = lds32(p);                   // col g, k 4t..4t+3
          bf[ni][1] = lds32(p + 16);              // col g, k + 16
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
      }
    }
    __syncthreads();
  }
  // accumulator e of tile (mi, ni): row g + 8 * (e / 2), col 2t + e % 2
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + mi * 16 + g + 8 * (e >> 1);
        const int col = n0 + wn + ni * 8 + 2 * t + (e & 1);
        if (row < m && col < n)
          out[(size_t)row * n + col] =
              (int)((__int2float_rn(acc[mi][ni][e]) >= __ldg(thr + col)) !=
                    (__ldg(flip + col) != 0));
      }
}

// ---- plain C interface (ctypes) -------------------------------------------

extern "C" int twm_matmul_launch(const void* x, const void* wp,
                                 const void* wn, const void* thr,
                                 const void* flip, void* out, int m, int kw,
                                 int n, int sa, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid((n + TM_BN - 1) / TM_BN, (m + TM_BM - 1) / TM_BM);
  twm_matmul_kernel<<<grid, TM_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)wp, (const uint32_t*)wn,
      (const float*)thr, (const int32_t*)flip, (int32_t*)out, m, kw, n, sa);
  return (int)cudaGetLastError();
}

extern "C" int twm_matmul_mxu_launch(const void* x, const void* wt,
                                     const void* thr, const void* flip,
                                     void* out, int m, int kp, int n,
                                     void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (kp % 32) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + MX_BN - 1) / MX_BN, (m + MX_BM - 1) / MX_BM);
  twm_matmul_mxu_kernel<<<grid, MX_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)wt, (const float*)thr,
      (const int32_t*)flip, (int32_t*)out, m, kp, n);
  return (int)cudaGetLastError();
}
