// The decode-sized dropping MoE dispatch of one layer on Hopper (sm_90a):
// route and rank, the experts' gate/up and down products on their buckets,
// and the gate-weighted combine, as four kernels launched by one host call.
//
// It replaces no Pallas kernel: the JAX package's MoE
// (`src/repro/models/moe.py`) is plain `jnp`, which XLA fuses on the TPU.
// Eager PyTorch ran the same dispatch as ~200 launches a layer; the card
// waited on the host.  What bounds the layer on the card is the experts'
// weights: every held expert's `wi_gate`, `wi_up` and `wo` is read once a
// call whatever the routing (E_held x 3 x D x F bf16 bytes), against
// C <= 64 bucket rows, far below the ~295 operations a byte where the
// tensor cores would bound it.  So the design streams each weight tile
// through a `cp.async` ring in shared memory exactly once, at 16 bytes a
// thread on neighbouring addresses, and spends tensor-core work only to
// keep up: the bucket's rows padded to the MMA's 16, `mma.sync` bf16 with
// float32 accumulators, fragments from `ldmatrix` on a swizzled layout.
//
//  1. route_rank_kernel, one block per (token, block of D rows): the
//     float32 router product of those rows (full float32 FMAs), and the
//     token's bf16 row for the buckets.  A token's last block to arrive
//     (arrival counters, each reset by the block that reads it last) sums
//     its partial logits in a fixed order, takes the softmax, the top-k by
//     descending probability (the lower expert first on ties, as a stable
//     sort) and the renorm; the last token's block ranks the (token, slot)
//     pairs slot-major in one pass of one warp (earlier slots win
//     capacity), and writes the held buckets' slot -> token table, the
//     (E,) counts and the aux loss.
//  2. bucket_gemm_kernel<GATED>: one block per (128 columns of F, held
//     expert); the bucket's rows gathered from the bf16 tokens through
//     the table, the expert's gate and up tiles streamed once; h =
//     bf16(silu(bf16 g)) * bf16 u, rounded where the plain SwiGLU rounds.
//     (64-column blocks measured the same, within 1 %, at both cells'
//     shapes on an H100 80GB HBM3 at 700 W.)
//  3. bucket_gemm_kernel<!GATED>: h @ wo per held expert, bf16 out.
//  4. combine_kernel: each token's kept slots in slot order, float32
//     products and sums rounded as the plain version's (no contraction,
//     no atomics: deterministic), cast to the output's type.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int ROUTE_THREADS = 256;
constexpr int MAX_EXPERTS = 256;
constexpr int GEMM_THREADS = 128;  // 4 warps split a tile's columns
constexpr int BK = 64;             // K depth of one ring stage
constexpr int BN = 128;            // output columns a block
constexpr int COMBINE_THREADS = 256;
constexpr int COMBINE_SPAN = COMBINE_THREADS * 8;  // outputs a block
constexpr int MAX_DEVICES = 64;

struct RouteArgs {
  const void* x;        // (N, D) float32 or bf16
  const float* router;  // (D, E)
  __nv_bfloat16* xb;    // (N, D) the tokens in bf16, the buckets' rows
  float* partial;       // (N, S, E) logits over each block of D rows
  float* probs;         // (N, E)
  float* gate;          // (N, K)
  int64_t* idx;         // (N, K)
  int64_t* pos;         // (N, K) 0 where past capacity
  uint8_t* keep;        // (N, K) within capacity and on a held expert
  int64_t* counts;      // (E,) assignments per expert
  int32_t* table;       // (E_held, C) token of each bucket row, -1 empty
  float* aux;           // () the load-balance loss
  unsigned* arrived;    // (1 + N,) tokens and blocks done; 0 between launches
  int n, d, e, k, cap, lo, hi, renorm, x_bf16, rows;
};

struct GemmArgs {
  const __nv_bfloat16* a;   // rows: xb (N, K) through the table, or h
  const int32_t* table;     // (E_held, C), or null: A is (E_held, C, K)
  const __nv_bfloat16* b0;  // (E_held, K, Nout)
  const __nv_bfloat16* b1;  // the up projection of a gated product
  __nv_bfloat16* out;       // (E_held, C, Nout)
  int c, kdim, nout;
};

struct CombineArgs {
  const __nv_bfloat16* y;  // (E_held, C, D)
  const float* gate;
  const int64_t* idx;
  const int64_t* pos;
  const uint8_t* keep;
  void* out;  // (N, D) float32 or bf16
  int n, d, k, c, lo, out_bf16;
};

// ---- primitives ----------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  // 16 bytes, or 16 zero bytes where ``fill`` is false (no read)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// D += A (16x16 bf16, row) * B (16x8 bf16, col), float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// The plain SwiGLU's roundings: g and u to bf16, silu in float32 to bf16,
// the product in float32 to bf16.
__device__ __forceinline__ __nv_bfloat16 swiglu(float g, float u) {
  const float gv = __bfloat162float(__float2bfloat16_rn(g));
  const float uv = __bfloat162float(__float2bfloat16_rn(u));
  const float s = __bfloat162float(
      __float2bfloat16_rn(__fdiv_rn(gv, __fadd_rn(1.0f, expf(-gv)))));
  return __float2bfloat16_rn(__fmul_rn(s, uv));
}

// ---- 1. route and rank ---------------------------------------------------

// A token's last block: its logits summed over the D blocks in order, the
// softmax, the top-k (a stable descending sort's first k: the larger
// probability, the lower expert on ties) and the renorm.
__device__ void finish_token(const RouteArgs& a, int tok, float* lg) {
  const int t = threadIdx.x, lane = t & 31;
  const int S = gridDim.y, E = a.e, K = a.k;
  for (int ex = t; ex < E; ex += ROUTE_THREADS) {
    const float* src = a.partial + (size_t)tok * S * E + ex;
    float v = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) v += __ldcg(src + (size_t)s * E);
    lg[ex] = v;
  }
  __syncthreads();
  if (t >= 32) return;
  constexpr int PER_LANE = MAX_EXPERTS / 32;
  float p[PER_LANE];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    p[j] = j * 32 + lane < E ? lg[j * 32 + lane] : -CUDART_INF_F;
    mx = fmaxf(mx, p[j]);
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    if (j * 32 + lane < E) {
      p[j] = expf(p[j] - mx);
      sum += p[j];
    }
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int ex = j * 32 + lane;
    p[j] = ex < E ? __fdiv_rn(p[j], sum) : -1.f;  // -1: never chosen
    if (ex < E) a.probs[(size_t)tok * E + ex] = p[j];
  }
  float chosen = 0.f;
  for (int kk = 0; kk < K; ++kk) {
    float bv = -2.f;
    int be = MAX_EXPERTS;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (p[j] > bv) {
        bv = p[j];
        be = j * 32 + lane;
      }
    for (int o = 16; o; o >>= 1) {
      const float ov = __shfl_xor_sync(~0u, bv, o);
      const int oe = __shfl_xor_sync(~0u, be, o);
      if (ov > bv || (ov == bv && oe < be)) {
        bv = ov;
        be = oe;
      }
    }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (j * 32 + lane == be) p[j] = -2.f;
    if (lane == 0) a.idx[tok * K + kk] = be;
    if (kk % 32 == lane) lg[kk] = bv;  // the chosen probabilities, in order
    chosen += bv;
  }
  __syncwarp();
  const float denom = a.renorm ? __fadd_rn(chosen, 1e-9f) : 1.f;
  for (int kk = lane; kk < K; kk += 32)
    a.gate[tok * K + kk] = a.renorm ? __fdiv_rn(lg[kk], denom) : lg[kk];
}

// The last token's block: the pairs ranked slot-major over all E in one
// pass of one warp (earlier slots win capacity), the held buckets' table,
// the counts and the aux loss E * sum_e(f_e * p_e), f_e the routed
// fraction and p_e the mean probability.
__device__ void rank_pairs(const RouteArgs& a, unsigned char* smem) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int E = a.e, K = a.k, N = a.n, P = N * K;
  int* slot_expert = reinterpret_cast<int*>(smem);  // (N, K)
  int* cnt = slot_expert + P;                       // (E,)
  float* part = reinterpret_cast<float*>(cnt + E);  // (ROUTE_THREADS,)
  for (int i = t; i < P; i += ROUTE_THREADS)
    slot_expert[i] =
        (int)__ldcg(reinterpret_cast<const long long*>(a.idx) + i);
  for (int i = t; i < (a.hi - a.lo) * a.cap; i += ROUTE_THREADS)
    a.table[i] = -1;
  for (int i = t; i < E; i += ROUTE_THREADS) cnt[i] = 0;
  // each expert's summed probability, over phases of the tokens
  const int phases = ROUTE_THREADS / E;
  float imp = 0.f;
  if (t < phases * E) {
    const float* src = a.probs + t % E;
#pragma unroll 8
    for (int tok = t / E; tok < N; tok += phases)
      imp += __ldcg(src + (size_t)tok * E);
  }
  part[t] = imp;
  __syncthreads();

  if (warp == 0) {
    for (int b = 0; b < P; b += 32) {
      const int pr = b + lane;
      const int kk = pr / N, tok = pr - kk * N;
      const int ex = pr < P ? slot_expert[tok * K + kk] : -1;
      const unsigned peers = __match_any_sync(~0u, ex);
      const int before = __popc(peers & ((1u << lane) - 1u));
      if (ex >= 0) {
        const int at = cnt[ex] + before;
        const bool fits = at < a.cap;
        const bool local = ex >= a.lo && ex < a.hi;
        a.pos[tok * K + kk] = fits ? at : 0;
        a.keep[tok * K + kk] = fits && local;
        if (fits && local) a.table[(ex - a.lo) * a.cap + at] = tok;
      }
      __syncwarp();
      if (ex >= 0 && before == 0) cnt[ex] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  float term = 0.f;
  if (t < E) {
    a.counts[t] = cnt[t];
    float sum = 0.f;
    for (int ph = 0; ph < phases; ++ph) sum += part[ph * E + t];
    term = ((float)cnt[t] / N / K) * (sum / N);
  }
  __syncthreads();
  part[t] = term;
  __syncthreads();
  if (t == 0) {
    float s = 0.f;
    for (int ex = 0; ex < E; ++ex) s += part[ex];
    *a.aux = E * s;
    a.arrived[0] = 0u;  // ready for the next launch on this stream
  }
}

__global__ void __launch_bounds__(ROUTE_THREADS)
    route_rank_kernel(const RouteArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float lg[MAX_EXPERTS];
  __shared__ bool last;
  const int t = threadIdx.x, tok = blockIdx.x, s = blockIdx.y;
  const int r0 = s * a.rows, r1 = min(a.d, r0 + a.rows);
  float* xs = reinterpret_cast<float*>(smem);  // the block's rows of x
  float* part = xs + a.rows;                   // (ROUTE_THREADS,)
  for (int i = r0 + t; i < r1; i += ROUTE_THREADS) {
    const size_t at = (size_t)tok * a.d + i;
    const float v =
        a.x_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.x)[at])
                 : static_cast<const float*>(a.x)[at];
    xs[i - r0] = v;
    a.xb[at] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  // thread t sums expert t % E over rows r0 + t / E, + phases, ...
  const int phases = ROUTE_THREADS / a.e;
  float acc = 0.f;
  if (t < phases * a.e) {
    const int ex = t % a.e;
#pragma unroll 8
    for (int i = r0 + t / a.e; i < r1; i += phases)
      acc = fmaf(xs[i - r0], a.router[(size_t)i * a.e + ex], acc);
  }
  part[t] = acc;
  __syncthreads();
  if (t < a.e) {
    float v = 0.f;
    for (int ph = 0; ph < phases; ++ph) v += part[ph * a.e + t];
    a.partial[((size_t)tok * gridDim.y + s) * a.e + t] = v;
  }
  // the token's last block finishes it; the last token's ranks the pairs
  // (arrived[0] counts tokens, arrived[1 + tok] the token's blocks; each
  // reset by the block that reads it last)
  __threadfence();
  __syncthreads();
  if (t == 0)
    last = atomicAdd(a.arrived + 1 + tok, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  finish_token(a, tok, lg);
  __threadfence();
  __syncthreads();
  if (t == 0) {
    a.arrived[1 + tok] = 0u;
    last = atomicAdd(a.arrived, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  rank_pairs(a, smem);
}

// ---- 2, 3. the experts' products on their buckets ------------------------

template <int MT, bool GATED>
struct GemmShape {
  static constexpr int NB = GATED ? 2 : 1;       // weight tiles a stage
  static constexpr int STAGES = GATED ? 3 : 4;   // ring depth
  static constexpr int A_ELEMS = MT * 16 * BK;
  static constexpr int B_ELEMS = BK * BN;
  static constexpr int STAGE_ELEMS = A_ELEMS + NB * B_ELEMS;
  static constexpr int SMEM = STAGES * STAGE_ELEMS * 2;
  static constexpr int NT = BN / 32;  // n8 tiles a warp
};

// Shared tiles are rows of 16-byte chunks; chunk c of row r sits at
// c ^ (r & 7), so that the 8 rows an ldmatrix reads hit 8 distinct bank
// groups.
__device__ __forceinline__ int swz(int row, int chunk) {
  return (chunk ^ (row & 7)) * 8;
}

template <int MT, bool GATED>
__global__ void __launch_bounds__(GEMM_THREADS)
    bucket_gemm_kernel(const GemmArgs g) {
  using S = GemmShape<MT, GATED>;
  extern __shared__ __align__(128) __nv_bfloat16 sm[];
  __shared__ int src_row[MT * 16];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ex = blockIdx.y, n0 = blockIdx.x * BN;
  const size_t wofs = (size_t)ex * g.kdim * g.nout;
  if (t < MT * 16) {
    int r = -1;
    if (t < g.c) r = g.table ? g.table[ex * g.c + t] : ex * g.c + t;
    src_row[t] = r;
  }
  __syncthreads();

  auto load = [&](int stage, int k0) {
    __nv_bfloat16* sa = sm + stage * S::STAGE_ELEMS;
    for (int i = t; i < MT * 16 * (BK / 8); i += GEMM_THREADS) {
      const int r = i / (BK / 8), ch = i % (BK / 8), k = k0 + ch * 8;
      const int row = src_row[r];
      const bool ok = row >= 0 && k < g.kdim;
      cp_async16(sa + r * BK + swz(r, ch),
                 ok ? g.a + (size_t)row * g.kdim + k : g.a, ok);
    }
#pragma unroll
    for (int m = 0; m < S::NB; ++m) {
      const __nv_bfloat16* b = (m ? g.b1 : g.b0) + wofs;
      __nv_bfloat16* sb = sa + S::A_ELEMS + m * S::B_ELEMS;
      for (int i = t; i < BK * (BN / 8); i += GEMM_THREADS) {
        const int kk = i / (BN / 8), ch = i % (BN / 8);
        const int k = k0 + kk, col = n0 + ch * 8;
        const bool ok = k < g.kdim && col < g.nout;
        cp_async16(sb + kk * BN + swz(kk, ch),
                   ok ? b + (size_t)k * g.nout + col : b, ok);
      }
    }
  };

  float acc[S::NB][MT][S::NT][4];
#pragma unroll
  for (int m = 0; m < S::NB; ++m)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][mt][nt][q] = 0.f;

  const int ktiles = (g.kdim + BK - 1) / BK;
  const int wn = warp * (BN / 4);  // the warp's first column in the tile
  const int mat = lane >> 3;       // which 8x8 matrix this lane addresses
#pragma unroll
  for (int s = 0; s < S::STAGES - 1; ++s) {
    if (s < ktiles) load(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<S::STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free to refill
    const int nk = kt + S::STAGES - 1;
    if (nk < ktiles) load(nk % S::STAGES, nk * BK);
    cp_async_commit();
    const __nv_bfloat16* sa = sm + (kt % S::STAGES) * S::STAGE_ELEMS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      unsigned af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = mt * 16 + (lane & 7) + (mat & 1) * 8;
        ldmatrix_x4(af[mt], sa + r * BK + swz(r, ks * 2 + (mat >> 1)));
      }
#pragma unroll
      for (int m = 0; m < S::NB; ++m) {
        const __nv_bfloat16* sb = sa + S::A_ELEMS + m * S::B_ELEMS;
#pragma unroll
        for (int np = 0; np < S::NT / 2; ++np) {
          unsigned bf[4];
          const int kk = ks * 16 + (lane & 7) + (mat & 1) * 8;
          const int ch = wn / 8 + np * 2 + (mat >> 1);
          ldmatrix_x4_trans(bf, sb + kk * BN + swz(kk, ch));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[m][mt][np * 2], af[mt], bf[0], bf[1]);
            mma_bf16(acc[m][mt][np * 2 + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + gq + half * 8;
        const int col = n0 + wn + nt * 8 + tq * 2;
        if (r >= g.c || col >= g.nout) continue;
        const float v0 = acc[0][mt][nt][half * 2];
        const float v1 = acc[0][mt][nt][half * 2 + 1];
        __nv_bfloat162 o;
        if constexpr (GATED) {
          o.x = swiglu(v0, acc[S::NB - 1][mt][nt][half * 2]);
          o.y = swiglu(v1, acc[S::NB - 1][mt][nt][half * 2 + 1]);
        } else {
          o = __floats2bfloat162_rn(v0, v1);
        }
        *reinterpret_cast<__nv_bfloat162*>(
            g.out + ((size_t)ex * g.c + r) * g.nout + col) = o;
      }
}

// ---- 4. combine ----------------------------------------------------------

__global__ void __launch_bounds__(COMBINE_THREADS)
    combine_kernel(const CombineArgs a) {
  constexpr int KC = 8;  // slots whose rows are in flight together
  const int tok = blockIdx.x;
  const int d0 = (blockIdx.y * COMBINE_THREADS + threadIdx.x) * 8;
  if (d0 >= a.d) return;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < a.k; k0 += KC) {
    bool kept[KC];
    float w[KC];
    size_t row[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int p = tok * a.k + k0 + j;
      kept[j] = k0 + j < a.k && a.keep[p];  // the plain adds y * 0 else
      w[j] = kept[j] ? a.gate[p] : 0.f;
      row[j] = kept[j] ? (size_t)(a.idx[p] - a.lo) * a.c + a.pos[p] : 0;
    }
    uint4 raw[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j)
      raw[j] = kept[j] ? *reinterpret_cast<const uint4*>(a.y + row[j] * a.d +
                                                         d0)
                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (!kept[j]) continue;
      const unsigned words[4] = {raw[j].x, raw[j].y, raw[j].z, raw[j].w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // a bf16 is the high half of its float32
        const unsigned bits = i & 1 ? words[i / 2] & 0xffff0000u
                                    : words[i / 2] << 16;
        acc[i] = __fadd_rn(acc[i], __fmul_rn(__uint_as_float(bits), w[j]));
      }
    }
  }
  const size_t at = (size_t)tok * a.d + d0;
  if (a.out_bf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.out) + at;
#pragma unroll
    for (int i = 0; i < 8; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(o + i) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  } else {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(a.out) + at);
    o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

// ---- launches ------------------------------------------------------------

template <int MT, bool GATED>
int launch_gemm(const GemmArgs& g, int device, int experts,
                cudaStream_t st) {
  using S = GemmShape<MT, GATED>;
  static bool ready[MAX_DEVICES];  // the shared-memory limit set
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        bucket_gemm_kernel<MT, GATED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready[device] = true;
  }
  const dim3 grid((g.nout + BN - 1) / BN, experts);
  bucket_gemm_kernel<MT, GATED><<<grid, GEMM_THREADS, S::SMEM, st>>>(g);
  return (int)cudaGetLastError();
}

template <bool GATED>
int launch_gemm_tile(const GemmArgs& g, int mt, int device, int experts,
                     cudaStream_t st) {
  switch (mt) {
    case 1: return launch_gemm<1, GATED>(g, device, experts, st);
    case 2: return launch_gemm<2, GATED>(g, device, experts, st);
    case 3: return launch_gemm<3, GATED>(g, device, experts, st);
    case 4: return launch_gemm<4, GATED>(g, device, experts, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One layer's dispatch: the four kernels on ``stream``, on card
// ``device``.  Pointers as ``kernels/moe_dispatch.py``'s workspace lays
// them out; returns the first CUDA error, 0 when every launch was taken.
extern "C" int moe_dispatch_launch(
    const void* x, const void* router, const void* wi_gate,
    const void* wi_up, const void* wo, void* xb, void* partial, void* probs,
    void* gate, void* idx, void* pos, void* keep, void* counts, void* table,
    void* aux, void* h, void* y, void* out, void* arrived, int n, int d,
    int f, int e, int k, int cap, int lo, int hi, int renorm, int x_bf16,
    int out_bf16, int route_rows, int route_smem, int mt, int device,
    void* stream) {
  if (n <= 0) return 0;
  if (e < 1 || e > MAX_EXPERTS || k < 1 || k > e || d % 8 || f % 8 ||
      route_rows < 1 || route_smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int held = hi - lo;
  int rc = 0;
  {
    RouteArgs a{x, (const float*)router, (__nv_bfloat16*)xb,
                (float*)partial, (float*)probs, (float*)gate,
                (int64_t*)idx, (int64_t*)pos, (uint8_t*)keep,
                (int64_t*)counts, (int32_t*)table, (float*)aux,
                (unsigned*)arrived, n, d, e, k, cap, lo, hi, renorm, x_bf16,
                route_rows};
    const dim3 grid(n, (d + route_rows - 1) / route_rows);
    route_rank_kernel<<<grid, ROUTE_THREADS, route_smem, st>>>(a);
    rc = (int)cudaGetLastError();
  }
  if (!rc) {
    GemmArgs g{(const __nv_bfloat16*)xb, (const int32_t*)table,
               (const __nv_bfloat16*)wi_gate, (const __nv_bfloat16*)wi_up,
               (__nv_bfloat16*)h, cap, d, f};
    rc = launch_gemm_tile<true>(g, mt, device, held, st);
  }
  if (!rc) {
    GemmArgs g{(const __nv_bfloat16*)h, nullptr,
               (const __nv_bfloat16*)wo, nullptr, (__nv_bfloat16*)y, cap, f,
               d};
    rc = launch_gemm_tile<false>(g, mt, device, held, st);
  }
  if (!rc) {
    CombineArgs c{(const __nv_bfloat16*)y, (const float*)gate,
                  (const int64_t*)idx, (const int64_t*)pos,
                  (const uint8_t*)keep, out, n, d, k, cap, lo, out_bf16};
    const dim3 grid(n, (d + COMBINE_SPAN - 1) / COMBINE_SPAN);
    combine_kernel<<<grid, COMBINE_THREADS, 0, st>>>(c);
    rc = (int)cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return rc;
}
