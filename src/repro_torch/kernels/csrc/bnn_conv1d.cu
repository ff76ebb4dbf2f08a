// Popcount conv kernels for Hopper (sm_90a): the per-stage stream kernels
// (batched popcount conv step, bit-serial first-layer step, fused
// classifier tail) and the kernel library's single-stream fused
// conv -> SA -> pool.
//
// Replaces the reference's Pallas kernels
//   src/repro/kernels/bnn_conv1d.py::bnn_conv1d_step_packed     (B.4)
//   src/repro/kernels/bnn_conv1d.py::bnn_bitserial_step_packed  (B.3)
//   src/repro/kernels/bnn_conv1d.py::classifier_tail_packed     (B.5)
//   src/repro/kernels/bnn_conv1d.py::bnn_conv1d_packed          (B.6)
// The reference's per-stage stream backend launches B.3-B.5 once per conv
// stage per hop, plus once per ghost-flush conv and once for the
// classifier on an emit hop; its kernel library (ops.bnn_conv1d) launches
// B.6 once per layer of an utterance.
//
// Inputs are the packed windows themselves, not the reference's
// materialised (B, K, L_out, Cw) tap views: each thread indexes its K taps
// as rows p * stride + t of the (B, L_in, Cw) window, so the input costs
// L_in rows instead of K * L_out.
//
// B.4, B.5 and B.6 run on the tensor cores (mma.sync, mma.cuh), as the
// hop megakernel's convs and classifier do, over weights laid out once per
// model in fragment order (conv_kernels.prepare_step_weights /
// prepare_tail_weights): B.4 and B.6 on the 1-bit MMA over the packed
// words, B.5 on the u8 x s8 MMA over the u8 GAP counts.
//
// What bounds them on H100.  B.4 at a hop's b1-b3 windows (B = 256) is 2.85
// G binary MACs, 1.4 us at the int8 peak, against 22.5 MB of int32 raw
// output, 6.7 us at HBM rate: bytes.  On the CUDA cores two popc per 32
// MACs alone take ~45 us, so the design moves the MACs to the tensor cores
// (0.20 M 1-bit MMAs a hop) and spends its effort on the store: 16-byte
// stores from the MMA fragments, one or two CTAs for every SM, and few
// bytes from L2 per CTA (a CTA takes a block of slots, so each weight byte
// it stages serves them all).  B.5 at B = 256 is 47.7 M MACs over 186 KB
// of fc weights: the weights are the bytes, and a cluster of CTAs splits
// them, each CTA reading its share once for up to 16 slots (the rows of
// one m16 tile).
//
// B.3 (see its kernel) stages its window slice as u8 codes and its
// weights as s8x4 words in shared memory, and each thread runs dp4a over
// several positions x 4 channels.  Its bound at the hop's l0 (B=256, 64
// positions, 64 channels, k=19, stride 8) is its 4.2 MB int32 output,
// ~1.3 us at HBM rate; the MACs (19 per output) are nothing to the int8
// units.  So the design cuts what stands between the launch and that
// store: no dependent global loads in the MAC loop, one 16-byte store per
// position and 4 channels, and enough CTAs (one per slot and block of
// positions, sized on the host) to fill the SMs at B=256 and at a single
// utterance's 2,000 positions alike.
//
// B.6 is B.4's kernel in a mode of its own (ONE, see the kernel): one
// stream, whose pooled positions are split into blocks, a CTA per block of
// positions and block of n-tiles, in place of B.4's blocks of slots.  At
// the KWS utterance's b1-b3 its bound is 0.35-0.51 MB of int32 {0,1}
// output or 0.05-0.16 G MACs, 0.14-0.17 us either way, against the ~3 us
// floor of a launch, one copy into shared memory, a short MMA chain and a
// store; the design keeps each CTA's copy small (its n-tiles' weights and
// the rows of its positions) and gives every SM a CTA or two
// (conv_kernels.conv_block_tiles).

#include <cstdint>
#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

#define MAX_FC 8

// ---- B.4 (and B.6): K-tap conv on the 1-bit tensor cores -----------------
//
// x     (B, l_in, cw) packed words of the binary window
// wf    ([M,] n_tiles, ksteps, 32, 4) int32: the packed weight planes in
//       the B-fragment order of mma.m16n8k256 (prepare_step_weights): lane
//       4 g + t of n-tile j and k-step s holds words 8 s + t and 8 s + 4 + t
//       of the depth (word d = cw t' + c for tap t', word c) of column
//       8 j + g, first of the positive plane, then of the negative one;
//       zero past k * cw words and past cout
// out   raw: (B, n_out, cout) int32; sa: (B, n_out, cout) {0,1}, the OR
//       over `pool` consecutive positions of SA'd sums
//
// popc(x & wp) - popc(x & wn) over a position's taps is two 1-bit MMAs
// (mma.m16n8k256 .and.popc) per 256 bits of depth, on the packed words as
// they are: position p's depth is the contiguous run of k * cw words from
// word p * stride * cw of its slot's window, so lane (g, t)'s A registers
// for k-step s are words 8 s + t and 8 s + 4 + t of rows g and g + 8's runs.
// On H100 one such MMA issues every 1.5 cycles an SM, as a u8 m16n8k32
// does (chip_smoke.py's `mma rate`), so the product takes a quarter of the
// tensor-core time of the u8 form, and the window needs no expansion.
//
// A CTA takes `slots` slots and `ntb` n-tiles (8 output channels each),
// sized on the host (conv_kernels.conv_step_tiles): it copies its slots'
// packed rows and its n-tiles' weights into shared memory with cp.async.
// Its output rows are its slots' (slot, pooled position) pairs in order, so
// short windows (a flush's 1-3 positions) still fill the 16-row tiles; row
// R of pool phase q reads position n pool + q.  A warp's item is NG
// n-tiles x MC m-tiles; with `sa` it loops over the pool phases and ORs
// each phase's SA bits in registers (so any pool works, and no bit crosses
// a lane).  The epilogue pairs lanes 4 g + t and 4 g + (t ^ 1) by one
// shuffle, so each stores 4 consecutive columns of one row as 16 bytes.
struct StepArgs {
  const uint32_t* x;
  const int32_t* wf;
  const float* thr;          // (cout,) sa only
  const int32_t* flip;       // (cout,) sa only
  const int32_t* model_idx;  // (B,) pool row per slot (a CTA takes one
                             // slot), or null
  int32_t* out;
  int batch, l_in, cw, k, stride, cout, n_out, pool, sa;
  int slots, ntb;            // slots (ONE: pooled positions) and n-tiles
                             // per CTA
  int rows_in, win_words;    // B.4: rows a slot's window reads; words it
                             // takes
  int pad;                   // ONE: the conv's zero rows before the input
};

// ONE (B.6): x is one stream's (l_in, cw) words, unpadded, and n_out its
// pooled positions (l_out in raw mode); a CTA takes positions n0 .. n0 +
// slots - 1.  It stages input rows (n0 pool) stride - pad .. of them from
// the 16-byte boundary at or before the first (`lead` words early), so a
// staged word and its source share their alignment and 16-byte copies
// serve every block, whatever its first row; words outside [0, l_in cw) are
// written as zeros, the conv's padding.  The positions are then the rows
// of one slot, and the MMA items, SA, OR-pool and epilogue are B.4's; a
// CTA's output rows are n0 ...
template <int NG, int MC, bool ONE>
__global__ void __launch_bounds__(256) bnn_conv1d_step_kernel(
    const StepArgs P) {
  extern __shared__ __align__(128) unsigned char sm[];
  const int nt = (P.cout + 7) >> 3, ks = (P.k * P.cw + 7) >> 3;
  const int j0 = blockIdx.y * P.ntb;
  const int b0 = ONE ? 0 : blockIdx.x * P.slots;
  const int ns = ONE ? 1 : min(P.slots, P.batch - b0);
  const int n0 = ONE ? blockIdx.x * P.slots : 0;
  const int n_out = ONE ? min(P.slots, P.n_out - n0) : P.n_out;  // a slot's
                                                                  // rows
  const int ntc = min(P.ntb, nt - j0);
  const size_t m = !ONE && P.model_idx ? (size_t)P.model_idx[b0] : 0;
  const int npool = P.sa ? P.pool : 1;
  const int rstep = P.stride * P.cw;  // words from one position to the next
  const uint4* wsm = reinterpret_cast<const uint4*>(sm);
  uint32_t* win =
      reinterpret_cast<uint32_t*>(sm + (size_t)P.ntb * ks * 512);
  int lead = 0;  // ONE: words staged before the first position's run
  if (ONE) {
    const long long first =
        ((long long)n0 * npool * P.stride - P.pad) * P.cw;
    const long long total = (long long)P.l_in * P.cw;
    lead = (int)(first & 3);
    const long long g0 = first - lead;
    const int words = lead + ((n_out * npool - 1) * P.stride + P.k) * P.cw;
    const bool vec = (size_t)P.x % 16 == 0;
    for (int v = threadIdx.x; v < (words + 3) >> 2; v += blockDim.x) {
      const long long g = g0 + 4 * v;
      if (vec && g >= 0 && g + 4 <= total) {
        cp_async16(win + 4 * v, P.x + g);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (g + e >= 0 && g + e < total)
            cp_async4(win + 4 * v + e, P.x + g + e);
          else
            win[4 * v + e] = 0u;
        }
      }
    }
  } else {
    // the slots' packed rows: 16-byte copies where a slot's window starts
    // on 16 bytes (its words are then copied 4 at a time, the last < 4
    // one by one), else word by word
    const int per = P.rows_in * P.cw;
    const size_t stride = (size_t)P.l_in * P.cw;
    const int vec =
        (stride & 3) == 0 && (size_t)P.x % 16 == 0 ? per >> 2 : 0;
    const int rest = per - 4 * vec;
    for (int i = threadIdx.x; i < ns * vec; i += blockDim.x) {
      const int s = i / vec, v = i - s * vec;
      cp_async16(win + s * P.win_words + 4 * v,
                 P.x + (b0 + s) * stride + 4 * v);
    }
    for (int i = threadIdx.x; i < ns * rest; i += blockDim.x) {
      const int s = i / rest, w = 4 * vec + i - s * rest;
      cp_async4(win + s * P.win_words + w, P.x + (b0 + s) * stride + w);
    }
  }
  {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(P.wf) +
                               (m * nt + j0) * (size_t)ks * 512;
    const int bytes = ntc * ks * 512;
    for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
      cp_async16(sm + i, src + i);
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3, odd = tq & 1;
  const int rows = ns * n_out;
  const int mts = (rows + 15) >> 4, mgs = (mts + MC - 1) / MC;
  const int ngs = (ntc + NG - 1) / NG;
  const bool vec = (P.cout & 3) == 0;
  const size_t orow0 = ONE ? (size_t)n0 : (size_t)b0 * P.n_out;
  for (int it = warp; it < mgs * ngs; it += blockDim.x >> 5) {
    const int jg = it % ngs, mg = it / ngs;
    // this lane's rows g and g + 8 of each m-tile: (slot, pooled
    // position) -> the word where the position's depth run starts, + t
    int rb[MC][2];
#pragma unroll
    for (int mi = 0; mi < MC; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = min((mg * MC + mi) * 16 + gq + 8 * h, rows - 1);
        const int s = r / n_out, n = r - s * n_out;
        rb[mi][h] = s * P.win_words + n * npool * rstep + lead + tq;
      }
    const uint4* bp[NG];
    float th[NG][2];
    bool fl[NG][2];
#pragma unroll
    for (int ni = 0; ni < NG; ++ni) {
      const int jt = min(jg * NG + ni, ntc - 1);
      bp[ni] = wsm + (size_t)jt * ks * 32 + lane;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = min((j0 + jt) * 8 + 2 * tq + e, P.cout - 1);
        th[ni][e] = P.sa ? __ldg(P.thr + c) : 0.f;
        fl[ni][e] = P.sa ? __ldg(P.flip + c) != 0 : false;
      }
    }
    int pos[NG][MC][4], neg[NG][MC][4];
    unsigned long long bits = 0;  // sa: OR of the phases' SA bits
    for (int q = 0; q < npool; ++q) {
#pragma unroll
      for (int ni = 0; ni < NG; ++ni)
#pragma unroll
        for (int mi = 0; mi < MC; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) pos[ni][mi][e] = neg[ni][mi][e] = 0;
      const int qoff = q * rstep;
#pragma unroll 2
      for (int kk = 0; kk < ks; ++kk) {
        uint4 b[NG];
        unsigned a[MC][4];
#pragma unroll
        for (int ni = 0; ni < NG; ++ni) b[ni] = bp[ni][kk * 32];
#pragma unroll
        for (int mi = 0; mi < MC; ++mi) {
          const int o = qoff + 8 * kk;
          a[mi][0] = win[rb[mi][0] + o];
          a[mi][1] = win[rb[mi][1] + o];
          a[mi][2] = win[rb[mi][0] + o + 4];
          a[mi][3] = win[rb[mi][1] + o + 4];
        }
#pragma unroll
        for (int mi = 0; mi < MC; ++mi)
#pragma unroll
          for (int ni = 0; ni < NG; ++ni) {
            mma_b1(pos[ni][mi], a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                   b[ni].x, b[ni].y);
            mma_b1(neg[ni][mi], a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                   b[ni].z, b[ni].w);
          }
      }
#pragma unroll
      for (int ni = 0; ni < NG; ++ni)
#pragma unroll
        for (int mi = 0; mi < MC; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pos[ni][mi][e] -= neg[ni][mi][e];
            if (P.sa) {
              const bool y = (__int2float_rn(pos[ni][mi][e]) >=
                              th[ni][e & 1]) != fl[ni][e & 1];
              bits |= (unsigned long long)y << ((ni * MC + mi) * 4 + e);
            }
          }
    }
    // epilogue: lane pairs (t, t ^ 1) swap halves, so an even lane holds
    // row g and an odd lane row g + 8, each at 4 consecutive columns
#pragma unroll
    for (int ni = 0; ni < NG; ++ni) {
      if (jg * NG + ni >= ntc) break;
      const int col = (j0 + jg * NG + ni) * 8 + 4 * (tq >> 1);
#pragma unroll
      for (int mi = 0; mi < MC; ++mi) {
        int v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = P.sa ? (int)((bits >> ((ni * MC + mi) * 4 + e)) & 1ull)
                      : pos[ni][mi][e];
        const int r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
        const int r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
        const int4 o = odd ? make_int4(r0, r1, v[2], v[3])
                           : make_int4(v[0], v[1], r0, r1);
        const int row = (mg * MC + mi) * 16 + gq + 8 * odd;
        if (row >= rows || col >= P.cout) continue;
        int32_t* dst = P.out + (orow0 + row) * P.cout + col;
        if (vec) {
          *reinterpret_cast<int4*>(dst) = o;
        } else {
          const int oe[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < P.cout) dst[e] = oe[e];
        }
      }
    }
  }
}

// ---- B.3: bit-serial first layer -----------------------------------------
//
// sum_b 2^b sum_{t,c} plane_b * w  ==  sum_{t,c} (code & (2^bits - 1)) * w,
// so the kernel MACs the masked codes; the offset fold stays on the host.
// x (B, l_in, cin) int32 codes; w ([M,] k, cin, cout) int8 ternary;
// out (B, l_out, cout) int32.
//
// One CTA per (slot, block of `pb` positions, block of `cb` channels).  It
// stages the masked codes of its window slice as u8 (bits <= 8) and its
// model's weights as s8x4 words along the depth k * cin ((k * cin) / 4
// words per channel, zero-padded); position p's depth is the contiguous
// byte run [p * stride * cin, (p * stride + k) * cin) of the slice, read a
// word at a time with a funnel shift.  Each thread owns PPT positions x 4
// channels: per word, one 16-byte load of 4 channels' weights and PPT
// window words feed 4 * PPT dp4a (u8 x s8), and each position's 4 sums go
// out as one 16-byte store.
__device__ __forceinline__ int dp4a_us(unsigned a, int b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

template <int PPT>
__global__ void __launch_bounds__(256) bnn_bitserial_step_kernel(
    const int32_t* __restrict__ x, const int8_t* __restrict__ w,
    const int32_t* __restrict__ model_idx, int32_t* __restrict__ out,
    int l_in, int cin, int k, int stride, int cout, int l_out, int mask,
    int pb, int cb) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int b = blockIdx.x;
  const int p0 = blockIdx.y * pb, c0 = blockIdx.z * cb;
  const int kc = k * cin, kw = (kc + 3) / 4;
  const int np = min(pb, l_out - p0), ncb = min(cb, cout - c0);
  int* wpk = reinterpret_cast<int*>(sm);                  // [kw][cb]
  unsigned char* win = sm + (size_t)kw * cb * 4;          // window slice
  const size_t m = model_idx ? (size_t)model_idx[b] : 0;
  const int8_t* wm = w + m * (size_t)kc * cout + c0;
  for (int i = threadIdx.x; i < kw * cb; i += blockDim.x) {
    const int q = i / cb, c = i - q * cb;
    unsigned v = 0;
    if (c < ncb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = 4 * q + e;
        if (kk < kc) v |= (unsigned)(unsigned char)__ldg(wm + (size_t)kk * cout + c) << (8 * e);
      }
    }
    wpk[i] = (int)v;
  }
  const int nbytes = ((np - 1) * stride + k) * cin;
  const int32_t* xb = x + ((size_t)b * l_in + (size_t)p0 * stride) * cin;
  const int padded = (nbytes + 3) / 4 * 4 + 8;
  for (int i = threadIdx.x; i < padded; i += blockDim.x)
    win[i] = i < nbytes ? (unsigned char)(__ldg(xb + i) & mask) : 0;
  __syncthreads();

  const int cg = (ncb + 3) / 4;          // channel groups of 4
  const int pgs = (np + PPT - 1) / PPT;  // position groups
  const int rstep = stride * cin;
  for (int item = threadIdx.x; item < pgs * cg; item += blockDim.x) {
    const int q = item % cg, pg = item / cg;
    int acc[PPT][4];
    int off[PPT];
#pragma unroll
    for (int r = 0; r < PPT; ++r) {
      off[r] = min(pg + r * pgs, np - 1) * rstep;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0;
    }
    const int4* wq = reinterpret_cast<const int4*>(wpk) + q;
    for (int j = 0; j < kw; ++j) {
      const int4 wv = wq[(size_t)j * (cb / 4)];
#pragma unroll
      for (int r = 0; r < PPT; ++r) {
        const int o = off[r] + 4 * j;
        const unsigned* wp = reinterpret_cast<const unsigned*>(win + (o & ~3));
        const unsigned xw = __funnelshift_r(wp[0], wp[1], (o & 3) * 8);
        acc[r][0] = dp4a_us(xw, wv.x, acc[r][0]);
        acc[r][1] = dp4a_us(xw, wv.y, acc[r][1]);
        acc[r][2] = dp4a_us(xw, wv.z, acc[r][2]);
        acc[r][3] = dp4a_us(xw, wv.w, acc[r][3]);
      }
    }
    const int c = c0 + 4 * q;
#pragma unroll
    for (int r = 0; r < PPT; ++r) {
      const int p = pg + r * pgs;
      if (p >= np) continue;
      int32_t* o = out + ((size_t)b * l_out + p0 + p) * cout + c;
      if (c + 4 <= cout && (cout & 3) == 0) {
        *reinterpret_cast<int4*>(o) =
            make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * q + e < ncb) o[e] = acc[r][e];
      }
    }
  }
}

// ---- B.5: classifier tail on the int8 tensor cores -----------------------
//
// gap   (B, gap_c) int32 GAP counts (>= 0)
// fc[j] weights ([M,] n_tiles, ksteps, 32, 8) int8 in fragment order (depth
//       cin, columns cout), thresholds float32 and flips int32 ([M,] cout)
//       on the SA layers; only the last layer may be raw
// out   (B, n_out) int32 logits
//
// A cluster of `cluster` CTAs takes `slots` slots (at most 16) as the rows
// of one m16 tile: row s is slot s.  Each layer is one GEMM of that tile
// against the layer's weights, and the cluster's CTAs split its n-tiles,
// so each CTA reads only its share of the weights: one SM pulls 186 KB
// from L2 no faster than a few microseconds, however few slots it serves.
// A layer's A rows -- fc1's min(gap, 255) as u8, later layers' SA bits --
// sit in every CTA's shared memory at `pitch` bytes a row: each CTA writes
// its columns into every CTA of the cluster (distributed shared memory,
// 8 bytes a row and n-tile), and a cluster barrier separates one layer from
// the next; the rows alternate between two buffers, so a layer's stores
// never meet the previous layer's reads.  Everything a CTA reads from
// global memory is copied at its start: its GAP columns and SA parameters
// in one cp.async group, and its weights through a two-slot cp.async ring
// (mma.cuh) whose slots hold a CTA's share of a layer.  Its warps split a
// chunk's n-tiles, TAIL_NG at a time, or, for a chunk of fewer n-tiles
// than warps, each tile's k-steps.  With a tenant pool, each layer runs
// one pass per distinct model of the slots over that model's weights, and
// writes only that model's rows.
#define TAIL_ROWS 16
#define MAX_TAIL_PASSES (MAX_FC * TAIL_ROWS)
#define TAIL_NG 4  // n-tiles a warp runs at once
#define TAIL_KG 4  // k-steps of fragments a warp loads at once

struct TailFc {
  int cin, cout, raw, ksteps, n_tiles, unused;
  const int8_t* w;        // ([M,] n_tiles, ksteps, 32, 8) fragment order
  const float* thr;       // ([M,] cout), null when raw
  const int32_t* flip;    // ([M,] cout), null when raw
};

struct TailParams {
  int n_fc, gap_c, n_out, batch, slots, pitch, ring_bytes, cluster;
  int sa_cols, n_sa;  // SA-parameter columns of a CTA's widest share; SA
                      // layers
  const int32_t* gap;        // (B, gap_c) GAP counts
  int32_t* out;              // (B, n_out) raw logits
  const int32_t* model_idx;  // (B,) pool row per slot, or null
  TailFc fc[MAX_FC];
};

// CTA `rank`'s share [lo, hi) of n items split over `parts` CTAs.
__device__ __forceinline__ int2 tail_share(int n, int parts, int rank) {
  const int per = (n + parts - 1) / parts;
  const int lo = min(rank * per, n);
  return make_int2(lo, min(lo + per, n));
}

__global__ void __launch_bounds__(256) classifier_tail_kernel(
    const TailParams P0) {
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ TailParams P;                    // the parameters, copied once
  __shared__ Pass passes[MAX_TAIL_PASSES];
  __shared__ int models[TAIL_ROWS];           // the slots' distinct models
  __shared__ unsigned model_rows[TAIL_ROWS];  // each one's rows
  __shared__ int4 shares[MAX_FC];  // per layer: this CTA's n-tiles [x, y),
                                   // n-tiles a chunk, SA ordinal (-1: raw)
  __shared__ int n_models, n_passes;
  // one parallel read of the parameter block: the scalar work below then
  // reads shared memory, not one constant-cache miss after another
  for (int i = threadIdx.x; i < (int)(sizeof(TailParams) / 4);
       i += blockDim.x)
    reinterpret_cast<int*>(&P)[i] = reinterpret_cast<const int*>(&P0)[i];
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nc = P.cluster;
  const int b0 = (blockIdx.x / nc) * P.slots;
  const int ns = min(P.slots, P.batch - b0);
  const int pitch = P.pitch, act_bytes = TAIL_ROWS * pitch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  unsigned char* act = sm + 2 * (size_t)P.ring_bytes;  // two row buffers
  float* s_thr = reinterpret_cast<float*>(act + 2 * act_bytes);
  const int sa_len = P.n_sa * P.slots * P.sa_cols;
  int* s_flip = reinterpret_cast<int*>(s_thr + sa_len);
  int* s_red = s_flip + sa_len;               // split-K partial sums
  int32_t* s_gap = s_red + blockDim.x * 4;
  ASSUME_SHARED(act);
  ASSUME_SHARED(s_thr);
  ASSUME_SHARED(s_flip);
  ASSUME_SHARED(s_red);
  ASSUME_SHARED(s_gap);
  // this CTA's share of the GAP columns, copied at once (16 bytes a copy
  // where the rows allow)
  const int2 gsh = tail_share(P.gap_c, nc, rank);
  const int gw = gsh.y - gsh.x;
  const int gv =
      ((P.gap_c | gsh.x | gw) & 3) == 0 && (size_t)P.gap % 16 == 0 ? 4 : 1;
  for (int i = threadIdx.x; i < ns * gw / gv; i += blockDim.x) {
    const int r = i / (gw / gv), c = gv * i - r * gw;
    const int32_t* src = P.gap + (size_t)(b0 + r) * P.gap_c + gsh.x + c;
    if (gv == 4)
      cp_async16(s_gap + r * gw + c, src);
    else
      cp_async4(s_gap + r * gw + c, src);
  }
  if (warp == 0) {
    // the distinct models of the slots (lane s is slot s), in slot order:
    // the first slot of each leads it, and its lanes are its rows
    const int ms = lane < ns ? (P.model_idx ? __ldg(P.model_idx + b0 + lane)
                                            : 0)
                             : -1 - lane;
    const unsigned grp = __match_any_sync(0xffffffffu, ms);
    const bool lead = lane < ns && __ffs(grp) - 1 == lane;
    const unsigned leads = __ballot_sync(0xffffffffu, lead);
    const unsigned below = (1u << lane) - 1;
    const int nm = __popc(leads);
    if (lead) {
      models[__popc(leads & below)] = ms;
      model_rows[__popc(leads & below)] = grp;
    }
    // lane j: layer j's share of n-tiles, and one pass per model over it
    // (the passes of the layers with a share, layer by layer)
    const bool layer = lane < P.n_fc;
    const TailFc& f = P.fc[layer ? lane : 0];
    const int2 sh = tail_share(f.n_tiles, nc, rank);
    const int tile = f.ksteps * 256, ct = P.ring_bytes / tile;
    const unsigned full = __ballot_sync(0xffffffffu, layer && sh.x < sh.y);
    const unsigned sa = __ballot_sync(0xffffffffu, layer && !f.raw);
    __syncwarp();  // models[]
    if (layer) {
      shares[lane] = make_int4(sh.x, sh.y, ct,
                               f.raw ? -1 : __popc(sa & below));
      if (sh.x < sh.y) {
        const int nch = (sh.y - sh.x + ct - 1) / ct;
        Pass* p = passes + __popc(full & below) * nm;
        for (int i = 0; i < nm; ++i) {
          p[i].w = f.w + ((size_t)models[i] * f.n_tiles + sh.x) * tile;
          p[i].nchunks = nch;
          p[i].chunk_bytes = ct * tile;
          p[i].last_bytes = (sh.y - sh.x - (nch - 1) * ct) * tile;
        }
      }
    }
    if (lane == 0) {
      n_passes = __popc(full) * nm;
      n_models = nm;
    }
  }
  __syncthreads();  // the pass list
  const int nm = n_models;
  // the SA parameters of every SA layer and model, this CTA's columns: one
  // commit group with the GAP share
  for (int j = 0; j < P.n_fc; ++j) {
    const int4 ls = shares[j];
    if (ls.w < 0 || ls.x == ls.y) continue;
    const TailFc& f = P.fc[j];
    const int c0 = ls.x * 8, ncol = min(ls.y * 8, f.cout) - c0;
    // 16 bytes a copy where the rows allow (c0 is a multiple of 8)
    const int v = ((f.cout | ncol) & 3) == 0 &&
                          ((size_t)f.thr | (size_t)f.flip) % 16 == 0
                      ? 4
                      : 1;
    for (int i = threadIdx.x; i < nm * ncol / v; i += blockDim.x) {
      const int mi = i / (ncol / v), c = v * i - mi * ncol;
      const int o = (ls.w * P.slots + mi) * P.sa_cols + c;
      const size_t g = (size_t)models[mi] * f.cout + c0 + c;
      if (v == 4) {
        cp_async16(s_thr + o, f.thr + g);
        cp_async16(s_flip + o, f.flip + g);
      } else {
        cp_async4(s_thr + o, f.thr + g);
        cp_async4(s_flip + o, f.flip + g);
      }
    }
  }
  cp_async_commit();
  Ring R{sm, P.ring_bytes, 0, 0, 0, 0, n_passes};
  ring_issue(R, passes);
  ring_issue(R, passes);
  cp_async_wait2();  // the first group (the ring's two may be in flight)
  __syncthreads();
  // fc1's rows: the GAP share as min(gap, 255) u8, into every CTA of the
  // cluster.  Nothing else of the rows is written: the weights are zero
  // past a layer's cin, and rows past the slots are never stored.
  if ((gsh.x & 3) == 0 && (gw & 3) == 0) {
    // four columns to a store
    const int gw4 = gw >> 2;
    for (int i = threadIdx.x; i < ns * gw4; i += blockDim.x) {
      const int r = i / gw4, c = 4 * (i - r * gw4);
      const int* g = s_gap + r * gw + c;
      const unsigned v = (unsigned)min(g[0], 255) |
                         (unsigned)min(g[1], 255) << 8 |
                         (unsigned)min(g[2], 255) << 16 |
                         (unsigned)min(g[3], 255) << 24;
      for (int q = 0; q < nc; ++q)
        *reinterpret_cast<unsigned*>(cluster.map_shared_rank(act, q) +
                                     r * pitch + gsh.x + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < ns * gw; i += blockDim.x) {
      const int r = i / gw, c = i - r * gw;
      const unsigned char v = (unsigned char)min(s_gap[i], 255);
      for (int q = 0; q < nc; ++q)
        cluster.map_shared_rank(act, q)[r * pitch + gsh.x + c] = v;
    }
  }
  cluster.sync();  // fc1's rows complete in every CTA
  const int gq = lane >> 2, tq = lane & 3;
  for (int j = 0; j < P.n_fc; ++j) {
    const TailFc& f = P.fc[j];
    const int4 ls = shares[j];
    const int ksteps = f.ksteps, cout = f.cout, ct = ls.z;
    const bool raw = f.raw != 0, last = j + 1 == P.n_fc;
    const unsigned char* hin = act + (j & 1) * act_bytes;
    unsigned char* hout = act + ((j + 1) & 1) * act_bytes;
    ASSUME_SHARED(hin);
    const unsigned char* p0 = hin + gq * pitch + 4 * tq;
    const unsigned char* p1 = p0 + 8 * pitch;
    // acc[u] += the tile's A x B over k-steps [k_lo, k_hi), for the first
    // cnt of TAIL_NG tiles: TAIL_KG k-steps of fragments are loaded before
    // their MMAs, so one load latency serves TAIL_KG steps of each chain
    auto mma_tiles = [&](int (&acc)[TAIL_NG][4],
                         const uint2* const (&bp)[TAIL_NG], int cnt, int k_lo,
                         int k_hi) {
      for (int kk0 = k_lo; kk0 < k_hi; kk0 += TAIL_KG) {
        unsigned a[TAIL_KG][4];
        uint2 b[TAIL_KG][TAIL_NG];
#pragma unroll
        for (int q = 0; q < TAIL_KG; ++q) {
          const int kk = min(kk0 + q, k_hi - 1), k0 = kk * 32;
          a[q][0] = a_word<true>(p0 + k0);
          a[q][1] = a_word<true>(p1 + k0);
          a[q][2] = a_word<true>(p0 + k0 + 16);
          a[q][3] = a_word<true>(p1 + k0 + 16);
#pragma unroll
          for (int u = 0; u < TAIL_NG; ++u)
            if (u < cnt) b[q][u] = bp[u][kk * 32];
        }
#pragma unroll
        for (int q = 0; q < TAIL_KG; ++q) {
          if (kk0 + q >= k_hi) break;
#pragma unroll
          for (int u = 0; u < TAIL_NG; ++u)
            if (u < cnt)
              mma_u8s8(acc[u], a[q][0], a[q][1], a[q][2], a[q][3],
                       b[q][u].x, b[q][u].y);
        }
      }
    };
    for (int i = 0; i < nm && ls.x < ls.y; ++i) {
      const unsigned sel = model_rows[i];
      const int sa_off =
          raw ? 0 : (ls.w * P.slots + i) * P.sa_cols - ls.x * 8;
      // the SA'd or raw outputs of n-tile t's columns 2 tq, 2 tq + 1 of
      // rows gq, gq + 8: logits, or bits into every CTA's next rows
      auto store = [&](const int (&acc)[4], int t) {
        const int col0 = t * 8 + 2 * tq;
        int v[4];  // rows gq and gq + 8, columns col0 and col0 + 1
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = acc[e];
          const int sc = sa_off + min(col0 + (e & 1), cout - 1);
          if (!raw)
            v[e] = (__int2float_rn(v[e]) >= s_thr[sc]) != (s_flip[sc] != 0);
        }
        if (last) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = gq + 8 * (e >> 1), col = col0 + (e & 1);
            if (((sel >> s) & 1u) && col < cout)
              P.out[(size_t)(b0 + s) * P.n_out + col] = v[e];
          }
          return;
        }
        // the n-tile's 8 bits of a row as 8 bytes: lane 4 g gathers row g
        // and lane 4 g + 1 row g + 8 from the quad, and stores them into
        // every CTA's next rows (columns past cout meet zero weights)
        const unsigned mine = (unsigned)(v[0] | v[1] << 8) |
                              (unsigned)(v[2] | v[3] << 8) << 16;
        unsigned w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = __shfl_sync(0xffffffffu, mine, (lane & ~3) | k);
        const int s = gq + 8 * tq;
        if (tq < 2 && ((sel >> s) & 1u)) {
          const int sh = 16 * tq;
          const uint2 row = make_uint2(
              (w[0] >> sh & 0xffffu) | (w[1] >> sh & 0xffffu) << 16,
              (w[2] >> sh & 0xffffu) | (w[3] >> sh & 0xffffu) << 16);
          for (int q = 0; q < nc; ++q)
            *reinterpret_cast<uint2*>(cluster.map_shared_rank(hout, q) +
                                      s * pitch + t * 8) = row;
        }
      };
      const int nchunks = (ls.y - ls.x + ct - 1) / ct;
      for (int c = 0; c < nchunks; ++c) {
        const int8_t* chunk = ring_acquire(R);
        ASSUME_SHARED(chunk);
        const int t0 = ls.x + c * ct;  // the chunk's first n-tile
        const int nt = min(ct, ls.y - t0);
        const uint2* tiles = reinterpret_cast<const uint2*>(chunk) + lane;
        if (nt >= nwarps) {
          // a warp takes up to TAIL_NG of the chunk's n-tiles at once: one
          // A fragment feeds their independent MMA chains
          for (int jt0 = warp; jt0 < nt; jt0 += TAIL_NG * nwarps) {
            const int cnt = min(TAIL_NG, (nt - jt0 + nwarps - 1) / nwarps);
            int acc[TAIL_NG][4] = {};
            const uint2* bp[TAIL_NG];
#pragma unroll
            for (int u = 0; u < TAIL_NG; ++u)
              bp[u] = tiles + (size_t)min(jt0 + u * nwarps, nt - 1) * ksteps *
                                  32;
            mma_tiles(acc, bp, cnt, 0, ksteps);
#pragma unroll
            for (int u = 0; u < TAIL_NG; ++u)
              if (u < cnt) store(acc[u], t0 + jt0 + u * nwarps);
          }
        } else {
          // fewer n-tiles than warps: kp warps split each tile's k-steps,
          // and the first of them adds the others' partial sums
          const int kp = nwarps / nt, part = warp / nt, jt = warp - part * nt;
          const int kpp = (ksteps + kp - 1) / kp;
          const int k_lo = min(part * kpp, ksteps);
          int acc[TAIL_NG][4] = {};
          const uint2* bp[TAIL_NG] = {tiles + (size_t)jt * ksteps * 32};
          if (part < kp) mma_tiles(acc, bp, 1, k_lo, min(ksteps, k_lo + kpp));
          if (kp > 1) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s_red[(warp * 32 + lane) * 4 + e] = acc[0][e];
            __syncthreads();
            if (part == 0)
              for (int q = 1; q < kp; ++q)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[0][e] += s_red[((q * nt + jt) * 32 + lane) * 4 + e];
          }
          if (part == 0) store(acc[0], t0 + jt);
        }
        ring_release(R, passes);
      }
    }
    // every CTA's rows of this layer are written, and every CTA is done
    // reading the previous layer's, which the next layer overwrites
    if (!last) cluster.sync();
  }
}

// ---- plain C interface (ctypes) -------------------------------------------

// Opt a kernel in to `bytes` of dynamic shared memory (above the default
// 48 KB).  A refusal is returned and cleared, so it does not surface later
// as the error of another launch.
template <class K>
static int allow_smem(K kern, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) return 0;
  cudaGetLastError();
  return (int)e;
}

// B.4's kernel (B.6's with ONE) for an item of NG n-tiles x MC m-tiles:
// the shapes of conv_kernels.STEP_ITEMS, (2, 2), (4, 1), (1, 4), (2, 1),
// (1, 2), (1, 1).
typedef void (*StepKernel)(const StepArgs);

template <bool ONE>
static StepKernel step_kernel(int ng, int mc) {
  if (ng == 2) return mc == 2 ? bnn_conv1d_step_kernel<2, 2, ONE>
                              : bnn_conv1d_step_kernel<2, 1, ONE>;
  if (ng == 4) return bnn_conv1d_step_kernel<4, 1, ONE>;
  return mc == 4   ? bnn_conv1d_step_kernel<1, 4, ONE>
         : mc == 2 ? bnn_conv1d_step_kernel<1, 2, ONE>
                   : bnn_conv1d_step_kernel<1, 1, ONE>;
}

// grid: (blocks of `slots` slots -- ONE: of `slots` pooled positions --,
// blocks of `ntb` n-tiles)
template <bool ONE>
static int conv_launch(const StepArgs* a, int ng, int mc, int smem_bytes,
                       void* stream) {
  const int items = ONE ? a->n_out : a->batch;
  if (items <= 0 || a->n_out <= 0 || a->cout <= 0) return 0;
  const int nt = (a->cout + 7) / 8;
  const dim3 grid((items + a->slots - 1) / a->slots,
                  (nt + a->ntb - 1) / a->ntb);
  const StepKernel kern = step_kernel<ONE>(ng, mc);
  if (const int e = allow_smem(kern, smem_bytes)) return e;
  kern<<<grid, 256, smem_bytes, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int bnn_conv1d_step_launch(const StepArgs* a, int ng, int mc,
                                      int smem_bytes, void* stream) {
  return conv_launch<false>(a, ng, mc, smem_bytes, stream);
}

extern "C" int bnn_conv1d_launch(const StepArgs* a, int ng, int mc,
                                 int smem_bytes, void* stream) {
  return conv_launch<true>(a, ng, mc, smem_bytes, stream);
}

extern "C" int bnn_bitserial_step_launch(
    const void* x, const void* w, const void* model_idx, void* out,
    int batch, int l_in, int cin, int k, int stride, int cout, int l_out,
    int mask, int ppt, int pb, int cb, int smem_bytes, void* stream) {
  if (batch <= 0 || l_out <= 0 || cout <= 0) return 0;
  const dim3 grid(batch, (l_out + pb - 1) / pb, (cout + cb - 1) / cb);
  void (*kern)(const int32_t*, const int8_t*, const int32_t*, int32_t*, int,
               int, int, int, int, int, int, int, int) =
      ppt == 4 ? bnn_bitserial_step_kernel<4>
               : (ppt == 2 ? bnn_bitserial_step_kernel<2>
                           : bnn_bitserial_step_kernel<1>);
  if (const int e = allow_smem(kern, smem_bytes)) return e;
  kern<<<grid, 256, smem_bytes, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int8_t*)w, (const int32_t*)model_idx,
      (int32_t*)out, l_in, cin, k, stride, cout, l_out, mask, pb, cb);
  return (int)cudaGetLastError();
}

extern "C" int classifier_tail_launch(const TailParams* p, int smem_bytes,
                                      void* stream) {
  if (p->batch <= 0) return 0;
  if (const int e = allow_smem(classifier_tail_kernel, smem_bytes)) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p->batch + p->slots - 1) / p->slots * p->cluster);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p->cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, classifier_tail_kernel, *p);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

extern "C" int classifier_tail_params_size() {
  return (int)sizeof(TailParams);
}

extern "C" int bnn_conv1d_step_args_size() { return (int)sizeof(StepArgs); }

// The classifier kernel's static shared memory (its pass list), which the
// host's layout leaves room for beside the dynamic buffers.
extern "C" int classifier_tail_static_smem() {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, classifier_tail_kernel) != cudaSuccess)
    return -1;
  return (int)a.sharedSizeBytes;
}
