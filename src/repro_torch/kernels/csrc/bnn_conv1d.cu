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
// Design (B.4, B.5).  One thread per (slot, output position, output
// channel), with adjacent threads on adjacent output channels: the
// weights are laid out (K, Cw, Cout), so a warp's weight loads are one
// coalesced line, its input loads one broadcast word, and its output
// stores one line.  The classifier runs one CTA per slot with the
// saturated GAP vector and each fc layer's activations in shared memory,
// one thread per output.
//
// What bounds them on H100: the conv step does K * Cw popcount pairs per
// output on the CUDA cores; at the KWS shapes the int32 raw output (a few
// MB per launch) and the weights are the bytes, and the ideal time is
// microseconds.  These kernels re-read every weight from L2 once per
// output position and launch once per stage, so they sit far above that;
// tiling positions per thread, weights in shared memory and fusing the
// stages are later work (the hop megakernel fuses them).
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
// B.6 is laid out differently (see its kernel): one CTA per block of
// pooled positions and output channels, with the block's weight planes
// and input rows staged once in shared memory.  Its bound at the KWS
// layer shapes is the same kind: a few hundred KB of input, weights and
// output (well under a microsecond at HBM rate), against K * Cw popcount
// pairs per pre-pool output on the CUDA cores.

#include <cstdint>
#include <cuda_runtime.h>

#define MAX_FC 8

// ---- B.4: batched K-tap popcount conv, raw or SA + OR-pool ---------------
//
// x     (B, l_in, cw) packed words of the binary window
// wp/wn ([M,] k, cw, cout) packed positive / negative weight planes
// out   raw: (B, n_pos, cout) int32 popcount difference
//       sa:  (B, n_pos, cout) {0,1}, n_pos = l_out / pool pooled positions
__global__ void bnn_conv1d_step_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ wp,
    const uint32_t* __restrict__ wn, const float* __restrict__ thr,
    const int32_t* __restrict__ flip, const int32_t* __restrict__ model_idx,
    int32_t* __restrict__ out, int batch, int l_in, int cw, int k,
    int stride, int cout, int n_pos, int pool, int sa) {
  const long long total = (long long)batch * n_pos * cout;
  const size_t wsz = (size_t)k * cw * cout;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int co = (int)(idx % cout);
    const long long rest = idx / cout;
    const int n = (int)(rest % n_pos);
    const int b = (int)(rest / n_pos);
    const size_t m = model_idx ? (size_t)model_idx[b] : 0;
    const uint32_t* wpb = wp + m * wsz + co;
    const uint32_t* wnb = wn + m * wsz + co;
    const uint32_t* xb = x + (size_t)b * l_in * cw;
    const int np = sa ? pool : 1;
    const float th = sa ? __ldg(thr + co) : 0.f;
    const bool fl = sa ? __ldg(flip + co) != 0 : false;
    int y = 0;
    for (int q = 0; q < np; ++q) {
      // taps t of output position p are window rows p * stride + t
      const uint32_t* xr = xb + (size_t)(n * np + q) * stride * cw;
      int acc = 0;
      for (int j = 0; j < k * cw; ++j) {
        const uint32_t xv = xr[j];
        acc += __popc(xv & __ldg(wpb + (size_t)j * cout)) -
               __popc(xv & __ldg(wnb + (size_t)j * cout));
      }
      if (!sa) {
        y = acc;
      } else {
        const bool ge = __int2float_rn(acc) >= th;
        y |= (int)(ge != fl);
      }
    }
    out[idx] = y;
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

// ---- B.5: classifier tail -------------------------------------------------

struct TailFc {
  int cin, cout, raw, unused;
  const int8_t* w;        // ([M,] cin, cout) ternary
  const float* thr;       // ([M,] cout), null when raw
  const int32_t* flip;    // ([M,] cout), null when raw
};

struct TailParams {
  int n_fc, gap_c, n_out, buf_elems;
  const int32_t* gap;        // (B, gap_c) GAP counts
  int32_t* out;              // (B, n_out) raw logits
  const int32_t* model_idx;  // (B,) pool row per slot, or null
  TailFc fc[MAX_FC];
};

// One CTA per slot: h = min(gap, 255) in shared memory, then each fc layer
// with one thread per output, SA on the non-raw layers.
__global__ void classifier_tail_kernel(const TailParams P) {
  extern __shared__ __align__(16) int32_t hbuf[];
  int32_t* hin = hbuf;
  int32_t* hout = hbuf + P.buf_elems;
  const int b = blockIdx.x;
  const size_t m = P.model_idx ? (size_t)P.model_idx[b] : 0;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int c = tid; c < P.gap_c; c += nt)
    hin[c] = min(P.gap[(size_t)b * P.gap_c + c], 255);
  __syncthreads();
  for (int j = 0; j < P.n_fc; ++j) {
    const TailFc& f = P.fc[j];
    const int8_t* w = f.w + m * f.cin * f.cout;
    for (int o = tid; o < f.cout; o += nt) {
      int acc = 0;
      for (int c = 0; c < f.cin; ++c)
        acc += hin[c] * (int)__ldg(w + (size_t)c * f.cout + o);
      if (f.raw) {
        hout[o] = acc;
      } else {
        const bool ge = __int2float_rn(acc) >= __ldg(f.thr + m * f.cout + o);
        hout[o] = (int)(ge != (__ldg(f.flip + m * f.cout + o) != 0));
      }
    }
    __syncthreads();
    int32_t* t = hin;
    hin = hout;
    hout = t;
  }
  for (int o = tid; o < P.n_out; o += nt)
    P.out[(size_t)b * P.n_out + o] = hin[o];
}

// ---- B.6: single-stream fused conv -> SA -> OR-pool (PWB) -----------------
//
// x     (l_in, cw) packed words of the unpadded binary input; rows outside
//       [0, l_in) are the conv's zero padding
// wp/wn (k, cw, cout) packed positive / negative weight planes
// out   raw: (n_pos, cout) int32 popcount difference (pool == 1)
//       sa:  (n_pos, cout) {0,1}, n_pos = l_out / pool pooled positions
//
// Grid: (position blocks of bp pooled outputs, channel blocks of bn).  The
// block's k * cw * bn pos/neg plane words are staged once in shared memory
// and read by every position of the block (B.4 re-reads them from L2 per
// output), and the input rows the block's taps touch are staged beside
// them.  Thread (tx, ty) owns channel tx of the block and pooled outputs
// ty, ty + blockDim.y, ...; the pool pre-pool positions of one output are
// accumulated R at a time with each weight word loaded once per R, then
// SA'd and OR-reduced in registers before the single write (the PWB
// write-back).  R divides pool, so no position is computed twice.
//
// Position p's taps are input rows p * stride - pad + t, so tap t, word c
// of position p is staged word (p - p0) * stride * cw + t * cw + c: the
// k * cw words of a position are contiguous, as in B.4.
template <int R>
__global__ void bnn_conv1d_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ wp,
    const uint32_t* __restrict__ wn, const float* __restrict__ thr,
    const int32_t* __restrict__ flip, int32_t* __restrict__ out, int l_in,
    int cw, int k, int stride, int pad, int cout, int n_pos, int pool,
    int sa, int bn, int bp) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int kc = k * cw;
  uint32_t* wp_s = smem;                 // (kc, bn)
  uint32_t* wn_s = smem + kc * bn;       // (kc, bn)
  uint32_t* x_s = smem + 2 * kc * bn;    // (rows, cw)
  const int n0 = blockIdx.x * bp;
  const int c0 = blockIdx.y * bn;
  const int nb = min(bp, n_pos - n0);
  const int p0 = n0 * pool;              // first pre-pool position
  const int rows = (nb * pool - 1) * stride + k;
  const int row0 = p0 * stride - pad;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  for (int i = tid; i < kc * bn; i += nt) {
    const int j = i / bn, c = i % bn;
    const bool in = c0 + c < cout;
    wp_s[i] = in ? __ldg(wp + (size_t)j * cout + c0 + c) : 0u;
    wn_s[i] = in ? __ldg(wn + (size_t)j * cout + c0 + c) : 0u;
  }
  for (int i = tid; i < rows * cw; i += nt) {
    const int r = row0 + i / cw;
    x_s[i] = (r >= 0 && r < l_in) ? __ldg(x + (size_t)r * cw + i % cw)
                                  : 0u;
  }
  __syncthreads();
  const int tx = threadIdx.x;
  const int co = c0 + tx;
  if (tx >= bn || co >= cout) return;
  const float th = sa ? __ldg(thr + co) : 0.f;
  const bool fl = sa ? __ldg(flip + co) != 0 : false;
  const uint32_t* wpc = wp_s + tx;
  const uint32_t* wnc = wn_s + tx;
  const int xstep = stride * cw;
  for (int n = threadIdx.y; n < nb; n += blockDim.y) {
    int y = 0;
    for (int q = 0; q < pool; q += R) {
      const uint32_t* xr = x_s + (n * pool + q) * xstep;
      int acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0;
      for (int j = 0; j < kc; ++j) {
        const uint32_t vp = wpc[j * bn], vn = wnc[j * bn];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const uint32_t xv = xr[r * xstep + j];
          acc[r] += __popc(xv & vp) - __popc(xv & vn);
        }
      }
      if (!sa) {
        y = acc[0];
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
          y |= (int)((__int2float_rn(acc[r]) >= th) != fl);
      }
    }
    out[(size_t)(n0 + n) * cout + co] = y;
  }
}

// ---- plain C interface (ctypes) -------------------------------------------

static int grid_for(long long total, int threads) {
  const long long g = (total + threads - 1) / threads;
  return (int)(g < (1LL << 30) ? g : (1LL << 30));
}

extern "C" int bnn_conv1d_step_launch(
    const void* x, const void* wp, const void* wn, const void* thr,
    const void* flip, const void* model_idx, void* out, int batch, int l_in,
    int cw, int k, int stride, int cout, int n_pos, int pool, int sa,
    int threads, void* stream) {
  const long long total = (long long)batch * n_pos * cout;
  if (total <= 0) return 0;
  bnn_conv1d_step_kernel<<<grid_for(total, threads), threads, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)wp, (const uint32_t*)wn,
      (const float*)thr, (const int32_t*)flip, (const int32_t*)model_idx,
      (int32_t*)out, batch, l_in, cw, k, stride, cout, n_pos, pool, sa);
  return (int)cudaGetLastError();
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
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, 256, smem_bytes, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int8_t*)w, (const int32_t*)model_idx,
      (int32_t*)out, l_in, cin, k, stride, cout, l_out, mask, pb, cb);
  return (int)cudaGetLastError();
}

extern "C" int classifier_tail_launch(const TailParams* p, int batch,
                                      int threads, int smem_bytes,
                                      void* stream) {
  if (batch <= 0) return 0;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        classifier_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  classifier_tail_kernel<<<batch, threads, smem_bytes,
                           (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int bnn_conv1d_launch(
    const void* x, const void* wp, const void* wn, const void* thr,
    const void* flip, void* out, int l_in, int cw, int k, int stride,
    int pad, int cout, int n_pos, int pool, int sa, int bn, int bp, int ty,
    int smem_bytes, void* stream) {
  if (n_pos <= 0 || cout <= 0) return 0;
  const dim3 grid((n_pos + bp - 1) / bp, (cout + bn - 1) / bn);
  const dim3 block(bn, ty);
  // R pre-pool positions per pass, R | pool
  const int r = pool % 4 == 0 ? 4 : (pool % 2 == 0 ? 2 : 1);
  void (*kern)(const uint32_t*, const uint32_t*, const uint32_t*,
               const float*, const int32_t*, int32_t*, int, int, int, int,
               int, int, int, int, int, int, int) =
      r == 4 ? bnn_conv1d_kernel<4>
             : (r == 2 ? bnn_conv1d_kernel<2> : bnn_conv1d_kernel<1>);
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, block, smem_bytes, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)wp, (const uint32_t*)wn,
      (const float*)thr, (const int32_t*)flip, (int32_t*)out, l_in, cw, k,
      stride, pad, cout, n_pos, pool, sa, bn, bp);
  return (int)cudaGetLastError();
}

extern "C" int classifier_tail_params_size() {
  return (int)sizeof(TailParams);
}
