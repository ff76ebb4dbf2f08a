// Per-stage stream kernels for Hopper (sm_90a): the batched popcount conv
// step, the bit-serial first-layer step and the fused classifier tail.
//
// Replaces the reference's Pallas kernels
//   src/repro/kernels/bnn_conv1d.py::bnn_conv1d_step_packed     (B.4)
//   src/repro/kernels/bnn_conv1d.py::bnn_bitserial_step_packed  (B.3)
//   src/repro/kernels/bnn_conv1d.py::classifier_tail_packed     (B.5)
// which the reference's per-stage stream backend launches once per conv
// stage per hop, plus once per ghost-flush conv and once for the
// classifier on an emit hop.
//
// Inputs are the packed windows themselves, not the reference's
// materialised (B, K, L_out, Cw) tap views: each thread indexes its K taps
// as rows p * stride + t of the (B, L_in, Cw) window, so the input costs
// L_in rows instead of K * L_out.
//
// Design.  One thread per (slot, output position, output channel), with
// adjacent threads on adjacent output channels: the weights are laid out
// (K, Cw|Cin, Cout), so a warp's weight loads are one coalesced line, its
// input loads one broadcast word, and its output stores one line.  The
// classifier runs one CTA per slot with the saturated GAP vector and each
// fc layer's activations in shared memory, one thread per output.
//
// What bounds them on H100: the conv steps do K * Cw popcount pairs (B.4)
// or K * Cin scalar multiply-adds (B.3) per output, on the CUDA cores; at
// the KWS shapes the int32 raw output (a few MB per launch) and the
// weights are the bytes, and the ideal time is microseconds.  These
// kernels re-read every weight from L2 once per output position and
// launch once per stage, so they sit far above that; tiling positions per
// thread, weights in shared memory and fusing the stages are later work
// (the hop megakernel fuses them).

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
__global__ void bnn_bitserial_step_kernel(
    const int32_t* __restrict__ x, const int8_t* __restrict__ w,
    const int32_t* __restrict__ model_idx, int32_t* __restrict__ out,
    int batch, int l_in, int cin, int k, int stride, int cout, int l_out,
    int mask) {
  const long long total = (long long)batch * l_out * cout;
  const size_t wsz = (size_t)k * cin * cout;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int co = (int)(idx % cout);
    const long long rest = idx / cout;
    const int n = (int)(rest % l_out);
    const int b = (int)(rest / l_out);
    const size_t m = model_idx ? (size_t)model_idx[b] : 0;
    const int8_t* wb = w + m * wsz + co;
    // the k taps of position n are k consecutive rows: k * cin codes
    const int32_t* xr = x + ((size_t)b * l_in + (size_t)n * stride) * cin;
    int acc = 0;
    for (int j = 0; j < k * cin; ++j)
      acc += (xr[j] & mask) * (int)__ldg(wb + (size_t)j * cout);
    out[idx] = acc;
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
    int mask, int threads, void* stream) {
  const long long total = (long long)batch * l_out * cout;
  if (total <= 0) return 0;
  bnn_bitserial_step_kernel<<<grid_for(total, threads), threads, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int8_t*)w, (const int32_t*)model_idx,
      (int32_t*)out, batch, l_in, cin, k, stride, cout, l_out, mask);
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

extern "C" int classifier_tail_params_size() {
  return (int)sizeof(TailParams);
}
