// Hop megakernel for Hopper (sm_90a): one launch per streaming KWS hop.
//
// Replaces the reference's Pallas kernels
//   src/repro/kernels/hop_megakernel.py::hop_megakernel_packed    (B.1)
//   src/repro/kernels/hop_megakernel.py::finalize_megakernel_packed (B.2)
// whose body is `_megakernel`.  One kernel serves both: `finalize_only`
// selects the peek mode (ghost flush + classifier from resident state).
//
// What one hop computes, per slot:
//   * layer 0: codes (x & (2^in_bits - 1)) - in_offset over concat(tail, audio)
//     (the reference's bit-plane sum telescopes back to this code);
//   * per conv stage: K-tap int32 conv, SA `float(raw) >= thr` xor flip,
//     max-pool over concat(pending, y) with the steady pool phase; the new
//     receptive-field tail and pending frames are carried out;
//   * GAP: gap = min(gap + sum(frames), 255), clamped every hop;
//   * masked slots keep tails, pendings and GAP bit for bit;
//   * on emit (or finalize_only): the ghost end-of-stream flush on the
//     merged state, then the fc cascade -> raw int32 logits.
//
// Design.  One CTA per slot; threads tile (4 output positions x 1 output
// channel) so each weight load from L2 serves four MACs, and each input
// read from shared memory is a warp broadcast.  The feature maps never
// leave shared memory: the layer-0 window (int32) and two int8 ping-pong
// buffers hold each stage's input window (tail rows, then the previous
// stage's pooled frames), and an int8 frames buffer holds
// concat(pending, y) for the pool.  Weights are int8 ternary, read through
// the read-only cache.  The plan geometry is a runtime struct, so one build
// serves every streamable plan.
//
// Stages past the first keep their windows as int8 (binary maps), so a
// bit-serial input there (in_bits <= 8) is stored as its raw value mod 256
// and coded at the MAC; carried tails are written from the int32 inputs.
//
// What bounds it on H100: the work is ~11M int MACs per slot per hop at
// full KWS width (hop_frames=8), done here with scalar int32 multiply-add
// on the CUDA cores; the tensor-core bound (int8, 1979 TOP/s) and the byte
// bound (slot state + weights, a few MB) are both far below.  So this
// kernel is bound by scalar issue rate; the int8 tensor-core path (wgmma)
// and weight residency in shared memory are later work.

#include <cstdint>
#include <cuda_runtime.h>

#define MAX_STAGES 8
#define MAX_FC 4
#define TILE_P 4

struct StageDesc {
  int k, stride, pad, pool, cin, cout, in_bits, in_offset;
  int tail, phase, n_in, n_conv, n_out, flush_in, flush_conv, flush_out;
  const int32_t* tail_in;   // (B, tail, cin) or null when tail == 0
  int32_t* tail_out;
  const int32_t* pend_in;   // (B, phase, cout) or null when phase == 0
  int32_t* pend_out;
  const int8_t* w;          // ([K,] k, cin, cout) ternary
  const float* thr;         // ([K,] cout)
  const int32_t* flip;      // ([K,] cout)
};

struct FcDesc {
  int cin, cout, raw, unused;
  const int8_t* w;          // ([K,] cin, cout)
  const float* thr;         // ([K,] cout), null when raw
  const int32_t* flip;
};

struct HopParams {
  int n_stages, n_fc, emit, finalize_only;
  int gap_c, n_logits;
  // shared-memory layout, in elements of each buffer's type
  int win0_elems;   // int32: layer-0 window
  int bin_bytes;    // int8: each ping-pong buffer
  int frm_bytes;    // int8: concat(pending, y)
  int fc_elems;     // int32: each classifier activation buffer
  const int32_t* audio;      // (B, n_in0, cin0) codes
  const int32_t* mask;       // (B,)
  const int32_t* gap_in;     // (B, gap_c)
  int32_t* gap_out;          // (B, gap_c) or null in finalize mode
  int32_t* logits;           // (B, n_logits) or null
  const int32_t* model_idx;  // (B,) pool row per slot, or null
  StageDesc st[MAX_STAGES];
  FcDesc fc[MAX_FC];
};

__device__ __forceinline__ int code_of(int raw, const StageDesc& g) {
  if (g.in_bits > 1) {
    const int m = g.in_bits >= 31 ? -1 : (1 << g.in_bits) - 1;
    return (raw & m) - g.in_offset;
  }
  return raw;
}

// n_pos conv positions over `win` (row-major (rows, cin)), SA'd into
// frm rows [0, n_pos) of width cout.  Must be called by the whole CTA.
// CODED: `win` holds raw inputs of a bit-serial stage, turned into codes
// here; an int8 window keeps each raw value mod 256, which is all the
// code of an in_bits <= 8 input reads.
template <typename T, bool CODED>
__device__ void conv_sa(const T* win, const StageDesc& g, int n_pos,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ thr,
                        const int32_t* __restrict__ flip, int8_t* frm) {
  const int cin = g.cin, cout = g.cout, k = g.k, stride = g.stride;
  const int ntile = (n_pos + TILE_P - 1) / TILE_P;
  for (int item = threadIdx.x; item < ntile * cout; item += blockDim.x) {
    const int co = item % cout;
    const int n0 = (item / cout) * TILE_P;
    int rb[TILE_P];
    int acc[TILE_P];
#pragma unroll
    for (int p = 0; p < TILE_P; ++p) {
      rb[p] = min(n0 + p, n_pos - 1) * stride * cin;
      acc[p] = 0;
    }
    for (int t = 0; t < k; ++t) {
      const int8_t* wt = w + (size_t)t * cin * cout + co;
      const T* xt = win + t * cin;
      for (int ci = 0; ci < cin; ++ci) {
        const int wv = __ldg(wt + (size_t)ci * cout);
#pragma unroll
        for (int p = 0; p < TILE_P; ++p) {
          const int xv = CODED ? code_of((int)xt[rb[p] + ci], g) : (int)xt[rb[p] + ci];
          acc[p] += xv * wv;
        }
      }
    }
    const float th = __ldg(thr + co);
    const bool fl = __ldg(flip + co) != 0;
#pragma unroll
    for (int p = 0; p < TILE_P; ++p) {
      if (n0 + p < n_pos) {
        const bool ge = __int2float_rn(acc[p]) >= th;
        frm[(n0 + p) * cout + co] = (int8_t)(ge != fl);
      }
    }
  }
}

// Stage i's conv: layer 0 reads its int32 code window, later stages their
// int8 window (coded at the MAC when bit-serial).
__device__ void stage_conv(int i, const int32_t* win0, const int8_t* win,
                           const StageDesc& g, int n_pos,
                           const int8_t* __restrict__ w,
                           const float* __restrict__ thr,
                           const int32_t* __restrict__ flip, int8_t* frm) {
  if (i == 0) conv_sa<int32_t, false>(win0, g, n_pos, w, thr, flip, frm);
  else if (g.in_bits > 1) conv_sa<int8_t, true>(win, g, n_pos, w, thr, flip, frm);
  else conv_sa<int8_t, false>(win, g, n_pos, w, thr, flip, frm);
}

// max-pool frm rows [0, n_out * pool) into dst rows [0, n_out).
__device__ void pool_into(const int8_t* frm, int n_out, int pool, int cout,
                          int8_t* dst) {
  for (int i = threadIdx.x; i < n_out * cout; i += blockDim.x) {
    const int j = i / cout, c = i % cout;
    int v = frm[j * pool * cout + c];
    for (int q = 1; q < pool; ++q) v = max(v, (int)frm[(j * pool + q) * cout + c]);
    dst[j * cout + c] = (int8_t)v;
  }
}

__device__ void load_rows(const int32_t* src, int rows, int c, int8_t* dst) {
  for (int i = threadIdx.x; i < rows * c; i += blockDim.x) dst[i] = (int8_t)src[i];
}

__global__ void hop_megakernel_kernel(const HopParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* win0 = reinterpret_cast<int32_t*>(smem);
  int8_t* bin[2];
  bin[0] = reinterpret_cast<int8_t*>(smem + (size_t)P.win0_elems * 4);
  bin[1] = bin[0] + P.bin_bytes;
  int8_t* frm = bin[1] + P.bin_bytes;
  int32_t* hbuf = reinterpret_cast<int32_t*>(frm + P.frm_bytes);

  const int b = blockIdx.x;
  const int ns = P.n_stages;
  const int m = P.model_idx ? P.model_idx[b] : 0;
  const int C = P.gap_c;
  const int tid = threadIdx.x, nt = blockDim.x;

  // state the flush reads: the merged outputs on a hop, the inputs on a peek
  const int32_t* tails_src[MAX_STAGES];
  const int32_t* pends_src[MAX_STAGES];
  const int32_t* gap_src;

  if (!P.finalize_only) {
    const bool live = P.mask[b] != 0;
    for (int i = 0; i < ns; ++i) {
      const StageDesc& g = P.st[i];
      tails_src[i] = g.tail_out + (size_t)b * g.tail * g.cin;
      pends_src[i] = g.pend_out + (size_t)b * g.phase * g.cout;
    }
    gap_src = P.gap_out + (size_t)b * C;
    if (!live) {
      // masked slot: state passes through bit for bit
      for (int i = 0; i < ns; ++i) {
        const StageDesc& g = P.st[i];
        const size_t nt_ = (size_t)g.tail * g.cin, np_ = (size_t)g.phase * g.cout;
        for (size_t j = tid; j < nt_; j += nt)
          g.tail_out[b * nt_ + j] = g.tail_in[b * nt_ + j];
        for (size_t j = tid; j < np_; j += nt)
          g.pend_out[b * np_ + j] = g.pend_in[b * np_ + j];
      }
      for (int c = tid; c < C; c += nt) P.gap_out[(size_t)b * C + c] = P.gap_in[(size_t)b * C + c];
    } else {
      // ---- steady cascade ----
      const StageDesc& g0 = P.st[0];
      {
        const int32_t* t0 = g0.tail_in + (size_t)b * g0.tail * g0.cin;
        const int32_t* a0 = P.audio + (size_t)b * g0.n_in * g0.cin;
        const int nrow = g0.tail + g0.n_in;
        for (int i = tid; i < nrow * g0.cin; i += nt) {
          const int r = i / g0.cin, c = i % g0.cin;
          const int raw = r < g0.tail ? t0[i] : a0[(r - g0.tail) * g0.cin + c];
          win0[i] = code_of(raw, g0);
        }
      }
      __syncthreads();
      for (int i = 0; i < ns; ++i) {
        const StageDesc& g = P.st[i];
        const int8_t* src = i == 0 ? nullptr : bin[(i - 1) & 1];
        int8_t* dst = bin[i & 1];
        const int next_tail = i + 1 < ns ? P.st[i + 1].tail : 0;
        // pending frames, and the next stage's tail rows, land first
        load_rows(g.pend_in + (size_t)b * g.phase * g.cout, g.phase, g.cout, frm);
        if (i + 1 < ns) {
          const StageDesc& gn = P.st[i + 1];
          load_rows(gn.tail_in + (size_t)b * gn.tail * gn.cin, gn.tail, gn.cin, dst);
        }
        const int8_t* w = g.w + (size_t)m * g.k * g.cin * g.cout;
        const float* thr = g.thr + (size_t)m * g.cout;
        const int32_t* flip = g.flip + (size_t)m * g.cout;
        int8_t* y = frm + g.phase * g.cout;
        stage_conv(i, win0, src, g, g.n_conv, w, thr, flip, y);
        // new tail: window rows [n_conv * stride, n_conv * stride + tail)
        {
          const int off = g.n_conv * g.stride;
          int32_t* to = g.tail_out + (size_t)b * g.tail * g.cin;
          if (i == 0) {
            const int32_t* t0 = g.tail_in + (size_t)b * g.tail * g.cin;
            const int32_t* a0 = P.audio + (size_t)b * g.n_in * g.cin;
            for (int j = tid; j < g.tail * g.cin; j += nt) {
              const int r = j / g.cin + off, c = j % g.cin;
              to[j] = r < g.tail ? t0[r * g.cin + c] : a0[(r - g.tail) * g.cin + c];
            }
          } else {
            // rows below `tail` come from the carried tail, whose raw
            // values an int8 window of a bit-serial stage keeps only mod 256
            const int32_t* ti = g.tail_in + (size_t)b * g.tail * g.cin;
            for (int j = tid; j < g.tail * g.cin; j += nt) {
              const int r = j / g.cin + off;
              to[j] = r < g.tail ? ti[j + off * g.cin] : (int32_t)src[off * g.cin + j];
            }
          }
        }
        __syncthreads();
        // pool into the next window after its tail rows; carry the phase
        pool_into(frm, g.n_out, g.pool, g.cout, dst + next_tail * g.cout);
        {
          int32_t* po = g.pend_out + (size_t)b * g.phase * g.cout;
          const int used = g.n_out * g.pool;
          for (int j = tid; j < g.phase * g.cout; j += nt) po[j] = frm[used * g.cout + j];
        }
        __syncthreads();
      }
      const StageDesc& gl = P.st[ns - 1];
      const int8_t* last = bin[(ns - 1) & 1];
      for (int c = tid; c < C; c += nt) {
        int s = 0;
        for (int j = 0; j < gl.n_out; ++j) s += last[j * gl.cout + c];
        P.gap_out[(size_t)b * C + c] = min(P.gap_in[(size_t)b * C + c] + s, 255);
      }
    }
    if (!P.emit) return;
    __syncthreads();  // merged state in global is visible to the whole CTA
  } else {
    for (int i = 0; i < ns; ++i) {
      const StageDesc& g = P.st[i];
      tails_src[i] = g.tail_in + (size_t)b * g.tail * g.cin;
      pends_src[i] = g.pend_in + (size_t)b * g.phase * g.cout;
    }
    gap_src = P.gap_in + (size_t)b * C;
  }

  // ---- ghost end-of-stream flush ----
  for (int i = 0; i < ns; ++i) {
    const StageDesc& g = P.st[i];
    int8_t* dst = bin[i & 1];
    const int next_tail = i + 1 < ns ? P.st[i + 1].tail : 0;
    const int pad_raw = g.in_bits > 1 ? g.in_offset : 0;
    const int L = g.tail + g.flush_in + g.pad;
    if (i == 0) {
      for (int j = tid; j < L * g.cin; j += nt) {
        const int r = j / g.cin;
        win0[j] = code_of(r < g.tail ? tails_src[0][j] : pad_raw, g);
      }
    } else {
      // rows [tail, tail + flush_in) already hold the stage above's frames
      int8_t* win = bin[(i - 1) & 1];
      for (int j = tid; j < g.tail * g.cin; j += nt) win[j] = (int8_t)tails_src[i][j];
      for (int j = tid; j < g.pad * g.cin; j += nt)
        win[(g.tail + g.flush_in) * g.cin + j] = (int8_t)pad_raw;
    }
    for (int j = tid; j < g.phase * g.cout; j += nt) frm[j] = (int8_t)pends_src[i][j];
    __syncthreads();
    if (g.flush_conv > 0) {
      const int8_t* w = g.w + (size_t)m * g.k * g.cin * g.cout;
      const float* thr = g.thr + (size_t)m * g.cout;
      const int32_t* flip = g.flip + (size_t)m * g.cout;
      int8_t* y = frm + g.phase * g.cout;
      stage_conv(i, win0, i == 0 ? nullptr : bin[(i - 1) & 1], g, g.flush_conv,
                 w, thr, flip, y);
    }
    __syncthreads();
    pool_into(frm, g.flush_out, g.pool, g.cout, dst + next_tail * g.cout);
    __syncthreads();
  }

  // ---- GAP + classifier ----
  {
    const StageDesc& gl = P.st[ns - 1];
    const int8_t* last = bin[(ns - 1) & 1];
    for (int c = tid; c < C; c += nt) {
      int s = 0;
      for (int j = 0; j < gl.flush_out; ++j) s += last[j * gl.cout + c];
      hbuf[c] = min(gap_src[c] + s, 255);
    }
  }
  __syncthreads();
  int32_t* hin = hbuf;
  int32_t* hout = hbuf + P.fc_elems;
  for (int j = 0; j < P.n_fc; ++j) {
    const FcDesc& f = P.fc[j];
    const int8_t* w = f.w + (size_t)m * f.cin * f.cout;
    for (int o = tid; o < f.cout; o += nt) {
      int acc = 0;
      for (int c = 0; c < f.cin; ++c) acc += hin[c] * (int)__ldg(w + (size_t)c * f.cout + o);
      if (f.raw) {
        hout[o] = acc;
      } else {
        const bool ge = __int2float_rn(acc) >= __ldg(f.thr + (size_t)m * f.cout + o);
        hout[o] = ge != (__ldg(f.flip + (size_t)m * f.cout + o) != 0);
      }
    }
    __syncthreads();
    int32_t* t = hin; hin = hout; hout = t;
  }
  for (int o = tid; o < P.n_logits; o += nt) P.logits[(size_t)b * P.n_logits + o] = hin[o];
}

extern "C" int hop_megakernel_launch(const HopParams* p, int batch,
                                     int threads, int smem_bytes,
                                     void* stream) {
  if (batch <= 0) return 0;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hop_megakernel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  hop_megakernel_kernel<<<batch, threads, smem_bytes,
                          (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int hop_megakernel_params_size() { return (int)sizeof(HopParams); }
