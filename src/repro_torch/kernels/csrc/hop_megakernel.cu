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
// What bounds it on H100: at full KWS width (hop_frames=8) a steady hop is
// ~11.2M MACs per slot (l0 77,824; b1 1,572,864; b2 5,242,880; b3
// 4,325,376), an emit hop ~1.08M flush and 186K fc MACs more.  For 256
// slots the int8 tensor cores need ~3 us and the slot state moves in
// under 1 us (chip_smoke.py's bound).  The work is a chain of dependent
// stages, each too narrow (16-64 positions a slot, 1-3 in the flush) to
// fill a CTA, over 646 KB of weights (460 KB conv, 186 KB fc) streamed
// from L2.
//
// Design.
//   * Slot blocks: a CTA takes `slots` (S) slots, chosen on the host so the
//     grid fills the SMs in the fewest waves (S = 2 at B = 256); every
//     weight chunk it stages serves all S slots.
//   * Convs on the int8 tensor cores: each conv stage, steady and flush, is
//     an implicit GEMM with S x n_pos rows, cout columns and depth k * cin
//     (padded to 32), on `mma.sync.m16n8k32.row.col.s32.u8.s8.s32`.  The A
//     fragments come straight from the slot's u8 window in shared memory:
//     with the window row-major (rows, cin), position p's taps are the
//     contiguous slice [p*stride*cin, (p*stride+k)*cin).  Windows with
//     cin % 32 == 0 pad each row to cin + 16 bytes, which puts the 8 rows of
//     a fragment on distinct banks.  A bit-serial stage (in_bits <= 8) feeds
//     the masked raw value as u8 and the epilogue subtracts
//     in_offset * sum(w[:, co]): exact, as a padding row holds in_offset,
//     whose code is 0.  A warp's item is up to 2 n-tiles x 4 m-tiles of one
//     slot, with all fragments of a k-step loaded before its MMAs (no
//     branch in the loop).  SA runs in the epilogue from registers, with
//     the pass's thresholds staged in shared memory, and stores two frames
//     at a time into rows of an odd number of words; pool, tails, pendings
//     and GAP are scalar loops over a (row, column) thread layout.
//   * Weights: `prepare_hop_weights` lays each layer out once, on the host,
//     in fragment order ([K,] n_tiles, kp / 32, 32 lanes, 8 bytes), so a
//     chunk of `chunk_tiles` n-tiles is one contiguous run of bytes.  The
//     CTA streams the chunks of every pass (layer x distinct model) into a
//     two-slot shared-memory ring with cp.async: chunk n + 1 (possibly the
//     next layer's first) loads while the warps run chunk n's MMAs.
//   * State: each slot's audio, tails, pendings and GAP counts are copied
//     into shared memory in one round of cp.async at the start.
//   * Classifier: fc1 (u8 GAP counts x s8) and fc2 run on the same MMA path,
//     the S slots as the rows of one 16-row tile.
//   * Tenants: `model_idx` is per slot.  A block runs each distinct model of
//     its slots as its own pass over that model's weights, on that model's
//     rows only.
//
// Where the time goes (NVIDIA H100 80GB HBM3, 700 W; clock64 stamps of
// block 0 and variants with parts removed, B = 256, S = 2; PERF.md has the
// numbers): about half is the chunks' MMA loops, which are bound by the
// shared-memory wavefronts of the register fragments (up to 512 B of
// loads per MMA at these narrow tiles; the tensor pipe itself is idle
// most of the time), and about a third is the ~40 barrier-separated
// scalar phases of a hop at 1-3K cycles each.  Removing the weight copies
// saves 7 %; the MMAs themselves, under 10 %.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma.cuh"

#define MAX_STAGES 8
#define MAX_FC 4
#define MAX_S 8
#define MAX_PASSES ((2 * MAX_STAGES + MAX_FC) * MAX_S)
#define FC_ROWS 16  // the classifier's one m-tile: slot s is row s

struct StageDesc {
  int k, stride, pad, pool, cin, cout, in_bits, in_offset;
  int tail, phase, n_in, n_conv, n_out, flush_in, flush_conv, flush_out;
  int pitch;    // bytes per window row in shared memory
  int kp;       // GEMM depth: k * cin rounded up to 32
  int n_tiles;  // ceil(cout / 8)
  int a_mode;   // 0: padded rows (cin % 32 == 0); 1: linear, 4-byte aligned;
                // 2: linear, read bytewise
  int fpitch;   // bytes per row of concat(pending, y): an odd number of
                // words, so a fragment's 8 rows store to distinct banks
  int tail_sto, pend_sto;   // int32 offsets of tail_in / pend_in in a slot's
                            // staged state
  const int32_t* tail_in;   // (B, tail, cin) or null when tail == 0
  int32_t* tail_out;
  const int32_t* pend_in;   // (B, phase, cout) or null when phase == 0
  int32_t* pend_out;
  const int8_t* w;          // ([K,] n_tiles, kp / 32, 32, 8) fragment order
  const int32_t* wsum;      // ([K,] cout) sum of each column's weights
  const float* thr;         // ([K,] cout)
  const int32_t* flip;      // ([K,] cout)
};

struct FcDesc {
  int cin, cout, raw, kp, n_tiles, unused;
  const int8_t* w;          // ([K,] n_tiles, kp / 32, 32, 8) fragment order
  const float* thr;         // ([K,] cout), null when raw
  const int32_t* flip;
};

struct HopParams {
  int n_stages, n_fc, emit, finalize_only, gap_c, n_logits;
  int batch, slots, chunk_tiles, ring_bytes;
  // one slot's buffers, in bytes: layer-0 window, two ping-pong windows,
  // concat(pending, y); then the classifier's row pitch
  int win0_bytes, bin_bytes, frm_bytes, slot_bytes, fc_pitch;
  // a slot's staged input state: its byte offset in the slot's buffers,
  // and the int32 offsets of audio and gap_in in it; the columns of the
  // SA-parameter buffer
  int stg_off, audio_sto, gap_sto, sa_cols;
  const int32_t* audio;      // (B, n_in0, cin0) codes
  const int32_t* mask;       // (B,)
  const int32_t* gap_in;     // (B, gap_c)
  int32_t* gap_out;          // (B, gap_c) or null in finalize mode
  int32_t* logits;           // (B, n_logits) or null
  const int32_t* model_idx;  // (B,) pool row per slot, or null
  StageDesc st[MAX_STAGES];
  FcDesc fc[MAX_FC];
};

// ---- slot selection ------------------------------------------------------

// The slots of `cand` that share slot s's model, if s is the first of them
// in `cand`; else 0.  Passes over a layer go model by model in this order.
__device__ __forceinline__ unsigned model_group(int s, unsigned cand,
                                                const int* mdl) {
  if (!((cand >> s) & 1u)) return 0;
  unsigned grp = 0;
  for (int j = 0; j < MAX_S; ++j) {
    if (((cand >> j) & 1u) && mdl[j] == mdl[s]) {
      if (j < s) return 0;
      grp |= 1u << j;
    }
  }
  return grp;
}

__device__ __forceinline__ int nth_bit(unsigned sel, int n) {
  for (int j = 0; j < MAX_S; ++j) {
    if ((sel >> j) & 1u) {
      if (n == 0) return j;
      --n;
    }
  }
  return 0;
}

__device__ __forceinline__ void add_passes(Pass* passes, int& np, const int8_t* w,
                           int n_tiles, int ksteps, unsigned cand,
                           const int* mdl, int ct) {
  const size_t mstride = (size_t)n_tiles * ksteps * 256;
  for (int s = 0; s < MAX_S; ++s) {
    if (!model_group(s, cand, mdl)) continue;
    Pass& p = passes[np++];
    p.w = w + (size_t)mdl[s] * mstride;
    p.nchunks = (n_tiles + ct - 1) / ct;
    p.chunk_bytes = ct * ksteps * 256;
    p.last_bytes = (n_tiles - (p.nchunks - 1) * ct) * ksteps * 256;
  }
}

// ---- conv stage as an implicit GEMM --------------------------------------

// What a stage's window holds for a raw input is raw & amask: the masked
// raw value of a bit-serial stage (its code + in_offset), the raw value
// of a binary one.
__device__ __forceinline__ int amask_of(const StageDesc& g) {
  return g.in_bits > 1 ? (1 << g.in_bits) - 1 : 0xff;
}

// One conv pass's operands, read once into registers: the hot loop then
// touches only registers and shared memory.
struct ConvArgs {
  int stride, cin, pitch, a_mode, ksteps, cout, fpitch, phase, n_pos,
      in_offset;
  unsigned sel;           // slots of this pass
  unsigned char* slots;   // slot buffers
  int slot_bytes, win_off, frm_off;
  // this model's SA parameters per column, staged in shared memory:
  // threshold, flip, and in_offset * sum(w) (0 unless bit-serial)
  const float* thr;
  const int* flip;
  const int* fold;
};

// The MMAs of one chunk (n-tiles [tile0, tile0 + nt)) over the selected
// slots' positions; SA in the epilogue into frm rows [phase, phase + n_pos).
// A work item is NG n-tiles x MC m-tiles of one slot: one A fragment feeds
// NG MMAs, one B fragment MC, and the NG x MC accumulator chains are
// independent.  The loop has no branch: every fragment of a k-step loads
// before its MMAs (rows past n_pos are clamped to the last, and their sums
// never stored), and the loop is unrolled so the next k-step's loads
// overlap this one's MMAs.
template <bool ALIGNED, int NG, int MC>
__device__ void conv_chunk(const int8_t* __restrict__ chunk, int tile0,
                           int nt, const ConvArgs A) {
  ASSUME_SHARED(chunk);
  ASSUME_SHARED(A.slots);
  ASSUME_SHARED(A.thr);
  ASSUME_SHARED(A.flip);
  ASSUME_SHARED(A.fold);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int nwarps = blockDim.x >> 5;
  const int ksteps = A.ksteps, n_pos = A.n_pos;
  const int mts = (n_pos + 15) >> 4, mgs = (mts + MC - 1) / MC;
  const int ngs = (nt + NG - 1) / NG;
  const int items = ngs * __popc(A.sel) * mgs;
  const bool padded = A.a_mode == 0;
  const int rstep = A.stride * (padded ? A.pitch : A.cin);
  // padded rows put 16 bytes after each tap: depth column 32 ks + 4 tq
  // sits at 32 ks + 16 * (32 ks / cin) + 4 tq
  const int kpt = padded ? A.cin >> 5 : 1 << 30;
  for (int it = warp; it < items; it += nwarps) {
    const int jg = it % ngs;
    const int rest = it / ngs;
    const int mg = rest % mgs;
    const int s = nth_bit(A.sel, rest / mgs);
    const unsigned char* __restrict__ win =
        A.slots + (size_t)s * A.slot_bytes + A.win_off + 4 * tq;
    int acc[NG][MC][4];
    int roff[MC][2];
#pragma unroll
    for (int mi = 0; mi < MC; ++mi) {
      const int r0 = (mg * MC + mi) * 16 + gq;
      roff[mi][0] = min(r0, n_pos - 1) * rstep;
      roff[mi][1] = min(r0 + 8, n_pos - 1) * rstep;
#pragma unroll
      for (int ni = 0; ni < NG; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ni][mi][e] = 0;
    }
    const uint2* __restrict__ bp[NG];
    // SA parameters of this item's columns
    float th[NG][2];
    bool fl[NG][2];
    int fold[NG][2];
#pragma unroll
    for (int ni = 0; ni < NG; ++ni) {
      bp[ni] = reinterpret_cast<const uint2*>(chunk) +
               (size_t)min(jg * NG + ni, nt - 1) * ksteps * 32 + lane;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = min((tile0 + jg * NG + ni) * 8 + 2 * tq + e, A.cout - 1);
        th[ni][e] = A.thr[c];
        fl[ni][e] = A.flip[c] != 0;
        fold[ni][e] = A.fold[c];
      }
    }
    int tap = 0, kin = 0;  // k-steps into the current tap
#pragma unroll 2
    for (int ks = 0; ks < ksteps; ++ks) {
      const int koff = ks * 32 + (padded ? 16 * tap : 0);
      uint2 b[NG];
      unsigned a[MC][4];
#pragma unroll
      for (int ni = 0; ni < NG; ++ni) b[ni] = bp[ni][ks * 32];
#pragma unroll
      for (int mi = 0; mi < MC; ++mi) {
        const unsigned char* p0 = win + roff[mi][0] + koff;
        const unsigned char* p1 = win + roff[mi][1] + koff;
        a[mi][0] = a_word<ALIGNED>(p0);
        a[mi][1] = a_word<ALIGNED>(p1);
        a[mi][2] = a_word<ALIGNED>(p0 + 16);
        a[mi][3] = a_word<ALIGNED>(p1 + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MC; ++mi)
#pragma unroll
        for (int ni = 0; ni < NG; ++ni)
          mma_u8s8(acc[ni][mi], a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                   b[ni].x, b[ni].y);
      if (++kin == kpt) {
        kin = 0;
        ++tap;
      }
    }
    // epilogue: rows gq / gq + 8 of each m-tile, columns c0 and c0 + 1,
    // stored together
    unsigned char* frm = A.slots + (size_t)s * A.slot_bytes + A.frm_off +
                         A.phase * A.fpitch;
#pragma unroll
    for (int ni = 0; ni < NG; ++ni) {
      if (jg * NG + ni >= nt) break;
      const int c0 = (tile0 + jg * NG + ni) * 8 + 2 * tq;
      if (c0 >= A.cout) continue;
#pragma unroll
      for (int mi = 0; mi < MC; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (mg * MC + mi) * 16 + gq + 8 * h;
          if (r >= n_pos) continue;
          unsigned y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            y[e] = (__int2float_rn(acc[ni][mi][2 * h + e] - fold[ni][e]) >=
                    th[ni][e]) != fl[ni][e];
          unsigned char* o = frm + r * A.fpitch + c0;
          if (c0 + 1 < A.cout)
            *reinterpret_cast<unsigned short*>(o) =
                (unsigned short)(y[0] | (y[1] << 8));
          else
            o[0] = (unsigned char)y[0];
        }
      }
    }
  }
}

// One chunk of a conv pass: picks the item shape.  Two n-tiles by MC
// m-tiles of one slot (up to 4: a B fragment serves them all) while that
// still leaves every warp two items, else one by one.  A window whose rows
// are not 4-byte aligned (a stride * cin not a multiple of 4) reads
// bytewise, one tile at a time.
__device__ __noinline__ void conv_chunk_any(const int8_t* chunk, int tile0,
                                            int nt, const ConvArgs A) {
  ASSUME_SHARED(chunk);
  if (A.a_mode == 2) {
    conv_chunk<false, 1, 1>(chunk, tile0, nt, A);
    return;
  }
  const int mts = (A.n_pos + 15) >> 4;
  const int mc = mts >= 4 ? 4 : (mts >= 2 ? 2 : 1);
  const int items = nt * __popc(A.sel) * ((mts + mc - 1) / mc);
  if (items < 2 * (int)(blockDim.x >> 5))
    conv_chunk<true, 1, 1>(chunk, tile0, nt, A);
  else if (mc == 4)
    conv_chunk<true, 2, 4>(chunk, tile0, nt, A);
  else if (mc == 2)
    conv_chunk<true, 2, 2>(chunk, tile0, nt, A);
  else
    conv_chunk<true, 2, 1>(chunk, tile0, nt, A);
}

// A pass's SA parameters, per column, into shared memory: the epilogues
// then read no global memory.  (Visible after the pass's first
// ring_acquire; the previous pass's last ring_release fenced its readers.)
__device__ __forceinline__ void stage_sa(float* s_thr, int* s_flip,
                                         int* s_fold, int cout,
                                         const float* thr,
                                         const int32_t* flip,
                                         const int32_t* wsum, int in_offset) {
  for (int c = threadIdx.x; c < cout; c += blockDim.x) {
    s_thr[c] = thr ? __ldg(thr + c) : 0.f;
    s_flip[c] = flip ? __ldg(flip + c) : 0;
    s_fold[c] = wsum ? in_offset * __ldg(wsum + c) : 0;
  }
}

// Every model pass of one conv stage over the slots of `cand`, chunk by
// chunk through the ring.
__device__ __noinline__ void conv_stage(Ring& R, const Pass* passes, int ct,
                                        const StageDesc& g, int n_pos,
                                        unsigned cand, const int* mdl,
                                        unsigned char* slots, int slot_bytes,
                                        int win_off, int frm_off, float* s_thr,
                                        int* s_flip, int* s_fold) {
  ASSUME_SHARED(R.buf);
  ASSUME_SHARED(passes);
  ASSUME_SHARED(mdl);
  ASSUME_SHARED(slots);
  ASSUME_SHARED(s_thr);
  ASSUME_SHARED(s_flip);
  ASSUME_SHARED(s_fold);
  for (int s = 0; s < MAX_S; ++s) {
    const unsigned grp = model_group(s, cand, mdl);
    if (!grp) continue;
    const size_t m = (size_t)mdl[s] * g.cout;
    stage_sa(s_thr, s_flip, s_fold, g.cout, g.thr + m, g.flip + m,
             g.in_bits > 1 ? g.wsum + m : nullptr, g.in_offset);
    const ConvArgs A{g.stride, g.cin, g.pitch, g.a_mode, g.kp >> 5, g.cout,
                     g.fpitch, g.phase, n_pos, g.in_offset, grp, slots,
                     slot_bytes, win_off, frm_off, s_thr, s_flip, s_fold};
    const int n_tiles = g.n_tiles, nchunks = (n_tiles + ct - 1) / ct;
    for (int c = 0; c < nchunks; ++c) {
      const int8_t* chunk = ring_acquire(R);
      conv_chunk_any(chunk, c * ct, min(ct, n_tiles - c * ct), A);
      ring_release(R, passes);
    }
  }
}

// ---- classifier ----------------------------------------------------------

// One fc layer, one model: rows = the slots of `sel` (row s of `hin`),
// written to row s of `hout` (SA) or, on the last layer, to the logits.
__device__ __forceinline__ void fc_pass(Ring& R, const Pass* passes, int ct, const FcDesc& f,
                        int m, unsigned sel, const unsigned char* hin,
                        unsigned char* hout, int pitch, bool last,
                        int32_t* logits, int b0, int n_logits, float* s_thr,
                        int* s_flip) {
  ASSUME_SHARED(R.buf);
  ASSUME_SHARED(hin);
  ASSUME_SHARED(hout);
  ASSUME_SHARED(s_thr);
  ASSUME_SHARED(s_flip);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int nwarps = blockDim.x >> 5;
  const int ksteps = f.kp >> 5, n_tiles = f.n_tiles, cout = f.cout;
  const bool raw = f.raw != 0;
  const int nchunks = (n_tiles + ct - 1) / ct;
  if (!raw) {
    for (int c = threadIdx.x; c < cout; c += blockDim.x) {
      s_thr[c] = __ldg(f.thr + (size_t)m * cout + c);
      s_flip[c] = __ldg(f.flip + (size_t)m * cout + c) != 0;
    }
  }
  for (int c = 0; c < nchunks; ++c) {
    const int8_t* chunk = ring_acquire(R);
    const int nt = min(ct, n_tiles - c * ct);
    for (int j = warp; j < nt; j += nwarps) {
      int acc[4] = {0, 0, 0, 0};
      const uint2* bp = reinterpret_cast<const uint2*>(chunk) +
                        (size_t)j * ksteps * 32 + lane;
      const unsigned char* p0 = hin + gq * pitch + 4 * tq;
      const unsigned char* p1 = p0 + 8 * pitch;
#pragma unroll 4
      for (int ks = 0; ks < ksteps; ++ks) {
        const uint2 b = bp[ks * 32];
        const int k0 = ks * 32;
        mma_u8s8(acc, a_word<true>(p0 + k0), a_word<true>(p1 + k0),
                 a_word<true>(p0 + k0 + 16), a_word<true>(p1 + k0 + 16), b.x,
                 b.y);
      }
      const int col0 = (c * ct + j) * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = gq + 8 * h;
        if (s >= MAX_S || !((sel >> s) & 1u)) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + e;
          if (col >= cout) continue;
          int v = acc[2 * h + e];
          if (!raw) v = (__int2float_rn(v) >= s_thr[col]) != s_flip[col];
          if (last) logits[(size_t)(b0 + s) * n_logits + col] = v;
          else hout[s * pitch + col] = (unsigned char)v;
        }
      }
    }
    ring_release(R, passes);
  }
}

// ---- scalar stage work ---------------------------------------------------
//
// Every loop below reads its geometry from registers (read through a
// reference into the parameter block, a field would be reloaded after each
// byte store), and lays the CTA's threads out as (row, column) with a
// power-of-two column width, so no index is divided inside a loop.

// A stage's scalars, by value.
struct Geo {
  int k, stride, pad, pool, cin, cout, amask, in_offset;
  int tail, phase, n_in, n_conv, n_out, flush_in, flush_conv, flush_out;
  int pitch, fpitch;
};

__device__ __forceinline__ Geo geo_of(const StageDesc& g) {
  return Geo{g.k, g.stride, g.pad, g.pool, g.cin, g.cout, amask_of(g),
             g.in_offset, g.tail, g.phase, g.n_in, g.n_conv, g.n_out,
             g.flush_in, g.flush_conv, g.flush_out, g.pitch, g.fpitch};
}

// f(s, j, q) for every slot s of `sel`, row j < rows and column q < cols.
template <class F>
__device__ __forceinline__ void for_rows(unsigned sel, int rows, int cols,
                                         F f) {
  int tx = 1;  // at most the block's width, so every thread has a row
  while (tx < cols && 2 * tx <= (int)blockDim.x) tx <<= 1;
  const int sh = __ffs(tx) - 1;
  const int x = threadIdx.x & (tx - 1), y = threadIdx.x >> sh;
  const int ny = blockDim.x >> sh;
  for (int s = 0; s < MAX_S; ++s) {
    if (!((sel >> s) & 1u)) continue;
    for (int j = y; j < rows; j += ny)
      for (int q = x; q < cols; q += tx) f(s, j, q);
  }
}

// The helpers below run at several points of a hop; each is one function,
// not inlined, so the kernel's code stays small enough for the SM's
// instruction caches.

// max-pool frm rows [0, n_out * pool) (pitch fp) of each slot of `sel` into
// rows [row0, row0 + n_out) of the window at `dst` (pitch dpitch).  The
// frames are SA bits {0, 1}, so the max is an OR, four channels to a word
// where the rows align.
__device__ __noinline__ void pool_rows(unsigned char* slots, int slot_bytes,
                                       int frm_off, unsigned sel, int cout,
                                       int pool, int fp, int n_out, int dst,
                                       int row0, int dpitch) {
  ASSUME_SHARED(slots);
  if (cout % 4 == 0 && dpitch % 4 == 0) {
    const int fw = fp >> 2;
    for_rows(sel, n_out, cout >> 2, [&](int s, int j, int c) {
      unsigned char* base = slots + (size_t)s * slot_bytes;
      const unsigned* frm =
          reinterpret_cast<const unsigned*>(base + frm_off) + j * pool * fw +
          c;
      unsigned v = frm[0];
      for (int q = 1; q < pool; ++q) v |= frm[q * fw];
      reinterpret_cast<unsigned*>(base + dst + (row0 + j) * dpitch)[c] = v;
    });
    return;
  }
  for_rows(sel, n_out, cout, [&](int s, int j, int c) {
    unsigned char* base = slots + (size_t)s * slot_bytes;
    const unsigned char* frm = base + frm_off;
    unsigned char v = frm[j * pool * fp + c];
    for (int q = 1; q < pool; ++q) v |= frm[(j * pool + q) * fp + c];
    base[dst + (row0 + j) * dpitch + c] = v;
  });
}

// rows [0, rows) of int32 state (c per row; slot s's at src + s * sstride)
// -> rows of pitch `pitch` at `dst` of each slot of `sel`, & amask.  The
// source is global (plain loads: on an emit hop the flush reads state this
// kernel wrote) or a slot's staged state in shared memory.
__device__ __noinline__ void load_rows(unsigned char* slots, int slot_bytes,
                                       unsigned sel, const int32_t* src,
                                       int sstride, int rows, int c,
                                       int amask, int dst, int pitch) {
  ASSUME_SHARED(slots);
  for_rows(sel, rows, c, [&](int s, int j, int q) {
    slots[(size_t)s * slot_bytes + dst + j * pitch + q] =
        (unsigned char)(src[(size_t)s * sstride + j * c + q] & amask);
  });
}

// ---- the kernel ----------------------------------------------------------

__global__ void __launch_bounds__(256, 1)
    hop_megakernel_kernel(const __grid_constant__ HopParams P) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Pass passes[MAX_PASSES];
  __shared__ int s_model[MAX_S];
  __shared__ int s_np;

  const int S = P.slots, ct = P.chunk_tiles;
  const int b0 = blockIdx.x * S;
  const int nv = min(S, P.batch - b0);
  const int ns = P.n_stages, C = P.gap_c;
  // shared memory: weight ring | slot buffers | classifier rows | SA
  unsigned char* slots = smem + 2 * (size_t)P.ring_bytes;
  const int SB = P.slot_bytes;
  const int win0_bytes = P.win0_bytes, bin_bytes = P.bin_bytes;
  const int frm_off = win0_bytes + 2 * bin_bytes;
  const int fc_pitch = P.fc_pitch;
  unsigned char* fcbuf0 = slots + (size_t)S * SB;
  unsigned char* fcbuf1 = fcbuf0 + FC_ROWS * fc_pitch;
  float* s_thr = reinterpret_cast<float*>(fcbuf1 + FC_ROWS * fc_pitch);
  int* s_flip = reinterpret_cast<int*>(s_thr + P.sa_cols);
  int* s_fold = s_flip + P.sa_cols;
  // slot s's byte at offset o of its buffers
  auto at = [&](int s, int o) -> unsigned char& {
    return slots[(size_t)s * SB + o];
  };
  // slot 0's staged int32 state at offset sto; slot s's is SB / 4 further
  const int sstride = SB >> 2;
  auto stg = [&](int sto) {
    return reinterpret_cast<const int32_t*>(slots + P.stg_off) + sto;
  };
  // window offsets: stage 0 reads win0, stage i > 0 bin[(i - 1) & 1]
  auto win_of = [&](int i) {
    return i == 0 ? 0 : win0_bytes + ((i - 1) & 1) * bin_bytes;
  };
  // slot masks: valid (inside the batch) and live (advancing on a hop)
  unsigned valid = 0, live = 0;
  for (int s = 0; s < nv; ++s) {
    valid |= 1u << s;
    if (!P.finalize_only && P.mask[b0 + s] != 0) live |= 1u << s;
  }
  if (threadIdx.x < MAX_S)
    s_model[threadIdx.x] =
        ((int)threadIdx.x < nv && P.model_idx) ? P.model_idx[b0 + threadIdx.x]
                                               : 0;
  const bool peek = P.finalize_only != 0;
  // stage the input state of the slots that read it (the live ones on a
  // hop, all on a peek) with one round of asynchronous copies
  const unsigned staged = peek ? valid : live;
  {
    auto stage_in = [&](const int32_t* src, int n, int sto) {
      for_rows(staged, 1, n, [&](int s, int, int q) {
        cp_async4(&at(s, P.stg_off + 4 * (sto + q)),
                  src + (size_t)(b0 + s) * n + q);
      });
    };
    for (int i = 0; i < ns; ++i) {
      const StageDesc& g = P.st[i];
      stage_in(g.tail_in, g.tail * g.cin, g.tail_sto);
      stage_in(g.pend_in, g.phase * g.cout, g.pend_sto);
    }
    stage_in(P.gap_in, C, P.gap_sto);
    if (!peek)
      stage_in(P.audio, P.st[0].n_in * P.st[0].cin, P.audio_sto);
    cp_async_commit();
  }
  __syncthreads();
  const bool with_fc = P.emit || peek;
  if (threadIdx.x == 0) {
    int np = 0;
    if (!peek)
      for (int i = 0; i < ns; ++i)
        add_passes(passes, np, P.st[i].w, P.st[i].n_tiles, P.st[i].kp >> 5,
                   live, s_model, ct);
    if (with_fc) {
      for (int i = 0; i < ns; ++i)
        if (P.st[i].flush_conv > 0)
          add_passes(passes, np, P.st[i].w, P.st[i].n_tiles,
                     P.st[i].kp >> 5, valid, s_model, ct);
      for (int j = 0; j < P.n_fc; ++j)
        add_passes(passes, np, P.fc[j].w, P.fc[j].n_tiles, P.fc[j].kp >> 5,
                   valid, s_model, ct);
    }
    s_np = np;
  }
  __syncthreads();
  Ring R{smem, P.ring_bytes, 0, 0, 0, 0, s_np};
  ring_issue(R, passes);
  ring_issue(R, passes);
  cp_async_wait2();  // the staged state has landed (two ring chunks may not)
  __syncthreads();

  if (!peek) {
    // masked slots: state passes through bit for bit
    const unsigned masked = valid & ~live;
    if (masked) {
      auto copy = [&](const int32_t* src, int32_t* dst, int n) {
        for_rows(masked, 1, n, [&](int s, int, int q) {
          dst[(size_t)(b0 + s) * n + q] = src[(size_t)(b0 + s) * n + q];
        });
      };
      for (int i = 0; i < ns; ++i) {
        const Geo G = geo_of(P.st[i]);
        copy(P.st[i].tail_in, P.st[i].tail_out, G.tail * G.cin);
        copy(P.st[i].pend_in, P.st[i].pend_out, G.phase * G.cout);
      }
      copy(P.gap_in, P.gap_out, C);
    }
    // ---- steady cascade over the live slots ----
    const int32_t* audio = stg(P.audio_sto);
    {
      const Geo G = geo_of(P.st[0]);
      const int32_t* tail_in = stg(P.st[0].tail_sto);
      for_rows(live, G.tail + G.n_in, G.cin, [&](int s, int row, int c) {
        const int raw =
            row < G.tail ? tail_in[s * sstride + row * G.cin + c]
                         : audio[s * sstride + (row - G.tail) * G.cin + c];
        at(s, row * G.pitch + c) = (unsigned char)(raw & G.amask);
      });
    }
    for (int i = 0; i < ns; ++i) {
      const Geo G = geo_of(P.st[i]);
      const int src_off = win_of(i), dst_off = win_of(i + 1);
      const bool more = i + 1 < ns;
      const int dpitch = more ? P.st[i + 1].pitch : G.cout;
      const int next_tail = more ? P.st[i + 1].tail : 0;
      const int32_t* tail_in = stg(P.st[i].tail_sto);
      int32_t* __restrict__ tail_out = P.st[i].tail_out;
      int32_t* __restrict__ pend_out = P.st[i].pend_out;
      // pending frames, and the next stage's tail rows, land first
      load_rows(slots, SB, live, stg(P.st[i].pend_sto), sstride, G.phase,
                G.cout, 0xff, frm_off, G.fpitch);
      if (more)
        load_rows(slots, SB, live, stg(P.st[i + 1].tail_sto), sstride,
                  next_tail, P.st[i + 1].cin, amask_of(P.st[i + 1]), dst_off,
                  dpitch);
      conv_stage(R, passes, ct, P.st[i], G.n_conv, live, s_model, slots, SB,
                 src_off, frm_off, s_thr, s_flip, s_fold);
      // new tail: window rows [n_conv * stride, n_conv * stride + tail)
      {
        const int off = G.n_conv * G.stride;
        for_rows(live, G.tail, G.cin, [&](int s, int j, int c) {
          const int row = j + off;
          int v;
          if (row < G.tail) {
            v = tail_in[s * sstride + row * G.cin + c];
          } else if (i == 0) {
            v = audio[s * sstride + (row - G.tail) * G.cin + c];
          } else {
            // the stage above's pooled frames: {0, 1}
            v = at(s, src_off + row * G.pitch + c);
          }
          tail_out[((size_t)(b0 + s) * G.tail + j) * G.cin + c] = v;
        });
      }
      // pool into the next window after its tail rows; carry the phase.
      // (The conv's last ring_release fenced its frames; the tail loop
      // touches neither frm nor the next window.)
      pool_rows(slots, SB, frm_off, live, G.cout, G.pool, G.fpitch, G.n_out,
                dst_off, next_tail, dpitch);
      {
        const int used = G.n_out * G.pool;
        for_rows(live, G.phase, G.cout, [&](int s, int j, int c) {
          pend_out[((size_t)(b0 + s) * G.phase + j) * G.cout + c] =
              (signed char)at(s, frm_off + (used + j) * G.fpitch + c);
        });
      }
      __syncthreads();
    }
    {
      const int cl = P.st[ns - 1].cout, n_out = P.st[ns - 1].n_out;
      const int last_off = win_of(ns);
      const int32_t* gap_in = stg(P.gap_sto);
      int32_t* __restrict__ gap_out = P.gap_out;
      for_rows(live, 1, C, [&](int s, int, int c) {
        int sum = 0;
        for (int j = 0; j < n_out; ++j) sum += at(s, last_off + j * cl + c);
        gap_out[(size_t)(b0 + s) * C + c] =
            min(gap_in[s * sstride + c] + sum, 255);
      });
    }
    if (!P.emit) return;
    __syncthreads();  // merged state in global is visible to the whole CTA
  }

  // ---- ghost end-of-stream flush, every valid slot ----
  // the state it reads: the merged outputs on a hop (global), the staged
  // inputs on a peek
  for (int i = 0; i < ns; ++i) {
    const Geo G = geo_of(P.st[i]);
    const int src_off = win_of(i), dst_off = win_of(i + 1);
    const bool more = i + 1 < ns;
    const int dpitch = more ? P.st[i + 1].pitch : G.cout;
    const int next_tail = more ? P.st[i + 1].tail : 0;
    const unsigned char pad =
        (unsigned char)((P.st[i].in_bits > 1 ? G.in_offset : 0) & G.amask);
    // tail rows, then (past the stage above's frames) the pad rows
    if (peek) {
      load_rows(slots, SB, valid, stg(P.st[i].tail_sto), sstride, G.tail,
                G.cin, G.amask, src_off, G.pitch);
      load_rows(slots, SB, valid, stg(P.st[i].pend_sto), sstride, G.phase,
                G.cout, 0xff, frm_off, G.fpitch);
    } else {
      load_rows(slots, SB, valid, P.st[i].tail_out + (size_t)b0 * G.tail *
                G.cin, G.tail * G.cin, G.tail, G.cin, G.amask, src_off,
                G.pitch);
      load_rows(slots, SB, valid, P.st[i].pend_out + (size_t)b0 * G.phase *
                G.cout, G.phase * G.cout, G.phase, G.cout, 0xff, frm_off,
                G.fpitch);
    }
    const int row0 = G.tail + G.flush_in;
    for_rows(valid, G.pad, G.cin, [&](int s, int j, int c) {
      at(s, src_off + (row0 + j) * G.pitch + c) = pad;
    });
    __syncthreads();
    if (G.flush_conv > 0)  // (ends in a barrier, as pool_rows needs)
      conv_stage(R, passes, ct, P.st[i], G.flush_conv, valid, s_model, slots,
                 SB, src_off, frm_off, s_thr, s_flip, s_fold);
    pool_rows(slots, SB, frm_off, valid, G.cout, G.pool, G.fpitch,
              G.flush_out, dst_off, next_tail, dpitch);
    __syncthreads();
  }

  // ---- GAP + classifier: slot s is row s of the u8 activations ----
  {
    const int cl = P.st[ns - 1].cout, n_out = P.st[ns - 1].flush_out;
    const int last_off = win_of(ns);
    const int32_t* gap_src = peek ? stg(P.gap_sto) : P.gap_out + (size_t)b0 * C;
    const int gstride = peek ? sstride : C;
    for_rows(1u, FC_ROWS, fc_pitch, [&](int, int s, int c) {
      int v = 0;
      if (s < MAX_S && ((valid >> s) & 1u) && c < C) {
        int sum = 0;
        for (int j = 0; j < n_out; ++j) sum += at(s, last_off + j * cl + c);
        v = min(gap_src[s * gstride + c] + sum, 255);
      }
      fcbuf0[s * fc_pitch + c] = (unsigned char)v;
    });
  }
  __syncthreads();
  const int n_fc = P.n_fc, n_logits = P.n_logits;
  int32_t* logits = P.logits;
  if (n_fc == 0) {
    for_rows(valid, 1, C, [&](int s, int, int c) {
      logits[(size_t)(b0 + s) * n_logits + c] = fcbuf0[s * fc_pitch + c];
    });
    return;
  }
  for (int j = 0; j < n_fc; ++j) {
    const bool last = j + 1 == n_fc;
    for (int s = 0; s < MAX_S; ++s) {
      const unsigned grp = model_group(s, valid, s_model);
      if (!grp) continue;
      fc_pass(R, passes, ct, P.fc[j], s_model[s], grp,
              (j & 1) ? fcbuf1 : fcbuf0, (j & 1) ? fcbuf0 : fcbuf1, fc_pitch,
              last, logits, b0, n_logits, s_thr, s_flip);
    }
  }
}

extern "C" int hop_megakernel_launch(const HopParams* p, int blocks,
                                     int threads, int smem_bytes,
                                     void* stream) {
  if (blocks <= 0) return 0;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hop_megakernel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  hop_megakernel_kernel<<<blocks, threads, smem_bytes,
                          (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int hop_megakernel_params_size() { return (int)sizeof(HopParams); }

// The kernel's static shared memory (the pass list), which the host's
// layout leaves room for beside the dynamic buffers; -1 on error.
extern "C" int hop_megakernel_static_smem() {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, hop_megakernel_kernel) != cudaSuccess)
    return -1;
  return (int)a.sharedSizeBytes;
}
