// Banded Smith-Waterman extension (bwa-mem ksw_extend) over a batch of
// independent (query, target, h0) pairs.
//
// Replaces genomicsbench_palisade_tpu/ops/bsw_pallas.py:_kernel (the TPU's
// layout: 128 pairs on lanes, query positions on sublanes, the lazy-F chain
// as log2(Qe) roll/max rounds) and the per-pair set-up its wrapper
// `_bsw_core` does before it (band clamp, first row).
//
// What it computes, per pair b: the six int32 outputs of
// scalarBandedSWA (bandedSWA.cpp:130-251; ops/oracle/bsw.py), in OUT_ORDER
// rows of `out` [6, batch]: score, qle, tle, gtle, gscore, max_off.  Every
// branch of the oracle maps one to one onto this code: the band clamp
// (w = min(w0, max_ins, max_del), an IEEE double division truncated as C
// truncates), the first-row decay from h0, the M = 0 rule where
// H(i-1,j-1) == 0, the last argmax on ties (m <= h), the gscore check when
// the band reaches the query's end, the m == 0 break, the z-drop break and
// the band shrink to the non-zero span of the row just written.  All
// arithmetic is int32 but the band clamp, so the result is bit-equal to the
// oracle, the JAX scan and the plain PyTorch version.
//
// Design.  One thread per pair: pairs are independent, so there is no
// communication.  A thread walks the target rows and, inside a row, the
// band's columns, as the oracle does.  The H/E row (entry j holds
// H(i, j-1) and E(i+1, j)) lives in global scratch as one int2 per entry,
// laid out [qe, batch] so that neighbouring threads touch neighbouring
// 8-byte words.  The shrink's two zero scans are folded into the column
// loop: it notes the first and the last entry it writes that is non-zero,
// which is what the scans would find (the row's band is never empty when
// the shrink runs: an empty band gives m == 0 and the break).  Queries and
// targets are read in place from the flat code buffer by their int64
// offsets (the buffer passes 2^31 bytes at the reference's bsw_large
// scale).  Neighbouring threads work on pairs of similar length because
// the caller sorts pairs into (qlen, tlen) buckets.
//
// Bound.  Per band cell the recurrence does 22 int32 operations (score 6,
// M 3, H 2, running max and argmax 3, E 4, F 4) and moves one 8-byte H/E
// word in and one out.  The function's own inputs and outputs are
// ~qlen+tlen+52 bytes a pair, so on the card it is bound by operations.
// This first design leaves two costs in the way.  The H/E traffic: 16
// bytes a cell, which stays in L1 and L2 only while a launch is small
// (cli/bsw.py launches 16,384 pairs: 20 MB of scratch); a launch of
// 262,144 pairs runs ~2.7x slower per pair.  And latency: a thread's cells
// form one dependent chain, and a warp runs until its slowest pair stops.
// The known remedies (a warp per pair with query positions on lanes, the
// F chain as a warp scan, H/E in shared memory or int16) are left for a
// later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAmbig = 4;
constexpr int kMaxThreads = 128;

struct Params {
  int o_del, e_del, o_ins, e_ins, zdrop, end_bonus, match, mismatch, ambig, w;
};

__device__ __forceinline__ int run_cap(int qlen, int match, int end_bonus, int o, int e) {
  // int((qlen*max_sc + end_bonus - o) / e + 1.0), max 1; max_sc = match
  const double q = __ddiv_rn(static_cast<double>(qlen * match + end_bonus - o),
                             static_cast<double>(e));
  return max(static_cast<int>(__dadd_rn(q, 1.0)), 1);
}

__global__ void __launch_bounds__(kMaxThreads)
bsw_extend_kernel(const int8_t* __restrict__ codes, const int64_t* __restrict__ q_off,
                  const int32_t* __restrict__ q_len, const int64_t* __restrict__ t_off,
                  const int32_t* __restrict__ t_len, const int32_t* __restrict__ h0s,
                  int2* __restrict__ scratch, int32_t* __restrict__ out, int batch, Params p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int qlen = q_len[b];
  const int tlen = t_len[b];
  const int h0 = h0s[b];
  const int8_t* __restrict__ query = codes + q_off[b];
  const int8_t* __restrict__ target = codes + t_off[b];
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = p.o_ins + p.e_ins;
  int2* __restrict__ eh = scratch + b;  // entry j at eh[j * stride]
  const size_t stride = static_cast<size_t>(batch);

  // first row (bandedSWA.cpp:158-162); entries past the chain are 0
  eh[0] = make_int2(h0, 0);
  int prev = h0 > oe_ins ? h0 - oe_ins : 0;
  if (qlen >= 1) eh[stride] = make_int2(prev, 0);
  bool chain = true;
  for (int j = 2; j <= qlen; ++j) {
    chain = chain && prev > p.e_ins;
    prev = chain ? prev - p.e_ins : 0;
    eh[j * stride] = make_int2(prev, 0);
  }

  // band clamp (bandedSWA.cpp:166-175)
  const int w = min(min(p.w, run_cap(qlen, p.match, p.end_bonus, p.o_ins, p.e_ins)),
                    run_cap(qlen, p.match, p.end_bonus, p.o_del, p.e_del));

  int max_score = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1, max_off = 0;
  int beg = 0, end = qlen;
  for (int i = 0; i < tlen; ++i) {
    int f = 0, m = 0, mj = -1;
    const int tc = target[i];
    const bool t_amb = tc >= kAmbig;
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    int h1 = 0;
    if (beg == 0) {
      h1 = h0 - (p.o_del + p.e_del * (i + 1));
      if (h1 < 0) h1 = 0;
    }
    int first_nz = end, last_nz = -1;  // of the entries written this row
    for (int j = beg; j < end; ++j) {
      // eh[j] holds {H(i-1,j-1), E(i,j)}; f = F(i,j); h1 = H(i,j-1)
      int2* cell = eh + j * stride;
      const int2 he = *cell;
      const int qc = query[j];
      const int sc = (t_amb || qc >= kAmbig) ? p.ambig : (qc == tc ? p.match : -p.mismatch);
      const int M = he.x ? he.x + sc : 0;
      int e = he.y;
      int h = M > e ? M : e;
      h = h > f ? h : f;
      int t = max(M - oe_del, 0);
      e = max(e - p.e_del, t);
      *cell = make_int2(h1, e);
      if (h1 != 0 || e != 0) {
        if (first_nz == end) first_nz = j;
        last_nz = j;
      }
      h1 = h;
      if (m <= h) {
        mj = j;
        m = h;
      }
      t = max(M - oe_ins, 0);
      f = max(f - p.e_ins, t);
    }
    eh[end * stride] = make_int2(h1, 0);
    if (h1 != 0) last_nz = end;
    if (end == qlen && gscore <= h1) {
      max_ie = i;
      gscore = h1;
    }
    if (m == 0) break;
    if (m > max_score) {
      max_score = m;
      max_i = i;
      max_j = mj;
      max_off = max(max_off, abs(mj - i));
    } else if (p.zdrop > 0) {
      if (i - max_i > mj - max_j) {
        if (max_score - m - ((i - max_i) - (mj - max_j)) * p.e_del > p.zdrop) break;
      } else {
        if (max_score - m - ((mj - max_j) - (i - max_i)) * p.e_ins > p.zdrop) break;
      }
    }
    // band shrink to the non-zero span of the row just written
    beg = first_nz;
    const int last = max(last_nz, beg - 1);
    end = last + 2 < qlen ? last + 2 : qlen;
  }

  out[b] = max_score;
  out[stride + b] = max_j + 1;
  out[2 * stride + b] = max_i + 1;
  out[3 * stride + b] = max_ie + 1;
  out[4 * stride + b] = gscore;
  out[5 * stride + b] = max_off;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// scratch: qe * batch int2, qe > every q_len; out: 6 * batch int32.
int bsw_extend(const int8_t* codes, const int64_t* q_off, const int32_t* q_len,
               const int64_t* t_off, const int32_t* t_len, const int32_t* h0, int2* scratch,
               int32_t* out, int batch, int o_del, int e_del, int o_ins, int e_ins, int zdrop,
               int end_bonus, int match, int mismatch, int ambig, int w, void* stream) {
  if (batch <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // small blocks while the batch is too small to give every SM two blocks
  int threads = kMaxThreads;
  while (threads > 32 && (batch + threads - 1) / threads < 2 * sms) threads /= 2;
  const int blocks = (batch + threads - 1) / threads;
  const Params p{o_del, e_del, o_ins, e_ins, zdrop, end_bonus, match, mismatch, ambig, w};
  bsw_extend_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      codes, q_off, q_len, t_off, t_len, h0, scratch, out, batch, p);
  return static_cast<int>(cudaGetLastError());
}

const char* bsw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
