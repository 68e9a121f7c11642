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
// branch of the oracle has its counterpart here: the band clamp
// (w = min(w0, max_ins, max_del), an IEEE double division truncated as C
// truncates), the first-row decay from h0, the M = 0 rule where
// H(i-1,j-1) == 0, the last argmax on ties (m <= h), the gscore check when
// the band reaches the query's end, the m == 0 break, the z-drop break and
// the band shrink to the non-zero span of the row just written.  All
// arithmetic is int32 but the band clamp, so the result is bit-equal to the
// oracle, the JAX scan and the plain PyTorch version.
//
// Design.  A group of L lanes (8, 16 or a whole warp of 32) takes one pair,
// and lane r owns the K = edge / L consecutive query entries j in
// [r*K, r*K + K) of the bucket's query edge (32-512).  Entry j holds
// {H(i-1, j-1), E(i, j)} in the lane's registers for the whole pair, so the
// H/E row never leaves the SM.  One target row is one step of the group:
//  - M and E of every cell depend only on the row above, so each lane
//    computes its K cells at once;
//  - F, the lazy insertion chain F(j+1) = max(F(j) - e_ins, c_j) with
//    c_j = max(M(j) - oe_ins, 0), is a chain of maps x -> max(x - a, b).
//    Two such maps compose to another, (a1, b1) then (a2, b2) giving
//    (a1 + a2, max(b1 - a2, b2)), so each lane folds its band cells into
//    one map, log2(L) shuffle rounds scan the maps across the lanes, and
//    each lane replays its K cells from the F its scan hands it.  Every
//    value the chain takes is >= 0 and e_ins >= 0, so b1 - a2 cannot wrap,
//    a saturating add keeps a1 + a2 exact where it matters (a1 + a2 above
//    INT32_MAX only ever meets b1 <= INT32_MAX, where b1 - a2 < 0 <= b2
//    either way), and the identity map is (0, 0).  The F it gives equals
//    the oracle's sequential chain for every int32 input;
//  - H(i, j-1), written into entry j, comes from the lane's own cell j-1
//    or, for its first entry, from lane r-1 by a shuffle;
//  - the row max is a warp reduction (__reduce_max_sync, or xor shuffles
//    inside a group of 8 or 16), its last argmax on ties the highest lane
//    of a ballot of the lanes that hold it, then that lane's last j; the
//    span of non-zero entries written (for the band shrink) is the lowest
//    and the highest lane of two ballots;
//  - gscore, the m == 0 break, z-drop and the band shrink are then the
//    same scalar code on every lane of the group, so nothing diverges.
// Lanes outside the band [beg, end) keep their entries: entries past `end`
// are read again when the band grows.  The first row is the closed form
// max(h0 - oe_ins - (j-1)*e_ins, 0) in 64 bits, which equals the oracle's
// decay loop when e_ins >= 0.  A group of 8 or 16 lanes runs until the
// slowest of the warp's 4 or 2 pairs stops; a warp a pair never waits.
// The kernel has one instance a query edge; the wrapper picks it from the
// longest query it is told of.  Targets are read 32 (L) rows at a time, one
// code a lane, and handed out by shuffles.  Queries and targets are read in
// place from the flat code buffer by their int64 offsets.
//
// Bound.  Per band cell the recurrence does 22 int32 operations (score 6,
// M 3, H 2, running max and argmax 3, E 4, F 4).  The function's own
// inputs and outputs are ~qlen+tlen+52 bytes a pair, so on the card it is
// bound by operations.  This design computes every cell of a lane's K
// entries on every row, in the band or not, and adds a fixed cost a row
// (the scan's log2(L) rounds, the reductions and ballots, the scalar
// bookkeeping), so its cost a row is K cells plus ~100 instructions a
// group, against the bound's band cells; narrow bands on a wide edge pay
// for the whole edge.
//
// Negative gap extension (e_ins < 0).  The map scan and the closed-form
// first row above need e_ins >= 0, and with e_ins < 0 the plain version
// (the JAX scan written in torch) is itself no longer the oracle's loop:
// its F is the prefix maximum max(0, max_{j'<j} (c_j' + j'*e_ins) -
// (j-1)*e_ins) (no term for the chain's zero start, which grows when
// e_ins < 0), its first row is max(h0 - oe_ins - (j-1)*e_ins, 0) written
// while the unclamped previous entry is > e_ins.  So each instance has a
// second variant, kPlainF, picked at launch when e_ins < 0, that computes
// those two closed forms as the plain version does, in int32 that wraps
// (uint32 arithmetic read back as int32), the out-of-band cells at NEG and
// an F with no contribution (prefix <= NEG / 2) at 0: a max-scan over the
// lanes in place of the map scan.  The e_ins >= 0 code is unchanged.
//
// Long queries (q_max > 512).  bsw_extend_long_kernel: a warp a pair, the
// H/E row in a per-warp store of shared memory (a block of one warp, the
// row's (q_max + 1) entries rounded up to whole chunks of kChunk = 512) or,
// when that passes the 227 KB a block can have, of a global scratch the
// wrapper allocates, one slot a warp of a grid that strides over the pairs.
// A target row visits only the chunks that hold band entries [rbeg, rend)
// or the entry rend it writes after them (with the default w of 100 a band
// is at most 201 entries: one or two chunks).  In a chunk, lane r holds
// entries c0 + rK .. c0 + rK + K - 1 (K = 16) in registers as the 512
// instance does, loaded from and stored back to the store (entry k of lane
// r at slot c0 + 32k + r: conflict-free and coalesced; every slot is read
// and written by the one lane that owns it, so the store needs no barrier).
// Two scalars cross a chunk boundary: the F prefix maximum and H(i, j-1)
// of the chunk's first entry.  The row max and its last argmax on ties
// (a later chunk wins a tie), H(i, rend-1) and the first and last non-zero
// entries fold over the chunks in order.  It computes F and the first row
// in the plain version's closed forms (above) for every e_ins, so it equals
// the plain version bit for bit, wrap included.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

// Lanes a pair for each query edge (K = edge / lanes entries a lane) come
// from the build, -DBSW_LANES_<edge>=L: ops/bsw_cuda.py's LANES table,
// measured on the card by tools/bsw_lanes.py.

namespace {

constexpr int kAmbig = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kNeg = -(1 << 20);  // ops/bsw.NEG: an out-of-band cell of the F prefix
constexpr int kChunkK = 16;  // entries a lane of a long-query chunk
constexpr int kChunk = 32 * kChunkK;  // entries a chunk

struct Params {
  int o_del, e_del, o_ins, e_ins, zdrop, end_bonus, match, mismatch, ambig, w;
};

__device__ __forceinline__ int run_cap(int qlen, int match, int end_bonus, int o, int e) {
  // int((qlen*max_sc + end_bonus - o) / e + 1.0), max 1; max_sc = match
  const double q = __ddiv_rn(static_cast<double>(qlen * match + end_bonus - o),
                             static_cast<double>(e));
  return max(static_cast<int>(__dadd_rn(q, 1.0)), 1);
}

// a + b for a, b >= 0, saturated at INT32_MAX
__device__ __forceinline__ int add_sat(int a, int b) {
  return a > INT_MAX - b ? INT_MAX : a + b;
}

// int32 arithmetic that wraps, as the plain version's int32 tensors do
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// entry j of the plain version's first row (ops/bsw.first_row)
__device__ __forceinline__ int plain_first_row(int h0, int j, int qlen, int oe_ins, int e_ins) {
  if (j == 0) return h0;
  const int top = wsub(h0, oe_ins);
  if (j == 1) return max(top, 0);
  const int prev = wsub(top, wmul(j - 2, e_ins));
  return prev > e_ins && j <= qlen ? max(wsub(prev, e_ins), 0) : 0;
}

// the plain version's F from the prefix maximum of c + j*e_ins before the
// cell (kNeg when no band cell precedes it); jm1e = (j-1)*e_ins
__device__ __forceinline__ int plain_f(int run, int jm1e) {
  return run <= kNeg / 2 ? 0 : max(wsub(run, jm1e), 0);
}

// max over the L lanes of the calling lane's group
template <int L>
__device__ __forceinline__ int group_max(int v) {
  if constexpr (L == 32) {
    return __reduce_max_sync(kFull, v);
  } else {
#pragma unroll
    for (int d = L / 2; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(kFull, v, d, L));
    return v;
  }
}

struct Scores {
  int max_score, max_i, max_j, max_ie, gscore, max_off;
};

// The scalar end of target row i (bandedSWA.cpp:215-246): the band was
// [rbeg, rend), m its row max (0 for an empty band), mj its last argmax,
// h1 = H(i, rend-1) (h1_pre for an empty band), fnz and lnz the first and
// last entries written non-zero (INT_MAX and -1 for none).  Returns true
// when the pair stops here; else [beg, end) is the next row's band.
__device__ __forceinline__ bool end_row(Scores& s, int& beg, int& end, int i, int rbeg, int rend,
                                        int m, int mj, int h1, int fnz, int lnz, int qlen,
                                        const Params& p) {
  beg = rbeg;
  end = rend;
  if (end == qlen && s.gscore <= h1) {
    s.max_ie = i;
    s.gscore = h1;
  }
  if (m == 0) return true;
  if (m > s.max_score) {
    s.max_score = m;
    s.max_i = i;
    s.max_j = mj;
    s.max_off = max(s.max_off, abs(mj - i));
  } else if (p.zdrop > 0) {
    if (i - s.max_i > mj - s.max_j) {
      if (s.max_score - m - ((i - s.max_i) - (mj - s.max_j)) * p.e_del > p.zdrop) return true;
    } else {
      if (s.max_score - m - ((mj - s.max_j) - (i - s.max_i)) * p.e_ins > p.zdrop) return true;
    }
  }
  // band shrink to the non-zero span of the entries just written
  beg = min(fnz, end);
  int last = lnz;
  if (h1 != 0) last = end;
  last = max(last, beg - 1);
  end = last + 2 < qlen ? last + 2 : qlen;
  return false;
}

__device__ __forceinline__ void store_scores(int32_t* out, int64_t b, int batch, const Scores& s) {
  const size_t stride = static_cast<size_t>(batch);
  out[b] = s.max_score;
  out[stride + b] = s.max_j + 1;
  out[2 * stride + b] = s.max_i + 1;
  out[3 * stride + b] = s.max_ie + 1;
  out[4 * stride + b] = s.gscore;
  out[5 * stride + b] = s.max_off;
}

template <int K, int L, bool kPlainF>
__global__ void __launch_bounds__(kThreads)
bsw_extend_kernel(const int8_t* __restrict__ codes, const int64_t* __restrict__ q_off,
                  const int32_t* __restrict__ q_len, const int64_t* __restrict__ t_off,
                  const int32_t* __restrict__ t_len, const int32_t* __restrict__ h0s,
                  int32_t* __restrict__ out, int batch, Params p) {
  constexpr int G = 32 / L;  // pairs a warp
  const int lane = threadIdx.x & 31;
  const int r = lane & (L - 1);  // lane within the pair's group
  const int shift = lane & ~(L - 1);  // the group's first lane in the warp
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (warp * G >= batch) return;  // the whole warp: no pair of it exists
  const int64_t b = warp * G + lane / L;
  const bool real = b < batch;
  const int qlen = real ? q_len[b] : 0;
  const int tlen = real ? t_len[b] : 0;
  const int h0 = real ? h0s[b] : 0;
  const int8_t* __restrict__ query = codes + (real ? q_off[b] : 0);
  const int8_t* __restrict__ target = codes + (real ? t_off[b] : 0);
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = p.o_ins + p.e_ins;
  const int j0 = r * K;  // this lane's first entry

  // the query's codes and the first row (bandedSWA.cpp:158-162): eh[0] =
  // {h0, 0}, eh[j] = {max(h0 - oe_ins - (j-1)*e_ins, 0), 0} for j <= qlen
  int qc[K], H[K], E[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    qc[k] = j < qlen ? query[j] : kAmbig;
    if constexpr (kPlainF) {
      H[k] = plain_first_row(h0, j, qlen, oe_ins, p.e_ins);
    } else {
      const long long v = static_cast<long long>(h0) - oe_ins -
                          static_cast<long long>(j - 1) * p.e_ins;
      H[k] = j == 0 ? h0 : (j <= qlen ? static_cast<int>(v > 0 ? v : 0) : 0);
    }
    E[k] = 0;
  }

  // band clamp (bandedSWA.cpp:166-175)
  const int w = min(min(p.w, run_cap(qlen, p.match, p.end_bonus, p.o_ins, p.e_ins)),
                    run_cap(qlen, p.match, p.end_bonus, p.o_del, p.e_del));

  Scores sc{h0, -1, -1, -1, -1, 0};
  int beg = 0, end = qlen;
  bool done = !real;
  int tcodes = kAmbig;
  for (int i = 0;; ++i) {
    const bool live = !done && i < tlen;
    if (!__any_sync(kFull, live)) break;
    if ((i & (L - 1)) == 0) tcodes = live && i + r < tlen ? target[i + r] : kAmbig;
    const int tc = __shfl_sync(kFull, tcodes, i & (L - 1), L);
    const int sc_eq = tc >= kAmbig ? p.ambig : p.match;
    const int sc_ne = tc >= kAmbig ? p.ambig : -p.mismatch;

    // band at row start (bandedSWA.cpp:180-183)
    const int rbeg = max(beg, i - w);
    const int rend = min(min(end, i + w + 1), qlen);
    const int h1_pre = rbeg == 0 ? max(h0 - (p.o_del + p.e_del * (i + 1)), 0) : 0;

    // M of every cell, and the lane's F map over its band cells (kPlainF:
    // the lane's maximum of c + j*e_ins over them)
    int M[K];
    int fa = 0, fb = kPlainF ? kNeg : 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + k;
      const int sc = qc[k] >= kAmbig ? p.ambig : (qc[k] == tc ? sc_eq : sc_ne);
      M[k] = H[k] ? H[k] + sc : 0;
      if (j >= rbeg && j < rend) {
        if constexpr (kPlainF) {
          fb = max(fb, wadd(max(wsub(M[k], oe_ins), 0), wmul(j, p.e_ins)));
        } else {
          fb = max(fb - p.e_ins, max(M[k] - oe_ins, 0));
          fa = add_sat(fa, p.e_ins);
        }
      }
    }
    // inclusive scan of the maps over the group's lanes, then F at the
    // lane's first entry: the b of all the maps before it (kPlainF: the
    // prefix maximum before the lane's first entry)
#pragma unroll
    for (int d = 1; d < L; d <<= 1) {
      if constexpr (kPlainF) {
        const int pb = __shfl_up_sync(kFull, fb, d, L);
        if (r >= d) fb = max(pb, fb);
      } else {
        const int pa = __shfl_up_sync(kFull, fa, d, L);
        const int pb = __shfl_up_sync(kFull, fb, d, L);
        if (r >= d) {
          fb = max(pb - fa, fb);
          fa = add_sat(pa, fa);
        }
      }
    }
    int f = __shfl_up_sync(kFull, fb, 1, L);
    if (r == 0) f = kPlainF ? kNeg : 0;

    // H and the next E of every cell; the row max and its last argmax
    int hn[K], en[K];
    int lm = -1, lj = -1, h_last = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + k;
      hn[k] = max(max(M[k], E[k]), kPlainF ? plain_f(f, wmul(j - 1, p.e_ins)) : f);
      en[k] = max(E[k] - p.e_del, max(M[k] - oe_del, 0));
      if (j >= rbeg && j < rend) {
        if constexpr (kPlainF) {
          f = max(f, wadd(max(wsub(M[k], oe_ins), 0), wmul(j, p.e_ins)));
        } else {
          f = max(f - p.e_ins, max(M[k] - oe_ins, 0));
        }
        if (lm <= hn[k]) {
          lm = hn[k];
          lj = j;
        }
      }
      if (j == rend - 1) h_last = hn[k];
    }

    // write back: entry j gets {H(i, j-1), E(i+1, j)} over the band,
    // {H(i, end-1), 0} at j == end; the span of non-zero band entries
    const int h_before = __shfl_up_sync(kFull, hn[K - 1], 1, L);
    int fnz = INT_MAX, lnz = -1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + k;
      const int hprev = j == rbeg ? h1_pre : (k == 0 ? h_before : hn[k - 1]);
      // (a group that is not live stops here, so its entries may change)
      if (j >= rbeg && j < rend) {
        if (hprev != 0 || en[k] != 0) {
          fnz = min(fnz, j);
          lnz = j;
        }
        H[k] = hprev;
        E[k] = en[k];
      } else if (j == rend && rend >= rbeg) {
        H[k] = hprev;
        E[k] = 0;
      }
    }

    // the group's row max m, its last argmax mj, H(i, end-1), the span
    const unsigned gbits = L == 32 ? kFull : ((1u << L) - 1) << shift;
    const int m_all = group_max<L>(lm);
    const unsigned at_max = (__ballot_sync(kFull, lm >= 0 && lm == m_all) & gbits) >> shift;
    const int mj_all = __shfl_sync(kFull, lj, at_max ? 31 - __clz(at_max) : 0, L);
    const int h_end = __shfl_sync(kFull, h_last, max(rend - 1, 0) / K, L);
    const unsigned any_f = (__ballot_sync(kFull, fnz != INT_MAX) & gbits) >> shift;
    const int fnz_all = __shfl_sync(kFull, fnz, any_f ? __ffs(any_f) - 1 : 0, L);
    const unsigned any_l = (__ballot_sync(kFull, lnz >= 0) & gbits) >> shift;
    const int lnz_all = __shfl_sync(kFull, lnz, any_l ? 31 - __clz(any_l) : 0, L);
    if (!live) {
      done = true;
      continue;
    }

    // the scalar end of the row, alike on every lane
    const bool band = rend > rbeg;
    done = end_row(sc, beg, end, i, rbeg, rend, band ? m_all : 0, band ? mj_all : -1,
                   band ? h_end : h1_pre, any_f ? fnz_all : INT_MAX, any_l ? lnz_all : -1,
                   qlen, p);
  }

  if (real && r == 0) store_scores(out, b, batch, sc);
}

// Queries past the widest instance: a warp a pair (blocks of one warp), the
// H/E row in `store` (see the note at the top): slot c0 + 32k + lane holds
// entry c0 + lane*K + k, H in the first `stride` ints of the warp's region,
// E in the next.  scratch == nullptr: the region is the block's dynamic
// shared memory; else warp w's region of scratch, the grid striding over
// the pairs.
template <int K>
__global__ void __launch_bounds__(32)
bsw_extend_long_kernel(const int8_t* __restrict__ codes, const int64_t* __restrict__ q_off,
                       const int32_t* __restrict__ q_len, const int64_t* __restrict__ t_off,
                       const int32_t* __restrict__ t_len, const int32_t* __restrict__ h0s,
                       int32_t* __restrict__ out, int batch, Params p, int stride,
                       int32_t* __restrict__ scratch) {
  constexpr int C = 32 * K;
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  int32_t* __restrict__ hs =
      scratch ? scratch + 2 * static_cast<int64_t>(stride) * blockIdx.x : smem;
  int32_t* __restrict__ es = hs + stride;
  const int oe_del = p.o_del + p.e_del;
  const int oe_ins = wadd(p.o_ins, p.e_ins);
  for (int64_t b = blockIdx.x; b < batch; b += gridDim.x) {
    const int qlen = q_len[b];
    const int tlen = t_len[b];
    const int h0 = h0s[b];
    const int8_t* __restrict__ query = codes + q_off[b];
    const int8_t* __restrict__ target = codes + t_off[b];
    // the first row over the chunks that hold entries 0..qlen
    for (int c0 = 0; c0 <= qlen; c0 += C) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        hs[c0 + 32 * k + lane] = plain_first_row(h0, c0 + lane * K + k, qlen, oe_ins, p.e_ins);
        es[c0 + 32 * k + lane] = 0;
      }
    }
    const int wb = min(min(p.w, run_cap(qlen, p.match, p.end_bonus, p.o_ins, p.e_ins)),
                       run_cap(qlen, p.match, p.end_bonus, p.o_del, p.e_del));

    Scores sc{h0, -1, -1, -1, -1, 0};
    int beg = 0, end = qlen;
    int tcodes = kAmbig;
    for (int i = 0; i < tlen; ++i) {
      if ((i & 31) == 0) tcodes = i + lane < tlen ? target[i + lane] : kAmbig;
      const int tc = __shfl_sync(kFull, tcodes, i & 31);
      const int sc_eq = tc >= kAmbig ? p.ambig : p.match;
      const int sc_ne = tc >= kAmbig ? p.ambig : -p.mismatch;
      const int rbeg = max(beg, i - wb);
      const int rend = min(min(end, i + wb + 1), qlen);
      const int h1_pre = rbeg == 0 ? max(h0 - (p.o_del + p.e_del * (i + 1)), 0) : 0;

      // what crosses a chunk boundary, and what the row folds over its chunks
      int run_in = kNeg;  // the F prefix maximum before the chunk
      int h_in = 0;  // H(i, c0 - 1)
      int m_row = -1, mj_row = -1, h_end = 0, fnz_row = INT_MAX, lnz_row = -1;
      // the chunks of band entries [rbeg, rend) and of the entry rend
      const int last = rend >= rbeg ? rend : -1;
      for (int c0 = rbeg / C * C; c0 <= last; c0 += C) {
        const int j0 = c0 + lane * K;
        int qc[K], H[K], E[K], M[K];
        int gl = kNeg;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = j0 + k;
          qc[k] = j < qlen ? query[j] : kAmbig;
          H[k] = hs[c0 + 32 * k + lane];
          E[k] = es[c0 + 32 * k + lane];
          const int s = qc[k] >= kAmbig ? p.ambig : (qc[k] == tc ? sc_eq : sc_ne);
          M[k] = H[k] ? H[k] + s : 0;
          if (j >= rbeg && j < rend) {
            gl = max(gl, wadd(max(wsub(M[k], oe_ins), 0), wmul(j, p.e_ins)));
          }
        }
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(kFull, gl, d);
          if (lane >= d) gl = max(gl, v);
        }
        int run = __shfl_up_sync(kFull, gl, 1);
        run = lane == 0 ? run_in : max(run, run_in);
        run_in = max(run_in, __shfl_sync(kFull, gl, 31));

        int hn[K], en[K];
        int lm = -1, lj = -1, h_last = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = j0 + k;
          hn[k] = max(max(M[k], E[k]), plain_f(run, wmul(j - 1, p.e_ins)));
          en[k] = max(E[k] - p.e_del, max(M[k] - oe_del, 0));
          if (j >= rbeg && j < rend) {
            run = max(run, wadd(max(wsub(M[k], oe_ins), 0), wmul(j, p.e_ins)));
            if (lm <= hn[k]) {
              lm = hn[k];
              lj = j;
            }
          }
          if (j == rend - 1) h_last = hn[k];
        }
        int h_before = __shfl_up_sync(kFull, hn[K - 1], 1);
        if (lane == 0) h_before = h_in;
        h_in = __shfl_sync(kFull, hn[K - 1], 31);
        int fnz = INT_MAX, lnz = -1;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = j0 + k;
          const int hprev = j == rbeg ? h1_pre : (k == 0 ? h_before : hn[k - 1]);
          if (j >= rbeg && j < rend) {
            if (hprev != 0 || en[k] != 0) {
              fnz = min(fnz, j);
              lnz = j;
            }
            hs[c0 + 32 * k + lane] = hprev;
            es[c0 + 32 * k + lane] = en[k];
          } else if (j == rend) {
            hs[c0 + 32 * k + lane] = hprev;
            es[c0 + 32 * k + lane] = 0;
          }
        }

        // fold the chunk into the row: a later chunk wins a tie of the max
        const int m_c = __reduce_max_sync(kFull, lm);
        if (m_c >= 0 && m_c >= m_row) {
          const unsigned at_max = __ballot_sync(kFull, lm == m_c);
          m_row = m_c;
          mj_row = __shfl_sync(kFull, lj, 31 - __clz(at_max));
        }
        if (rend - 1 >= c0 && rend - 1 < c0 + C) {
          h_end = __shfl_sync(kFull, h_last, (rend - 1 - c0) / K);
        }
        const unsigned any_f = __ballot_sync(kFull, fnz != INT_MAX);
        if (any_f && fnz_row == INT_MAX) fnz_row = __shfl_sync(kFull, fnz, __ffs(any_f) - 1);
        const unsigned any_l = __ballot_sync(kFull, lnz >= 0);
        if (any_l) lnz_row = __shfl_sync(kFull, lnz, 31 - __clz(any_l));
      }

      const bool band = rend > rbeg;
      if (end_row(sc, beg, end, i, rbeg, rend, band ? m_row : 0, band ? mj_row : -1,
                  band ? h_end : h1_pre, fnz_row, lnz_row, qlen, p)) {
        break;
      }
    }
    if (lane == 0) store_scores(out, b, batch, sc);
  }
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// The register instance for q_max <= 512, the first edge at or above it:
// run(edge, lanes) as Int constants.  The launch below and the CPU
// emulation (tests/cuda_emulation/run_kernels.cpp) both dispatch through it.
template <class Run>
auto with_instance(int q_max, Run&& run) {
  if (q_max <= 32) return run(Int<32>{}, Int<BSW_LANES_32>{});
  if (q_max <= 64) return run(Int<64>{}, Int<BSW_LANES_64>{});
  if (q_max <= 128) return run(Int<128>{}, Int<BSW_LANES_128>{});
  if (q_max <= 256) return run(Int<256>{}, Int<BSW_LANES_256>{});
  return run(Int<512>{}, Int<BSW_LANES_512>{});
}

// entries of a long query's store a warp, H or E: q_max + 1 in whole chunks
inline int long_stride(int q_max) { return (q_max + kChunk) / kChunk * kChunk; }

}  // namespace

namespace {

template <int E, int L, bool kPlainF>
cudaError_t launch(const int8_t* codes, const int64_t* q_off, const int32_t* q_len,
                   const int64_t* t_off, const int32_t* t_len, const int32_t* h0, int32_t* out,
                   int batch, const Params& p, cudaStream_t stream) {
  static_assert(L == 8 || L == 16 || L == 32, "a group is 8, 16 or 32 lanes");
  static_assert(E % L == 0, "the edge splits evenly over the lanes");
  constexpr int G = 32 / L;
  const int64_t warps = (static_cast<int64_t>(batch) + G - 1) / G;
  const int64_t blocks = (warps * 32 + kThreads - 1) / kThreads;
  bsw_extend_kernel<E / L, L, kPlainF><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      codes, q_off, q_len, t_off, t_len, h0, out, batch, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// q_max: at least every q_len of the batch (the bucket's query edge or the
// longest query); up to 512 it picks the register instance, above it the
// long-query kernel.  That one keeps a pair's rows in the block's shared
// memory (2 * long_stride(q_max) int32) when scratch is null, else in
// `scratch`: scratch_warps regions of that size, one a warp of the grid.
// The caller passes scratch where the shared memory would pass the 227 KB
// a block may have.  out: 6 * batch int32.
int bsw_extend(const int8_t* codes, const int64_t* q_off, const int32_t* q_len,
               const int64_t* t_off, const int32_t* t_len, const int32_t* h0, int32_t* out,
               int batch, int q_max, int o_del, int e_del, int o_ins, int e_ins, int zdrop,
               int end_bonus, int match, int mismatch, int ambig, int w, int32_t* scratch,
               int scratch_warps, void* stream) {
  if (batch <= 0) return 0;
  const Params p{o_del, e_del, o_ins, e_ins, zdrop, end_bonus, match, mismatch, ambig, w};
  const auto s = static_cast<cudaStream_t>(stream);
  if (q_max > 512) {
    const int stride = long_stride(q_max);
    if (scratch != nullptr) {
      if (scratch_warps <= 0) return static_cast<int>(cudaErrorInvalidValue);
      const int grid = scratch_warps < batch ? scratch_warps : batch;
      bsw_extend_long_kernel<kChunkK><<<static_cast<unsigned>(grid), 32, 0, s>>>(
          codes, q_off, q_len, t_off, t_len, h0, out, batch, p, stride, scratch);
      return static_cast<int>(cudaGetLastError());
    }
    const int bytes = 2 * stride * static_cast<int>(sizeof(int32_t));
    cudaError_t err = cudaFuncSetAttribute(bsw_extend_long_kernel<kChunkK>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    bsw_extend_long_kernel<kChunkK><<<static_cast<unsigned>(batch), 32, bytes, s>>>(
        codes, q_off, q_len, t_off, t_len, h0, out, batch, p, stride, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(with_instance(q_max, [&](auto edge, auto lanes) {
    constexpr int E = decltype(edge)::value, L = decltype(lanes)::value;
    return e_ins < 0 ? launch<E, L, true>(codes, q_off, q_len, t_off, t_len, h0, out, batch, p, s)
                     : launch<E, L, false>(codes, q_off, q_len, t_off, t_len, h0, out, batch, p, s);
  }));
}

const char* bsw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
