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

template <int K, int L>
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
    const long long v = static_cast<long long>(h0) - oe_ins -
                        static_cast<long long>(j - 1) * p.e_ins;
    H[k] = j == 0 ? h0 : (j <= qlen ? static_cast<int>(v > 0 ? v : 0) : 0);
    E[k] = 0;
  }

  // band clamp (bandedSWA.cpp:166-175)
  const int w = min(min(p.w, run_cap(qlen, p.match, p.end_bonus, p.o_ins, p.e_ins)),
                    run_cap(qlen, p.match, p.end_bonus, p.o_del, p.e_del));

  int max_score = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1, max_off = 0;
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

    // M of every cell, and the lane's F map over its band cells
    int M[K];
    int fa = 0, fb = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + k;
      const int sc = qc[k] >= kAmbig ? p.ambig : (qc[k] == tc ? sc_eq : sc_ne);
      M[k] = H[k] ? H[k] + sc : 0;
      if (j >= rbeg && j < rend) {
        fb = max(fb - p.e_ins, max(M[k] - oe_ins, 0));
        fa = add_sat(fa, p.e_ins);
      }
    }
    // inclusive scan of the maps over the group's lanes, then F at the
    // lane's first entry: the b of all the maps before it
#pragma unroll
    for (int d = 1; d < L; d <<= 1) {
      const int pa = __shfl_up_sync(kFull, fa, d, L);
      const int pb = __shfl_up_sync(kFull, fb, d, L);
      if (r >= d) {
        fb = max(pb - fa, fb);
        fa = add_sat(pa, fa);
      }
    }
    int f = __shfl_up_sync(kFull, fb, 1, L);
    if (r == 0) f = 0;

    // H and the next E of every cell; the row max and its last argmax
    int hn[K], en[K];
    int lm = -1, lj = -1, h_last = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + k;
      hn[k] = max(max(M[k], E[k]), f);
      en[k] = max(E[k] - p.e_del, max(M[k] - oe_del, 0));
      if (j >= rbeg && j < rend) {
        f = max(f - p.e_ins, max(M[k] - oe_ins, 0));
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

    // the scalar end of the row (bandedSWA.cpp:215-246), alike on every lane
    const bool band = rend > rbeg;
    const int m = band ? m_all : 0;
    const int mj = band ? mj_all : -1;
    const int h1 = band ? h_end : h1_pre;
    beg = rbeg;
    end = rend;
    if (end == qlen && gscore <= h1) {
      max_ie = i;
      gscore = h1;
    }
    if (m == 0) {
      done = true;
      continue;
    }
    if (m > max_score) {
      max_score = m;
      max_i = i;
      max_j = mj;
      max_off = max(max_off, abs(mj - i));
    } else if (p.zdrop > 0) {
      if (i - max_i > mj - max_j) {
        if (max_score - m - ((i - max_i) - (mj - max_j)) * p.e_del > p.zdrop) done = true;
      } else {
        if (max_score - m - ((mj - max_j) - (i - max_i)) * p.e_ins > p.zdrop) done = true;
      }
      if (done) continue;
    }
    // band shrink to the non-zero span of the entries just written
    beg = any_f ? fnz_all : end;
    int last = any_l ? lnz_all : -1;
    if (h1 != 0) last = end;
    last = max(last, beg - 1);
    end = last + 2 < qlen ? last + 2 : qlen;
  }

  if (real && r == 0) {
    const size_t stride = static_cast<size_t>(batch);
    out[b] = max_score;
    out[stride + b] = max_j + 1;
    out[2 * stride + b] = max_i + 1;
    out[3 * stride + b] = max_ie + 1;
    out[4 * stride + b] = gscore;
    out[5 * stride + b] = max_off;
  }
}

}  // namespace

namespace {

template <int E, int L>
cudaError_t launch(const int8_t* codes, const int64_t* q_off, const int32_t* q_len,
                   const int64_t* t_off, const int32_t* t_len, const int32_t* h0, int32_t* out,
                   int batch, const Params& p, cudaStream_t stream) {
  static_assert(L == 8 || L == 16 || L == 32, "a group is 8, 16 or 32 lanes");
  static_assert(E % L == 0, "the edge splits evenly over the lanes");
  constexpr int G = 32 / L;
  const int64_t warps = (static_cast<int64_t>(batch) + G - 1) / G;
  const int64_t blocks = (warps * 32 + kThreads - 1) / kThreads;
  bsw_extend_kernel<E / L, L><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      codes, q_off, q_len, t_off, t_len, h0, out, batch, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// q_max: at least every q_len of the batch (the bucket's query edge or the
// longest query), at most 512; it picks the instance.  e_ins >= 0.
// out: 6 * batch int32.
int bsw_extend(const int8_t* codes, const int64_t* q_off, const int32_t* q_len,
               const int64_t* t_off, const int32_t* t_len, const int32_t* h0, int32_t* out,
               int batch, int q_max, int o_del, int e_del, int o_ins, int e_ins, int zdrop,
               int end_bonus, int match, int mismatch, int ambig, int w, void* stream) {
  if (batch <= 0) return 0;
  if (q_max > 512 || e_ins < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{o_del, e_del, o_ins, e_ins, zdrop, end_bonus, match, mismatch, ambig, w};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_max <= 32) {
    err = launch<32, BSW_LANES_32>(codes, q_off, q_len, t_off, t_len, h0, out, batch, p, s);
  } else if (q_max <= 64) {
    err = launch<64, BSW_LANES_64>(codes, q_off, q_len, t_off, t_len, h0, out, batch, p, s);
  } else if (q_max <= 128) {
    err = launch<128, BSW_LANES_128>(codes, q_off, q_len, t_off, t_len, h0, out, batch, p, s);
  } else if (q_max <= 256) {
    err = launch<256, BSW_LANES_256>(codes, q_off, q_len, t_off, t_len, h0, out, batch, p, s);
  } else {
    err = launch<512, BSW_LANES_512>(codes, q_off, q_len, t_off, t_len, h0, out, batch, p, s);
  }
  return static_cast<int>(err);
}

const char* bsw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
