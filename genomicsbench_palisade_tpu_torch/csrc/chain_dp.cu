// minimap2 anchor-chaining DP (mm_chain_dp, n_segs == 1) over a flat batch
// of independent calls.
//
// Replaces genomicsbench_palisade_tpu/ops/chain_pallas.py:_kernel (the
// TPU's layout: 128 calls on lanes, the predecessor window on sublanes, the
// descending visit order as log2(w) roll rounds of suffix scans, the
// max_skip marks as an OR-reduced bitmask, the gap cost as a fixed-point
// slope, and a w-row ring carry between grid steps).
//
// What it computes, per anchor i of each call: the int32 score, parent
// (call-local, -1 for none) and peak of the reference's loop
// (benchmarks/chain/src/host_kernel.cpp:405-472; ops/oracle/chain.py),
// written to rows 0, 1, 2 of `out` [3, n_total] at the call's offset: the
// `continue` tests (dr == 0, dq <= 0, dq > max_dist_y, dq > max_dist_x,
// dd > bw); sc = min(dq, dr, qspan_i) - gap[dd] + scores[j]; the strict
// improvement that takes one off n_skip (floored at 0); the targets[j] == i
// skip count and the n_skip > MAX_SKIP break, before the mark; the
// targets[parents[j]] = i mark; then the anchor's score, parent and peak.
// The host precomputes what is exact there (ops/chain.py prepare_call): the
// window start st_eff[i] (call-local, >= i - MAX_ITER), the low 32 bits of
// x, whose u32 difference is exact inside the window (dr <= max_dist_x),
// and each call's float64-exact gap table over dd in [0, bw].  All
// arithmetic is int32 (dq in two's-complement wrap, as the JAX scan), so
// the result is bit-equal to the oracle, the JAX scan and the plain
// PyTorch version.
//
// A call may start past a preset head (`first`, per call; null for none):
// rows [0, first) of `out` hold its anchors' results already and are read,
// not recomputed.  This is how a shard of one call runs in the sharded
// runtime: the previous shard's last w anchors, then its own.  The register
// banks then start from the preset rows first-1 .. first-96, and the peak
// chain from row first-1.
//
// Design.  A warp takes one call (a block of one warp each, launched in
// order of call length, longest first): the anchors of a call form one
// dependent chain, and calls are independent.  For anchor i the warp visits
// the window 32 predecessors a step, lane k taking j = i-1-32s-k in step s,
// which is the reference's descending order lane by lane:
//  - each lane applies the `continue` tests and scores its j (the gap table
//    sits in shared memory);
//  - the strict improvements are the lanes whose sc beats both the carried
//    max_f and every earlier lane's sc: one ballot when at most one lane
//    beats max_f, else an exclusive prefix max (5 shuffle rounds); ties
//    keep the earlier visit;
//  - targets[j] == i holds only if a visit of this anchor's loop marked j,
//    so the kernel keeps no targets array: it keeps the anchor's marks as a
//    bitmap of offsets i-1-p in shared memory (MAX_ITER bits; st_eff >= i -
//    MAX_ITER bounds every offset that is read).  A mark always lands below
//    the j that makes it, so a step's marks for its own lanes reach only
//    later lanes of the step: they are OR-reduced across the warp
//    (__reduce_or_sync) and used at once; marks for later steps go to the
//    bitmap by shared atomics, ordered before the next step's read by
//    __syncwarp.  Marks from lanes past a break are made too: they land
//    below every visit made before the break, and the bitmap is cleared
//    when the anchor ends, so they change nothing;
//  - the max_skip walk, c_k = max(c_{k-1} + d_k, 0) with d = +1 for a skip
//    and -1 for an improvement, is c_k = S_k - min(-n_skip, min_{m<=k} S_m)
//    over the prefix sums S (two popcounts of ballots a lane); without a
//    skip it is max(n_skip - improvements, 0); with at most one
//    improvement S falls at one lane only, so its running min is S_0 or
//    min(S_0, S_m), again popcounts; only a step with two improvements or
//    more reduces (__reduce_min_sync) or, when it may break, scans the
//    prefix min; the break is the first skip lane with c > MAX_SKIP;
//  - the new max_f and max_j are the last improvement before the break.
// The 96 nearest predecessors' x, q, score and parent stay in registers
// (kBanks = 3 banks of 32, a lane each), and shift by one predecessor an
// anchor (a rotation by one lane a bank; lane 0 takes the last lane of the
// bank before), so the first three steps load nothing; each later step's
// are loaded from global memory a step ahead.  The peak, the one value
// that reads back (peaks[max_j]), is finished an anchor late, so its load
// is off the chain.
//
// Bound.  Each visited predecessor costs at least 5 int32 operations (loop
// test and step, the two differences, the dr == 0 test) and each one that
// passes the skip tests 16 more (four tests, |dr - dq|, two mins, the gap
// subtract, the score add, the compare with max_f, the update of max_f,
// max_j and n_skip or the skip count and break test, the parent test);
// address arithmetic is not counted.  The bytes are 16 in and 12 out an
// anchor plus 4(bw+1) of gap table a call, so on the card's rates the
// function is bound by operations.  This kernel is bound by neither: a
// call's anchors stay one dependent chain, each step's shuffles, ballots
// and shared-memory round trips a few hundred cycles of latency, and only
// as many warps are live as there are calls (~1000); the longest call
// (87,271 anchors on the reference's data) sets the launch's time.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSkip = 25;
constexpr int kMaxIter = 5000;  // ops/chain.MAX_ITER: the longest window
constexpr int kMarkWords = kMaxIter / 32 + 1;  // a bit an offset in [0, kMaxIter)
constexpr int kBanks = 3;  // steps whose predecessors stay in registers
constexpr unsigned kFull = 0xffffffffu;

// one predecessor j as a lane holds it
struct Pred {
  uint32_t x, q;
  int score, parent;
};

// the state of anchor i's walk over its window
struct Walk {
  int max_f, max_j, n_skip;
};

// Step s of anchor i's walk: lane k visits j = i-1-32s-k (held in p).
// Returns true at the max_skip break.
__device__ __forceinline__ bool visit_step(const Pred& p, int s, int i, int win, uint32_t x_i,
                                           uint32_t q_i, int span_i, const int32_t* gap,
                                           unsigned* marks, int max_dist_x, int max_dist_y,
                                           int bw, int lane, unsigned upto_me, Walk& w) {
  const int first = 32 * s;  // lane 0's offset i-1-j
  const bool in_win = first + lane < win;
  const unsigned marked_before = s > 0 && s < kMarkWords ? marks[s] : 0u;

  const int dr = static_cast<int>(x_i - p.x);
  const int dq = static_cast<int>(q_i - p.q);
  bool pass = in_win && dr != 0 && dq > 0 && dq <= max_dist_y && dq <= max_dist_x;
  const int dd = static_cast<int>(dr > dq ? static_cast<uint32_t>(dr) - static_cast<uint32_t>(dq)
                                          : static_cast<uint32_t>(dq) - static_cast<uint32_t>(dr));
  pass = pass && dd <= bw;
  const int sc = pass ? min(min(dq, dr), span_i) - gap[pass ? dd : 0] + p.score : INT_MIN;

  // marks: targets[parent] = i, at the parent's offset t > first + lane
  const int t = (i - 1) - p.parent;
  const bool mark = pass && p.parent >= 0;
  const bool in_step = mark && t < first + 32;
  const unsigned marked_now = __reduce_or_sync(kFull, in_step ? 1u << (t - first) : 0u);
  if (mark && !in_step && t < win && t < 32 * kMarkWords) {
    atomicOr(&marks[t >> 5], 1u << (t & 31));
  }
  const bool marked = ((marked_before | marked_now) >> lane) & 1u;

  // strict improvements, in visit order
  const unsigned beats = __ballot_sync(kFull, sc > w.max_f);
  unsigned improve = beats;
  if (__popc(beats) > 1) {
    int run = sc;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, run, d);
      if (lane >= d) run = max(run, v);
    }
    int before = __shfl_up_sync(kFull, run, 1);
    if (lane == 0) before = INT_MIN;
    improve = __ballot_sync(kFull, sc > max(w.max_f, before));
  }
  const unsigned skip = __ballot_sync(kFull, pass && marked && !((improve >> lane) & 1u));

  // the max_skip walk and its break
  int brk = 32;
  const int n_improve = __popc(improve);
  if (skip == 0) {
    w.n_skip = max(w.n_skip - n_improve, 0);
  } else if (n_improve <= 1) {
    // S falls only at the improvement's lane m, so its running min is S_0
    // before m and min(S_0, S_m) from m on: no reduction needed
    const int m = n_improve ? __ffs(improve) - 1 : 32;
    const int s_0 = static_cast<int>(skip & 1u) - static_cast<int>(improve & 1u);
    const int s_m = n_improve ? __popc(skip & ((2u << m) - 1)) - 1 : s_0;
    const int walk = __popc(skip & upto_me) - __popc(improve & upto_me);
    const int count = walk - min(-w.n_skip, lane >= m ? min(s_0, s_m) : s_0);
    const int over = w.n_skip + __popc(skip) > kMaxSkip
                         ? __ballot_sync(kFull, ((skip >> lane) & 1u) && count > kMaxSkip)
                         : 0;
    if (over) {
      brk = __ffs(over) - 1;
    } else {
      w.n_skip = __popc(skip) - n_improve - min(-w.n_skip, min(s_0, s_m));
    }
  } else {
    const int walk = __popc(skip & upto_me) - __popc(improve & upto_me);
    const int walk_end = __popc(skip) - n_improve;
    if (w.n_skip + __popc(skip) <= kMaxSkip) {
      w.n_skip = walk_end - min(-w.n_skip, __reduce_min_sync(kFull, walk));
    } else {
      int low = walk;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, low, d);
        if (lane >= d) low = min(low, v);
      }
      const int count = walk - min(-w.n_skip, low);
      const unsigned over = __ballot_sync(kFull, ((skip >> lane) & 1u) && count > kMaxSkip);
      if (over) {
        brk = __ffs(over) - 1;
      } else {
        w.n_skip = walk_end - min(-w.n_skip, __shfl_sync(kFull, low, 31));
      }
    }
  }
  const unsigned taken = brk < 32 ? improve & ((1u << brk) - 1) : improve;
  if (taken) {
    const int last = 31 - __clz(taken);
    w.max_f = __shfl_sync(kFull, sc, last);
    w.max_j = i - 1 - first - last;
  }
  __syncwarp();  // this step's marks before the next step reads them
  return brk < 32;
}

__global__ void __launch_bounds__(32)
chain_dp_kernel(const int32_t* __restrict__ x_lo, const int32_t* __restrict__ qi,
                const int32_t* __restrict__ qspan, const int32_t* __restrict__ st_eff,
                const int64_t* __restrict__ off, const int32_t* __restrict__ n_anchors,
                const int32_t* __restrict__ gap_table, const int32_t* __restrict__ first,
                const int32_t* __restrict__ order, int32_t* __restrict__ out, int64_t n_total,
                int max_dist_x, int max_dist_y, int bw) {
  extern __shared__ int32_t smem[];
  int32_t* gap = smem;  // bw + 1 entries
  unsigned* marks = reinterpret_cast<unsigned*>(smem + bw + 1);  // kMarkWords
  const int lane = threadIdx.x;
  const int c = order[blockIdx.x];
  const int64_t base = off[c];
  const int n = n_anchors[c];
  const uint32_t* __restrict__ xs = reinterpret_cast<const uint32_t*>(x_lo) + base;
  const uint32_t* __restrict__ qs = reinterpret_cast<const uint32_t*>(qi) + base;
  const int32_t* __restrict__ spans = qspan + base;
  const int32_t* __restrict__ starts = st_eff + base;
  const int32_t* __restrict__ gap_g = gap_table + static_cast<int64_t>(c) * (bw + 1);
  int32_t* scores = out + base;
  int32_t* parents = out + n_total + base;
  int32_t* peaks = out + 2 * n_total + base;
  for (int t = lane; t <= bw; t += 32) gap[t] = gap_g[t];
  for (int t = lane; t < kMarkWords; t += 32) marks[t] = 0;
  __syncwarp();
  const unsigned upto_me = (2u << lane) - 1;  // lanes 0..lane

  // the first anchor to compute: rows before it are preset
  const int i0 = first == nullptr ? 0 : min(max(first[c], 0), n);

  // bank b, lane k: predecessor j = i-1-32b-k of the current anchor i
  Pred bank[kBanks];
#pragma unroll
  for (int b = 0; b < kBanks; ++b) {
    const int j = i0 - 1 - 32 * b - lane;
    bank[b] = j >= 0 ? Pred{xs[j], qs[j], scores[j], parents[j]} : Pred{0, 0, 0, -1};
  }
  // the anchor whose peak waits for its load
  bool pend = false;
  int pend_f = 0, pend_pk = 0, prev_peak = i0 > 0 ? peaks[i0 - 1] : 0;
  // anchor i's own values, loaded an anchor ahead
  uint32_t ax = 0, aq = 0;
  int aspan = 0, ast = 0;
  if (i0 < n) {
    ax = xs[i0];
    aq = qs[i0];
    aspan = spans[i0];
    ast = starts[i0];
  }
  for (int i = i0; i < n; ++i) {
    const uint32_t x_i = ax, q_i = aq;
    const int span_i = aspan;
    const int win = i - ast;  // predecessors in the window
    if (i + 1 < n) {
      ax = xs[i + 1];
      aq = qs[i + 1];
      aspan = spans[i + 1];
      ast = starts[i + 1];
    }
    // the first step past the banks, loaded ahead
    Pred next{0, 0, 0, -1};
    int j = i - 1 - 32 * kBanks - lane;
    if (32 * kBanks + lane < win) next = Pred{xs[j], qs[j], scores[j], parents[j]};

    Walk w{span_i, -1, 0};
    bool brk = false;
#pragma unroll
    for (int s = 0; s < kBanks; ++s) {
      if (brk || 32 * s >= win) break;
      brk = visit_step(bank[s], s, i, win, x_i, q_i, span_i, gap, marks, max_dist_x, max_dist_y,
                       bw, lane, upto_me, w);
    }
    for (int s = kBanks; !brk && 32 * s < win; ++s) {
      const Pred cur = next;
      j -= 32;
      if (32 * (s + 1) + lane < win) next = Pred{xs[j], qs[j], scores[j], parents[j]};
      brk = visit_step(cur, s, i, win, x_i, q_i, span_i, gap, marks, max_dist_x, max_dist_y, bw,
                       lane, upto_me, w);
    }

    // clear the bitmap words the window covers (marks land at t < win)
    for (int t = 1 + lane; 32 * t < win && t < kMarkWords; t += 32) marks[t] = 0;
    __syncwarp();

    // the outputs (lane 0 stores them; every lane keeps the same state, so
    // nothing diverges but the stores): anchor i-1's peak if it waited for
    // its load, then anchor i's, or its load when it reads back further
    if (pend) {
      prev_peak = max(pend_f, pend_pk);
      if (lane == 0) peaks[i - 1] = prev_peak;
    }
    pend = w.max_j >= 0 && w.max_j != i - 1;
    if (pend) {
      pend_pk = peaks[w.max_j];
      pend_f = w.max_f;
    } else {
      prev_peak = w.max_j < 0 ? w.max_f : max(w.max_f, prev_peak);
      if (lane == 0) peaks[i] = prev_peak;
    }
    if (lane == 0) {
      scores[i] = w.max_f;
      parents[i] = w.max_j;
    }
    // shift the banks by one predecessor: rotate each by a lane, and lane
    // 0 of each takes the last lane of the bank before it (of bank 0: i)
    Pred rot[kBanks];
#pragma unroll
    for (int b = 0; b < kBanks; ++b) {
      const int from = (lane + 31) & 31;
      rot[b] = Pred{__shfl_sync(kFull, bank[b].x, from), __shfl_sync(kFull, bank[b].q, from),
                    __shfl_sync(kFull, bank[b].score, from),
                    __shfl_sync(kFull, bank[b].parent, from)};
    }
#pragma unroll
    for (int b = 0; b < kBanks; ++b) {
      bank[b] = lane > 0 ? rot[b] : (b == 0 ? Pred{x_i, q_i, w.max_f, w.max_j} : rot[b - 1]);
    }
  }
  if (lane == 0 && pend) peaks[n - 1] = max(pend_f, pend_pk);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// Per anchor (n_total): x_lo, qi, qspan, st_eff (st_eff[i] >= i - 5000);
// per call (n_calls): off, n, gap_table [n_calls, bw+1], first (null, or
// the preset rows of each call, which `out` holds), order (a permutation
// of the calls); out: 3 * n_total int32.
int chain_dp(const int32_t* x_lo, const int32_t* qi, const int32_t* qspan,
             const int32_t* st_eff, const int64_t* off, const int32_t* n, const int32_t* gap_table,
             const int32_t* first, const int32_t* order, int32_t* out, int n_calls,
             int64_t n_total, int max_dist_x, int max_dist_y, int bw, void* stream) {
  if (n_calls <= 0 || n_total <= 0) return 0;
  if (bw < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(bw) + 1 + kMarkWords) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chain_dp_kernel<<<n_calls, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      x_lo, qi, qspan, st_eff, off, n, gap_table, first, order, out, n_total, max_dist_x,
      max_dist_y, bw);
  return static_cast<int>(cudaGetLastError());
}

const char* chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
