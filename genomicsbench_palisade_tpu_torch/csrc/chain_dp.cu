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
// written to rows 0, 1, 2 of `out` [3, n_total] at the call's offset.
// Every branch of the oracle maps one to one onto the loop below, in its
// order: the `continue` tests (dr == 0, dq <= 0, dq > max_dist_y,
// dq > max_dist_x, dd > bw); sc = min(dq, dr, qspan_i) - gap[dd] +
// scores[j]; the strict-improvement update that takes one off n_skip; the
// targets[j] == i skip count and the n_skip > MAX_SKIP break, before the
// mark; the targets[parents[j]] = i mark; then the anchor's score, parent
// and peak.  The host precomputes what is exact there (ops/chain.py
// prepare_call): the window start st_eff[i] (call-local), the low 32 bits
// of x, whose u32 difference is exact inside the window (dr <=
// max_dist_x), and each call's float64-exact gap table over dd in [0, bw].
// All arithmetic is int32 (dq in two's-complement wrap, as the JAX scan),
// so the result is bit-equal to the oracle, the JAX scan and the plain
// PyTorch version.
//
// Design.  One thread per call: the anchors of a call form one dependent
// chain (scores[i] reads scores[j < i]), and calls are independent.  The
// thread walks the reference's loop on the prepared arrays; a call's
// scores, parents and peaks are read back from `out` as the loop goes, and
// its targets live in a zeroed int32 scratch (the oracle starts them at
// 0).  The gap table is read from global memory, where a call's 2 KB stays
// in L1.  What sets the speed is the latency of each visit, so:
//  - the next predecessor's x, q, score, parent and target are loaded one
//    visit ahead, which leaves the gap lookup as the one load on the
//    dependent chain (the visit's only store, targets[parents[j]] = i, may
//    hit the prefetched target of j-1, and then patches it);
//  - each call gets a block (one thread, so a warp) of its own: calls'
//    loops diverge, so warp-mates would wait on each other, and the calls
//    spread over every SM, so each SM's L1 holds its few windows (~290
//    anchors x 20 bytes and a 2 KB gap table each).  Blocks beyond what the
//    card holds at once queue.  Blocks go in order of call length (`order`,
//    longest first), so the longest chains start first.
//
// Bound.  Each visited predecessor costs at least 5 int32 operations (loop
// test and step, the two differences, the dr == 0 test) and each one that
// passes the skip tests 16 more (four tests, |dr - dq|, two mins, the gap
// subtract, the score add, the compare with max_f, the update of max_f,
// max_j and n_skip or the skip count and break test, the parent test);
// address arithmetic is not counted.  The bytes are 16 in and 12 out an
// anchor plus 4(bw+1) of gap table a call, so on the card's rates the
// function is bound by operations.  This kernel is bound by neither: it is
// latency-bound by each call's sequential chain (~200 dependent window
// visits an anchor on the reference's data, 87,271 anchors in its largest
// call: 17.7 M visits on one thread) with only as many threads as calls
// live (~1000).  A warp per call with the window on lanes, the running max
// and the max_skip walk as warp scans, is left for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSkip = 25;

__global__ void __launch_bounds__(1)
chain_dp_kernel(const int32_t* __restrict__ x_lo, const int32_t* __restrict__ qi,
                const int32_t* __restrict__ qspan, const int32_t* __restrict__ st_eff,
                const int64_t* __restrict__ off, const int32_t* __restrict__ n_anchors,
                const int32_t* __restrict__ gap_table, const int32_t* __restrict__ order,
                int32_t* __restrict__ targets, int32_t* __restrict__ out, int64_t n_total,
                int max_dist_x, int max_dist_y, int bw) {
  const int c = order[blockIdx.x];
  const int64_t base = off[c];
  const int n = n_anchors[c];
  const uint32_t* __restrict__ xs = reinterpret_cast<const uint32_t*>(x_lo) + base;
  const uint32_t* __restrict__ qs = reinterpret_cast<const uint32_t*>(qi) + base;
  const int32_t* __restrict__ spans = qspan + base;
  const int32_t* __restrict__ starts = st_eff + base;
  const int32_t* __restrict__ gap = gap_table + static_cast<int64_t>(c) * (bw + 1);
  int32_t* scores = out + base;
  int32_t* parents = out + n_total + base;
  int32_t* peaks = out + 2 * n_total + base;
  int32_t* tg = targets + base;

  for (int i = 0; i < n; ++i) {
    const uint32_t x_i = xs[i];
    const uint32_t q_i = qs[i];
    const int span_i = spans[i];
    const int st = starts[i];
    int max_f = span_i, max_j = -1, n_skip = 0;
    // predecessor j's values, loaded during the visit of j + 1
    uint32_t next_x = 0, next_q = 0;
    int next_score = 0, next_parent = -1, next_target = 0;
    if (i > st) {
      next_x = xs[i - 1];
      next_q = qs[i - 1];
      next_score = scores[i - 1];
      next_parent = parents[i - 1];
      next_target = tg[i - 1];
    }
    for (int j = i - 1; j >= st; --j) {
      const uint32_t x_j = next_x, q_j = next_q;
      const int score_j = next_score, parent_j = next_parent, target_j = next_target;
      if (j > st) {
        next_x = xs[j - 1];
        next_q = qs[j - 1];
        next_score = scores[j - 1];
        next_parent = parents[j - 1];
        next_target = tg[j - 1];
      }
      const int dr = static_cast<int>(x_i - x_j);
      const int dq = static_cast<int>(q_i - q_j);
      if (dr == 0 || dq <= 0) continue;
      if (dq > max_dist_y || dq > max_dist_x) continue;
      const int dd = dr > dq ? dr - dq : dq - dr;
      if (dd > bw) continue;
      const int sc = min(min(dq, dr), span_i) - gap[dd] + score_j;
      if (sc > max_f) {
        max_f = sc;
        max_j = j;
        if (n_skip > 0) --n_skip;
      } else if (target_j == i) {
        if (++n_skip > kMaxSkip) break;
      }
      if (parent_j >= 0) {
        tg[parent_j] = i;
        if (parent_j == j - 1) next_target = i;
      }
    }
    scores[i] = max_f;
    parents[i] = max_j;
    int peak = max_f;
    if (max_j >= 0) {
      const int pk = peaks[max_j];
      if (pk > max_f) peak = pk;
    }
    peaks[i] = peak;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// Per anchor (n_total): x_lo, qi, qspan, st_eff; per call (n_calls): off,
// n, gap_table [n_calls, bw+1], order (a permutation of the calls);
// targets: n_total int32, zeroed; out: 3 * n_total int32.
int chain_dp(const int32_t* x_lo, const int32_t* qi, const int32_t* qspan,
             const int32_t* st_eff, const int64_t* off, const int32_t* n, const int32_t* gap_table,
             const int32_t* order, int32_t* targets, int32_t* out, int n_calls, int64_t n_total,
             int max_dist_x, int max_dist_y, int bw, void* stream) {
  if (n_calls <= 0 || n_total <= 0) return 0;
  chain_dp_kernel<<<n_calls, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      x_lo, qi, qspan, st_eff, off, n, gap_table, order, targets, out, n_total, max_dist_x,
      max_dist_y, bw);
  return static_cast<int>(cudaGetLastError());
}

const char* chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
