// The minimap2 chaining recurrence alone, over a fixed window of
// predecessors: the micro side of the chain roofline probe.
//
// Replaces tools/chain_roofline.py:_micro_kernel (wrapper `micro_batch`).
// That Pallas probe kept only the per-anchor recurrence of
// ops/chain_pallas.py's kernel (window slice, dr/dq/dd, the eligibility
// compares, the fixed-point gap, the score add, a plain max and the carry)
// and dropped the descending visit order, the max_skip marks and the
// parents and peaks, so that the production kernel's time over the micro
// kernel's is the cost of that bookkeeping.
//
// What it computes, per call b (a row of the [batch, n_pad] arrays) and
// anchor i in [0, n_pad), over the w anchors before it (j = i-w .. i-1):
//   dr = int32(uint32(x_i) - uint32(x_j)),  dq = q_i - q_j,  dd = |dr - dq|
//   eligible: dr != 0, 0 < dq, dq <= max_dist, dd <= bw
//   gap = gap0 + (uint32(dd * m) >> 20) + (ilog >> 1),
//         ilog = #{k in 1..n_log : dd >= 2^k}, n_log = max(floor(log2 max(bw, 2)), 1)
//   sc_i = max(max over eligible j of (min(dq, dr, qspan_i) - gap + sc_j), qspan_i)
// with NEG = -2^28 for a j that is not eligible.  The Pallas kernel took
// max_dist_x and max_dist_y apart, and micro_batch fixed both to 5000: one
// max_dist here, one compare.  The Pallas wrapper padded
// x and q with w zero rows and zeroed the first chunk's scores, so anchor
// i < w sees phantom predecessors at (0, 0) with score 0, and they pass the
// eligibility test like any other: the ring starts with them.  Its chunks
// of nc anchors (a blocking of the TPU grid) carried the last w scores
// forward, so every anchor saw exactly its w predecessors: this kernel does
// not chunk.  Every add, subtract and multiply that can wrap is done in
// uint32 and read back as int32, as the Pallas kernel's int32 arithmetic
// wraps (dd * m does, for pairs far apart; only eligible pairs, dd <= bw,
// reach the output), and |INT32_MIN| stays INT32_MIN as jnp.abs leaves it.
// ilog is min(floor(log2 dd), n_log) for dd >= 2 and 0 below, the count of
// the Pallas kernel's compares.  So the result equals the Pallas kernel's
// (interpret mode) and the plain version's bit for bit.
//
// Design.  The production kernel's launch (csrc/chain_dp.cu), so that the
// probe's ratio is the bookkeeping and not a change of layout: a block of
// one thread a call, the calls spread over the SMs, anchors in order.  The
// last w anchors' x, q and score live in a ring in the block's shared
// memory (12 bytes an entry, 768 bytes at w = 64), which starts as the
// phantom zeros; anchor i overwrites the entry of anchor i - w once its
// score is known.  The window's visits are independent but for the
// running max, so the compiler can overlap them.  A warp a call, with the
// window across lanes and a __reduce_max_sync, is the later redesign.
//
// Bound.  Per visited predecessor the function needs 25 int32 operations:
// dr 1, dq 1, dd 2 (subtract, abs), the four eligibility compares and
// their three ands 7, the slope 2 (multiply, shift), ilog 3 (count leading
// zeros, subtract, max with 0), the gap 3 (shift, two adds), min_d 2, the
// candidate 3 (subtract, add, select), the max 1; loads from the ring and
// address arithmetic are not counted.  ilog's cap at n_log never changes
// a score: a pair is eligible only when dd <= bw, and then floor(log2 dd)
// <= n_log already.  This kernel keeps the cap and its dd >= 2 select (two
// operations the bound does not count), as the Pallas kernel's count of
// compares has them.  The bytes are 12 an anchor in and 4
// out, and 8 a call: ~8.4 MB at the probe's 128 x 4096 against ~0.84 G
// operations, so on the card the function is bound by operations.  This
// kernel is bound by latency: 262,144 visits a call on one thread, with
// only as many threads as calls (128).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kNeg = -(1 << 28);

struct Params {
  int w, max_dist, bw, n_log;
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__global__ void __launch_bounds__(1)
chain_micro_kernel(const int32_t* __restrict__ x_lo, const int32_t* __restrict__ qi,
                   const int32_t* __restrict__ qspan, const int32_t* __restrict__ m_fp,
                   const int32_t* __restrict__ gap0, int32_t* __restrict__ out, int n_pad,
                   Params p) {
  extern __shared__ int32_t ring[];  // [3][w]: x, q, score
  int32_t* rx = ring;
  int32_t* rq = ring + p.w;
  int32_t* rs = ring + 2 * p.w;
  for (int k = 0; k < 3 * p.w; ++k) ring[k] = 0;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n_pad;
  const int32_t* __restrict__ xs = x_lo + base;
  const int32_t* __restrict__ qs = qi + base;
  const int32_t* __restrict__ spans = qspan + base;
  int32_t* __restrict__ scores = out + base;
  const uint32_t m = static_cast<uint32_t>(m_fp[blockIdx.x]);
  const int32_t g0 = gap0[blockIdx.x];
  int slot = 0;  // the ring entry of anchor i - w
  for (int i = 0; i < n_pad; ++i) {
    const int32_t x_i = xs[i];
    const int32_t q_i = qs[i];
    const int32_t span = spans[i];
    int32_t best = kNeg;
#pragma unroll 4
    for (int k = 0; k < p.w; ++k) {
      const int32_t dr = wsub(x_i, rx[k]);
      const int32_t dq = wsub(q_i, rq[k]);
      const int32_t diff = wsub(dr, dq);
      const int32_t dd = diff < 0 ? wsub(0, diff) : diff;
      const bool eligible = dr != 0 && dq > 0 && dq <= p.max_dist && dd <= p.bw;
      const int32_t lin = static_cast<int32_t>((static_cast<uint32_t>(dd) * m) >> 20);
      const int32_t ilog = dd >= 2 ? min(31 - __clz(dd), p.n_log) : 0;
      const int32_t gap = wadd(wadd(g0, lin), ilog >> 1);
      const int32_t min_d = min(min(dq, dr), span);
      const int32_t cand = eligible ? wadd(wsub(min_d, gap), rs[k]) : kNeg;
      best = max(best, cand);
    }
    const int32_t sc = max(best, span);
    scores[i] = sc;
    rx[slot] = x_i;
    rq[slot] = q_i;
    rs[slot] = sc;
    slot = slot + 1 == p.w ? 0 : slot + 1;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// x_lo, qi, qspan: int32 [batch, n_pad]; m_fp, gap0: int32 [batch]; out:
// int32 [batch, n_pad].  w >= 1; the ring takes 12 * w bytes of shared
// memory a block (at most the card's per-block limit).
int chain_micro(const int32_t* x_lo, const int32_t* qi, const int32_t* qspan,
                const int32_t* m_fp, const int32_t* gap0, int32_t* out, int batch, int n_pad,
                int w, int max_dist, int bw, void* stream) {
  if (w < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || n_pad <= 0) return 0;
  const size_t smem = 12 * static_cast<size_t>(w);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_micro_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int n_log = 0;
  for (int v = bw > 2 ? bw : 2; v > 1; v >>= 1) ++n_log;  // floor(log2 max(bw, 2)) >= 1
  const Params p{w, max_dist, bw, n_log};
  chain_micro_kernel<<<batch, 1, smem, static_cast<cudaStream_t>(stream)>>>(
      x_lo, qi, qspan, m_fp, gap0, out, n_pad, p);
  return static_cast<int>(cudaGetLastError());
}

const char* chain_micro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
