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
// eligibility test like any other: the window starts with them.  Its chunks
// of nc anchors (a blocking of the TPU grid) carried the last w scores
// forward, so every anchor saw exactly its w predecessors: this kernel does
// not chunk.  Every add, subtract and multiply that can wrap is done in
// uint32 and read back as int32, as the Pallas kernel's int32 arithmetic
// wraps (dd * m does, for pairs far apart; only eligible pairs, dd <= bw,
// reach the output), and |INT32_MIN| stays INT32_MIN as jnp.abs leaves it.
// ilog is min(floor(log2 dd), n_log) for dd >= 2 and 0 below, the count
// of the Pallas kernel's compares (see the bound for the cap).  So the result equals the Pallas kernel's
// (interpret mode) and the plain version's bit for bit.
//
// Design.  A warp takes one call (a block of one warp each, the calls spread
// over the SMs, as csrc/chain_dp.cu).  The window is a ring of slots in the
// warp's registers: slot s lives in lane s & 31 of register bank s >> 5, and
// holds a predecessor's x, q and score.  With w <= 32 * NB (NB banks, one
// template instance each, up to kBanks) the ring has w slots and anchor j sits in slot
// j mod w; anchor i's result overwrites slot i mod w, the slot of anchor
// i - w, by one select on the owning lane.  The ring starts as the phantom
// zeros.  The function is a max and has no visit order and no ties that
// show, so the lanes need no rotation and no shuffles to keep an order
// (the order is the bookkeeping the probe leaves out).  Everything in a
// candidate but `+ sc_j` depends on x and q only (dr, dq, dd, the
// eligibility test, the slope, ilog, the gap, min_d - gap), so anchor
// i+1's terms are computed while anchor i's maximum is being reduced.  An
// anchor's chain is then: one add and select a slot, the lane's max,
// __reduce_max_sync, the max with qspan_i, the owning lane's select.  The
// anchors' x, q and qspan are read 32 at a time, one a lane, a chunk
// ahead, and handed out by shuffles an anchor ahead; lane 0 stores the
// scores.
//
// Windows wider than the register banks (w > 32 * kBanks) keep kBanks
// banks of the nearest 32 * kBanks predecessors (the ring then has that
// many slots), and the rest in a second ring in shared memory, x, q and
// score by position j mod (w - 32 * kBanks): the anchor that leaves the
// register ring is written there by its lane, over the anchor that left
// the window.  That part of anchor i+1's window holds no score still being
// computed, so its candidates and their lane maximum are made whole, 32
// slots a step, while anchor i is reduced, off the chain.
//
// Bound.  Per visited predecessor the function needs 17 instructions of
// the card, counting what Hopper fuses as one (IADD3 a three-way add,
// VIMNMX3 a three-way min, compares that chain their predicates, a
// predicated max): dr 1, dq 1, dd 2 (subtract, abs), the four eligibility
// compares 4, the slope 2 (multiply, shift), ilog 3 (max with 1, find
// leading one, halve), the gap 1, min_d 1, the candidate 1 (min_d - gap +
// sc_j), the max 1; loads and address arithmetic are not counted.
// chip_smoke.py takes them at the card's integer issue rate (4 warp
// instructions an SM a clock).  ilog's cap at n_log never changes a score:
// a pair is eligible only when dd <= bw, and then floor(log2 dd) <= n_log
// already; an ineligible pair's terms are never used.  So this kernel
// drops the cap and takes ilog as floor(log2 max(dd, 1)), which is 0 for
// dd < 2 (INT32_MIN included), as the bound counts it.  The bytes are 12
// an anchor in and 4 out, and 8 a call: ~8.4 MB at the probe's 128 x 4096
// against ~0.57 G instructions, so on the card the function is bound by
// operations.  This kernel is bound
// by one warp's issue and latencies: a call is one warp on one SM
// sub-partition, whose 16 INT32 lanes take a warp's integer instruction
// every two cycles, and the probe has only 128 calls (one warp an SM, no
// other warp to hide a stall behind): at w = 64 a lane computes 2 slots'
// terms (~50 instructions, each slot a chain of ~10 dependent operations)
// and the chain's ~15 an anchor, so at least ~130 cycles an anchor,
// against a dependent chain of ~50 (the add, select and max, the
// reduction, the max with qspan, the select); 4,096 anchors x the fewest
// dependent cycles an anchor is the latency floor.

#include <cstdint>
#include <cuda_runtime.h>

// Register banks of 32 window slots (wider windows keep the rest in shared
// memory) come from the build, -DCHAIN_MICRO_BANKS=NB: ops/chain_micro.py's
// BANKS, measured on the card by tools/probe_lanes.py.

namespace {

constexpr int32_t kNeg = -(1 << 28);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBanks = CHAIN_MICRO_BANKS;

struct Params {
  int w, max_dist, bw;
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// the anchor a candidate is scored for, as every lane holds it
struct Anchor {
  int32_t x, q, span;
};

// predecessor (x_j, q_j) of anchor a: whether it is eligible and, if it
// is, min_d - gap (its candidate is that plus sc_j)
__device__ __forceinline__ int32_t terms(const Anchor& a, int32_t x_j, int32_t q_j, uint32_t m,
                                         int32_t g0, const Params& p, bool& eligible) {
  const int32_t dr = wsub(a.x, x_j);
  const int32_t dq = wsub(a.q, q_j);
  const int32_t diff = wsub(dr, dq);
  const int32_t dd = diff < 0 ? wsub(0, diff) : diff;
  eligible = dr != 0 && dq > 0 && dq <= p.max_dist && dd <= p.bw;
  const int32_t lin = static_cast<int32_t>((static_cast<uint32_t>(dd) * m) >> 20);
  const int32_t ilog = 31 - __clz(max(dd, 1));  // no cap at n_log: see the bound
  const int32_t gap = wadd(wadd(g0, lin), ilog >> 1);
  return wsub(min(min(dq, dr), a.span), gap);
}

template <int NB>
__global__ void __launch_bounds__(32)
chain_micro_kernel(const int32_t* __restrict__ x_lo, const int32_t* __restrict__ qi,
                   const int32_t* __restrict__ qspan, const int32_t* __restrict__ m_fp,
                   const int32_t* __restrict__ gap0, int32_t* __restrict__ out, int n_pad,
                   Params p) {
  extern __shared__ int32_t smem[];  // the far ring: [3][n_far] x, q, score
  const int lane = threadIdx.x;
  const int n_reg = min(p.w, 32 * NB);  // slots of the register ring
  const int n_far = p.w - n_reg;        // slots of the far ring
  int32_t* far_x = smem;
  int32_t* far_q = smem + n_far;
  int32_t* far_s = smem + 2 * n_far;
  for (int t = lane; t < 3 * n_far; t += 32) smem[t] = 0;
  __syncwarp();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n_pad;
  const int32_t* __restrict__ xs = x_lo + base;
  const int32_t* __restrict__ qs = qi + base;
  const int32_t* __restrict__ spans = qspan + base;
  int32_t* __restrict__ scores = out + base;
  const uint32_t m = static_cast<uint32_t>(m_fp[blockIdx.x]);
  const int32_t g0 = gap0[blockIdx.x];

  // the register ring (slot 32b + lane in bank b), and the current
  // anchor's eligibility and min_d - gap for each slot
  int32_t rx[NB], rq[NB], rs[NB], rt[NB];
  bool re[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    rx[b] = rq[b] = rs[b] = 0;
  }

  // anchors 32c .. 32c+31 (chunk c), one a lane; the next chunk loaded ahead
  Anchor cur{0, 0, 0}, ahead{0, 0, 0};
  if (lane < n_pad) cur = Anchor{xs[lane], qs[lane], spans[lane]};
  if (32 + lane < n_pad) ahead = Anchor{xs[32 + lane], qs[32 + lane], spans[32 + lane]};

  // the far part of an anchor's window: the lane's max over its slots
  auto far_max = [&](const Anchor& a) {
    int32_t best = kNeg;
    for (int t = lane; t < n_far; t += 32) {
      bool e;
      const int32_t v = terms(a, far_x[t], far_q[t], m, g0, p, e);
      best = max(best, e ? wadd(v, far_s[t]) : kNeg);
    }
    return best;
  };

  // anchor 0 against the phantom ring; anchor 1 handed out already
  Anchor a{__shfl_sync(kFull, cur.x, 0), __shfl_sync(kFull, cur.q, 0),
           __shfl_sync(kFull, cur.span, 0)};
  Anchor an{__shfl_sync(kFull, cur.x, 1), __shfl_sync(kFull, cur.q, 1),
            __shfl_sync(kFull, cur.span, 1)};
#pragma unroll
  for (int b = 0; b < NB; ++b) rt[b] = terms(a, 0, 0, m, g0, p, re[b]);
  int32_t fmax = far_max(a);
  int slot = 0;                                         // i mod n_reg
  int fpos = n_far ? (n_far - n_reg % n_far) % n_far : 0;  // (i - n_reg) mod n_far

  for (int i = 0; i < n_pad; ++i) {
    // the chain: anchor i's candidates, their max over the warp
    int32_t best = fmax;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const bool in = 32 * b + lane < n_reg;
      best = max(best, in && re[b] ? wadd(rt[b], rs[b]) : kNeg);
    }
    best = __reduce_max_sync(kFull, best);

    // off the chain: anchor i enters slot i mod n_reg (its x and q now,
    // its score below); the anchor it replaces moves to the far ring
    const bool owner = lane == (slot & 31);
    const int bank = slot >> 5;
    if (n_far) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (owner && b == bank) {
          far_x[fpos] = rx[b];
          far_q[fpos] = rq[b];
          far_s[fpos] = rs[b];
        }
      }
      fpos = fpos + 1 == n_far ? 0 : fpos + 1;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (owner && b == bank) {
        rx[b] = a.x;
        rq[b] = a.q;
      }
    }
    // anchor i+2 from the chunk (the next chunk once i+2 starts it), so
    // that anchor i+1's terms below wait for no shuffle
    const int next = (i + 2) & 31;
    if (next == 0) {
      cur = ahead;
      const int t = i + 34 + lane;
      if (t < n_pad) ahead = Anchor{xs[t], qs[t], spans[t]};
    }
    const Anchor an2{__shfl_sync(kFull, cur.x, next), __shfl_sync(kFull, cur.q, next),
                     __shfl_sync(kFull, cur.span, next)};
    int32_t nt[NB];
    bool ne[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) nt[b] = terms(an, rx[b], rq[b], m, g0, p, ne[b]);
    if (n_far) {
      __syncwarp();  // the far ring's new entry before the reads
      fmax = far_max(an);
      __syncwarp();  // the reads before the next write
    }

    // the end of the chain: anchor i's score into its slot
    const int32_t sc = max(best, a.span);
    if (lane == 0) scores[i] = sc;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (owner && b == bank) rs[b] = sc;
      rt[b] = nt[b];
      re[b] = ne[b];
    }
    a = an;
    an = an2;
    slot = slot + 1 == n_reg ? 0 : slot + 1;
  }
}

}  // namespace

namespace {

template <int NB>
cudaError_t launch(const int32_t* x_lo, const int32_t* qi, const int32_t* qspan,
                   const int32_t* m_fp, const int32_t* gap0, int32_t* out, int batch, int n_pad,
                   const Params& p, cudaStream_t stream) {
  const int n_far = p.w - min(p.w, 32 * NB);
  const size_t smem = 12 * static_cast<size_t>(n_far);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_micro_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  chain_micro_kernel<NB><<<batch, 32, smem, stream>>>(x_lo, qi, qspan, m_fp, gap0, out, n_pad, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// x_lo, qi, qspan: int32 [batch, n_pad]; m_fp, gap0: int32 [batch]; out:
// int32 [batch, n_pad].  w >= 1; a window wider than the register banks
// takes 12 * (w - 32 * CHAIN_MICRO_BANKS) bytes of shared memory a block
// (at most the card's per-block limit).
int chain_micro(const int32_t* x_lo, const int32_t* qi, const int32_t* qspan,
                const int32_t* m_fp, const int32_t* gap0, int32_t* out, int batch, int n_pad,
                int w, int max_dist, int bw, void* stream) {
  static_assert(kBanks == 1 || kBanks == 2 || kBanks == 4 || kBanks == 8,
                "1, 2, 4 or 8 register banks");
  if (w < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || n_pad <= 0) return 0;
  const Params p{w, max_dist, bw};
  const auto s = static_cast<cudaStream_t>(stream);
  const int banks = min((w + 31) / 32, kBanks);
  cudaError_t err;
  switch (banks) {
    case 1: err = launch<1>(x_lo, qi, qspan, m_fp, gap0, out, batch, n_pad, p, s); break;
    case 2: err = launch<2>(x_lo, qi, qspan, m_fp, gap0, out, batch, n_pad, p, s); break;
#if CHAIN_MICRO_BANKS > 2
    case 3: err = launch<3>(x_lo, qi, qspan, m_fp, gap0, out, batch, n_pad, p, s); break;
    case 4: err = launch<4>(x_lo, qi, qspan, m_fp, gap0, out, batch, n_pad, p, s); break;
#endif
#if CHAIN_MICRO_BANKS > 4
    case 5: err = launch<5>(x_lo, qi, qspan, m_fp, gap0, out, batch, n_pad, p, s); break;
    case 6: err = launch<6>(x_lo, qi, qspan, m_fp, gap0, out, batch, n_pad, p, s); break;
    case 7: err = launch<7>(x_lo, qi, qspan, m_fp, gap0, out, batch, n_pad, p, s); break;
    case 8: err = launch<8>(x_lo, qi, qspan, m_fp, gap0, out, batch, n_pad, p, s); break;
#endif
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* chain_micro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
