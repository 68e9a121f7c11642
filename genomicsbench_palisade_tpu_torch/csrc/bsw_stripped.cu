// The banded Smith-Waterman recurrence alone, over every cell of a padded
// query x target grid: the "stripped" side of the bsw roofline probe.
//
// Replaces tools/bsw_roofline.py:_stripped_kernel (wrapper `_stripped`).
// That Pallas probe kept only the per-row recurrence of ops/bsw_pallas.py's
// kernel (score add, the E update, the lazy-F chain as log2(qe_pad)
// roll/max rounds, the H write) and dropped the band, the z-drop and the
// running maxima, so that the production kernel's time over the stripped
// kernel's is the cost of that bookkeeping.
//
// What it computes, per pair b (a column of the [rows, batch] arrays), for
// target rows i = 0 .. tp-1 and every query row j = 0 .. qe_pad-1, from the
// H and E columns the caller gives (h_init, e_init: the Pallas kernel read
// its scratch before any write, so its start was whatever the scratch
// held; the port names it):
//   qsc = q[j] == t[i] ? match : -mismatch
//   M   = H[j] != 0 ? H[j] + qsc : 0
//   H0  = max(M, E[j])
//   c   = max(M - oe_ins, 0),  g = max(c + j*e_ins, NEG)
//   F   = max(max_{k<j} g_k - (j-1)*e_ins, 0)       (the max over no k is NEG)
//   E'  = max(E[j] - e_del, max(M - oe_del, 0))
//   H'[j] = max(H0, F) of row j-1, H'[0] = 0          (the one-sublane roll)
// and writes the final H and E, [2, qe_pad, batch].  The Pallas kernel
// returned H's first 8 rows only; those rows depend on nothing past query
// row 7 (F and the roll flow to larger j, E stays in its row), so a kernel
// that returned them could skip ~94% of the cells, and the probe would time
// nothing.  Every add, subtract and multiply that can wrap is done in
// uint32 and read back as int32: from a start near INT32_MAX the Pallas
// kernel's int32 arithmetic wraps in two's complement, and signed overflow
// is undefined in C++.  So the result equals the Pallas kernel's
// (interpret mode) and the plain version's bit for bit from any start.
//
// F is the prefix maximum of the clamped g, the Pallas kernel's cummax.
// The shorter running form r = max(r - e_ins, c), F = max(r, 0) equals it
// while c + j*e_ins fits in int32, but from a start near INT32_MAX with a
// small E that sum wraps, the NEG clamp drops the term, and the shorter
// form does not.  A maximum is exact under wrap, so the prefix maximum can
// be taken in any grouping.
//
// Design (csrc/bsw_extend.cu's layout).  A group of L lanes (8, 16 or 32)
// takes a pair, and lane r owns the K consecutive query rows
// j in [rK, rK + K), L * K >= qe_pad, one template instance a (L, K).
// Their H, E and query codes stay in the lane's registers for the whole
// pair: H and E are read once at the start and written once at the end.
// A target row is one step of the group:
//  - each lane computes M, H0, c, g and E' of its K cells at once (none
//    depends on another cell of the row) and folds its g into one maximum;
//  - log2(L) __shfl_up_sync rounds give every lane the inclusive prefix
//    maximum over the lanes up to it, one more shuffle the exclusive one
//    (lane 0 takes NEG);
//  - the lane replays its K rows' F and max(H0, F) from that prefix;
//  - H' of its first row is lane r-1's last max(H0, F), by one shuffle;
//    lane 0 takes 0.
// Targets are read L rows at a time, one code a lane, and handed out by
// shuffles.  Slots past qe_pad (L * K - qe_pad of them) compute from H =
// E = 0 but are never written back; they cannot reach a row below them,
// since F and the roll flow only to larger j.  A warp holds 32 / L pairs;
// a pair that does not exist computes on zeros and writes nothing.
//
// Past the widest instance (qe_pad > 520): bsw_stripped_long_kernel, a warp
// a pair, steps each target row over chunks of kChunk = 512 query rows.  In
// a chunk lane r holds rows c0 + rK .. c0 + rK + K - 1 (K = 16) as the 520
// instance does; their H and E live in `out` between rows (copied there
// from h_init and e_init at the start: each lane reads and writes only its
// own rows, so no barrier), and two scalars cross a chunk boundary: the F
// prefix maximum and the chunk's last max(H0, F), which the roll hands to
// the next chunk's first row.  It is the same recurrence in the same wrap
// arithmetic; its H/E traffic goes through the L1 and L2 caches on every
// row, so it is not a roofline design: it lets the probe run at any qe_pad.
//
// Bound.  Per cell 12 instructions of the card, counting what Hopper
// fuses as one (IADD3 a three-way add, VIADDMNMX an add and a max,
// VIMNMX3 a three-way max) and no loop-invariant term (j*e_ins is a
// constant of the lane's row): the score 2 (compare, select), M 3 (test,
// add, select), H0 1, c 1 (add and max with 0), the running prefix max 1
// (max(run, c + j*e_ins): run never falls below NEG, so g's clamp is
// implied), F and H' 2 (subtract, three-way max with H0 and 0), E' 2 (add
// and max with 0, add and max); address arithmetic, loads and the roll's
// moves are not counted.  chip_smoke.py takes them at the card's integer
// issue rate: 4 warp instructions an SM a clock, which the INT32 pipe and
// IMAD on the FMA pipe fill together.  The bytes are 4 a query row and a
// target row of a pair in, and 8 a query row of H/E in and out: ~30 MB at
// the probe's shape against ~3.4 G instructions, so on the card the
// function is bound by operations.  This design's cost a row is K cells
// of ~16 instructions (the count above, the scan's second prefix max, and
// the fold into the lane's maximum) and a fixed ~5 log2(L) + 12 a group
// (the scan's rounds, the exclusive shuffle, the roll, the target's
// shuffle and the loop), and L * K - qe_pad padding slots: at the probe's
// qe_pad 136 with 8 lanes of 17 rows, none, and ~27 fixed against ~272
// cell instructions, ~10%.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

// Lanes a pair for each qe_pad edge (K = ceil(edge / lanes) rows a lane)
// come from the build, -DBSW_STRIPPED_LANES_<edge>=L: ops/bsw_stripped.py's
// LANES table, measured on the card by tools/probe_lanes.py.

namespace {

constexpr int kThreads = 128;
constexpr int32_t kNeg = -(1 << 20);
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  int o_del, e_del, o_ins, e_ins, match, mismatch;
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

template <int K, int L>
__global__ void __launch_bounds__(kThreads)
bsw_stripped_kernel(const int32_t* __restrict__ q_codes, const int32_t* __restrict__ target,
                    const int32_t* __restrict__ h_init, const int32_t* __restrict__ e_init,
                    int32_t* __restrict__ out, int qe_pad, int tp, int batch, Params p) {
  constexpr int G = 32 / L;  // pairs a warp
  const int lane = threadIdx.x & 31;
  const int r = lane & (L - 1);  // lane within the pair's group
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (warp * G >= batch) return;  // the whole warp: no pair of it exists
  const int64_t b = warp * G + lane / L;
  const bool real = b < batch;
  const size_t stride = static_cast<size_t>(batch);
  const int j0 = r * K;  // this lane's first query row

  // the lane's rows: query code, H, E and (j-1)*e_ins
  int32_t qc[K], H[K], E[K], jm1e[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    const bool in = real && j < qe_pad;
    const size_t at = static_cast<size_t>(in ? j : 0) * stride + (real ? b : 0);
    qc[k] = in ? q_codes[at] : 0;
    H[k] = in ? h_init[at] : 0;
    E[k] = in ? e_init[at] : 0;
    jm1e[k] = static_cast<int32_t>(static_cast<uint32_t>(j - 1) * static_cast<uint32_t>(p.e_ins));
  }
  const int32_t oe_del = wadd(p.o_del, p.e_del);
  const int32_t oe_ins = wadd(p.o_ins, p.e_ins);
  const int32_t mis = wsub(0, p.mismatch);

  int32_t tcodes = 0;
  for (int i = 0; i < tp; ++i) {
    if ((i & (L - 1)) == 0) {
      const int t = i + r;
      tcodes = real && t < tp ? target[static_cast<size_t>(t) * stride + b] : 0;
    }
    const int32_t tc = __shfl_sync(kFull, tcodes, i & (L - 1), L);

    // M, H0, g and E' of the lane's cells; the lane's max of g
    int32_t h0[K], g[K];
    int32_t gl = kNeg;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int32_t qsc = qc[k] == tc ? p.match : mis;
      const int32_t m = H[k] != 0 ? wadd(H[k], qsc) : 0;
      h0[k] = max(m, E[k]);
      const int32_t c = max(wsub(m, oe_ins), 0);
      g[k] = max(wadd(wadd(c, jm1e[k]), p.e_ins), kNeg);  // c + j*e_ins, clamped
      gl = max(gl, g[k]);
      E[k] = __vimax_s32_relu(wsub(E[k], p.e_del), wsub(m, oe_del));  // DPX max-with-zero
    }
    // inclusive max-scan over the group's lanes, then the exclusive prefix
#pragma unroll
    for (int d = 1; d < L; d <<= 1) {
      const int32_t v = __shfl_up_sync(kFull, gl, d, L);
      if (r >= d) gl = max(gl, v);
    }
    int32_t run = __shfl_up_sync(kFull, gl, 1, L);
    if (r == 0) run = kNeg;

    // F and max(H0, F) of each row, which row j+1 takes as its H
    int32_t hn[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      hn[k] = __vimax_s32_relu(h0[k], wsub(run, jm1e[k]));  // max(H0, F), F clamped at 0
      run = max(run, g[k]);
    }
    const int32_t h_in = __shfl_up_sync(kFull, hn[K - 1], 1, L);
    H[0] = r == 0 ? 0 : h_in;
#pragma unroll
    for (int k = 1; k < K; ++k) H[k] = hn[k - 1];
  }

  if (!real) return;
  int32_t* __restrict__ hs = out + b;
  int32_t* __restrict__ es = out + static_cast<size_t>(qe_pad) * stride + b;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    if (j < qe_pad) {
      hs[static_cast<size_t>(j) * stride] = H[k];
      es[static_cast<size_t>(j) * stride] = E[k];
    }
  }
}

constexpr int kChunkK = 16;  // rows a lane of a long column's chunk
constexpr int kChunk = 32 * kChunkK;  // rows a chunk

// qe_pad > 520: a warp a pair (see the note at the top)
template <int K>
__global__ void __launch_bounds__(kThreads)
bsw_stripped_long_kernel(const int32_t* __restrict__ q_codes, const int32_t* __restrict__ target,
                         const int32_t* __restrict__ h_init, const int32_t* __restrict__ e_init,
                         int32_t* __restrict__ out, int qe_pad, int tp, int batch, Params p) {
  constexpr int C = 32 * K;
  const int lane = threadIdx.x & 31;
  const int64_t b = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (b >= batch) return;  // the whole warp
  const size_t stride = static_cast<size_t>(batch);
  int32_t* __restrict__ hs = out + b;
  int32_t* __restrict__ es = out + static_cast<size_t>(qe_pad) * stride + b;
  for (int c0 = 0; c0 < qe_pad; c0 += C) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = c0 + lane * K + k;
      if (j < qe_pad) {
        hs[j * stride] = h_init[j * stride + b];
        es[j * stride] = e_init[j * stride + b];
      }
    }
  }
  const int32_t oe_del = wadd(p.o_del, p.e_del);
  const int32_t oe_ins = wadd(p.o_ins, p.e_ins);
  const int32_t mis = wsub(0, p.mismatch);

  int32_t tcodes = 0;
  for (int i = 0; i < tp; ++i) {
    if ((i & 31) == 0) {
      tcodes = i + lane < tp ? target[static_cast<size_t>(i + lane) * stride + b] : 0;
    }
    const int32_t tc = __shfl_sync(kFull, tcodes, i & 31);
    int32_t run_in = kNeg, h_roll = 0;  // what crosses a chunk boundary
    for (int c0 = 0; c0 < qe_pad; c0 += C) {
      const int j0 = c0 + lane * K;
      int32_t H[K], E[K], h0[K], g[K];
      int32_t gl = kNeg;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = j0 + k;
        const bool in = j < qe_pad;
        const int32_t qc = in ? q_codes[j * stride + b] : 0;
        H[k] = in ? hs[j * stride] : 0;
        E[k] = in ? es[j * stride] : 0;
        const int32_t qsc = qc == tc ? p.match : mis;
        const int32_t m = H[k] != 0 ? wadd(H[k], qsc) : 0;
        h0[k] = max(m, E[k]);
        const int32_t c = max(wsub(m, oe_ins), 0);
        const int32_t je = static_cast<int32_t>(static_cast<uint32_t>(j) *
                                                static_cast<uint32_t>(p.e_ins));
        g[k] = max(wadd(c, je), kNeg);
        gl = max(gl, g[k]);
        E[k] = __vimax_s32_relu(wsub(E[k], p.e_del), wsub(m, oe_del));
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t v = __shfl_up_sync(kFull, gl, d);
        if (lane >= d) gl = max(gl, v);
      }
      int32_t run = __shfl_up_sync(kFull, gl, 1);
      run = lane == 0 ? run_in : max(run, run_in);
      run_in = max(run_in, __shfl_sync(kFull, gl, 31));
      int32_t hn[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int32_t jm1e = static_cast<int32_t>(static_cast<uint32_t>(j0 + k - 1) *
                                                  static_cast<uint32_t>(p.e_ins));
        hn[k] = __vimax_s32_relu(h0[k], wsub(run, jm1e));
        run = max(run, g[k]);
      }
      int32_t h_in = __shfl_up_sync(kFull, hn[K - 1], 1);
      if (lane == 0) h_in = c0 == 0 ? 0 : h_roll;
      h_roll = __shfl_sync(kFull, hn[K - 1], 31);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = j0 + k;
        if (j < qe_pad) {
          hs[j * stride] = k == 0 ? h_in : hn[k - 1];
          es[j * stride] = E[k];
        }
      }
    }
  }
}

template <int V>
using Int = std::integral_constant<int, V>;

// The instance for qe_pad, the first edge at or above it: run(edge, lanes)
// as integral constants.  The launch below and the CPU emulation
// (tests/cuda_emulation/run_kernels.cpp) both dispatch through it.
template <class Run>
auto with_instance(int qe_pad, Run&& run) {
  if (qe_pad <= 8) return run(Int<8>{}, Int<BSW_STRIPPED_LANES_8>{});
  if (qe_pad <= 16) return run(Int<16>{}, Int<BSW_STRIPPED_LANES_16>{});
  if (qe_pad <= 32) return run(Int<32>{}, Int<BSW_STRIPPED_LANES_32>{});
  if (qe_pad <= 64) return run(Int<64>{}, Int<BSW_STRIPPED_LANES_64>{});
  if (qe_pad <= 136) return run(Int<136>{}, Int<BSW_STRIPPED_LANES_136>{});
  if (qe_pad <= 264) return run(Int<264>{}, Int<BSW_STRIPPED_LANES_264>{});
  return run(Int<520>{}, Int<BSW_STRIPPED_LANES_520>{});
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// q_codes, h_init, e_init: int32 [qe_pad, batch]; target: int32 [tp,
// batch]; out: int32 [2, qe_pad, batch], the final H then E.  qe_pad
// picks the instance; above 520 the long-column kernel runs.
int bsw_stripped(const int32_t* q_codes, const int32_t* target, const int32_t* h_init,
                 const int32_t* e_init, int32_t* out, int qe_pad, int tp, int batch, int o_del,
                 int e_del, int o_ins, int e_ins, int match, int mismatch, void* stream) {
  if (batch <= 0 || qe_pad <= 0) return 0;
  const Params p{o_del, e_del, o_ins, e_ins, match, mismatch};
  const auto s = static_cast<cudaStream_t>(stream);
  if (qe_pad > 520) {
    const int64_t blocks = (static_cast<int64_t>(batch) * 32 + kThreads - 1) / kThreads;
    bsw_stripped_long_kernel<kChunkK><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        q_codes, target, h_init, e_init, out, qe_pad, tp, batch, p);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err = with_instance(qe_pad, [&](auto edge, auto lanes) {
    constexpr int L = decltype(lanes)::value;
    static_assert(L == 8 || L == 16 || L == 32, "a group is 8, 16 or 32 lanes");
    constexpr int K = (decltype(edge)::value + L - 1) / L;
    constexpr int G = 32 / L;  // pairs a warp
    const int64_t warps = (static_cast<int64_t>(batch) + G - 1) / G;
    const int64_t blocks = (warps * 32 + kThreads - 1) / kThreads;
    bsw_stripped_kernel<K, L><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        q_codes, target, h_init, e_init, out, qe_pad, tp, batch, p);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

const char* bsw_stripped_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
