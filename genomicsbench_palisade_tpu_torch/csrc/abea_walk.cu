// f5c adaptive banded event alignment: the traceback, over a flat batch of
// filled reads.
//
// Replaces genomicsbench_palisade_tpu/ops/abea_pallas.py:_walk_kernel
// (wrapper abea_walk_pallas).  That kernel swept 4096-row chunks of packed
// 2-bit trace rows in reverse, read them as i32 words (a u8 block that
// large hit a Mosaic bug), took the seed and the total of the band moves
// from XLA, and wrote the moves 2 bits a move, 16 to a word, with the count
// and the seed in meta rows, for the relay's fetch size; the host then
// replayed the moves into pairs and the QC sum.  Here the fill has left
// bll_e and the seed on the device, so the walk is the oracle's own
// (align.c:435-470, ops/oracle/abea.py:160-183): from (k-mer nk - 1, event
// seed), while both are >= 0, record the pair, add its emission, and step
// by the move of cell (band ce + ck + 2, offset bll_e[band] - ce): FROM_D
// lowers both, FROM_U the event, FROM_L the k-mer and counts a skip run.
// An offset outside the band (only a walk from an all -inf seed column can
// get there) is clamped to the band's edge, as the JAX package's walk does.
//
// Outputs, per read r: pairs (k-mer, event) int32 in walk order at rows
// band_off[r] .. of pairs [R, 2] (the wrapper zeroes the rest), n[r] the
// pairs, max_gap[r] the longest run of FROM_L moves, and sum_em[r] the
// pairs' f32 emissions (the fill's arithmetic) summed in double in walk
// order, as the C's QC does (align.c:443-460).  The host's QC is then a
// division and three compares a read (ops/abea.py decode).  All of it is
// bit-equal to the oracle and to the plain version (ops/abea.py
// abea_walk_plain).
//
// Design.  A walk is one chain: each step reads bll_e of its band and then
// the trace byte at the offset it gives, and the next band depends on that
// byte.  From the trace in device memory (~1 GB on the main path, far past
// the 50 MB L2) that is two dependent DRAM latencies a step.  Here one
// warp walks a read (a block of one warp, reads longest first) and every
// step reads shared memory only:
//   - the band row ce + ck + 2 falls by 1 or 2 a step and ce, ck never
//     rise, so the walk goes through fixed windows of kRows band rows
//     (global rows kRows w .. kRows w + kRows - 1) in order, never
//     skipping one, and while it is in window w-1 after entering window w
//     at (ce, ck), its events and k-mers lie in (ce - 2 kRows, ce] and
//     (ck - 2 kRows, ck];
//   - so on entering window w the warp copies window w-1 into the other of
//     two shared-memory slots with cp.async (its kRows trace rows, one
//     contiguous block of 100 kRows bytes, and their bll_e, 16 bytes a lane
//     a copy; the 2 kRows events and k-mer values of (gm, stdv, lstdv)
//     ending at ce and ck, 4 bytes a copy), and walks window w from the
//     slot it filled one window earlier: a window's copy has the walk of a
//     whole window (kRows/2 to kRows steps) to arrive;
//   - all 32 lanes walk in step (the same shared addresses: broadcasts); a
//     step loads the trace byte and, beside it, bll_e of the two rows it
//     can go to, so the chain is one shared load and a few integer
//     operations;
//   - lane 0 stages each step's pair in shared memory; at the end of a
//     window the lanes store the staged pairs coalesced and compute their
//     emissions in parallel from the slot's tables (the same f32
//     intrinsics), and the warp adds them into the sum in double in walk
//     order, the only order in which the sum is bit-equal.
//
// Bound.  The bytes it must move are the trace bytes it reads (one a
// step), bll_e (4 a step), the emission's inputs (16 a step) and the pairs
// it writes (8 a step): bound by bytes, far below the chain of dependent
// steps, which bounds this kernel (the longest walk's steps, each a shared
// load and a few integer operations, and a window's tail a window).

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBw = 100;
// band rows a window: a multiple of 4, so that a window's trace and bll_e
// start on 16-byte boundaries; two slots take 36 KB of shared memory
constexpr int kRows = 128;
constexpr int kSpan = 2 * kRows;                // events and k-mers a window's tables hold
constexpr int kTraceChunks = kRows * kBw / 16;  // 16-byte copies of a window's trace
constexpr int kBllChunks = kRows * 4 / 16;      // and of its bll_e
static_assert(kRows % 4 == 0, "windows start on 16-byte boundaries");
constexpr uint8_t kFromD = 0, kFromU = 1;
// the C's -0.918938 as a float, written exactly (bits 0xbf6b3f85)
constexpr float kEmissionC = -0x1.d67f0ap-1f;

__device__ __forceinline__ float emission(float level, float gm, float stdv, float lstdv) {
  const float a = __fdiv_rn(__fsub_rn(level, gm), stdv);
  return __fadd_rn(__fsub_rn(kEmissionC, lstdv), __fmul_rn(__fmul_rn(-0.5f, a), a));
}

// One slot: a window's trace rows and bll_e, and the event and k-mer
// tables from index ev_base and k_base on (entries below index 0 hold
// index 0's).  Aligned so that both slots' trace and bll_e take 16-byte
// copies.
struct alignas(16) Slot {
  uint8_t trace[kRows * kBw];
  int32_t bll[kRows];
  float ev[kSpan], gm[kSpan], sd[kSpan], ls[kSpan];
  int ev_base, k_base;
};

struct Shared {
  Slot slot[2];
  int2 pair[kRows];   // the window's pairs, in walk order
  float em[kRows];    // and their emissions
};

// A read's inputs.
struct Read {
  const uint8_t* __restrict__ trace;
  const int32_t* __restrict__ bll_e;
  const float* __restrict__ ev;
  const float* __restrict__ gm;
  const float* __restrict__ sd;
  const float* __restrict__ ls;
  int64_t row0, row_end;  // the read's global rows [row0, row_end)
};

// Start copying window w (global rows kRows w ..) into `s`, with the tables
// for events (ce - kSpan, ce] and k-mers (ck - kSpan, ck]; only the read's
// own rows are copied (a partial 16-byte chunk at its end is zero-filled).
// Commits one group of copies, empty or not.
__device__ __forceinline__ void fetch(Slot& s, const Read& rd, int64_t w, int ce, int ck,
                                      int lane) {
  const int64_t g0 = w * kRows;
  const int64_t lo = rd.row0 * kBw, hi = rd.row_end * kBw;
  for (int q = lane; q < kTraceChunks; q += 32) {
    const int64_t at = g0 * kBw + 16 * q;
    if (at + 16 > lo && at < hi)
      __pipeline_memcpy_async(s.trace + 16 * q, rd.trace + at, 16,
                              at + 16 > hi ? static_cast<size_t>(at + 16 - hi) : 0);
  }
  for (int q = lane; q < kBllChunks; q += 32) {
    const int64_t at = g0 + 4 * q;  // in int32 entries
    if (at + 4 > rd.row0 && at < rd.row_end)
      __pipeline_memcpy_async(s.bll + 4 * q, rd.bll_e + at, 16,
                              at + 4 > rd.row_end ? static_cast<size_t>(4 * (at + 4 - rd.row_end))
                                                  : 0);
  }
  if (lane == 0) {
    s.ev_base = ce - kSpan + 1;
    s.k_base = ck - kSpan + 1;
  }
  for (int t = lane; t < kSpan; t += 32) {
    const int e = max(ce - kSpan + 1 + t, 0), k = max(ck - kSpan + 1 + t, 0);
    __pipeline_memcpy_async(s.ev + t, rd.ev + e, 4);
    __pipeline_memcpy_async(s.gm + t, rd.gm + k, 4);
    __pipeline_memcpy_async(s.sd + t, rd.sd + k, 4);
    __pipeline_memcpy_async(s.ls + t, rd.ls + k, 4);
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(32)
abea_walk_kernel(const uint8_t* __restrict__ trace, const int32_t* __restrict__ bll_e,
                 const int32_t* __restrict__ seed, const float* __restrict__ ev,
                 const float* __restrict__ gm, const float* __restrict__ stdv,
                 const float* __restrict__ lstdv, const int64_t* __restrict__ ev_off,
                 const int64_t* __restrict__ k_off, const int64_t* __restrict__ band_off,
                 const int32_t* __restrict__ ne_r, const int32_t* __restrict__ nk_r,
                 const int32_t* __restrict__ order, int32_t* __restrict__ pairs,
                 int32_t* __restrict__ n_pairs, int32_t* __restrict__ max_gap_out,
                 double* __restrict__ sum_em) {
  extern __shared__ int32_t smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  const int r = order[blockIdx.x];
  const int lane = threadIdx.x;
  const int nk = nk_r[r];
  const Read rd{trace, bll_e, ev + ev_off[r], gm + k_off[r], stdv + k_off[r],
                lstdv + k_off[r], band_off[r], band_off[r] + ne_r[r] + nk + 2};
  int2* __restrict__ out = reinterpret_cast<int2*>(pairs) + rd.row0;

  int ck = nk - 1, ce = seed[r];
  int64_t g = rd.row0 + ce + ck + 2;  // the global band row of (ck, ce)
  int64_t w = g / kRows;
  fetch(sh.slot[w & 1], rd, w, ce, ck, lane);
  fetch(sh.slot[(w - 1) & 1], rd, w - 1, ce, ck, lane);
  __pipeline_wait_prior(1);
  __syncwarp();

  int cnt = 0, gap = 0, max_gap = 0;
  double sum = 0.0;
  for (;;) {
    const Slot& s = sh.slot[w & 1];
    const int64_t base = w * kRows;
    // walk window w: i the row in the window, b its bll_e
    int i = static_cast<int>(g - base), n = 0;
    int b = s.bll[i];
    while (ck >= 0 && ce >= 0 && i >= 0) {
      if (lane == 0) sh.pair[n] = make_int2(ck, ce);
      ++n;
      const int off = min(max(b - ce, 0), kBw - 1);
      const int b1 = s.bll[max(i - 1, 0)], b2 = s.bll[max(i - 2, 0)];
      const uint8_t frm = s.trace[i * kBw + off];
      if (frm == kFromD) {
        --ck;
        --ce;
        gap = 0;
        i -= 2;
        b = b2;
      } else {
        if (frm == kFromU) {
          --ce;
          gap = 0;
        } else {
          --ck;
          ++gap;
          max_gap = max(max_gap, gap);
        }
        --i;
        b = b1;
      }
    }
    g = base + i;
    // the window's pairs out, and their emissions into the sum in walk order
    __syncwarp();
    const int eb = s.ev_base, kb = s.k_base;
    for (int t = lane; t < n; t += 32) {
      const int2 p = sh.pair[t];
      out[cnt + t] = p;
      sh.em[t] = emission(s.ev[p.y - eb], s.gm[p.x - kb], s.sd[p.x - kb], s.ls[p.x - kb]);
    }
    __syncwarp();
    for (int t = 0; t < n; ++t) sum = __dadd_rn(sum, static_cast<double>(sh.em[t]));
    cnt += n;
    if (ck < 0 || ce < 0) break;
    // window w-1 now: copy w-2 into the slot just walked, then wait for w-1
    __syncwarp();
    fetch(sh.slot[w & 1], rd, w - 2, ce, ck, lane);
    __pipeline_wait_prior(1);
    __syncwarp();
    --w;
  }
  __pipeline_wait_prior(0);
  if (lane == 0) {
    n_pairs[r] = cnt;
    max_gap_out[r] = max_gap;
    sum_em[r] = sum;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The fill's trace [R, 100] u8 and bll_e [R] int32 (both 16-byte aligned)
// and seed [n_reads] int32; the flat batch's ev, gm, stdv, lstdv, ev_off,
// k_off, band_off, ne, nk; order (a permutation of the reads).  Outputs:
// pairs [R, 2] int32 (zeroed by the caller), n_pairs and max_gap [n_reads]
// int32, sum_em [n_reads] double.
int abea_walk(const uint8_t* trace, const int32_t* bll_e, const int32_t* seed, const float* ev,
              const float* gm, const float* stdv, const float* lstdv, const int64_t* ev_off,
              const int64_t* k_off, const int64_t* band_off, const int32_t* ne,
              const int32_t* nk, const int32_t* order, int32_t* pairs, int32_t* n_pairs,
              int32_t* max_gap, double* sum_em, int n_reads, void* stream) {
  if (n_reads <= 0) return 0;
  static_assert(sizeof(Shared) <= 48 * 1024, "no opt-in to more shared memory");
  abea_walk_kernel<<<n_reads, 32, sizeof(Shared), static_cast<cudaStream_t>(stream)>>>(
      trace, bll_e, seed, ev, gm, stdv, lstdv, ev_off, k_off, band_off, ne, nk, order, pairs,
      n_pairs, max_gap, sum_em);
  return static_cast<int>(cudaGetLastError());
}

const char* abea_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
