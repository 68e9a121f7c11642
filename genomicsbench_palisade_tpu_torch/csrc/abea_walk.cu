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
// Design.  One thread a read, 32 to a block, reads in order of length
// (`order`, longest first) so that warp-mates walk about as far.  A walk
// is one dependent chain: each step loads bll_e[band] and then the trace
// byte at the offset it gives, and the next band depends on that byte, so
// a step costs two dependent loads from a trace that does not fit in L2
// (~1 GB on the main path; the bands descend, so bll_e's loads share cache
// lines); the emission's four loads do not depend on the byte and overlap
// it.
//
// Bound.  The bytes it must move are the trace bytes it reads (one a
// step), bll_e (4 a step), the emission's inputs (16 a step) and the pairs
// it writes (8 a step): bound by bytes, far below the latency of the
// dependent loads, which bound this kernel (the longest walk's steps times
// two memory latencies).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBw = 100;
constexpr int kThreads = 32;
constexpr uint8_t kFromD = 0, kFromU = 1;
// the C's -0.918938 as a float, written exactly (bits 0xbf6b3f85)
constexpr float kEmissionC = -0x1.d67f0ap-1f;

__device__ __forceinline__ float emission(float level, float gm, float stdv, float lstdv) {
  const float a = __fdiv_rn(__fsub_rn(level, gm), stdv);
  return __fadd_rn(__fsub_rn(kEmissionC, lstdv), __fmul_rn(__fmul_rn(-0.5f, a), a));
}

__global__ void __launch_bounds__(kThreads)
abea_walk_kernel(const uint8_t* __restrict__ trace, const int32_t* __restrict__ bll_e,
                 const int32_t* __restrict__ seed, const float* __restrict__ ev,
                 const float* __restrict__ gm, const float* __restrict__ stdv,
                 const float* __restrict__ lstdv, const int64_t* __restrict__ ev_off,
                 const int64_t* __restrict__ k_off, const int64_t* __restrict__ band_off,
                 const int32_t* __restrict__ nk_r, const int32_t* __restrict__ order,
                 int32_t* __restrict__ pairs, int32_t* __restrict__ n_pairs,
                 int32_t* __restrict__ max_gap_out, double* __restrict__ sum_em,
                 int n_reads) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_reads) return;
  const int r = order[t];
  const float* __restrict__ evr = ev + ev_off[r];
  const float* __restrict__ gmr = gm + k_off[r];
  const float* __restrict__ sdr = stdv + k_off[r];
  const float* __restrict__ lsr = lstdv + k_off[r];
  const int64_t row0 = band_off[r];
  int2* __restrict__ out = reinterpret_cast<int2*>(pairs) + row0;

  int ck = nk_r[r] - 1, ce = seed[r];
  int cnt = 0, gap = 0, max_gap = 0;
  double sum = 0.0;
  while (ck >= 0 && ce >= 0) {
    out[cnt++] = make_int2(ck, ce);
    sum = __dadd_rn(sum, static_cast<double>(emission(evr[ce], gmr[ck], sdr[ck], lsr[ck])));
    const int64_t row = row0 + ce + ck + 2;
    const int off = min(max(bll_e[row] - ce, 0), kBw - 1);
    const uint8_t frm = trace[row * kBw + off];
    if (frm == kFromD) {
      --ck;
      --ce;
      gap = 0;
    } else if (frm == kFromU) {
      --ce;
      gap = 0;
    } else {
      --ck;
      ++gap;
      max_gap = max(max_gap, gap);
    }
  }
  n_pairs[r] = cnt;
  max_gap_out[r] = max_gap;
  sum_em[r] = sum;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The fill's trace [R, 100] u8, bll_e [R] and seed [n_reads] int32; the
// flat batch's ev, gm, stdv, lstdv, ev_off, k_off, band_off, nk; order (a
// permutation of the reads).  Outputs: pairs [R, 2] int32 (zeroed by the
// caller), n_pairs and max_gap [n_reads] int32, sum_em [n_reads] double.
int abea_walk(const uint8_t* trace, const int32_t* bll_e, const int32_t* seed, const float* ev,
              const float* gm, const float* stdv, const float* lstdv, const int64_t* ev_off,
              const int64_t* k_off, const int64_t* band_off, const int32_t* nk,
              const int32_t* order, int32_t* pairs, int32_t* n_pairs, int32_t* max_gap,
              double* sum_em, int n_reads, void* stream) {
  if (n_reads <= 0) return 0;
  const int blocks = (n_reads + kThreads - 1) / kThreads;
  abea_walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      trace, bll_e, seed, ev, gm, stdv, lstdv, ev_off, k_off, band_off, nk, order, pairs,
      n_pairs, max_gap, sum_em, n_reads);
  return static_cast<int>(cudaGetLastError());
}

const char* abea_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
