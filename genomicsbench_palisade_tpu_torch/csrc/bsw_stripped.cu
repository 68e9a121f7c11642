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
//   F   = max(max_{k<j} g_k - (j-1)*e_ins, 0)       (F_0 = 0)
//   E'  = max(E[j] - e_del, max(M - oe_del, 0))
//   H'[j] = max(H0, F) of row j-1, H'[0] = 0          (the one-sublane roll)
// and writes the final H and E, [2, qe_pad, batch].  The Pallas kernel
// returned H's first 8 rows only; those rows depend on nothing past query
// row 7 (F and the roll flow to larger j, E stays in its row), so a kernel
// that returned them could skip ~94% of the cells, and the probe would time
// nothing.  Every add and subtract that can wrap is done in uint32 and read
// back as int32: from a start near INT32_MAX the Pallas kernel's int32
// arithmetic wraps in two's complement, and signed overflow is undefined in
// C++.  So the result equals the Pallas kernel's (interpret mode) and the
// plain version's bit for bit from any start.
//
// F is the running maximum of the clamped g, one step a query row: it is
// the Pallas kernel's cummax read in order.  The shorter form
// r = max(r - e_ins, c), F = max(r, 0) equals it while c + j*e_ins fits in
// int32, but from a start near INT32_MAX with a small E that sum wraps, the
// NEG clamp drops the term, and the shorter form does not.
//
// Design.  The production kernel's layout (csrc/bsw_extend.cu), so that the
// probe's ratio is the bookkeeping and not a change of layout: a thread a
// pair, blocks as small as 32 threads while the batch gives fewer than two
// blocks an SM, target rows in order and query rows in order inside a row.
// The H and E columns live in the output itself, in global memory laid out
// [qe_pad, batch], so neighbouring threads touch neighbouring words, as the
// production kernel's int2 scratch: 136 rows x 8 bytes a pair at the
// probe's shape, 8.9 MB for 8,192 pairs, which stays in L2.  Shared memory
// would hold those columns (62 pairs an SM at that shape), but then the
// ratio would mix a change of memory into the bookkeeping it measures; a
// warp a pair with the F prefix as a shuffle scan is the later redesign of
// both kernels.  The query codes are read where they lie ([qe_pad, batch],
// coalesced); H'[j-1]'s new value and the prefix maximum stay in
// registers.
//
// Bound.  Per cell 19 int32 operations: score 2 (compare, select), M 3
// (test, add, select), H0 1, c 2, g 2 (add, clamp), the prefix max 1, F 2
// (subtract, clamp), j*e_ins 1, H 1, E 4 (subtract, subtract, clamp, max);
// address arithmetic and loads are not counted.  The bytes are 4 a query
// row and a target row of a pair in, and 8 a query row of H/E in and out:
// ~30 MB at the probe's shape against ~5.7 G operations, so on the card
// the function is bound by operations.  This kernel is bound by latency:
// each thread's cells form one dependent chain along j (the prefix max and
// H'[j-1]) and its rows along i (H/E through L1/L2), with 8,192 threads on
// 132 SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 128;
constexpr int32_t kNeg = -(1 << 20);

struct Params {
  int o_del, e_del, o_ins, e_ins, match, mismatch;
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__global__ void __launch_bounds__(kMaxThreads)
bsw_stripped_kernel(const int32_t* __restrict__ q_codes, const int32_t* __restrict__ target,
                    const int32_t* __restrict__ h_init, const int32_t* __restrict__ e_init,
                    int32_t* __restrict__ out, int qe_pad, int tp, int batch, Params p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const size_t stride = static_cast<size_t>(batch);
  const int32_t* __restrict__ qs = q_codes + b;
  int32_t* __restrict__ hs = out + b;
  int32_t* __restrict__ es = out + static_cast<size_t>(qe_pad) * stride + b;
  for (int j = 0; j < qe_pad; ++j) {
    hs[j * stride] = h_init[j * stride + b];
    es[j * stride] = e_init[j * stride + b];
  }
  const int32_t oe_del = wadd(p.o_del, p.e_del);
  const int32_t oe_ins = wadd(p.o_ins, p.e_ins);
  for (int i = 0; i < tp; ++i) {
    const int32_t tc = target[i * stride + b];
    int32_t prev = 0;          // max(H0, F) of row j-1: H'[j]
    int32_t gmax = kNeg;       // max over k < j of g_k
    int32_t jm1e = -p.e_ins;   // (j-1) * e_ins
    for (int j = 0; j < qe_pad; ++j) {
      const size_t at = j * stride;
      const int32_t h = hs[at];
      const int32_t e = es[at];
      const int32_t qsc = qs[at] == tc ? p.match : -p.mismatch;
      const int32_t m = h != 0 ? wadd(h, qsc) : 0;
      const int32_t h0 = max(m, e);
      const int32_t f = max(wsub(gmax, jm1e), 0);
      const int32_t je = wadd(jm1e, p.e_ins);
      const int32_t c = max(wsub(m, oe_ins), 0);
      gmax = max(gmax, max(wadd(c, je), kNeg));
      jm1e = je;
      es[at] = max(wsub(e, p.e_del), max(wsub(m, oe_del), 0));
      hs[at] = prev;
      prev = max(h0, f);
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// q_codes, h_init, e_init: int32 [qe_pad, batch]; target: int32 [tp,
// batch]; out: int32 [2, qe_pad, batch], the final H then E.
int bsw_stripped(const int32_t* q_codes, const int32_t* target, const int32_t* h_init,
                 const int32_t* e_init, int32_t* out, int qe_pad, int tp, int batch, int o_del,
                 int e_del, int o_ins, int e_ins, int match, int mismatch, void* stream) {
  if (batch <= 0 || qe_pad <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // csrc/bsw_extend.cu's rule: small blocks while the batch is too small to
  // give every SM two blocks
  int threads = kMaxThreads;
  while (threads > 32 && (batch + threads - 1) / threads < 2 * sms) threads /= 2;
  const int blocks = (batch + threads - 1) / threads;
  const Params p{o_del, e_del, o_ins, e_ins, match, mismatch};
  bsw_stripped_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      q_codes, target, h_init, e_init, out, qe_pad, tp, batch, p);
  return static_cast<int>(cudaGetLastError());
}

const char* bsw_stripped_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
