// Random occ-row gathers: the XOR fold of the 64-byte rows (or of the
// 512-byte groups of 8 rows) of a table picked by an index list.
//
// Replaces tools/occ_gather_experiment.py:_kernel (wrapper dma_gather_xor)
// and :_bw_kernel (wrapper dma_bw_xor).  Those Pallas probes kept the FM
// index's occ table (one 64-byte CP_OCC row a block of 64 BWT positions)
// in HBM packed 8 rows to a 512-byte tile row, streamed 512 indices a grid
// step through SMEM and issued one tile-row DMA an index with 2 or 8 (row
// probe) or 32 (tile probe) copies in flight, folding the landed rows with
// XOR so that no fetch could be elided.  The gather is the only memory
// traffic of the fmi engine's occ lookup (ops/fmi.py occ_all: two rows a
// lane a backward or forward extension), so these probes give the rate
// that bounds the fmi device engine on this card.
//
// occ_gather_row: out[0..7] = XOR over i < n of table[idx[i]][0..7] (int64
// words).  occ_gather_tile: out[0..63] = XOR over i of the 8 rows starting
// at row 8 * (idx[i] >> 3), the 512-byte tile the Pallas probe moved whole
// (the table's row count is a multiple of 8).  Every one of the n indices
// is folded (the Pallas grid dropped the last n % 512), and every index's
// row or tile is fetched from device memory: no sort, no de-duplication,
// no cancelling of rows picked an even number of times, and no reuse
// across indices beyond what the caches give a gather in random order.
//
// Design.  occ_gather_row: 4 lanes share a row, 16 bytes each, so one
// warp load instruction reads 8 whole rows (one request a row, where a
// thread a row took four, each touching 32 rows).  A warp reads 8 * DEPTH
// indices coalesced, hands each quad of lanes its rows by shuffles and
// issues DEPTH loads a lane (DEPTH rows in flight a quad, 8 * DEPTH a warp)
// before folding any.  occ_gather_tile: a warp a tile (32 lanes x 16
// bytes, one coalesced 512-byte request), DEPTH tiles in flight a warp.
// Each lane folds 16 bytes (its quarter of a row, or its sixteenth of a
// tile) and the warp ends with XOR shuffles and one atomicXor a word.
// DEPTH comes from ops/occ_gather.py's LAYOUTS table as -DOCC_<ROW2|ROW8|
// TILE>_DEPTH (the source has no defaults), measured on the card by
// tools/gather_lanes.py.  Four blocks an SM, plain __ldg loads: blocks 8,
// loads that skip L1 allocation or set an L2 fetch size, and bulk copies
// (cp.async.bulk into a shared ring with mbarriers) were measured and won
// nothing (PERF.md).
//
// Bound.  Each kernel must read its indices (4 bytes each) and the rows
// they pick (64 or 512 bytes each) and write 64 or 512 bytes: bound by
// bytes, at device-memory bandwidth if every row is a cold miss.  The
// distinct rows picked are the least it could read; a gather that fetches
// every pick, as this one must, reads n rows (the fetch floor).
//
// An index outside the table stops the kernel (__trap, like a device-side
// assert): the launch then fails at the next synchronisation.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlocksPerSm = 4;

__device__ __forceinline__ void fold(ulonglong2& acc, const ulonglong2& v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
}

__device__ __forceinline__ void check_row(int32_t row, int64_t rows) {
  if (row < 0 || row >= rows) __trap();
}

// the warp's folds into out: lanes that hold the same 16 bytes of a row
// (lane & 3 for rows) or of a tile (every lane its own) XOR across the warp
template <int kParts>
__device__ __forceinline__ void flush(ulonglong2 acc, unsigned long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = kParts; off < 32; off <<= 1) {
    acc.x ^= __shfl_xor_sync(kFull, acc.x, off);
    acc.y ^= __shfl_xor_sync(kFull, acc.y, off);
  }
  if (lane < kParts) {
    atomicXor(out + 2 * lane, acc.x);
    atomicXor(out + 2 * lane + 1, acc.y);
  }
}

// lane l reads part l & 3 of row slot l >> 2; a step of the warp takes
// 8 * D indices, D rows a quad
template <int D>
__global__ void __launch_bounds__(kThreads)
occ_gather_row_kernel(const ulonglong2* __restrict__ table, const int32_t* __restrict__ idx,
                      int64_t n, int64_t rows, unsigned long long* __restrict__ out) {
  constexpr int kStep = 8 * D;
  constexpr int kIdxRegs = (kStep + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int q = lane & 3, s = lane >> 2;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  ulonglong2 acc{0, 0};
  for (int64_t base = warp * kStep; base < n; base += warps * kStep) {
    int32_t iv[kIdxRegs];
#pragma unroll
    for (int m = 0; m < kIdxRegs; ++m) {
      const int64_t i = base + 32 * m + lane;
      iv[m] = 32 * m + lane < kStep && i < n ? idx[i] : 0;
    }
    ulonglong2 v[D];
#pragma unroll
    for (int t = 0; t < D; ++t) {
      // slot t * 8 + s of the step: lane (t % 4) * 8 + s of index register t / 4
      const int32_t row = __shfl_sync(kFull, iv[t / 4], (t % 4) * 8 + s);
      if (base + t * 8 + s < n) {
        check_row(row, rows);
        v[t] = __ldg(table + static_cast<int64_t>(row) * 4 + q);
      } else {
        v[t] = ulonglong2{0, 0};
      }
    }
#pragma unroll
    for (int t = 0; t < D; ++t) fold(acc, v[t]);
  }
  flush<4>(acc, out);
}

// a warp a tile, lane l its 16 bytes l; D tiles in flight a warp
template <int D>
__global__ void __launch_bounds__(kThreads)
occ_gather_tile_kernel(const ulonglong2* __restrict__ table, const int32_t* __restrict__ idx,
                       int64_t n, int64_t rows, unsigned long long* __restrict__ out) {
  static_assert(D <= 32, "a lane reads one index of the step");
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  ulonglong2 acc{0, 0};
  for (int64_t i0 = warp * D; i0 < n; i0 += warps * D) {
    const int32_t mine = i0 + lane < n && lane < D ? idx[i0 + lane] : 0;
    ulonglong2 v[D];
#pragma unroll
    for (int g = 0; g < D; ++g) {
      const int32_t row = __shfl_sync(kFull, mine, g);
      if (i0 + g < n) {
        check_row(row, rows);
        // tile row >> 3 is 32 ulonglong2 (512 bytes) long: lane l reads its 16 bytes
        v[g] = __ldg(table + static_cast<int64_t>(row >> 3) * 32 + lane);
      } else {
        v[g] = ulonglong2{0, 0};
      }
    }
#pragma unroll
    for (int g = 0; g < D; ++g) fold(acc, v[g]);
  }
  flush<32>(acc, out);
}

}  // namespace

namespace {

// the kernel of a launch: rows (8 * D indices a warp step) or tiles (D)
template <bool kTile, int D>
cudaError_t launch(const void* table, const int32_t* idx, int64_t n, int64_t rows,
                   unsigned long long* out, cudaStream_t s) {
  static_assert(D >= 1, "a depth of at least 1");
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t per_block = kWarps * (kTile ? D : 8 * D);
  const int64_t want = (n + per_block - 1) / per_block;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  const auto* t = static_cast<const ulonglong2*>(table);
  if constexpr (kTile) {
    occ_gather_tile_kernel<D><<<grid, kThreads, 0, s>>>(t, idx, n, rows, out);
  } else {
    occ_gather_row_kernel<D><<<grid, kThreads, 0, s>>>(t, idx, n, rows, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// table: int64 [rows, 8] (64-byte rows); idx: int32 [n], each in [0, rows);
// out: 8 int64, zeroed by the caller.  rows_in_flight: 2 or 8, the depth
// OCC_ROW2_DEPTH or OCC_ROW8_DEPTH (rows in flight a quad of lanes).
int occ_gather_row(const void* table, const int32_t* idx, int64_t n, int64_t rows,
                   int rows_in_flight, unsigned long long* out, void* stream) {
  if (rows_in_flight != 2 && rows_in_flight != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = rows_in_flight == 2
                              ? launch<false, OCC_ROW2_DEPTH>(table, idx, n, rows, out, s)
                              : launch<false, OCC_ROW8_DEPTH>(table, idx, n, rows, out, s);
  return static_cast<int>(err);
}

// table: int64 [rows, 8], rows a multiple of 8; idx: int32 [n] in [0, rows);
// out: 64 int64 (one 512-byte tile), zeroed by the caller.  OCC_TILE_DEPTH
// tiles in flight a warp.
int occ_gather_tile(const void* table, const int32_t* idx, int64_t n, int64_t rows,
                    unsigned long long* out, void* stream) {
  if (rows % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  return static_cast<int>(
      launch<true, OCC_TILE_DEPTH>(table, idx, n, rows, out, static_cast<cudaStream_t>(stream)));
}

const char* occ_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
