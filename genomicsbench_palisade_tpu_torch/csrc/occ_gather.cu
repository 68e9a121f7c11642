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
// words).  Each thread takes indices i0, i0 + stride, ... and loads a row
// as four 16-byte read-only vector loads; it issues the loads of
// kRowsInFlight rows (2 or 8, the probe's nslots) before folding any, so
// that many misses are outstanding a thread.  The fold ends with an XOR
// shuffle across the warp and one atomicXor a warp a word.  Every one of
// the n indices is folded (the Pallas grid dropped the last n % 512).
//
// occ_gather_tile: out[0..63] = XOR over i of the 8 rows starting at row
// 8 * (idx[i] >> 3), the 512-byte tile the Pallas probe moved whole.  A warp
// reads one tile as 32 lanes x 16 bytes (one coalesced request) and keeps
// kGroup = 8 tiles in flight; lane q folds bytes 16q..16q+15 of every tile
// and ends with one atomicXor a word.  The table's row count must be a
// multiple of 8.
//
// Bound.  Each kernel must read its indices (4 bytes each) and the rows
// they pick (64 or 512 bytes each) and write 64 or 512 bytes: bound by
// bytes, at device-memory bandwidth if every row is a cold miss.  Rows
// picked at random from a table past the 50 MB L2 are: the question the
// probe answers is how close random 64-byte reads come to that bound.
//
// An index outside the table stops the kernel (__trap, like a device-side
// assert): the launch then fails at the next synchronisation.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int kRowsInFlight>
__global__ void __launch_bounds__(kThreads)
occ_gather_row_kernel(const longlong2* __restrict__ table, const int32_t* __restrict__ idx,
                      int64_t n, int64_t rows, unsigned long long* __restrict__ out) {
  unsigned long long acc[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) acc[w] = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i0 < n;
       i0 += stride * kRowsInFlight) {
    longlong2 v[kRowsInFlight][4];
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      const int64_t i = i0 + r * stride;
      if (i < n) {
        const int32_t row = __ldg(idx + i);
        if (row < 0 || row >= rows) __trap();
        const longlong2* p = table + static_cast<int64_t>(row) * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) v[r][q] = __ldg(p + q);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[r][q] = make_longlong2(0, 0);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[2 * q] ^= static_cast<unsigned long long>(v[r][q].x);
        acc[2 * q + 1] ^= static_cast<unsigned long long>(v[r][q].y);
      }
    }
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[w] ^= __shfl_xor_sync(kFull, acc[w], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int w = 0; w < 8; ++w) atomicXor(out + w, acc[w]);
  }
}

__global__ void __launch_bounds__(kThreads)
occ_gather_tile_kernel(const longlong2* __restrict__ table, const int32_t* __restrict__ idx,
                       int64_t n, int64_t rows, unsigned long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  unsigned long long acc0 = 0, acc1 = 0;
  for (int64_t i0 = warp * kGroup; i0 < n; i0 += warps * kGroup) {
    longlong2 v[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int64_t i = i0 + g;
      if (i < n) {
        const int32_t row = __ldg(idx + i);
        if (row < 0 || row >= rows) __trap();
        // tile row >> 3 is 32 longlong2 (512 bytes) long: lane q reads its 16 bytes
        v[g] = __ldg(table + static_cast<int64_t>(row >> 3) * 32 + lane);
      } else {
        v[g] = make_longlong2(0, 0);
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      acc0 ^= static_cast<unsigned long long>(v[g].x);
      acc1 ^= static_cast<unsigned long long>(v[g].y);
    }
  }
  atomicXor(out + 2 * lane, acc0);
  atomicXor(out + 2 * lane + 1, acc1);
}

// enough blocks to fill the card, fewer when n is small; the loops stride
int grid_for(int64_t n, int64_t per_block) {
  const int64_t want = (n + per_block - 1) / per_block;
  return static_cast<int>(want < 132 * 8 ? want : 132 * 8);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// table: int64 [rows, 8] (64-byte rows); idx: int32 [n], each in [0, rows);
// out: 8 int64, zeroed by the caller.  rows_in_flight: 2 or 8.
int occ_gather_row(const void* table, const int32_t* idx, int64_t n, int64_t rows,
                   int rows_in_flight, unsigned long long* out, void* stream) {
  if (rows_in_flight != 2 && rows_in_flight != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const longlong2*>(table);
  if (rows_in_flight == 2) {
    occ_gather_row_kernel<2><<<grid_for(n, kThreads * 2), kThreads, 0, s>>>(t, idx, n, rows, out);
  } else {
    occ_gather_row_kernel<8><<<grid_for(n, kThreads * 8), kThreads, 0, s>>>(t, idx, n, rows, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// table: int64 [rows, 8], rows a multiple of 8; idx: int32 [n] in [0, rows);
// out: 64 int64 (one 512-byte tile), zeroed by the caller.
int occ_gather_tile(const void* table, const int32_t* idx, int64_t n, int64_t rows,
                    unsigned long long* out, void* stream) {
  if (rows % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  occ_gather_tile_kernel<<<grid_for(n, (kThreads / 32) * kGroup), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const longlong2*>(table), idx, n, rows, out);
  return static_cast<int>(cudaGetLastError());
}

const char* occ_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
