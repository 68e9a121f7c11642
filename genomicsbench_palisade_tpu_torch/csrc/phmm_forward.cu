// PairHMM forward pass over a batch of independent read x hap testcases.
//
// Replaces genomicsbench_palisade_tpu/ops/phmm_pallas.py:_kernel (the TPU's
// striped anti-diagonal wavefront).  Templated on float (the main pass) and
// double (the fallback for testcases whose float result underflows).
//
// What it computes, per testcase b (ROWS = rslen+1, COLS = haplen+1):
//   M[r][c] = prior * ((M[r-1][c-1]*pMM + X[r-1][c-1]*pGAPM) + Y[r-1][c-1]*pGAPM)
//   X[r][c] = M[r-1][c]*pMX + X[r-1][c]*pXX
//   Y[r][c] = M[r][c-1]*pMY + Y[r][c-1]*pYY
// with row 0: M = X = 0, Y = init_y (columns 0..haplen); column 0 of rows
// >= 1 all zero; prior = match ? 1-distm : distm/3, match = equal codes or
// either code N (4).  Result: the last row's M and X summed into two
// accumulators over columns 1..haplen in ascending order, then added.
// This is the association of ops/oracle/phmm.py:172-190, and every
// multiply and add rounds on its own (__fmul_rn/__fadd_rn and the double
// forms, which never contract into an FMA; the build adds -fmad=false), so
// the result is bit-equal to the oracle.  Every per-row probability is a
// lookup in a table built by numpy in the working type (ph2pr, 1-ph2pr,
// ph2pr/3, matchToMatch), and so is init_y[haplen] = INITIAL_CONSTANT /
// haplen: there is no division on the device.
//
// Design.  A group of L lanes (8, 16 or a whole warp of 32) takes one
// testcase, and lane l owns S consecutive rows of it: a tile of L*S rows.
// A lane keeps its rows' per-row probabilities (pMM, pGAPM, pMX, pXX = pYY,
// pMY, 1-distm, distm/3), read codes and M/X/Y at the previous column in
// registers, and at step t computes column c = t - l + 1 of its S rows top
// to bottom: an anti-diagonal wavefront across the lanes.
//  - The row above a lane's first row, at columns c and c-1, is the lane
//    above's last row from this step and the step before: one
//    __shfl_up_sync a step for each of M, X and Y.  Lane 0's row above is
//    row 0 (M = X = 0, Y = init_y) in the first tile.
//  - Row rslen always falls on a lane's last row: the rows are shifted down
//    by pad = (S - rslen % S) % S virtual rows at the top of lane 0, which
//    pass row 0 through unchanged (pMX = pMY = pMM = pGAPM = 0, pXX = pYY =
//    1, both priors 0, Y starting at init_y: M = 0*(...) = 0, X = 0*M + X =
//    0, Y = 0*M + Y*1 = init_y, exactly).  So no lane computes a row past
//    rslen, lanes past it idle, and the lane that holds row rslen adds its
//    last row's M and X into the two accumulators as it goes, in ascending
//    column order.
//  - The hap code of column c is read from global memory (L1) a step ahead.
//  - A testcase with more than L*S rows (rp - 1 above the instance's tile)
//    walks its tiles in order; the last lane of a tile writes its last row
//    (M, X, Y at every column) to a carry that lane 0 of the next tile reads
//    as its row above.  The carry lives in shared memory (3*hp values a
//    testcase) when a block's fits in kMaxSmem bytes, otherwise in a global
//    buffer of 3*hp values a testcase that the caller allocates
//    (phmm_forward_scratch says how many).  A lane reads a carry column two
//    steps before any lane of the same tile overwrites it, and the write
//    depends through the shuffles on the value read.
//  - The kernel has one instance a row edge (64, 128, 256, 512 rows); the
//    caller's rp (the bucket's r_pad) picks it, so nothing is read back.
//    Rows past the widest instance take more tiles of it.  A group of 8 or
//    16 lanes runs until the slowest of the warp's 4 or 2 testcases stops.
// The double instance at edge 512 takes two tiles of 256 rows: a lane's
// row needs ten values of T in registers (20 registers in double), and 16
// rows a lane would need 320 of the 255 a thread may have.
//
// Bound.  Each cell does 12 floating-point operations (8 multiplies, 4
// adds: 6 for M, 3 for X, 3 for Y) plus the match test, and the function
// moves only ~6 bytes per row and 1 per column of input, so it is bound by
// operations.  With FMA contraction off every one of the 12 is its own
// instruction: 132 SMs x 128 (f32) or 64 (f64) units x 1.98 GHz.  This
// design adds a compare and a select a cell, and a fixed cost a step (three
// shuffles, the hap load, the loop) over the S cells a lane computes; the
// wavefront's ramp (L-1 steps a tile) and rows past rslen in a bucket are
// idle lanes.  Within a step the X chain runs down a lane's S rows (two
// dependent operations a row), and the other warps on the SM hide it.
// ptxas (sm_90a, -fmad=false) gives the default instances 157 (f32 8x8)
// to 240 (f32 8x16, 16x16, 32x16) and 252 (f64 8x8, 16x8, 32x8) registers
// a thread and no spill, so an SM holds 8 to 12 warps.

#include <cstdint>
#include <cuda_runtime.h>

// Lanes a testcase (L) and rows a lane (S) for each row edge and type;
// compile-time constants, the fastest of tools/phmm_lanes.py's sweep on the
// card (PERF.md).  L*S below the edge walks the rows in tiles.
#ifndef PHMM_F32_LANES_64
#define PHMM_F32_LANES_64 8
#endif
#ifndef PHMM_F32_ROWS_64
#define PHMM_F32_ROWS_64 8
#endif
#ifndef PHMM_F32_LANES_128
#define PHMM_F32_LANES_128 8
#endif
#ifndef PHMM_F32_ROWS_128
#define PHMM_F32_ROWS_128 16
#endif
#ifndef PHMM_F32_LANES_256
#define PHMM_F32_LANES_256 16
#endif
#ifndef PHMM_F32_ROWS_256
#define PHMM_F32_ROWS_256 16
#endif
#ifndef PHMM_F32_LANES_512
#define PHMM_F32_LANES_512 32
#endif
#ifndef PHMM_F32_ROWS_512
#define PHMM_F32_ROWS_512 16
#endif
#ifndef PHMM_F64_LANES_64
#define PHMM_F64_LANES_64 8
#endif
#ifndef PHMM_F64_ROWS_64
#define PHMM_F64_ROWS_64 8
#endif
#ifndef PHMM_F64_LANES_128
#define PHMM_F64_LANES_128 16
#endif
#ifndef PHMM_F64_ROWS_128
#define PHMM_F64_ROWS_128 8
#endif
#ifndef PHMM_F64_LANES_256
#define PHMM_F64_LANES_256 32
#endif
#ifndef PHMM_F64_ROWS_256
#define PHMM_F64_ROWS_256 8
#endif
#ifndef PHMM_F64_LANES_512
#define PHMM_F64_LANES_512 32
#endif
#ifndef PHMM_F64_ROWS_512
#define PHMM_F64_ROWS_512 8
#endif

namespace {

constexpr int kAmbig = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory a block may have

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

struct Batch {
  const int8_t* rs_row;
  const int8_t* q;
  const int8_t* iq;
  const int8_t* dq;
  const int8_t* cq;
  const int8_t* hap;
  const int32_t* rslen;
  const int32_t* haplen;
  int batch, rp, hp;
};

template <typename T>
struct Tables {
  const T* init_y;
  const T* ph2pr;
  const T* one_m_ph2pr;
  const T* ph2pr_div3;
  const T* m2m;
};

// max over the warp (all groups run the same number of tiles and steps)
template <int L>
__device__ __forceinline__ int warp_max(int v) {
  if constexpr (L == 32) {
    return v;
  } else {
    return __reduce_max_sync(kFull, v);
  }
}

// carry: 3*hp values a testcase ([M, X, Y][column - 1]) in global memory,
// or null for the block's dynamic shared memory
template <typename T, int L, int S>
__global__ void __launch_bounds__(kThreads)
phmm_forward_kernel(Batch in, Tables<T> tab, T* __restrict__ carry_global, T* __restrict__ out) {
  constexpr int G = 32 / L;  // testcases a warp
  constexpr int kTile = L * S;
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int r = lane & (L - 1);  // lane within the testcase's group
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (warp * G >= in.batch) return;  // the whole warp: no testcase of it exists
  const int64_t b = warp * G + lane / L;
  const bool real = b < in.batch;
  const int n = real ? in.rslen[b] : 0;
  const int m = real ? in.haplen[b] : 0;
  const int hp = in.hp;
  const T iy = tab.init_y[m];  // INITIAL_CONSTANT / haplen, from the host's table
  const int vrows = (n + S - 1) / S * S;  // rows and the virtual rows above them
  const int pad = vrows - n;
  const int tiles = (vrows + kTile - 1) / kTile;
  const int own_tile = (vrows - 1) / kTile;  // row rslen: a lane's last row
  const int own_lane = ((vrows - 1) % kTile) / S;
  T* carry = carry_global != nullptr
                 ? carry_global + b * 3 * static_cast<int64_t>(hp)
                 : reinterpret_cast<T*>(smem) + (threadIdx.x / L) * 3 * static_cast<int64_t>(hp);
  const int8_t* __restrict__ hrow = in.hap + b * hp;
  const int64_t rbase = b * in.rp;

  T sum_m = T(0), sum_x = T(0);
  const int tiles_warp = warp_max<L>(tiles);
  for (int tile = 0; tile < tiles_warp; ++tile) {
    const int lanes_here = min(max(vrows / S - tile * L, 0), L);
    const bool active = r < lanes_here;
    const int row0 = tile * kTile + r * S + 1 - pad;  // the lane's first row
    T p_mm[S], p_gapm[S], p_mx[S], p_xx[S], p_my[S], pr_match[S], pr_mis[S];
    T m_l[S], x_l[S], y_l[S];  // each row's cell in the previous column
    int rs[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int row = row0 + k;
      m_l[k] = x_l[k] = y_l[k] = T(0);  // column 0
      if (active && row >= 1) {
        const int64_t o = rbase + row;
        const int qi = in.iq[o] & 127;
        const int qd = in.dq[o] & 127;
        const int qc = in.cq[o] & 127;
        const int qq = in.q[o] & 127;
        const int lo = min(qi, qd), hi = max(qi, qd);
        p_mm[k] = tab.m2m[((hi * (hi + 1)) >> 1) + lo];
        p_gapm[k] = tab.one_m_ph2pr[qc];
        p_mx[k] = tab.ph2pr[qi];
        p_xx[k] = tab.ph2pr[qc];
        p_my[k] = tab.ph2pr[qd];
        pr_match[k] = tab.one_m_ph2pr[qq];
        rs[k] = in.rs_row[o];
        // a read N matches every hap code: both priors 1-distm
        pr_mis[k] = rs[k] == kAmbig ? pr_match[k] : tab.ph2pr_div3[qq];
      } else {  // a virtual row (row 0 passed through), or a lane with no rows
        p_mm[k] = p_gapm[k] = p_mx[k] = p_my[k] = pr_match[k] = pr_mis[k] = T(0);
        p_xx[k] = T(1);
        rs[k] = -1;
        if (active) y_l[k] = iy;
      }
    }
    const bool own = n > 0 && tile == own_tile && r == own_lane;
    const bool feeds = tile + 1 < tiles && r == L - 1;  // writes the carry
    const bool first = tile == 0;
    // lane 0's row above at column cc: row 0, or the carry of the tile before
    auto top = [&](int cc, T& tm, T& tx, T& ty) {
      if (first) {
        tm = T(0), tx = T(0), ty = iy;
      } else if (cc >= 1 && cc <= m) {
        tm = carry[cc - 1], tx = carry[hp + cc - 1], ty = carry[2 * hp + cc - 1];
      } else {
        tm = tx = ty = T(0);
      }
    };
    // the row above the lane's first row at columns c (up) and c-1 (dg)
    T up_m = T(0), up_x = T(0), up_y = T(0), dg_m = T(0), dg_x = T(0), dg_y = T(0);
    if (r == 0) {
      top(1, up_m, up_x, up_y);
      top(0, dg_m, dg_x, dg_y);
    }
    int h_next = r == 0 && m >= 1 ? hrow[0] : 0;
    const int steps = warp_max<L>(lanes_here > 0 ? m + lanes_here - 1 : 0);
    for (int t = 0; t < steps; ++t) {
      const int c = t - r + 1;
      const int h = h_next;
      const int nxt = t + 1 - r;  // the hap index of the next step's column
      h_next = nxt >= 0 && nxt < m ? hrow[nxt] : 0;
      if (active && c >= 1 && c <= m) {
        const bool h_amb = h == kAmbig;
        T md = dg_m, xd = dg_x, yd = dg_y, mu = up_m, xu = up_x;
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const T prior = ((rs[k] == h) | h_amb) ? pr_match[k] : pr_mis[k];
          const T mn = mul_rn(prior, add_rn(add_rn(mul_rn(md, p_mm[k]), mul_rn(xd, p_gapm[k])),
                                            mul_rn(yd, p_gapm[k])));
          const T xn = add_rn(mul_rn(mu, p_mx[k]), mul_rn(xu, p_xx[k]));
          const T yn = add_rn(mul_rn(m_l[k], p_my[k]), mul_rn(y_l[k], p_xx[k]));
          md = m_l[k];  // the next row's diagonal input is this row at c-1
          xd = x_l[k];
          yd = y_l[k];
          mu = mn;  // and its upper input this row at c
          xu = xn;
          m_l[k] = mn;
          x_l[k] = xn;
          y_l[k] = yn;
        }
        if (own) {
          sum_m = add_rn(sum_m, m_l[S - 1]);
          sum_x = add_rn(sum_x, x_l[S - 1]);
        }
        if (feeds) {
          carry[c - 1] = m_l[S - 1];
          carry[hp + c - 1] = x_l[S - 1];
          carry[2 * hp + c - 1] = y_l[S - 1];
        }
      }
      // the lane below takes this lane's last row at column c as its row
      // above for its next column; lane 0 takes the next column of the top
      const T sm = __shfl_up_sync(kFull, m_l[S - 1], 1, L);
      const T sx = __shfl_up_sync(kFull, x_l[S - 1], 1, L);
      const T sy = __shfl_up_sync(kFull, y_l[S - 1], 1, L);
      dg_m = up_m;
      dg_x = up_x;
      dg_y = up_y;
      if (r == 0) {
        top(c + 1, up_m, up_x, up_y);
      } else {
        up_m = sm;
        up_x = sx;
        up_y = sy;
      }
    }
    __syncwarp();  // the carry written in this tile is read in the next
  }
  if (real && r == (n > 0 ? own_lane : 0)) out[b] = add_rn(sum_m, sum_x);
}

}  // namespace

namespace {

template <typename T, int E> struct Shape;
template <> struct Shape<float, 64> { static constexpr int L = PHMM_F32_LANES_64, S = PHMM_F32_ROWS_64; };
template <> struct Shape<float, 128> { static constexpr int L = PHMM_F32_LANES_128, S = PHMM_F32_ROWS_128; };
template <> struct Shape<float, 256> { static constexpr int L = PHMM_F32_LANES_256, S = PHMM_F32_ROWS_256; };
template <> struct Shape<float, 512> { static constexpr int L = PHMM_F32_LANES_512, S = PHMM_F32_ROWS_512; };
template <> struct Shape<double, 64> { static constexpr int L = PHMM_F64_LANES_64, S = PHMM_F64_ROWS_64; };
template <> struct Shape<double, 128> { static constexpr int L = PHMM_F64_LANES_128, S = PHMM_F64_ROWS_128; };
template <> struct Shape<double, 256> { static constexpr int L = PHMM_F64_LANES_256, S = PHMM_F64_ROWS_256; };
template <> struct Shape<double, 512> { static constexpr int L = PHMM_F64_LANES_512, S = PHMM_F64_ROWS_512; };

// the row edge of the instance that takes rp - 1 rows
int edge_of(int rp) {
  const int rows = rp - 1;
  return rows <= 64 ? 64 : rows <= 128 ? 128 : rows <= 256 ? 256 : 512;
}

// bytes of shared carry a block needs (0: one tile holds every row), and
// whether the carry must go to global memory instead
template <typename T, int E>
size_t carry_bytes(int rp, int hp) {
  constexpr int L = Shape<T, E>::L, S = Shape<T, E>::S;
  const int vrows = (rp - 1 + S - 1) / S * S;  // the most any testcase has
  if (vrows <= L * S) return 0;
  return static_cast<size_t>(kThreads / L) * 3 * hp * sizeof(T);
}

template <typename T>
size_t carry_bytes_for(int rp, int hp) {
  switch (edge_of(rp)) {
    case 64: return carry_bytes<T, 64>(rp, hp);
    case 128: return carry_bytes<T, 128>(rp, hp);
    case 256: return carry_bytes<T, 256>(rp, hp);
    default: return carry_bytes<T, 512>(rp, hp);
  }
}

template <typename T, int E>
cudaError_t launch_edge(const Batch& in, const Tables<T>& tab, T* scratch, T* out,
                        cudaStream_t stream) {
  constexpr int L = Shape<T, E>::L, S = Shape<T, E>::S;
  static_assert(L == 8 || L == 16 || L == 32, "a group is 8, 16 or 32 lanes");
  static_assert(S >= 1, "a lane holds at least one row");
  constexpr int per_block = kThreads / L;  // testcases a block
  const int64_t blocks = (static_cast<int64_t>(in.batch) + per_block - 1) / per_block;
  size_t smem = carry_bytes<T, E>(in.rp, in.hp);
  if (scratch != nullptr) smem = 0;  // the caller's global carry
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;  // needs scratch
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        phmm_forward_kernel<T, L, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  phmm_forward_kernel<T, L, S><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      in, tab, scratch, out);
  return cudaGetLastError();
}

template <typename T>
int launch(const int8_t* rs_row, const int8_t* q, const int8_t* iq, const int8_t* dq,
           const int8_t* cq, const int8_t* hap, const int32_t* rslen, const int32_t* haplen,
           const T* init_y, const T* ph2pr, const T* one_m_ph2pr, const T* ph2pr_div3,
           const T* m2m, T* scratch, T* out, int batch, int rp, int hp, void* stream) {
  if (batch <= 0) return 0;
  const Batch in{rs_row, q, iq, dq, cq, hap, rslen, haplen, batch, rp, hp};
  const Tables<T> tab{init_y, ph2pr, one_m_ph2pr, ph2pr_div3, m2m};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (edge_of(rp)) {
    case 64: err = launch_edge<T, 64>(in, tab, scratch, out, s); break;
    case 128: err = launch_edge<T, 128>(in, tab, scratch, out, s); break;
    case 256: err = launch_edge<T, 256>(in, tab, scratch, out, s); break;
    default: err = launch_edge<T, 512>(in, tab, scratch, out, s); break;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Elements of the working type the global carry needs for a batch of
// `batch` testcases of r_pad rp and h_pad hp: 0 when every testcase fits
// one tile or the block's carry fits in shared memory, else 3 * hp * batch.
long long phmm_forward_scratch(int f64, int batch, int rp, int hp) {
  const size_t smem = f64 ? carry_bytes_for<double>(rp, hp) : carry_bytes_for<float>(rp, hp);
  if (smem <= static_cast<size_t>(kMaxSmem)) return 0;
  return 3LL * hp * batch;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// init_y: hp + 1 entries; scratch: null, or phmm_forward_scratch's elements.
int phmm_forward_f32(const int8_t* rs_row, const int8_t* q, const int8_t* iq, const int8_t* dq,
                     const int8_t* cq, const int8_t* hap, const int32_t* rslen,
                     const int32_t* haplen, const float* init_y, const float* ph2pr,
                     const float* one_m_ph2pr, const float* ph2pr_div3, const float* m2m,
                     float* scratch, float* out, int batch, int rp, int hp, void* stream) {
  return launch<float>(rs_row, q, iq, dq, cq, hap, rslen, haplen, init_y, ph2pr, one_m_ph2pr,
                       ph2pr_div3, m2m, scratch, out, batch, rp, hp, stream);
}

int phmm_forward_f64(const int8_t* rs_row, const int8_t* q, const int8_t* iq, const int8_t* dq,
                     const int8_t* cq, const int8_t* hap, const int32_t* rslen,
                     const int32_t* haplen, const double* init_y, const double* ph2pr,
                     const double* one_m_ph2pr, const double* ph2pr_div3, const double* m2m,
                     double* scratch, double* out, int batch, int rp, int hp, void* stream) {
  return launch<double>(rs_row, q, iq, dq, cq, hap, rslen, haplen, init_y, ph2pr, one_m_ph2pr,
                        ph2pr_div3, m2m, scratch, out, batch, rp, hp, stream);
}

const char* phmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
