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
// Design.  One thread per testcase: testcases are independent, so there
// is no communication at all.  A thread walks its matrix in stripes of S
// rows; inside a stripe it sweeps the columns 1..haplen and computes the S
// cells of each column top to bottom, keeping the stripe's previous column
// (M, X, Y per row) and its per-row probabilities in registers.  Only the
// stripe's last row goes to global scratch, laid out [col, B] so that
// neighbouring threads touch neighbouring addresses; the next stripe reads
// it back as its row above.  Cells past rslen or haplen are never read
// into a result: the column loop stops at haplen, the sum takes only row
// rslen, and rows past rslen in the last stripe feed nothing.
//
// Bound.  Each cell does 12 floating-point operations (8 multiplies, 4
// adds: 6 for M, 3 for X, 3 for Y) plus the match test, and the function
// moves only ~6 bytes per row and 1 per column of input, so it is bound by
// operations, not bytes.  This first design does nothing clever about
// that: with S rows in registers the scratch traffic is 6*sizeof(T)/S
// bytes per cell, which stays in L2, and the time goes to the dependent
// chain of each thread's cells and to occupancy (one warp per 32
// testcases; a bench batch of 8192 fills ~2 warps per SM).  The known
// remedy is a warp-level wavefront (one testcase per warp, anti-diagonals
// across lanes, gpuPairHMM arXiv 2411.11547), left for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAmbig = 4;
constexpr int kMaxThreads = 128;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// rows per stripe: registers per row are ~12 values of T
template <typename T> struct StripeRows;
template <> struct StripeRows<float> { static constexpr int value = 8; };
template <> struct StripeRows<double> { static constexpr int value = 4; };

template <typename T, int S>
__global__ void __launch_bounds__(kMaxThreads)
phmm_forward_kernel(const int8_t* __restrict__ rs_row, const int8_t* __restrict__ q,
                    const int8_t* __restrict__ iq, const int8_t* __restrict__ dq,
                    const int8_t* __restrict__ cq, const int8_t* __restrict__ hap,
                    const int32_t* __restrict__ rslen, const int32_t* __restrict__ haplen,
                    const T* __restrict__ init_y, const T* __restrict__ ph2pr,
                    const T* __restrict__ one_m_ph2pr, const T* __restrict__ ph2pr_div3,
                    const T* __restrict__ m2m, T* __restrict__ scratch, T* __restrict__ out,
                    int batch, int rp, int hp) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int n = rslen[b];
  const int m = haplen[b];
  const T iy = init_y[m];  // INITIAL_CONSTANT / haplen, from the host's table
  const size_t plane = static_cast<size_t>(hp) * batch;
  T* carry_m = scratch;  // a stripe's last row: column c at (c-1)*batch + b
  T* carry_x = scratch + plane;
  T* carry_y = scratch + 2 * plane;
  const int8_t* hrow = hap + static_cast<size_t>(b) * hp;
  const size_t rbase = static_cast<size_t>(b) * rp;

  T sum_m = T(0), sum_x = T(0);
  for (int r0 = 1; r0 <= n; r0 += S) {
    T p_mm[S], p_gapm[S], p_mx[S], p_xx[S], p_my[S], p_yy[S], pr_match[S], pr_mis[S];
    T m_l[S], x_l[S], y_l[S];  // each row's cell in the previous column
    int rs[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int r = r0 + k;
      if (r <= n) {
        const int qi = iq[rbase + r] & 127;
        const int qd = dq[rbase + r] & 127;
        const int qc = cq[rbase + r] & 127;
        const int qq = q[rbase + r] & 127;
        const int lo = min(qi, qd), hi = max(qi, qd);
        p_mm[k] = m2m[((hi * (hi + 1)) >> 1) + lo];
        p_gapm[k] = one_m_ph2pr[qc];
        p_mx[k] = ph2pr[qi];
        p_xx[k] = ph2pr[qc];
        p_my[k] = ph2pr[qd];
        p_yy[k] = ph2pr[qc];
        pr_match[k] = one_m_ph2pr[qq];
        pr_mis[k] = ph2pr_div3[qq];
        rs[k] = rs_row[rbase + r];
      } else {  // past the read: computed, never read into a result
        p_mm[k] = p_gapm[k] = p_mx[k] = p_xx[k] = p_my[k] = p_yy[k] = T(0);
        pr_match[k] = pr_mis[k] = T(0);
        rs[k] = -1;
      }
      m_l[k] = x_l[k] = y_l[k] = T(0);  // column 0
    }
    const bool first = r0 == 1;
    const bool feeds_next = r0 + S <= n;
    const int last = n - r0;  // stripe row of row rslen (>= S: not here)
    // row r0-1 at column c-1: the diagonal input of the stripe's first row
    T m_dg = T(0), x_dg = T(0), y_dg = first ? iy : T(0);
    for (int c = 1; c <= m; ++c) {
      const int h = hrow[c - 1];
      T m_up = T(0), x_up = T(0), y_up = iy;  // row r0-1 at column c
      const size_t o = static_cast<size_t>(c - 1) * batch + b;
      if (!first) {
        m_up = carry_m[o];
        x_up = carry_x[o];
        y_up = carry_y[o];
      }
      T md = m_dg, xd = x_dg, yd = y_dg, mu = m_up, xu = x_up;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const bool match = (rs[k] == h) | (rs[k] == kAmbig) | (h == kAmbig);
        const T prior = match ? pr_match[k] : pr_mis[k];
        const T mn = mul_rn(prior, add_rn(add_rn(mul_rn(md, p_mm[k]), mul_rn(xd, p_gapm[k])),
                                          mul_rn(yd, p_gapm[k])));
        const T xn = add_rn(mul_rn(mu, p_mx[k]), mul_rn(xu, p_xx[k]));
        const T yn = add_rn(mul_rn(m_l[k], p_my[k]), mul_rn(y_l[k], p_yy[k]));
        md = m_l[k];  // the next row's diagonal input is this row at c-1
        xd = x_l[k];
        yd = y_l[k];
        mu = mn;  // and its upper input this row at c
        xu = xn;
        m_l[k] = mn;
        x_l[k] = xn;
        y_l[k] = yn;
        if (k == last) {
          sum_m = add_rn(sum_m, mn);
          sum_x = add_rn(sum_x, xn);
        }
      }
      m_dg = m_up;
      x_dg = x_up;
      y_dg = y_up;
      if (feeds_next) {  // read above, written here: same thread, same column
        carry_m[o] = m_l[S - 1];
        carry_x[o] = x_l[S - 1];
        carry_y[o] = y_l[S - 1];
      }
    }
  }
  out[b] = add_rn(sum_m, sum_x);
}

template <typename T>
int launch(const int8_t* rs_row, const int8_t* q, const int8_t* iq, const int8_t* dq,
           const int8_t* cq, const int8_t* hap, const int32_t* rslen, const int32_t* haplen,
           const T* init_y, const T* ph2pr, const T* one_m_ph2pr, const T* ph2pr_div3,
           const T* m2m, T* scratch, T* out, int batch, int rp, int hp, void* stream) {
  if (batch <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // small blocks while the batch is too small to give every SM two blocks
  int threads = kMaxThreads;
  while (threads > 32 && (batch + threads - 1) / threads < 2 * sms) threads /= 2;
  const int blocks = (batch + threads - 1) / threads;
  phmm_forward_kernel<T, StripeRows<T>::value>
      <<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          rs_row, q, iq, dq, cq, hap, rslen, haplen, init_y, ph2pr, one_m_ph2pr, ph2pr_div3,
          m2m, scratch, out, batch, rp, hp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// init_y: hp + 1 entries; scratch: 3 * hp * batch elements of the working type.
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
