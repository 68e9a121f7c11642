"""PairHMM forward-likelihood oracle (GATK/GKL semantics).

The port's own copy of genomicsbench_palisade_tpu/ops/oracle/phmm.py (the
port imports nothing of the JAX package).  It is the ground truth the
port's f32 and f64 forward passes are held to bit for bit.

Semantics source (reference, cited for parity checking — not copied):
  * tools/GKL/src/main/native/pairhmm/Context.h:40-61,95-175
      ph2pr table, Jacobian log table, matchToMatchProb table,
      INITIAL_CONSTANT = 2^120 (float) / 2^1020 (double).
  * tools/GKL/src/main/native/pairhmm/avx-pairhmm-template.h:83-131,181-197
      per-row transition probabilities and the M/X/Y recurrence.
  * tools/GKL/src/main/native/pairhmm/IntelPairHmmCSource.cpp:61-85
      float-first compute with double fallback when result < MIN_ACCEPTED
      (1e-28), final value log10(result) - LOG10_INITIAL_CONSTANT.
  * benchmarks/phmm/pairhmm_common.h:16-45
      base coding A=0 C=1 T=2 G=3 N=4 (note T/G order!), MIN_ACCEPTED.

The recurrence (ROWS = rslen+1, COLS = haplen+1; r indexes read base r-1,
c indexes hap base c-1):

    M[r][c] = prior(r,c) * (pMM[r]*M[r-1][c-1] + pGAPM[r]*(X[r-1][c-1] + Y[r-1][c-1]))
    X[r][c] = pMX[r]*M[r-1][c] + pXX[r]*X[r-1][c]
    Y[r][c] = pMY[r]*M[r][c-1] + pYY[r]*Y[r][c-1]

with row 0: M=X=0, Y=INITIAL_CONSTANT/haplen everywhere; column 0 all zero
for r>=1.  prior = (1-distm[r]) on base match / either-N, distm[r]/3 else.
Result = sum_c(M[ROWS-1][c] + X[ROWS-1][c]).
"""

from __future__ import annotations

import numpy as np

MAX_QUAL = 254
MAX_JACOBIAN_TOLERANCE = 8.0
JACOBIAN_LOG_TABLE_STEP = 0.0001
JACOBIAN_LOG_TABLE_INV_STEP = 1.0 / JACOBIAN_LOG_TABLE_STEP
JACOBIAN_LOG_TABLE_SIZE = int(MAX_JACOBIAN_TOLERANCE / JACOBIAN_LOG_TABLE_STEP) + 1
MIN_ACCEPTED = np.float32(1e-28)

# Base coding used by the phmm benchmark driver: A=0 C=1 T=2 G=3 N=4
# (pairhmm_common.h ConvertChar::init — note T before G).
BASE_CODE = {"A": 0, "C": 1, "T": 2, "G": 3, "N": 4}
AMBIG_CODE = 4


def _make_tables(dtype):
    """ph2pr / jacobian / matchToMatch tables in the given precision."""
    one = dtype(1.0)
    ph2pr = (10.0 ** (-(np.arange(128, dtype=np.float64)) / 10.0)).astype(dtype)
    if dtype == np.float32:
        # Context<float> computes powf in float
        ph2pr = np.power(
            np.float32(10.0), -(np.arange(128, dtype=np.float32)) / np.float32(10.0)
        ).astype(np.float32)

    jac = np.log10(
        1.0 + 10.0 ** (-np.arange(JACOBIAN_LOG_TABLE_SIZE, dtype=np.float64) * JACOBIAN_LOG_TABLE_STEP)
    ).astype(dtype)

    # matchToMatchProb[(i*(i+1)>>1)+j] for 0<=j<=i<=MAX_QUAL
    m2m = np.zeros(((MAX_QUAL + 1) * (MAX_QUAL + 2)) >> 1, dtype=dtype)
    for i in range(MAX_QUAL + 1):
        off = (i * (i + 1)) >> 1
        for j in range(i + 1):
            log10_sum = _approx_log10_sum_log10(
                dtype(-0.1 * i), dtype(-0.1 * j), jac, dtype
            )
            # computed in double then cast (Context.h:55-60); log1p(-1) = -inf
            # -> m2m = 0 is the intended result for saturating qualities
            with np.errstate(divide="ignore"):
                m2m_log10 = np.log1p(-min(1.0, 10.0 ** np.float64(log10_sum))) / np.log(10.0)
            m2m[off + j] = dtype(10.0 ** m2m_log10)
    del one
    return ph2pr, jac, m2m


def _approx_log10_sum_log10(small, big, jac, dtype):
    if small > big:
        small, big = big, small
    if np.isneginf(small) or np.isneginf(big):
        return big
    diff = dtype(big - small)
    if diff >= dtype(MAX_JACOBIAN_TOLERANCE):
        return big
    d = dtype(diff * dtype(JACOBIAN_LOG_TABLE_INV_STEP))
    ind = int(d + dtype(0.5)) if d > 0 else int(d - dtype(0.5))
    return dtype(big + jac[ind])


class _Ctx:
    """Precision context mirroring GKL Context<float>/Context<double>."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.ph2pr, self.jac, self.m2m = _make_tables(dtype)
        if dtype == np.float32:
            self.initial_constant = np.float32(np.ldexp(np.float32(1.0), 120))
        else:
            self.initial_constant = np.float64(np.ldexp(1.0, 1020))
        self.log10_initial_constant = dtype(np.log10(self.initial_constant))

    def set_mm_prob(self, ins_qual: int, del_qual: int):
        min_q, max_q = (ins_qual, del_qual) if ins_qual <= del_qual else (del_qual, ins_qual)
        if max_q > MAX_QUAL:
            a = _approx_log10_sum_log10(
                self.dtype(-0.1 * min_q), self.dtype(-0.1 * max_q), self.jac, self.dtype
            )
            return self.dtype(1.0) - self.dtype(10.0) ** a
        return self.m2m[((max_q * (max_q + 1)) >> 1) + min_q]


_CTX_CACHE: dict = {}


def get_ctx(dtype) -> _Ctx:
    key = np.dtype(dtype).name
    if key not in _CTX_CACHE:
        _CTX_CACHE[key] = _Ctx(np.dtype(dtype).type)
    return _CTX_CACHE[key]


def compute_full_prob(rs, hap, q, i_q, d_q, c_q, dtype=np.float32):
    """Single-testcase forward probability in the given precision.

    rs/hap: int arrays of base codes (0-3, 4=N).  q/i/d/c: int quality arrays
    (already normalized: phred+33 removed, q floored at 6).  Returns the raw
    (scaled) probability, dtype-precision.
    """
    ctx = get_ctx(dtype)
    dt = ctx.dtype
    rs = np.asarray(rs)
    hap = np.asarray(hap)
    rslen, haplen = len(rs), len(hap)
    rows, cols = rslen + 1, haplen + 1

    p_mm = np.zeros(rows, dtype=dt)
    p_gapm = np.zeros(rows, dtype=dt)
    p_mx = np.zeros(rows, dtype=dt)
    p_xx = np.zeros(rows, dtype=dt)
    p_my = np.zeros(rows, dtype=dt)
    p_yy = np.zeros(rows, dtype=dt)
    distm = np.zeros(rows, dtype=dt)
    for r in range(1, rows):
        _i = int(i_q[r - 1]) & 127
        _d = int(d_q[r - 1]) & 127
        _c = int(c_q[r - 1]) & 127
        _q = int(q[r - 1]) & 127
        p_mm[r] = ctx.set_mm_prob(_i, _d)
        p_gapm[r] = dt(1.0) - ctx.ph2pr[_c]
        p_mx[r] = ctx.ph2pr[_i]
        p_xx[r] = ctx.ph2pr[_c]
        p_my[r] = ctx.ph2pr[_d]
        p_yy[r] = ctx.ph2pr[_c]
        distm[r] = ctx.ph2pr[_q]

    init_y = dt(ctx.initial_constant / dt(haplen))
    m_prev = np.zeros(cols, dtype=dt)
    x_prev = np.zeros(cols, dtype=dt)
    y_prev = np.full(cols, init_y, dtype=dt)

    for r in range(1, rows):
        m_cur = np.zeros(cols, dtype=dt)
        x_cur = np.zeros(cols, dtype=dt)
        y_cur = np.zeros(cols, dtype=dt)
        one_m_distm = dt(1.0) - distm[r]
        distm3 = dt(distm[r] / dt(3.0))
        for c in range(1, cols):
            match = (rs[r - 1] == hap[c - 1]) or (rs[r - 1] == AMBIG_CODE) or (
                hap[c - 1] == AMBIG_CODE
            )
            prior = one_m_distm if match else distm3
            # association mirrors computeMXY (avx-pairhmm-template.h:186):
            # ((M*pMM + X*pGAPM) + Y*pGAPM) * distmSel
            m_cur[c] = dt(
                prior
                * dt(
                    dt(dt(m_prev[c - 1] * p_mm[r]) + dt(x_prev[c - 1] * p_gapm[r]))
                    + dt(y_prev[c - 1] * p_gapm[r])
                )
            )
            x_cur[c] = dt(dt(m_prev[c] * p_mx[r]) + dt(x_prev[c] * p_xx[r]))
            y_cur[c] = dt(dt(m_cur[c - 1] * p_my[r]) + dt(y_cur[c - 1] * p_yy[r]))
        m_prev, x_prev, y_prev = m_cur, x_cur, y_cur

    # The reference accumulates M and X separately, sequentially over columns
    # (avx-pairhmm-template.h:311-345 sumM/sumX), then adds the two sums.
    sum_m = dt(0.0)
    sum_x = dt(0.0)
    for c in range(1, cols):
        sum_m = dt(sum_m + m_prev[c])
        sum_x = dt(sum_x + x_prev[c])
    return dt(sum_m + sum_x)


def compute_likelihood(rs, hap, q, i_q, d_q, c_q):
    """Float-first with double fallback; returns log10 likelihood.

    Mirrors computelikelihoodsboth (IntelPairHmmCSource.cpp:61-85).
    """
    ctxf = get_ctx(np.float32)
    res_f = compute_full_prob(rs, hap, q, i_q, d_q, c_q, np.float32)
    if res_f < MIN_ACCEPTED:
        ctxd = get_ctx(np.float64)
        res_d = compute_full_prob(rs, hap, q, i_q, d_q, c_q, np.float64)
        return float(np.log10(res_d) - ctxd.log10_initial_constant)
    return float(np.float32(np.log10(res_f)) - ctxf.log10_initial_constant)


def encode_bases(s: str) -> np.ndarray:
    return np.array([BASE_CODE.get(ch.upper(), AMBIG_CODE) for ch in s], dtype=np.int32)


def normalize_quals(s: str, min_value: int = 0) -> np.ndarray:
    """PairHMMUnitTest.cpp:107-113 — phred+33 decode with a floor."""
    return np.array([max(min_value, ord(ch) - 33) for ch in s], dtype=np.int32)
