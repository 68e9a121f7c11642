"""Banded Smith-Waterman extension oracle (bwa-mem ksw_extend semantics).

The port's own copy of genomicsbench_palisade_tpu/ops/oracle/bsw.py
(the port imports nothing of the JAX package): the semantic ground truth
that ops/bsw.py's plain version and csrc/bsw_extend.cu are held to.

Semantics source: benchmarks/bsw/bandedSWA.cpp:130-251 (scalarBandedSWA) and
the driver defaults in benchmarks/bsw/main_banded.cpp:53-57,845-854:
match=1, mismatch=-4, gap open=6, gap extend=1 (both del and ins),
zdrop=100, w=100, end_bonus=5, ambig=-1.

Per pair the kernel extends an alignment seeded with score h0 and returns
  score   — best local score in the band
  qle/tle — query/target end of the best-scoring cell (+1)
  gtle    — target end of the best to-end-of-query alignment (+1)
  gscore  — best score reaching the end of the query (to-end alignment)
  max_off — max |row-col| offset at which the max was improved
Heuristics that affect results and must be reproduced exactly:
  * first-row seeding from h0 with ins-open/extend decay
  * band clamp from max attainable ins/del runs
  * early exit when the row max m == 0
  * z-drop break
  * adaptive band narrowing to the non-zero span (affects the j==qlen
    gscore check on later rows)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BswParams:
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    zdrop: int = 100
    end_bonus: int = 5
    match: int = 1
    mismatch: int = 4  # stored positive; matrix value is -mismatch
    ambig: int = -1
    w: int = 100


DEFAULT_PARAMS = BswParams()


def fill_scmat(match: int, mismatch: int, ambig: int) -> np.ndarray:
    """5x5 scoring matrix (main_banded.cpp:77-88)."""
    mat = np.zeros((5, 5), dtype=np.int32)
    for i in range(4):
        for j in range(4):
            mat[i, j] = match if i == j else -mismatch
        mat[i, 4] = ambig
    mat[4, :] = ambig
    return mat


def scalar_banded_swa(query, target, h0: int, params: BswParams = DEFAULT_PARAMS):
    """Returns dict(score, qle, tle, gtle, gscore, max_off)."""
    p = params
    query = np.asarray(query, dtype=np.int64)
    target = np.asarray(target, dtype=np.int64)
    qlen, tlen = len(query), len(target)
    mat = fill_scmat(p.match, p.mismatch, p.ambig)
    oe_del = p.o_del + p.e_del
    oe_ins = p.o_ins + p.e_ins

    # query profile: qp[k][j] = mat[k][query[j]]
    qp = mat[:, query]  # (5, qlen)

    eh_h = np.zeros(qlen + 2, dtype=np.int64)
    eh_e = np.zeros(qlen + 2, dtype=np.int64)

    # first row from the seed score
    eh_h[0] = h0
    eh_h[1] = h0 - oe_ins if h0 > oe_ins else 0
    j = 2
    while j <= qlen and eh_h[j - 1] > p.e_ins:
        eh_h[j] = eh_h[j - 1] - p.e_ins
        j += 1

    # clamp band width by max attainable ins/del runs
    w = p.w
    max_sc = int(mat.max())
    max_ins = int((qlen * max_sc + p.end_bonus - p.o_ins) / p.e_ins + 1.0)
    max_ins = max(max_ins, 1)
    w = min(w, max_ins)
    max_del = int((qlen * max_sc + p.end_bonus - p.o_del) / p.e_del + 1.0)
    max_del = max(max_del, 1)
    w = min(w, max_del)

    max_score = h0
    max_i = max_j = -1
    max_ie = -1
    gscore = -1
    max_off = 0
    beg, end = 0, qlen

    for i in range(tlen):
        f = 0
        m = 0
        mj = -1
        q = qp[target[i]]
        if beg < i - w:
            beg = i - w
        if end > i + w + 1:
            end = i + w + 1
        if end > qlen:
            end = qlen
        if beg == 0:
            h1 = h0 - (p.o_del + p.e_del * (i + 1))
            if h1 < 0:
                h1 = 0
        else:
            h1 = 0
        for j in range(beg, end):
            # eh[j] holds {H(i-1,j-1), E(i,j)}; f=F(i,j); h1=H(i,j-1)
            M = eh_h[j]
            e = eh_e[j]
            eh_h[j] = h1
            M = M + q[j] if M else 0
            h = M if M > e else e
            h = h if h > f else f
            h1 = h
            if m <= h:
                mj = j
                m = h
            t = M - oe_del
            t = t if t > 0 else 0
            e -= p.e_del
            e = e if e > t else t
            eh_e[j] = e
            t = M - oe_ins
            t = t if t > 0 else 0
            f -= p.e_ins
            f = f if f > t else t
        j = end  # value of j after the C for-loop (also when band is empty)
        eh_h[end] = h1
        eh_e[end] = 0
        if j == qlen:
            if gscore <= h1:
                max_ie = i
                gscore = h1
        if m == 0:
            break
        if m > max_score:
            max_score = m
            max_i = i
            max_j = mj
            max_off = max(max_off, abs(mj - i))
        elif p.zdrop > 0:
            if i - max_i > mj - max_j:
                if max_score - m - ((i - max_i) - (mj - max_j)) * p.e_del > p.zdrop:
                    break
            else:
                if max_score - m - ((mj - max_j) - (i - max_i)) * p.e_ins > p.zdrop:
                    break
        # adaptive band narrowing to the non-zero span
        j = beg
        while j < end and eh_h[j] == 0 and eh_e[j] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and eh_h[j] == 0 and eh_e[j] == 0:
            j -= 1
        end = j + 2 if j + 2 < qlen else qlen

    return {
        "score": int(max_score),
        "qle": int(max_j + 1),
        "tle": int(max_i + 1),
        "gtle": int(max_ie + 1),
        "gscore": int(gscore),
        "max_off": int(max_off),
    }

