"""minimap2 anchor-chaining DP oracle (mm_chain_dp 1-D scan semantics).

The port's own copy of genomicsbench_palisade_tpu/ops/oracle/chain.py
(the port imports nothing of the JAX package).  Semantics source:
benchmarks/chain/src/host_kernel.cpp:58-479 (plaintext path at :405-472)
with fixed parameters is_cdna=0, gap_scale=1.0, max_iter=5000,
max_skip=25; per-call params (max_dist_x/y, bw, n_segs, avg_qspan) come
from the input dump (host_data_io.cpp:40-80).

For each anchor i (ascending), scan predecessors j=i-1..st descending:
  score  sc = min(dq, dr, q_span) - gap_cost + scores[j]
  gap_cost (n_segs==1, !is_cdna, sidi==sidj):
         (int)(dd * 0.01 * avg_qspan) + (ilog2(dd) >> 1)
Heuristics that must be reproduced exactly:
  * window start st advances while ri > x[st] + max_dist_x, then clamps
    to i - max_iter
  * skip conditions (dr==0 same-seg, dq<=0, dq>max_dist, dd>bw)
  * max_skip break: n_skip increments when targets[j]==i and sc<=max_f,
    decrements (floor 0 implicitly via >0 check) on improvement; break
    when n_skip > max_skip
  * targets[parents[j]] = i mutation during the scan
Outputs per anchor: scores, parents, peak_scores (targets is scratch).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MM_SEED_SEG_SHIFT = 48
MM_SEED_SEG_MASK = 0xFF << MM_SEED_SEG_SHIFT
MAX_ITER = 5000
MAX_SKIP = 25
GAP_SCALE = 1.0


def ilog2_32(v: int) -> int:
    """floor(log2(v)) for v>0; -1 for v==0 (host_kernel.cpp:22-27)."""
    if v <= 0:
        return -1
    return int(v).bit_length() - 1


@dataclass
class ChainCall:
    n: int
    avg_qspan: float
    max_dist_x: int
    max_dist_y: int
    bw: int
    n_segs: int
    x: np.ndarray  # uint64 anchor positions (target)
    y: np.ndarray  # uint64 packed (seg<<48 | span<<32 | query pos)


def chain_dp(call: ChainCall, is_cdna: bool = False):
    """Returns dict(scores, parents, targets, peak_scores) int32/int64 arrays."""
    n = int(call.n)
    x = call.x.astype(np.uint64)
    y = call.y.astype(np.uint64)
    avg_qspan = np.float32(call.avg_qspan)
    max_dist_x, max_dist_y, bw = call.max_dist_x, call.max_dist_y, call.bw
    n_segs = call.n_segs

    scores = np.zeros(n, dtype=np.int32)
    parents = np.zeros(n, dtype=np.int64)
    targets = np.zeros(n, dtype=np.int64)
    peak_scores = np.zeros(n, dtype=np.int32)

    st = 0
    for i in range(n):
        ri = int(x[i])
        max_j = -1
        qi = np.int32(np.uint32(y[i] & np.uint64(0xFFFFFFFF)))
        q_span = int((y[i] >> np.uint64(32)) & np.uint64(0xFF))
        sidi = int((y[i] & np.uint64(MM_SEED_SEG_MASK)) >> np.uint64(MM_SEED_SEG_SHIFT))
        max_f = q_span
        n_skip = 0
        while st < i and ri > int(x[st]) + max_dist_x:
            st += 1
        if i - st > MAX_ITER:
            st = i - MAX_ITER
        for j in range(i - 1, st - 1, -1):
            dr = ri - int(x[j])
            dq = int(qi) - int(np.int32(np.uint32(y[j] & np.uint64(0xFFFFFFFF))))
            sidj = int((y[j] & np.uint64(MM_SEED_SEG_MASK)) >> np.uint64(MM_SEED_SEG_SHIFT))
            if (sidi == sidj and dr == 0) or dq <= 0:
                continue
            if (sidi == sidj and dq > max_dist_y) or dq > max_dist_x:
                continue
            dd = dr - dq if dr > dq else dq - dr
            if sidi == sidj and dd > bw:
                continue
            if n_segs > 1 and not is_cdna and sidi == sidj and dr > max_dist_y:
                continue
            min_d = dq if dq < dr else dr
            sc = q_span if min_d > q_span else (dq if dq < dr else dr)
            log_dd = ilog2_32(dd) if dd else 0
            if is_cdna or sidi != sidj:
                c_lin = int(dd * 0.01 * float(avg_qspan))
                c_log = log_dd
                if sidi != sidj and dr == 0:
                    sc += 1
                    gap_cost = 0
                elif dr > dq or sidi != sidj:
                    gap_cost = c_lin if c_lin < c_log else c_log
                else:
                    gap_cost = c_lin + (c_log >> 1)
            else:
                gap_cost = int(dd * 0.01 * float(avg_qspan)) + (log_dd >> 1)
            sc -= int(float(gap_cost) * GAP_SCALE + 0.499)
            sc += int(scores[j])
            if sc > max_f:
                max_f = sc
                max_j = j
                if n_skip > 0:
                    n_skip -= 1
            elif targets[j] == i:
                n_skip += 1
                if n_skip > MAX_SKIP:
                    break
            if parents[j] >= 0:
                targets[parents[j]] = i
        scores[i] = max_f
        parents[i] = max_j
        peak_scores[i] = (
            peak_scores[max_j] if (max_j >= 0 and peak_scores[max_j] > max_f) else max_f
        )
    return {
        "scores": scores,
        "parents": parents,
        "targets": targets,
        "peak_scores": peak_scores,
    }
