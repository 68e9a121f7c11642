"""Adaptive banded event alignment oracle (f5c eventalign semantics).

The port's own copy of genomicsbench_palisade_tpu/ops/oracle/abea.py (the
port imports nothing of the JAX package), with the band fill of `align`
split out as `fill_bands`, so that the tests can hold a fill to it.

Semantics source: benchmarks/abea/src/align.c:99-548 —
  * Suzuki-Kasahara adaptive band: width ALN_BANDWIDTH=100, per band the
    move (down/right) follows ll < ur comparison of the previous band's
    edge scores (alternating when both are -inf)
  * 3-state scores: diag + lp_step + emission (FROM_D), up + lp_stay +
    emission (FROM_U), left + lp_skip (FROM_L); ties resolved U then L
    (later assignment wins on equality, align.c:378-383)
  * trim states lp_trim*(event_idx+1) along kmer -1
  * transition probs from events-per-kmer; emission = log normal pdf of
    the event mean under the scaled pore-model gaussian
  * backtrack from the best (event, last kmer) cell with remaining-event
    trim penalty; QC drops alignments with avg emission < -5, unspanned
    ends, or max skip-gap > 50

Float behavior: C mixes float storage with double transition constants;
the oracle mirrors that (f32 bands, f64 lp_* constants).
"""

from __future__ import annotations

import numpy as np

ALN_BANDWIDTH = 100
KMER_SIZE = 6
FROM_D, FROM_U, FROM_L = 0, 1, 2

_RANK = {"A": 0, "C": 1, "G": 2, "T": 3}


def get_kmer_rank(kmer: str) -> int:
    r = 0
    k = len(kmer)
    for i in range(k):
        r += _RANK.get(kmer[k - i - 1], 0) << (i << 1)
    return r


def log_prob_match(model_mean, model_stdv, model_log_stdv, level, scale, shift):
    """log N(level; scale*mean+shift, stdv) in float32 (align.c:99-143)."""
    gp_mean = np.float32(scale) * np.float32(model_mean) + np.float32(shift)
    a = (np.float32(level) - gp_mean) / np.float32(model_stdv)
    return np.float32(-0.918938) - np.float32(model_log_stdv) + np.float32(-0.5) * a * a


def fill_bands(sequence: str, event_means: np.ndarray, model: dict, scale: float,
               shift: float, bandwidth: int = ALN_BANDWIDTH, k: int = KMER_SIZE):
    """The band fill of `align` (align.c:169-399): (bands f32, trace u8,
    bll_e) per band, [n_bands, bandwidth] and [n_bands]."""
    n_events = len(event_means)
    n_kmers = len(sequence) - k + 1
    half = bandwidth // 2

    events_per_kmer = n_events / n_kmers
    p_stay = 1 - (1 / (events_per_kmer + 1))
    epsilon = 1e-10
    # the C kernel keeps the transition penalties in DOUBLE and lets each
    # score addition promote to double before the float store
    # (align.c:202-205,371-373); replicate that exactly — scores are
    # f32(f64(band) + lp_const_f64 + f64(emission))
    lp_skip = np.float64(np.log(epsilon))
    lp_stay = np.float64(np.log(p_stay))
    lp_step = np.float64(np.log(1.0 - np.exp(lp_skip) - np.exp(lp_stay)))
    lp_trim = np.float64(np.log(0.01))

    kmer_ranks = np.array(
        [get_kmer_rank(sequence[i : i + k]) for i in range(n_kmers)], dtype=np.int64
    )
    lm = model["level_mean"]
    ls = model["level_stdv"]
    lls = model["level_log_stdv"]

    n_bands = n_events + 1 + n_kmers + 1
    bands = np.full((n_bands, bandwidth), -np.inf, dtype=np.float32)
    trace = np.zeros((n_bands, bandwidth), dtype=np.uint8)
    bll_e = np.zeros(n_bands, dtype=np.int64)
    bll_k = np.zeros(n_bands, dtype=np.int64)
    bll_e[0], bll_k[0] = half - 1, -1 - half
    bll_e[1], bll_k[1] = bll_e[0] + 1, bll_k[0]

    start_off = -1 - bll_k[0]
    bands[0, start_off] = 0.0
    first_trim = bll_e[1] - 0
    bands[1, first_trim] = np.float32(lp_trim)
    trace[1, first_trim] = FROM_U

    def emission(event_idx, rank):
        return log_prob_match(lm[rank], ls[rank], lls[rank], event_means[event_idx],
                              scale, shift)

    for bi in range(2, n_bands):
        ll = bands[bi - 1, 0]
        ur = bands[bi - 1, bandwidth - 1]
        ll_ob = ll == -np.inf
        ur_ob = ur == -np.inf
        right = (bi % 2 == 1) if (ll_ob and ur_ob) else bool(ll < ur)
        if right:
            bll_e[bi], bll_k[bi] = bll_e[bi - 1], bll_k[bi - 1] + 1
        else:
            bll_e[bi], bll_k[bi] = bll_e[bi - 1] + 1, bll_k[bi - 1]

        trim_off = -1 - bll_k[bi]
        if 0 <= trim_off < bandwidth:
            ei = bll_e[bi] - trim_off
            if 0 <= ei < n_events:
                bands[bi, trim_off] = np.float32(lp_trim * (ei + 1))
                trace[bi, trim_off] = FROM_U
            else:
                bands[bi, trim_off] = -np.inf

        kmer_min_off = 0 - bll_k[bi]
        kmer_max_off = n_kmers - bll_k[bi]
        event_min_off = bll_e[bi] - (n_events - 1)
        event_max_off = bll_e[bi] + 1
        min_off = max(kmer_min_off, event_min_off, 0)
        max_off = min(kmer_max_off, event_max_off, bandwidth)

        for off in range(min_off, max_off):
            ei = bll_e[bi] - off
            ki = bll_k[bi] + off
            rank = kmer_ranks[ki]
            off_up = bll_e[bi - 1] - (ei - 1)
            off_left = (ki - 1) - bll_k[bi - 1]
            off_diag = (ki - 1) - bll_k[bi - 2]
            up = bands[bi - 1, off_up] if 0 <= off_up < bandwidth else -np.inf
            left = bands[bi - 1, off_left] if 0 <= off_left < bandwidth else -np.inf
            diag = bands[bi - 2, off_diag] if 0 <= off_diag < bandwidth else -np.inf
            lp_emit = emission(ei, rank)
            score_d = np.float32(np.float64(diag) + lp_step + np.float64(lp_emit))
            score_u = np.float32(np.float64(up) + lp_stay + np.float64(lp_emit))
            score_l = np.float32(np.float64(left) + lp_skip)
            max_score = score_d
            frm = FROM_D
            if score_u > max_score:
                max_score = score_u
            if max_score == score_u:
                frm = FROM_U
            if score_l > max_score:
                max_score = score_l
            if max_score == score_l:
                frm = FROM_L
            bands[bi, off] = max_score
            trace[bi, off] = frm

    return bands, trace, bll_e


def align(sequence: str, event_means: np.ndarray, model: dict, scale: float,
          shift: float, bandwidth: int = ALN_BANDWIDTH, k: int = KMER_SIZE):
    """Returns list of (kmer_idx, event_idx) pairs (empty if QC failed)."""
    bands, trace, bll_e = fill_bands(sequence, event_means, model, scale, shift, bandwidth, k)
    n_events = len(event_means)
    n_kmers = len(sequence) - k + 1
    min_average_log_emission = -5.0
    max_gap_threshold = 50
    lp_trim = np.float64(np.log(0.01))
    kmer_ranks = np.array(
        [get_kmer_rank(sequence[i : i + k]) for i in range(n_kmers)], dtype=np.int64
    )
    lm = model["level_mean"]
    ls = model["level_stdv"]
    lls = model["level_log_stdv"]

    def emission(event_idx, rank):
        return log_prob_match(lm[rank], ls[rank], lls[rank], event_means[event_idx],
                              scale, shift)

    # backtrack
    max_score = -np.inf
    curr_event_idx = 0
    curr_kmer_idx = n_kmers - 1
    for ei in range(n_events):
        bi = (ei + 1) + (curr_kmer_idx + 1)
        off = bll_e[bi] - ei
        if 0 <= off < bandwidth:
            s = np.float32(np.float64(bands[bi, off]) + (n_events - ei) * lp_trim)
            if s > max_score:
                max_score = s
                curr_event_idx = ei

    out = []
    sum_emission = 0.0
    n_aligned = 0
    curr_gap = max_gap = 0
    while curr_kmer_idx >= 0 and curr_event_idx >= 0:
        out.append((curr_kmer_idx, curr_event_idx))
        rank = kmer_ranks[curr_kmer_idx]
        sum_emission += float(emission(curr_event_idx, rank))
        n_aligned += 1
        bi = (curr_event_idx + 1) + (curr_kmer_idx + 1)
        off = bll_e[bi] - curr_event_idx
        frm = trace[bi, off]
        if frm == FROM_D:
            curr_kmer_idx -= 1
            curr_event_idx -= 1
            curr_gap = 0
        elif frm == FROM_U:
            curr_event_idx -= 1
            curr_gap = 0
        else:
            curr_kmer_idx -= 1
            curr_gap += 1
            max_gap = max(max_gap, curr_gap)
    out.reverse()

    avg = sum_emission / max(n_aligned, 1)
    spanned = bool(out) and out[0][0] == 0 and out[-1][0] == n_kmers - 1
    if avg < min_average_log_emission or not spanned or max_gap > max_gap_threshold:
        return []
    return out
