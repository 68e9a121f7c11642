"""Host prep of a batch of nanopore reads: event detection and scalings.

The batch counterpart of the oracle's `getevents` and
`estimate_scalings_using_mom` (ops/oracle/events.py), bit-equal to them.
By default both run the JAX package's native engines a read at a time:
`native/events.cpp` (`io.native.detect_events_native`) and
`gt_mom_scalings` (`estimate_scalings_mom_fast`).  The
numpy versions below are their plain versions (`use_native=False`).

`detect_events_batch(..., use_native=False)` computes each read's prefix
sums and t-statistics with numpy (vectorised over its samples, as the
oracle does), then runs
the short/long peak detector.  The oracle's detector is a Python step per
sample of each read.  Here the reads run in lockstep instead: one Python
step per sample index, numpy over the reads still running (reads sorted
longest first, so those are a prefix).  The short detector runs before the
long one and may reset it, as in events.c:370-445, and each read's peaks
keep their append order, which `create_events` uses unsorted.  A lockstep
step costs about as much as 55 samples of the per-read loop, and 0.2 more
for each read in it, so it pays only while more than ~70 reads run:
`lockstep_split` gives the longest reads, whose tails would run nearly
alone, to the per-read loop when that costs less.  The t-statistics stay per read; the lockstep lays them out
[steps, reads] a chunk of steps at a time.

`estimate_scalings_mom_batch` keeps the C's sequential double sums
(align.c:60-83) as the last element of an `np.cumsum`, which adds in order
(np.sum's pairwise order lands on other ulps).
"""

from __future__ import annotations

import numpy as np

from ..io import native
from ..io.native import detect_events_native
from .abea import kmer_ranks
from .oracle import events as EO
from .oracle.abea import KMER_SIZE

F32_MAX = np.float32(np.finfo(np.float32).max)
# host costs of the detector, in samples of the oracle's per-read loop
# (`python -m genomicsbench_palisade_tpu_torch.ops.events` measures them)
STEP_COST = 55.0  # one lockstep step, whatever its width
LANE_COST = 0.2  # each read in a lockstep step
LOCKSTEP_CHUNK = 4096  # lockstep steps whose t-statistics are laid out at a time
_EMPTY = (np.zeros(1), np.zeros(1))  # an empty signal's prefix sums
EVENT_DTYPE = [("start", np.uint64), ("length", np.float32), ("mean", np.float32),
               ("stdv", np.float32)]


class _Detectors:
    """One detector's state for every read (events.c `detector_param`)."""

    def __init__(self, b, threshold, window_length):
        self.threshold = np.float32(threshold)
        self.window_length = window_length
        self.masked_to = np.zeros(b, np.int64)
        self.peak_pos = np.full(b, -1, np.int64)
        self.peak_value = np.full(b, F32_MAX, np.float32)
        self.valid_peak = np.zeros(b, bool)

    def step(self, i, m, current, peak_height, found, long=None):
        """Sample i of the m reads still running; appends (reads, peaks) to
        `found`; the short detector (`long` given) resets the long one."""
        masked_to, pos = self.masked_to[:m], self.peak_pos[:m]
        val, valid = self.peak_value[:m], self.valid_peak[:m]
        run = masked_to < i  # masked_to starts at 0: sample 0 is skipped
        no_peak = pos == -1
        has_peak = run & ~no_peak
        no_peak &= run
        lower = current < val
        rise = no_peak & ~lower & ((current - val) > peak_height)
        higher = has_peak & (current > val)
        np.copyto(val, current, where=(no_peak & lower) | rise | higher)
        np.copyto(pos, i, where=rise | higher)
        over = val > self.threshold
        if long is not None:
            reset = has_peak & over
            if reset.any():
                np.copyto(long.masked_to[:m], pos + self.window_length, where=reset)
                np.copyto(long.peak_pos[:m], -1, where=reset)
                np.copyto(long.peak_value[:m], F32_MAX, where=reset)
                np.copyto(long.valid_peak[:m], False, where=reset)
        valid |= has_peak & ((val - current) > peak_height) & over
        fire = has_peak & valid & ((i - pos) > self.window_length // 2)
        if fire.any():
            reads = np.flatnonzero(fire)
            found.append((reads, pos[reads]))
            np.copyto(pos, -1, where=fire)
            np.copyto(val, current, where=fire)
            valid &= ~fire


def peaks_batch(tracks1, tracks2, peak_height=EO.PEAK_HEIGHT):
    """Per read, the oracle's `short_long_peak_detector` peaks in append
    order, all reads in lockstep.  tracks1, tracks2: each read's f32 t-stat
    tracks (w1 and w2), reads ordered by length descending.  The tracks are
    laid out [steps, reads] LOCKSTEP_CHUNK steps at a time."""
    b = len(tracks1)
    n = np.array([len(t) for t in tracks1], np.int64)
    short = _Detectors(b, EO.THRESHOLD1, EO.WINDOW_LENGTH1)
    long = _Detectors(b, EO.THRESHOLD2, EO.WINDOW_LENGTH2)
    found: list = []
    m = b
    for i0 in range(0, int(n[0]) if b else 0, LOCKSTEP_CHUNK):
        while n[m - 1] <= i0:
            m -= 1
        i1 = min(i0 + LOCKSTEP_CHUNK, int(n[0]))
        blk1 = np.zeros((i1 - i0, m), np.float32)
        blk2 = np.zeros((i1 - i0, m), np.float32)
        for col in range(m):
            seg = tracks1[col][i0:i1]
            blk1[: len(seg), col] = seg
            blk2[: len(seg), col] = tracks2[col][i0:i1]
        for i in range(i0, i1):
            while n[m - 1] <= i:
                m -= 1
            short.step(i, m, blk1[i - i0, :m], peak_height, found, long=long)
            long.step(i, m, blk2[i - i0, :m], peak_height, found)
    if not found:
        return [np.zeros(0, np.int64) for _ in range(b)]
    reads = np.concatenate([r for r, _ in found])
    peaks = np.concatenate([p for _, p in found])
    order = np.argsort(reads, kind="stable")  # found is in append order
    bounds = np.searchsorted(reads[order], np.arange(b + 1))
    peaks = peaks[order]
    return [peaks[bounds[r] : bounds[r + 1]] for r in range(b)]


def lockstep_split(n_sorted) -> int:
    """How many of the longest reads (lengths sorted descending) take the
    oracle's per-read detector; the rest run in lockstep.  Picks the k with
    the least modelled cost: a lockstep step costs STEP_COST, plus
    LANE_COST for each read in it, and lasts until the longest read left
    (n_sorted[k]); a per-read sample costs 1."""
    n = np.asarray(n_sorted, np.float64)
    if not len(n):
        return 0
    after = np.concatenate([np.cumsum(n[::-1])[::-1], [0.0]])  # samples of reads k..
    steps = np.concatenate([n, [0.0]])
    cost = STEP_COST * steps + LANE_COST * after + (after[0] - after)
    return int(np.argmin(cost))


def create_events(peaks, sums, sumsqs, nsample):
    """The oracle's create_events over all of a read's events at once
    (events.c:455-503): the same f32 operations, elementwise."""
    peaks = np.asarray(peaks, np.int64)
    peaks = peaks[(peaks > 0) & (peaks < nsample)]
    bounds = np.concatenate([[0], peaks, [nsample]]).astype(np.int64)
    s, e = bounds[:-1], bounds[1:]
    length = (e - s).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = (sums[e] - sums[s]).astype(np.float32) / length
        deltasqr = (sumsqs[e] - sumsqs[s]).astype(np.float32)
        var = deltasqr / length - mean * mean
        stdv = np.sqrt(np.maximum(var, np.float32(0.0)))
    ev = np.zeros(len(s), dtype=EVENT_DTYPE)
    ev["start"], ev["length"], ev["mean"], ev["stdv"] = s, length, mean, stdv
    return ev


def detect_events_batch(signals, use_native: bool = True):
    """The oracle's `getevents` of each raw signal, as structured arrays
    (start, length, mean, stdv), in input order: the native detector a
    read, or with `use_native=False` the numpy lockstep."""
    raws = [np.asarray(s, np.float32) for s in signals]
    if use_native:
        # an empty signal's one event is 0/0: the oracle's stdv is NaN, the
        # C's fmax makes it 0 (ROADMAP queue 3), so it takes the oracle's
        return [detect_events_native(r) if len(r) else create_events([], *_EMPTY, 0)
                for r in raws]
    n = np.array([len(r) for r in raws], np.int64)
    order = np.argsort(-n, kind="stable")
    k = lockstep_split(n[order])
    prefix, tracks1, tracks2 = [], [], []
    for r in order:
        sums, sumsqs = EO.compute_sum_sumsq(raws[r])
        prefix.append((sums, sumsqs))
        tracks1.append(EO.compute_tstat(sums, sumsqs, int(n[r]), EO.WINDOW_LENGTH1))
        tracks2.append(EO.compute_tstat(sums, sumsqs, int(n[r]), EO.WINDOW_LENGTH2))
    peaks = ([EO.short_long_peak_detector(t1, t2) for t1, t2 in zip(tracks1[:k], tracks2[:k])]
             + peaks_batch(tracks1[k:], tracks2[k:]))
    events = [None] * len(raws)
    for col, r in enumerate(order):
        events[r] = create_events(peaks[col], *prefix[col], int(n[r]))
    return events


_CODE = np.zeros(256, np.uint8)  # any byte but ACGT codes as A (get_kmer_rank)
_CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)


def base_codes(sequence: str) -> np.ndarray:
    """A read's bases as uint8 codes, A0 C1 G2 T3 and any other byte 0."""
    return _CODE[np.frombuffer(sequence.encode(), np.uint8)]


def estimate_scalings_mom_fast(sequence, model, events):
    """estimate_scalings_using_mom by the native sequential double pass
    (gt_mom_scalings, bit-exact): (shift, scale) as f32."""
    ev_mean = np.ascontiguousarray(events["mean"], np.float32)
    lm = np.ascontiguousarray(model["level_mean"], np.float32)
    out = np.zeros(2, np.float32)
    p = native._p
    native._lib().gt_mom_scalings(p(base_codes(sequence)), len(sequence), p(ev_mean),
                                  len(ev_mean), p(lm), p(out))
    return out[0], out[1]


def estimate_scalings_mom_batch(sequences, model, events_list, use_native: bool = True):
    """(shifts, scales) f32 arrays: the oracle's estimate_scalings_using_mom
    of each (sequence, events), in input order: `gt_mom_scalings` a read,
    or with `use_native=False` numpy's sequential sums."""
    lm = np.asarray(model["level_mean"], np.float32)
    shifts = np.zeros(len(sequences), np.float32)
    scales = np.zeros(len(sequences), np.float32)
    for r, (seq, events) in enumerate(zip(sequences, events_list)):
        if use_native:
            shifts[r], scales[r] = estimate_scalings_mom_fast(seq, model, events)
            continue
        n_kmers = len(seq) - KMER_SIZE + 1
        x = np.asarray(events["mean"]).astype(np.float64)
        levels = lm[kmer_ranks(seq, KMER_SIZE, n_kmers)].astype(np.float64)
        shift = np.cumsum(x)[-1] / len(x) - np.cumsum(levels)[-1] / n_kmers
        d = x - shift
        scale = (np.cumsum(d * d)[-1] / len(x)) / (np.cumsum(levels * levels)[-1] / n_kmers)
        shifts[r], scales[r] = shift, scale
    return shifts, scales


def measure_costs(n_samples: int = 10_000, width: int = 256, seed: int = 0) -> dict:
    """This host's STEP_COST and LANE_COST: the per-read detector's seconds
    a sample, and lockstep steps of 1 and `width` reads, on synthetic raw
    signals."""
    import time

    rng = np.random.default_rng(seed)

    def tracks():
        # k-mers of 3-13 samples at levels 60-140, noise N(0, 0.8) or, for
        # 20% of them, N(0, 6.0) (the test fixtures' recipe)
        nk = n_samples // 3
        dwell, sigma = rng.integers(3, 14, nk), np.where(rng.random(nk) < 0.8, 0.8, 6.0)
        sig = (np.repeat(rng.uniform(60, 140, nk), dwell)
               + np.repeat(sigma, dwell) * rng.normal(0, 1, int(dwell.sum())))
        sig = sig[:n_samples].astype(np.float32)
        sums, sumsqs = EO.compute_sum_sumsq(sig)
        return (EO.compute_tstat(sums, sumsqs, n_samples, EO.WINDOW_LENGTH1),
                EO.compute_tstat(sums, sumsqs, n_samples, EO.WINDOW_LENGTH2))

    t1, t2 = tracks()
    t0 = time.perf_counter()
    EO.short_long_peak_detector(t1, t2)
    sample_s = (time.perf_counter() - t0) / n_samples
    step_s = {}
    for m in (1, width):
        tr = [tracks() for _ in range(m)]
        t0 = time.perf_counter()
        peaks_batch([a for a, _ in tr], [b for _, b in tr])
        step_s[m] = (time.perf_counter() - t0) / n_samples
    lane_s = (step_s[width] - step_s[1]) / (width - 1)
    return {"sample_s": sample_s, "step_s_1": step_s[1], f"step_s_{width}": step_s[width],
            "STEP_COST": (step_s[1] - lane_s) / sample_s, "LANE_COST": lane_s / sample_s}


if __name__ == "__main__":
    import json

    print(json.dumps(measure_costs()))
