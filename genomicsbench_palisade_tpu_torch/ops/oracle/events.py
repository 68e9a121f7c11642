"""Nanopore raw-signal event detection + scaling oracle (f5c events.c).

The port's own copy of the numpy path of
genomicsbench_palisade_tpu/ops/oracle/events.py: no native branch, and
without trim_raw_by_mad and its helpers (the reference discards the trim,
so they are not on the path).

Semantics source (reference abea benchmark, scrappie-derived):
  * compute_sum_sumsq — events.c:289-299 (double prefix sums of f32 data)
  * compute_tstat — events.c:314-365 (windowed two-sample t-statistic;
    boundary zeros for the first/last w samples, eta=FLT_MIN variance
    floor, mixed double/float arithmetic reproduced by computing the
    combined variance in f64 and the final statistic through f32 casts)
  * short_long_peak_detector — events.c:370-445 (two detectors over the
    w=3 and w=6 t-stat tracks; short detector masks the long one when its
    peak exceeds threshold1; a peak fires window_length/2 samples after
    its max if it rose and fell by peak_height and exceeded threshold)
  * create_event/create_events — events.c:455-503 (CADLAG [start,end)
    events with mean/stdv from the prefix sums; first event starts at 0,
    last ends at nsample)
  * detect_events defaults — events.c:42-46 (w1=3, w2=6, t1=1.4, t2=9.0,
    peak_height=0.2; DNA)
  * getevents — events.c:553-568: NOTE the reference passes raw_table by
    value to trim_and_segment_raw and DISCARDS the result, so trimming is
    a no-op in the reference binary; we reproduce that
  * estimate_scalings_using_mom — align.c:49-95 (method-of-moments
    shift/scale from event means vs model k-mer levels, f64 sums cast
    to f32 outputs)
"""

from __future__ import annotations

import numpy as np

from .abea import KMER_SIZE, get_kmer_rank

F32 = np.float32
FLT_MIN = np.float32(np.finfo(np.float32).tiny)

# event_detection_defaults (events.c:42-46)
WINDOW_LENGTH1 = 3
WINDOW_LENGTH2 = 6
THRESHOLD1 = np.float32(1.4)
THRESHOLD2 = np.float32(9.0)
PEAK_HEIGHT = np.float32(0.2)


def compute_sum_sumsq(data):
    """Double prefix sums; element i excludes data[i] (events.c:289-299)."""
    data = np.asarray(data, dtype=np.float32)
    sums = np.zeros(len(data) + 1, dtype=np.float64)
    sumsqs = np.zeros(len(data) + 1, dtype=np.float64)
    np.cumsum(data.astype(np.float64), out=sums[1:])
    # the C squares in FLOAT before accumulating in double (events.c:300)
    np.cumsum((data * data).astype(np.float64), out=sumsqs[1:])
    return sums, sumsqs


def compute_tstat(sums, sumsqs, d_length, w_length):
    """Windowed t-statistic, f32 output (events.c:314-365)."""
    tstat = np.zeros(d_length, dtype=np.float32)
    if d_length < 2 * w_length or w_length < 2:
        return tstat
    w = np.float32(w_length)
    i = np.arange(w_length, d_length - w_length + 1)
    sum1 = sums[i].copy()
    sumsq1 = sumsqs[i].copy()
    tail = i > w_length
    sum1[tail] -= sums[i - w_length][tail]
    sumsq1[tail] -= sumsqs[i - w_length][tail]
    sum2 = (sums[i + w_length] - sums[i]).astype(np.float32)
    sumsq2 = (sumsqs[i + w_length] - sumsqs[i]).astype(np.float32)
    mean1 = (sum1 / np.float64(w)).astype(np.float32)
    mean2 = sum2 / w
    # C mixed-precision: mean1*mean1 and mean2*mean2 are f32 multiplies,
    # sumsq1/w is a double divide, accumulation happens in double
    combined_var = (
        sumsq1 / np.float64(w)
        - (mean1 * mean1).astype(np.float64)
        + (sumsq2 / w).astype(np.float64)
        - (mean2 * mean2).astype(np.float64)
    ).astype(np.float32)
    combined_var = np.maximum(combined_var, FLT_MIN)
    delta_mean = mean2 - mean1
    tstat[i] = (
        np.abs(delta_mean.astype(np.float64))
        / np.sqrt((combined_var / w).astype(np.float64))
    ).astype(np.float32)
    return tstat


class _Detector:
    __slots__ = ("signal", "threshold", "window_length", "masked_to",
                 "peak_pos", "peak_value", "valid_peak")

    def __init__(self, signal, threshold, window_length):
        self.signal = signal
        self.threshold = np.float32(threshold)
        self.window_length = window_length
        self.masked_to = 0
        self.peak_pos = -1
        self.peak_value = np.float32(np.finfo(np.float32).max)
        self.valid_peak = False


def short_long_peak_detector(tstat1, tstat2, peak_height=PEAK_HEIGHT):
    """Peak positions from the two t-stat tracks (events.c:370-445)."""
    n = len(tstat1)
    short_d = _Detector(tstat1, THRESHOLD1, WINDOW_LENGTH1)
    long_d = _Detector(tstat2, THRESHOLD2, WINDOW_LENGTH2)
    peaks = []
    for i in range(n):
        for det in (short_d, long_d):
            if det.masked_to >= i:
                # NB masked_to starts at 0 so sample 0 is always skipped,
                # exactly like the C (events.c:386-389)
                continue
            current = det.signal[i]
            if det.peak_pos == -1:
                if current < det.peak_value:
                    det.peak_value = current
                elif current - det.peak_value > peak_height:
                    det.peak_value = current
                    det.peak_pos = i
            else:
                if current > det.peak_value:
                    det.peak_value = current
                    det.peak_pos = i
                if det is short_d and det.peak_value > det.threshold:
                    long_d.masked_to = det.peak_pos + det.window_length
                    long_d.peak_pos = -1
                    long_d.peak_value = np.float32(np.finfo(np.float32).max)
                    long_d.valid_peak = False
                if (det.peak_value - current > peak_height
                        and det.peak_value > det.threshold):
                    det.valid_peak = True
                if det.valid_peak and (i - det.peak_pos) > det.window_length // 2:
                    peaks.append(det.peak_pos)
                    det.peak_pos = -1
                    det.peak_value = current
                    det.valid_peak = False
    return peaks


def create_events(peaks, sums, sumsqs, nsample):
    """Events from peak boundaries; dtype-f32 mean/stdv (events.c:455-503).

    Returns structured array with fields start, length, mean, stdv.
    """
    peaks = [p for p in peaks if 0 < p < nsample]
    bounds = [0] + peaks + [nsample]
    n = len(bounds) - 1
    ev = np.zeros(n, dtype=[("start", np.uint64), ("length", np.float32),
                            ("mean", np.float32), ("stdv", np.float32)])
    for j in range(n):
        s, e = bounds[j], bounds[j + 1]
        length = np.float32(e - s)
        mean = np.float32(sums[e] - sums[s]) / length
        deltasqr = np.float32(sumsqs[e] - sumsqs[s])
        var = deltasqr / length - mean * mean
        ev[j] = (s, length, mean, np.sqrt(np.maximum(var, np.float32(0.0))))
    return ev


def detect_events(raw):
    """Full scrappie pipeline on one raw signal (events.c:505-547)."""
    raw = np.asarray(raw, dtype=np.float32)
    sums, sumsqs = compute_sum_sumsq(raw)
    tstat1 = compute_tstat(sums, sumsqs, len(raw), WINDOW_LENGTH1)
    tstat2 = compute_tstat(sums, sumsqs, len(raw), WINDOW_LENGTH2)
    peaks = short_long_peak_detector(tstat1, tstat2)
    return create_events(peaks, sums, sumsqs, len(raw))


def getevents(raw):
    """events.c:553-568 — the trim result is discarded by the reference
    (raw_table passed by value), so detection runs on the full signal."""
    return detect_events(raw)


def estimate_scalings_using_mom(sequence, model, events):
    """Method-of-moments (shift, scale) (align.c:49-95)."""
    n_kmers = len(sequence) - KMER_SIZE + 1
    event_means = events["mean"].astype(np.float64)
    # the C accumulates SEQUENTIALLY in double (align.c:60-83); np.sum's
    # pairwise summation lands on different ulps, which can flip the f32
    # scalings and downstream band ties — mirror the C loop order
    event_level_sum = 0.0
    for x in event_means.tolist():
        event_level_sum += x
    levels = [float(model["level_mean"][get_kmer_rank(
        sequence[i:i + KMER_SIZE])]) for i in range(n_kmers)]
    kmer_level_sum = 0.0
    kmer_level_sq_sum = 0.0
    for l in levels:
        kmer_level_sum += l
        kmer_level_sq_sum += l * l
    shift = event_level_sum / len(events) - kmer_level_sum / n_kmers
    event_level_sq_sum = 0.0
    for x in event_means.tolist():
        event_level_sq_sum += (x - shift) * (x - shift)
    scale = (event_level_sq_sum / len(events)) / (kmer_level_sq_sum / n_kmers)
    return np.float32(shift), np.float32(scale)
