"""f5c eventalign mode after the abea kernels, a batch of reads at a time.

Counterpart of genomicsbench_palisade_tpu/ops/eventalign.py, whose fast
paths run one read at a time through the JAX package's native engines
(native/eventalign.cpp); the port binds them too (`estimate_scalings_mom_fast`,
which lives in ops.events and is re-exported here, `scaling_read_fast`, `realign_read_arrays`, `realign_read`,
`emit_tsv_text_arrays`) beside the numpy emitters (`emit_tsv_lines_fast`,
`emit_tsv_lines_arrays`).  The spec is ops/oracle/eventalign.py (per
read, the reference's align.c, eventalign.c and f5c.c); every function
here equals it exactly:

- `scaling_batch`: postalign, the WLS recalibration and the QC gates,
  by default `gt_eventalign_scaling` a read; `use_native=False` is the
  plain version in numpy (scaling_read).  The C's double sums are
  sequential, so they are `np.add.accumulate` (np.sum adds pairwise).
- `realign_batch`: the reference-space profile-HMM realign
  (align_read_to_ref, profile_hmm_align) of every read in torch on the
  caller's device.  A read's windows are sequential: each starts where
  the last one's output ended.  So the reads run in lockstep: step t
  aligns window t of every read that still has one, and the host derives
  each read's next window from its last (`_windows`, one host sync a
  step).  Within a step the Viterbi fill is an anti-diagonal wavefront
  over (event row, k-mer block), batched over the windows, which are
  padded with -inf: cell (r, b) reads (r-1, b), (r-1, b-1) and (r, b-1)
  only, so the cells of a diagonal are independent, and each keeps the
  spec's f32 operations, their order and its last-index tie rules.  The
  backtrack walks every window at once, one gather of the movement a
  step.  The spec's end state (:432-444) reaches no output (the backtrack
  starts at each window's own last row and k-mer, :446-449), so it is
  not computed.
- `emit_tsv`, `summarize`: a read's TSV rows (emit_tsv_lines) as one
  string, by default through the native block formatter
  (`emit_tsv_text_arrays`; `use_native=False` is the f-string rows), and
  its --summary fields (summarize_alignment).
- The host realign (`realign_read_arrays`, `realign_read`: the native
  engine a read) stands beside `realign_batch`, which stays the CLI's
  route (ROADMAP queue 3).

The realign uses eager elementwise torch ops only (no fused or `alpha=`
forms, which CUDA would contract into FMAs), so the card, the CPU and
numpy round alike.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import default_device
from ..io import native
from .abea import _emission, kmer_ranks
from .events import base_codes, estimate_scalings_mom_fast  # noqa: F401 (re-exported)
from .oracle import eventalign as EAO
from .oracle.abea import KMER_SIZE

FAILED_CALIBRATION = 0x001  # f5c.h:49-51
FAILED_ALIGNMENT = 0x002
FAILED_QUALITY_CHK = 0x004
MIN_CALIBRATION_VAR = 2.5  # f5cmisc.h:9
MIN_EVENTS_TO_RESCALE = 200  # align.c:677
MAX_EVENTS_PER_BASE = 5.0  # f5c.c:1321
ALIGN_STRIDE = 100  # eventalign.c align_read_to_ref
OUTPUT_STRIDE = 50
GRAPH_ROUND = 32  # a CUDA graph's rows and k-mers, rounded up to a multiple of this
# ProfileStateR9 (eventalign.c:40-45): the realign's state codes
KMER_SKIP, BAD_EVENT, MATCH = 0, 1, 2
SOFT = 5  # HMT_FROM_SOFT: a movement, 0-4 are SAME_M PREV_M SAME_B PREV_B PREV_K
STOP = 6  # the backtrack's own mark: row 0, or a window whose walk has ended
# log(1 - TRANS_START_TO_CLIP) as f32 (eventalign.c:25): the first pre-flank
# entry, the soft start of row 1 at k-mer 0
SOFT_START = float(np.float32(np.log(1 - 0.5)))

# BAM cigar op -> (read, ref) increments (eventalign.c:1112-1180)
_CIGAR_INC = {"M": (1, 1), "=": (1, 1), "X": (1, 1), "D": (0, 1),
              "I": (1, 0), "S": (1, 0), "H": (0, 0)}
# getPossibleSymbols' first symbol (eventalign.c:1054-1110); ACGT stay
_DISAMBIG = np.zeros(256, np.uint8)
for _c, _b in {"A": "A", "C": "C", "G": "G", "T": "T", "M": "A", "R": "A", "W": "A",
               "S": "C", "Y": "C", "K": "G", "V": "A", "H": "A", "D": "A", "B": "C",
               "N": "A"}.items():
    _DISAMBIG[ord(_c)] = ord(_b)
_CODE = np.full(256, 0, np.int64)  # any byte but ACGT ranks as A (get_kmer_rank)
_CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
_COMP = np.zeros(256, np.uint8)
_COMP[np.frombuffer(b"ACGTN", np.uint8)] = np.frombuffer(b"TGCAN", np.uint8)


def _seq_sum(x) -> float:
    """The C's `s = 0.0; s += x[i]` in order, as a Python float."""
    return float(np.add.accumulate(np.concatenate(([0.0], x)))[-1])


# ---------------------------------------------------------------------------
# postalign + recalibration + QC (align.c:550-763, f5c.c:1263-1330)
# ---------------------------------------------------------------------------

def scaling_read(sequence: str, events, pairs, lm, ls):
    """scaling_read of one read: (status, scalings or None, b2e, events_per_base).
    `pairs` are the abea pairs [(kmer, event), ...], ascending."""
    if not len(pairs):
        return FAILED_ALIGNMENT, None, None, 0.0
    n_kmers = len(sequence) - KMER_SIZE + 1
    p = np.asarray(pairs, np.int64).reshape(-1, 2)
    kk, ee = p[:, 0], p[:, 1]
    # postalign: a pair sets b2e only where its event differs from the last one
    new = np.ones(len(ee), bool)
    new[1:] = ee[1:] != ee[:-1]
    ks, es = kk[new], ee[new]
    b2e = np.full((n_kmers, 2), -1, np.int32)
    uk, first = np.unique(ks, return_index=True)
    b2e[uk, 0] = es[first]
    uk, last = np.unique(ks[::-1], return_index=True)
    b2e[uk, 1] = es[::-1][last]
    events_per_base = float(max(0, int(ee.max())) - min(np.iinfo(np.int32).max, int(ee.min()))) \
        / n_kmers

    # the read-space alignment's 'M' entries: the first event of each k-mer
    # with events whose rank differs from the last such k-mer's
    start, stop = b2e[:, 0].astype(np.int64), b2e[:, 1].astype(np.int64)
    ki = np.nonzero((start != -1) & (stop >= start))[0]
    ranks = kmer_ranks(sequence, KMER_SIZE, n_kmers)[ki]
    is_m = ranks != np.concatenate(([-1], ranks[:-1]))
    num_m = int(is_m.sum())
    if num_m < MIN_EVENTS_TO_RESCALE:
        return FAILED_CALIBRATION, None, b2e, events_per_base
    e = np.asarray(events["mean"])[start[ki[is_m]]].astype(np.float64)
    mu = np.asarray(lm)[ranks[is_m]].astype(np.float64)
    stdv = np.asarray(ls)[ranks[is_m]].astype(np.float64)
    inv_var = 1.0 / (stdv * stdv)
    a00, a01, a11 = _seq_sum(inv_var), _seq_sum(mu * inv_var), _seq_sum(mu * mu * inv_var)
    b0, b1 = _seq_sum(e * inv_var), _seq_sum(mu * e * inv_var)
    a10 = a01
    div = a00 * a11 - a01 * a10
    shift = -(a01 * b1 - a11 * b0) / div
    scale = (a00 * b1 - a10 * b0) / div
    yi = e - shift - scale * mu
    var = _seq_sum(yi * yi / (stdv * stdv))
    var /= num_m
    var = float(np.sqrt(var))
    # log_var is the log of the double var, then rounded (align.c:745-750)
    sc = {"shift": np.float32(shift), "scale": np.float32(scale), "var": np.float32(var),
          "log_var": np.float32(np.log(var))}
    if float(sc["var"]) > MIN_CALIBRATION_VAR:
        return FAILED_CALIBRATION, None, b2e, events_per_base
    if events_per_base > MAX_EVENTS_PER_BASE:
        return FAILED_QUALITY_CHK, sc, b2e, events_per_base
    return 0, sc, b2e, events_per_base


def scaling_batch(seqs, events, pairs, model, use_native: bool = True) -> list:
    """scaling_read of every read of a batch: per read (status flag,
    {shift, scale, var, log_var} f32 or None, b2e, events_per_base).  The
    native pass a read (`scaling_read_fast`), or with `use_native=False`
    numpy's."""
    if use_native:
        return [scaling_read_fast(s, e, p, model) for s, e, p in zip(seqs, events, pairs)]
    lm = np.asarray(model["level_mean"], np.float32)
    ls = np.asarray(model["level_stdv"], np.float32)
    return [scaling_read(s, e, p, lm, ls) for s, e, p in zip(seqs, events, pairs)]


def scaling_read_fast(sequence, events, pairs, model):
    """The oracle's scaling_read with the native postalign, recalibration
    and QC pass (gt_eventalign_scaling: double sums in the oracle's
    sequential order, bit-exact): (status, scalings, b2e, events_per_base)."""
    lib = native._lib()
    n_kmers = len(sequence) - KMER_SIZE + 1
    codes = base_codes(sequence)
    pk = np.ascontiguousarray([p[0] for p in pairs], np.int32)
    pe = np.ascontiguousarray([p[1] for p in pairs], np.int32)
    ev_mean = np.ascontiguousarray(events["mean"], np.float32)
    lm = np.ascontiguousarray(model["level_mean"], np.float32)
    ls = np.ascontiguousarray(model["level_stdv"], np.float32)
    sc_out = np.zeros(4, np.float32)
    b2e = np.full((max(n_kmers, 1), 2), -1, np.int32)
    epb = np.zeros(1, np.float64)
    p = native._p
    rc = lib.gt_eventalign_scaling(p(codes), len(sequence), p(pk), p(pe), len(pk), p(ev_mean),
                                   p(lm), p(ls), p(sc_out), p(b2e), p(epb))
    if rc == 2:  # the oracle's FAILED_ALIGNMENT: no b2e, events_per_base 0
        return FAILED_ALIGNMENT, None, None, 0.0
    if rc == 1:
        return FAILED_CALIBRATION, None, b2e, float(epb[0])
    sc = {"shift": sc_out[0], "scale": sc_out[1], "var": sc_out[2], "log_var": sc_out[3]}
    if rc == 4:
        return FAILED_QUALITY_CHK, sc, b2e, float(epb[0])
    return 0, sc, b2e, float(epb[0])


# ---------------------------------------------------------------------------
# the realign (eventalign.c:1263-1543, profile_hmm_align :703-918)
# ---------------------------------------------------------------------------

@dataclass
class RealignRead:
    """One read to realign: its BAM record (cigar, pos, is_reverse), the
    genome from record.pos over the record's reference length, and its
    scaling_read results."""

    record: object
    ref_segment: str
    read_length: int
    events: np.ndarray
    sc: dict
    b2e: np.ndarray
    events_per_base: float


@dataclass
class Alignment:
    """A read's realign output in order: per row its reference position,
    event index and state (MATCH or BAD_EVENT); `ref` is the
    disambiguated segment as bytes, starting at `ref_offset`."""

    ref: np.ndarray
    ref_offset: int
    rc: bool
    ref_pos: np.ndarray
    event_idx: np.ndarray
    state: np.ndarray


def transitions(events_per_base: float) -> np.ndarray:
    """calculate_transitions (eventalign.c:171-243), whose rows are all
    alike: [10] f32 log probabilities (mm_self, mb, mk, mm_next, bb, bk,
    bm_next, bm_self, kk, km)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        p_stay = np.float32(1 - (1 / np.float64(events_per_base)))
        p_skip, p_bad, p_skip_self = np.float32(0.0025), np.float32(0.001), np.float32(0.3)
        p_mm_next = np.float32(np.float32(1.0) - p_stay - p_skip - p_bad)
        p_b3 = np.float32((np.float32(1.0) - p_bad) / np.float32(3))
        p_km = np.float32(np.float32(1.0) - p_skip_self)
        return np.array([np.float32(np.log(np.float64(p))) for p in
                         (p_stay, p_bad, p_skip, p_mm_next, p_bad, p_b3, p_b3, p_b3,
                          p_skip_self, p_km)], np.float32)


def aligned_segments(cigar, pos: int) -> list:
    """get_aligned_segments (eventalign.c:1112-1180) as arrays: per
    segment (the cigar split at N) its aligned (ref, read) positions."""
    segs = [([], [])]
    read_pos, ref_pos = 0, pos
    for op, length in cigar:
        if op == "N":
            segs.append(([], []))
            ref_pos += length
            continue
        if op not in _CIGAR_INC:
            raise ValueError(f"Unhandled cigar operation {op}")
        read_inc, ref_inc = _CIGAR_INC[op]
        if op in "M=X":
            segs[-1][0].append(ref_pos + np.arange(length, dtype=np.int64))
            segs[-1][1].append(read_pos + np.arange(length, dtype=np.int64))
        read_pos += read_inc * length
        ref_pos += ref_inc * length
    empty = np.zeros(0, np.int64)
    return [(np.concatenate(a) if a else empty, np.concatenate(b) if b else empty)
            for a, b in segs]


def _closest_event(b2e) -> callable:
    """get_closest_event_to over one read's b2e: the first event of the
    nearest k-mer with one at or before k (within 1000, the scan's stop
    excluded), else at or after it."""
    n = len(b2e)
    idx = np.arange(n)
    has = b2e[:, 0] != -1
    before = np.maximum.accumulate(np.where(has, idx, -1))
    after = np.minimum.accumulate(np.where(has, idx, n)[::-1])[::-1]

    def closest(k: int) -> int:
        j = int(before[k])
        if j > max(0, k - 1000):
            return int(b2e[j, 0])
        j = int(after[k])
        return int(b2e[j, 0]) if j < min(k + 1000, n - 1) else -1

    return closest


def _windows(read: RealignRead, ref: np.ndarray, region_start: int, region_end: int):
    """align_read_to_ref's control flow for one read: yields each window
    (start in the segment, k-mers, first event, last event, stride, events)
    and is sent its backtrack (events, k-mer indices, states) in forward
    order; returns the read's output rows (ref positions, events, states)."""
    k = KMER_SIZE
    rec = read.record
    closest = _closest_event(read.b2e)
    max_kmer_idx = read.read_length - k
    rc = rec.is_reverse
    out = ([], [], [])
    for seg_ref, seg_read in aligned_segments(rec.cigar, rec.pos):
        if region_start != -1 and region_end != -1:
            keep = (seg_ref >= region_start) & (seg_ref <= region_end)
            seg_ref, seg_read = seg_ref[keep], seg_read[keep]
        ok = np.nonzero(seg_read <= max_kmer_idx)[0]
        n_pairs = int(ok[-1]) + 1 if len(ok) else 0
        if n_pairs == 0:
            break
        refs, reads = seg_ref[:n_pairs], seg_read[:n_pairs]
        kstart, kend = int(reads[0]), int(reads[-1])
        if rc:
            kstart, kend = read.read_length - kstart - k, read.read_length - kend - k
        first_event, last_event = closest(kstart), closest(kend)
        forward = first_event < last_event
        cur_event, cur_ref, pair_idx = first_event, int(refs[0]), 0
        while (cur_event < last_event) if forward else (cur_event > last_event):
            # get_end_pair: the last pair at or before cur_ref + ALIGN_STRIDE
            end_pair = max(pair_idx, int(np.searchsorted(refs, cur_ref + ALIGN_STRIDE, "right"))) - 1
            end_ref, end_read = int(refs[end_pair]), int(reads[end_pair])
            if rc:
                end_read = read.read_length - end_read - k
            s = cur_ref - rec.pos
            n_sub = len(range(len(ref))[s : s + end_ref - cur_ref + 1])
            if n_sub < 2 * k:
                break
            stop_event = closest(end_read)
            if abs(cur_event - stop_event) < 2:
                break
            stride = 1 if cur_event < stop_event else -1
            ev, km, st = yield (s, n_sub - k + 1, cur_event, stop_event, stride,
                                abs(stop_event - cur_event) + 1)
            # the first OUTPUT_STRIDE rows that are not skips or the start event
            sel = np.nonzero((st != KMER_SKIP) & (ev != cur_event))[0]
            if end_pair != n_pairs - 1:
                sel = sel[:OUTPUT_STRIDE]
            if len(sel) == 0:
                break
            out[0].append(cur_ref + km[sel])
            out[1].append(ev[sel])
            out[2].append(st[sel])
            cur_event, cur_ref = int(ev[sel[-1]]), cur_ref + int(km[sel[-1]])
            pair_idx = max(pair_idx, int(np.searchsorted(refs, cur_ref, "right"))) - 1
    return tuple(np.concatenate(o) if o else np.zeros(0, np.int64) for o in out)


def _prep_reference(read: RealignRead):
    """The disambiguated segment (bytes) and its k-mer ranks, of the
    reverse complement for a reverse read (eventalign.c:1091-1110)."""
    raw = np.frombuffer(read.ref_segment.upper().encode(), np.uint8)
    ref = _DISAMBIG[raw]
    if (ref == 0).any():  # the spec's reverse_complement has no entry for it
        bad = chr(raw[np.argmax(ref == 0)])
        raise ValueError(f"reference base {bad!r} is not a nucleotide code")
    n = max(len(ref) - KMER_SIZE + 1, 0)
    codes = _CODE[ref]
    ranks = np.zeros(n, np.int64)
    for j in range(KMER_SIZE):  # the reverse complement's first base is the last's complement
        c = 3 - codes[KMER_SIZE - 1 - j : KMER_SIZE - 1 - j + n] if read.record.is_reverse \
            else codes[j : j + n]
        ranks |= c << (2 * (KMER_SIZE - 1 - j))
    return ref, ranks


class _Batch:
    """A realign batch's tables on the device: the pore model, every
    read's event means and k-mer ranks (flat), scalings and transitions."""

    def __init__(self, reads, ranks, model, device):
        def dev(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

        self.device = device
        self.lm = dev(np.asarray(model["level_mean"], np.float32), torch.float32)
        self.ls = dev(np.asarray(model["level_stdv"], np.float32), torch.float32)
        self.lls = dev(np.asarray(model["level_log_stdv"], np.float32), torch.float32)
        means = [np.asarray(r.events["mean"], np.float32) for r in reads]
        self.ev = dev(np.concatenate(means + [np.zeros(1, np.float32)]), torch.float32)
        self.ev_off = np.concatenate(([0], np.cumsum([len(m) for m in means])))[:-1]
        self.ranks = dev(np.concatenate(ranks + [np.zeros(1, np.int64)]), torch.int64)
        self.rank_off = np.concatenate(([0], np.cumsum([len(r) for r in ranks])))[:-1]
        sc = np.array([[r.sc[k] for k in ("scale", "shift", "var", "log_var")] for r in reads],
                      np.float32).reshape(len(reads), 4)
        self.sc = dev(sc, torch.float32)
        self.trans = dev(np.stack([transitions(r.events_per_base) for r in reads]
                                  + [np.zeros(10, np.float32)]), torch.float32)
        self.neg = torch.tensor(float("-inf"), device=device)
        self.zero8 = torch.tensor(0, dtype=torch.uint8, device=device)
        self.soft8 = torch.tensor(SOFT, dtype=torch.uint8, device=device)
        self.n_reads = len(reads)
        self.graphs = {}

    def graph(self, rows: int, cols: int):
        """On CUDA, the wavefront (`_fill`) of a window step captured as one
        CUDA graph over buffers padded to every read of the batch and to
        rows and k-mers rounded up to GRAPH_ROUND, and those buffers:
        "em", "lp_up", "lp_diag", "lp_left" (its inputs), "val" and "mov".
        Replaying it launches the eager loop's kernels without the host's
        cost a launch; a window step's own cells come out the same."""
        rows, cols = (-(-n // GRAPH_ROUND) * GRAPH_ROUND for n in (rows, cols))
        if (rows, cols) not in self.graphs:
            w, n_diag, dev = self.n_reads, rows + cols, self.device
            val, mov = _fill_buffers(w, n_diag, rows, dev)
            buf = {"val": val, "mov": mov, "em": torch.zeros((w, n_diag, rows), device=dev),
                   "lp_up": torch.zeros((2, 2, w, 1), device=dev),
                   "lp_diag": torch.zeros((3, w, 1), device=dev),
                   "lp_left": torch.zeros((3, w, 1), device=dev)}

            def fill():
                _fill(buf["val"], buf["mov"], buf["em"], buf["lp_up"], buf["lp_diag"],
                      buf["lp_left"], cols, self)

            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):  # a warm-up before capture
                fill()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fill()
            self.graphs[rows, cols] = (graph, buf)
        return self.graphs[rows, cols]


def _fill_buffers(w: int, n_diag: int, rows: int, dev):
    """The Viterbi values [state K/B/M, w, diagonal, row], all -inf, and
    movements [4, w, diagonal, row], 0 but STOP in row 0 and plane 3."""
    val = torch.full((3, w, n_diag, rows), float("-inf"), device=dev)
    mov = torch.zeros((4, w, n_diag, rows), dtype=torch.uint8, device=dev)
    mov[:, :, :, 0] = STOP
    mov[3] = STOP
    return val, mov


def _fill(val, mov, em_s, lp_up, lp_diag, lp_left, cols: int, tb) -> None:
    """The wavefront: step d computes the rows r of diagonal d with
    1 <= b = d - r <= cols, in place in val and mov.  Cells past a window's
    own rows or k-mers hold what their padding gives, which no cell of the
    window and no backtrack reads; block 0 and row 0 stay as they were."""
    n_diag, rows = val.shape[2], val.shape[3]
    neg, zero8, soft8 = tb.neg, tb.zero8, tb.soft8
    for d in range(2, n_diag):
        lo, hi = max(1, d - cols), min(d, rows)
        s1, s2 = val[:, :, d - 1], val[:, :, d - 2]
        up = lp_up + s1[1:3, :, lo - 1 : hi - 1]  # [dest M/B, src B/M]: (r-1, b)
        dg = lp_diag + s2[:, :, lo - 1 : hi - 1]  # (r-1, b-1)
        lf = lp_left + s1[:, :, lo:hi]  # (r, b-1)
        # MATCH: last-index max of (M same, M prev, B same, B prev, K prev, soft)
        mx = torch.maximum(up[0, 1], dg[2])
        frm = torch.where(dg[2] == mx, 1, zero8)
        for i, c in ((2, up[0, 0]), (3, dg[1]), (4, dg[0])):
            mx = torch.maximum(mx, c)
            frm = torch.where(c == mx, i, frm)
        out = mov[MATCH, :, d, lo:hi]
        if d == 2:  # the soft start: row 1, k-mer 0, the only cell of diagonal 2
            soft = torch.full_like(mx, SOFT_START)
            mx = torch.maximum(mx, soft)
            torch.where(soft == mx, soft8, frm, out=out)
        else:
            torch.where(mx == neg, soft8, frm, out=out)
        torch.add(mx, em_s[:, d, lo:hi], out=val[MATCH, :, d, lo:hi])
        # BAD_EVENT: of (M same, -, B same, -, -, -), emission 0
        mx = torch.maximum(up[1, 1], up[1, 0], out=val[BAD_EVENT, :, d, lo:hi])
        frm = torch.where(up[1, 1] == neg, 1, zero8)
        frm = torch.where(up[1, 0] == mx, 2, frm)
        torch.where(mx == neg, soft8, frm, out=mov[BAD_EVENT, :, d, lo:hi])
        # KMER_SKIP: of (-, M prev, -, B prev, K prev, -) by the spec's
        # `>` then `==` loop (a NaN never becomes the max)
        mx = torch.fmax(neg, lf[2])
        frm = torch.where(lf[2] == mx, 1, zero8)
        frm = torch.where(mx == neg, 2, frm)
        mx = torch.fmax(mx, lf[1])
        frm = torch.where(lf[1] == mx, 3, frm)
        mx = torch.fmax(mx, lf[0], out=val[KMER_SKIP, :, d, lo:hi])
        frm = torch.where(lf[0] == mx, 4, frm)
        torch.where(mx == neg, soft8, frm, out=mov[KMER_SKIP, :, d, lo:hi])


def _viterbi(tb: _Batch, reads_idx, wins, stats: dict) -> list:
    """profile_hmm_align of one window of each given read: per window its
    backtrack (events, k-mer indices, states) in forward order."""
    dev = tb.device
    t0 = time.perf_counter()
    w = len(wins)
    s, nk, e0, e1, stride, ne = (np.asarray(c, np.int64) for c in zip(*wins))
    rd = np.asarray(reads_idx, np.int64)
    rows, cols = int(ne.max()) + 1, int(nk.max())  # rows 0..ne (row 0 the start)
    n_diag = int((ne + nk).max()) + 1  # the last cell (ne, nk) is on diagonal ne + nk
    win = torch.from_numpy(np.stack([tb.rank_off[rd] + s, tb.ev_off[rd] + e0, stride, ne, nk, rd],
                                    1)).to(dev)
    k_first, e_first, e_step, n_ev, n_km, r_idx = win.unbind(1)

    # emissions [w, rows-1, cols] (_log_emission_matrix), then skewed to
    # [w, diagonal, row]: em_s[:, d, r] is cell (r, d - r)'s
    ar_c = torch.arange(cols, device=dev)
    ar_r = torch.arange(rows - 1, device=dev)
    ranks = tb.ranks[(k_first[:, None] + ar_c).clamp(max=tb.ranks.numel() - 1)]
    ev_at = (e_first[:, None] + ar_r * e_step[:, None]).clamp(0, tb.ev.numel() - 1)
    lvl = tb.ev[ev_at]
    sc = tb.sc[r_idx]
    gp_mean = sc[:, 0:1] * tb.lm[ranks] + sc[:, 1:2]
    gp_stdv = tb.ls[ranks] * sc[:, 2:3]
    gp_lstdv = tb.lls[ranks] + sc[:, 3:4]
    em = _emission(lvl[:, :, None], gp_mean[:, None, :], gp_stdv[:, None, :],
                   gp_lstdv[:, None, :])
    d_ar = torch.arange(n_diag, device=dev)[:, None]
    r_ar = torch.arange(rows, device=dev)[None, :]
    b_ar = d_ar - r_ar
    inside = (r_ar >= 1) & (b_ar >= 1) & (b_ar <= cols)
    skew = torch.where(inside, (r_ar - 1) * cols + (b_ar - 1), 0).reshape(-1)
    em_s = em.reshape(w, -1)[:, skew].reshape(w, n_diag, rows)

    # per window the transitions as [.., w, 1] columns: up (dest M, B) x
    # (src B, M), the diagonal (src K, B, M), the left (src K, B, M)
    tr = tb.trans[r_idx]
    lp_up = tr[:, [[7, 0], [4, 1]]].permute(1, 2, 0)[..., None]
    lp_diag = tr[:, [9, 6, 3]].t()[..., None]
    lp_left = tr[:, [8, 5, 2]].t()[..., None]

    if dev.type == "cuda":
        graph, buf = tb.graph(rows, cols)
        buf["em"][:w, :n_diag, :rows].copy_(em_s)
        for k, v in (("lp_up", lp_up), ("lp_diag", lp_diag), ("lp_left", lp_left)):
            buf[k][..., :w, :].copy_(v)
        t1 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        mov = buf["mov"]
    else:
        val, mov = _fill_buffers(w, n_diag, rows, dev)
        t1 = time.perf_counter()
        _fill(val, mov, em_s, lp_up, lp_diag, lp_left, cols, tb)
    t2 = time.perf_counter()

    # backtrack from MATCH at (ne, nk) of every window: a flat index into
    # mov, moved by a table of (state, movement); SOFT and STOP go to plane 3
    steps_max = n_diag + 1  # each step lowers the diagonal, or stops
    _, w_buf, n_diag, rows = mov.shape  # a graph's buffers are padded
    plane = w_buf * n_diag * rows
    delta, nxt = np.zeros((4, 7), np.int64), np.full((4, 7), 3, np.int64)
    for ps in range(3):
        row_step = rows + 1 if ps != KMER_SKIP else 0  # (r-1, b): diagonal - 1, row - 1
        for m, (to, dk) in enumerate(((MATCH, 0), (MATCH, 1), (BAD_EVENT, 0), (BAD_EVENT, 1),
                                      (KMER_SKIP, 1))):
            nxt[ps, m] = to
            delta[ps, m] = (to - ps) * plane - dk * rows - row_step
        delta[ps, SOFT] = delta[ps, STOP] = (3 - ps) * plane
    delta_t = torch.from_numpy(delta.reshape(-1)).to(dev)
    nxt7_t = torch.from_numpy(nxt.reshape(-1) * 7).to(dev)
    at = (MATCH * plane + torch.arange(w, device=dev) * (n_diag * rows)
          + (n_ev + n_km) * rows + n_ev)
    key_base = torch.full((w,), MATCH * 7, dtype=torch.int64, device=dev)
    flat = mov.reshape(-1)
    trail_at, trail_m = [], []
    for _ in range(steps_max):
        m = flat[at]
        key = key_base + m
        trail_at.append(at)
        trail_m.append(m)
        at = at + delta_t[key]
        key_base = nxt7_t[key]
    trail_at = torch.stack(trail_at).cpu().numpy()
    trail_m = torch.stack(trail_m).cpu().numpy()
    t3 = time.perf_counter()

    # the steps before each window's first STOP, decoded and reversed
    steps = np.where((trail_m == STOP).any(0), np.argmax(trail_m == STOP, 0), len(trail_m))
    state = trail_at // plane
    cell = trail_at % (n_diag * rows)
    row, diag = cell % rows, cell // rows
    out = []
    for j in range(w):
        n = steps[j]
        r = row[:n, j][::-1]
        out.append((e0[j] + (r - 1) * stride[j], (diag[:n, j] - row[:n, j])[::-1] - 1,
                    state[:n, j][::-1]))
    t4 = time.perf_counter()
    # on CUDA the replay is timed on the device; the host waits for it in
    # the backtrack's copy to the host, the step's one sync
    fill_s = start.elapsed_time(end) * 1e-3 if dev.type == "cuda" else t2 - t1
    stats["window_steps"] = stats.get("window_steps", 0) + 1
    stats["wavefront_steps"] = stats.get("wavefront_steps", 0) + steps_max - 3
    stats["backtrack_steps"] = stats.get("backtrack_steps", 0) + steps_max
    stats["cells"] = stats.get("cells", 0) + int(((ne + 1) * (nk + 2)).sum())
    for k, dt in (("setup_s", t1 - t0), ("fill_s", fill_s), ("backtrack_s", t3 - t1 - fill_s),
                  ("decode_s", t4 - t3)):
        stats[k] = stats.get(k, 0.0) + dt
    return out


def realign_batch(reads, model, device=None, region_start: int = -1, region_end: int = -1,
                  stats: dict | None = None) -> list:
    """align_read_to_ref of every RealignRead, on `device` (CUDA unless
    told otherwise): per read its Alignment.  `region_start`/`region_end`
    (both or neither -1) clip the aligned pairs to the reference (-w).
    `stats`, when given, accumulates window_steps (host syncs),
    wavefront_steps, backtrack_steps, cells (the spec's matrix cells) and
    seconds: prep_s, setup_s, fill_s, backtrack_s (to the host), decode_s
    and host_s (the windows' control flow)."""
    device = default_device(device)
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    preps = [_prep_reference(r) for r in reads]
    tb = _Batch(reads, [p[1] for p in preps], model, device)
    stats["prep_s"] = stats.get("prep_s", 0.0) + time.perf_counter() - t0
    results = [None] * len(reads)
    pending = {}

    def advance(i, gen, sent):
        try:
            pending[i] = gen.send(sent)
        except StopIteration as done:
            results[i] = done.value
            pending.pop(i, None)

    t0 = time.perf_counter()
    gens = [_windows(r, p[0], region_start, region_end) for r, p in zip(reads, preps)]
    for i, g in enumerate(gens):
        advance(i, g, None)
    host_s = time.perf_counter() - t0
    while pending:
        ids = list(pending)
        backtracks = _viterbi(tb, ids, [pending[i] for i in ids], stats)
        t0 = time.perf_counter()
        for i, bt in zip(ids, backtracks):
            advance(i, gens[i], bt)
        host_s += time.perf_counter() - t0
    stats["host_s"] = stats.get("host_s", 0.0) + host_s
    return [Alignment(p[0], r.record.pos, r.record.is_reverse, *res)
            for r, p, res in zip(reads, preps, results)]


def realign_read_arrays(record, ref_segment, ref_offset, read_length, events, sc, model, b2e,
                        events_per_base, region_start=-1, region_end=-1):
    """The native profile-HMM realign of one read (native/eventalign.cpp),
    raw arrays: (ref_positions int32, event_indices int32, states bytes of
    b'M'/b'B', ref_seq str, the disambiguated segment)."""
    ref_seq = EAO.disambiguate(ref_segment)
    max_kmer_idx = read_length - KMER_SIZE
    trimmed = []
    for seg in EAO.get_aligned_segments(record, 1):
        if region_start != -1 and region_end != -1:
            seg = EAO.trim_aligned_pairs_to_ref_region(seg, region_start, region_end)
        trimmed.append(EAO.trim_aligned_pairs_to_kmer(seg, max_kmer_idx))
    ref_codes = np.frombuffer(
        ref_seq.encode().translate(bytes.maketrans(b"ACGT", bytes([0, 1, 2, 3]))), np.uint8)
    rp, ei, st = native.eventalign_realign_native(ref_codes, ref_offset, trimmed,
                                                  record.is_reverse, read_length,
                                                  events["mean"], sc, model, b2e,
                                                  events_per_base)
    return rp, ei, st, ref_seq


def realign_read(record, ref_segment, ref_offset, read_length, events, sc, model, b2e,
                 events_per_base, read_idx, region_start=-1, region_end=-1,
                 use_native: bool = True):
    """align_read_to_ref of one read on the host: the native engine, or
    with `use_native=False` the oracle; the oracle's event_alignment dict
    list either way."""
    if not use_native:
        return EAO.align_read_to_ref(record, ref_segment, ref_offset, read_length, events, sc,
                                     model, b2e, events_per_base, read_idx, region_start,
                                     region_end)
    rp, ei, st, ref_seq = realign_read_arrays(record, ref_segment, ref_offset, read_length,
                                              events, sc, model, b2e, events_per_base,
                                              region_start, region_end)
    rc = record.is_reverse
    out = []
    for ref_position, event_idx, state in zip(rp.tolist(), ei.tolist(), st.decode()):
        ref_kmer = ref_seq[ref_position - ref_offset : ref_position - ref_offset + KMER_SIZE]
        if state == "B":
            model_kmer = "N" * KMER_SIZE
        elif rc:
            model_kmer = EAO.reverse_complement(ref_kmer)
        else:
            model_kmer = ref_kmer
        out.append({"ref_position": ref_position, "ref_kmer": ref_kmer, "read_idx": read_idx,
                    "event_idx": event_idx, "rc": rc, "model_kmer": model_kmer,
                    "hmm_state": state})
    return out


# ---------------------------------------------------------------------------
# TSV and summary (eventalign.c:1580-1941)
# ---------------------------------------------------------------------------

def _level_columns(ev_mean, ev_stdv, ev_len, lm, ls, is_b, sc, sample_rate, scale_events):
    """The TSV's float columns (emit_tsv_lines' op tree, f32 values
    promoted to double): event mean, stdv, duration, model mean, stdv and
    the standardized level, as float64 arrays."""
    shift, scale, var = (np.float32(sc[k]) for k in ("shift", "scale", "var"))
    duration = (ev_len / np.float32(sample_rate)).astype(np.float32)
    zero = np.float32(0.0)
    if scale_events:
        ev_mean = ((ev_mean - shift) / scale).astype(np.float32)
        model_mean = np.where(is_b, zero, lm)
        model_stdv = np.where(is_b, zero, ls)
    else:
        model_mean = np.where(is_b, zero, (scale * lm + shift).astype(np.float32))
        model_stdv = np.where(is_b, zero, (ls * var).astype(np.float32))
    # a float over (sqrt(double var) * float): only the quotient rounds to
    # f32; a B row divides by 0
    with np.errstate(divide="ignore", invalid="ignore"):
        level = ((ev_mean - model_mean).astype(np.float32).astype(np.float64)
                 / (np.sqrt(np.float64(var)) * model_stdv.astype(np.float64))).astype(np.float32)
    return tuple(a.astype(np.float64) for a in (ev_mean, ev_stdv, duration, model_mean,
                                                model_stdv, level))


def _rank_of(model_kmers) -> np.ndarray:
    """Ranks of [n, k] ASCII k-mers (ACGT 0-3, any other byte 0)."""
    return (_CODE[model_kmers] << (2 * (KMER_SIZE - 1 - np.arange(KMER_SIZE)))).sum(1)


def emit_tsv_lines_fast(events, model, sc, alignments, read_index, read_name, ref_name,
                        sample_rate, print_read_names=False, scale_events=False):
    """The oracle's emit_tsv_lines over its event_alignment dicts, with
    the float columns as arrays: its rows, byte for byte."""
    n = len(alignments)
    if n == 0:
        return []
    eidx = np.fromiter((ea["event_idx"] for ea in alignments), np.int64, n)
    is_b = np.fromiter((ea["hmm_state"] == "B" for ea in alignments), bool, n)
    mk = np.frombuffer("".join(ea["model_kmer"] for ea in alignments).encode(),
                       np.uint8).reshape(n, KMER_SIZE)
    ranks = _rank_of(mk)
    em, es, ed, mm, ms, sl = (c.tolist() for c in _level_columns(
        np.asarray(events["mean"], np.float32)[eidx], np.asarray(events["stdv"], np.float32)[eidx],
        np.asarray(events["length"], np.float32)[eidx],
        np.asarray(model["level_mean"], np.float32)[ranks],
        np.asarray(model["level_stdv"], np.float32)[ranks], is_b, sc, sample_rate, scale_events))
    who = read_name if print_read_names else str(int(read_index))
    ei = eidx.tolist()
    return [f"{ref_name}\t{ea['ref_position']}\t{ea['ref_kmer']}\t{who}\tt\t"
            f"{ei[i]}\t{em[i]:.2f}\t{es[i]:.3f}\t{ed[i]:.5f}\t"
            f"{ea['model_kmer']}\t{mm[i]:.2f}\t{ms[i]:.2f}\t{sl[i]:.2f}\n"
            for i, ea in enumerate(alignments)]


def _emit_cols(events, model, sc, rp, ei, st, ref_seq, ref_offset, rc, sample_rate,
               scale_events):
    """The array emitters' columns: (reference k-mers, model k-mers [n, k]
    ASCII, event indices int64, the six float64 columns), or None when a
    k-mer would run past the segment."""
    pos = rp.astype(np.int64) - np.int64(ref_offset)
    refbytes = np.frombuffer(ref_seq.encode(), np.uint8)
    if int(pos.min()) < 0 or int(pos.max()) + KMER_SIZE > refbytes.size:
        return None
    km = refbytes[pos[:, None] + np.arange(KMER_SIZE)]
    is_b = np.frombuffer(st, np.uint8) == ord("B")
    mk = _COMP[km][:, ::-1] if rc else km
    if is_b.any():
        mk = np.where(is_b[:, None], np.uint8(ord("N")), mk)
    ranks = _rank_of(mk)
    eidx = ei.astype(np.int64)
    cols = _level_columns(
        np.asarray(events["mean"], np.float32)[eidx], np.asarray(events["stdv"], np.float32)[eidx],
        np.asarray(events["length"], np.float32)[eidx],
        np.asarray(model["level_mean"], np.float32)[ranks],
        np.asarray(model["level_stdv"], np.float32)[ranks], is_b, sc, sample_rate, scale_events)
    return (km, mk, eidx, *cols)


def emit_tsv_lines_arrays(events, model, sc, rp, ei, st, ref_seq, ref_offset, rc, read_index,
                          read_name, ref_name, sample_rate, print_read_names=False,
                          scale_events=False):
    """emit_tsv_lines_fast fed by realign_read_arrays' raw output: the
    k-mer columns by byte gathers over the reference segment.  Returns
    the rows, or None when a k-mer would run past the segment."""
    n = int(rp.shape[0])
    if n == 0:
        return []
    cols = _emit_cols(events, model, sc, rp, ei, st, ref_seq, ref_offset, rc, sample_rate,
                      scale_events)
    if cols is None:
        return None
    km, mk, eidx, *floats = cols
    em, es, ed, mm, ms, sl = (c.tolist() for c in floats)
    who = read_name if print_read_names else str(int(read_index))
    ei_l, rp_l = eidx.tolist(), rp.tolist()
    kb, mb = km.tobytes().decode(), mk.tobytes().decode()
    k = KMER_SIZE
    return [f"{ref_name}\t{rp_l[i]}\t{kb[i * k:i * k + k]}\t{who}\tt\t"
            f"{ei_l[i]}\t{em[i]:.2f}\t{es[i]:.3f}\t{ed[i]:.5f}\t"
            f"{mb[i * k:i * k + k]}\t{mm[i]:.2f}\t{ms[i]:.2f}\t{sl[i]:.2f}\n"
            for i in range(n)]


def emit_tsv_text_arrays(events, model, sc, rp, ei, st, ref_seq, ref_offset, rc, read_index,
                         read_name, ref_name, sample_rate, print_read_names=False,
                         scale_events=False):
    """The read's TSV as one string by the native block formatter
    (gt_eventalign_emit), emit_tsv_lines_arrays' rows joined: (text,
    rows), or None when a k-mer would run past the segment."""
    n = int(rp.shape[0])
    if n == 0:
        return "", 0
    cols = _emit_cols(events, model, sc, rp, ei, st, ref_seq, ref_offset, rc, sample_rate,
                      scale_events)
    if cols is None:
        return None
    km, mk, eidx, *floats = cols
    who = read_name if print_read_names else str(int(read_index))
    return native.eventalign_emit_native(rp, eidx, km.tobytes(), mk.tobytes(), KMER_SIZE,
                                         *floats, ref_name, who), n

def _kmers(aln: Alignment):
    """The rows' reference and model k-mers ([n, k] ASCII) and the model
    k-mers' ranks: the reverse complement for a reverse read, N for B."""
    pos = aln.ref_pos - aln.ref_offset
    if len(pos) and (pos.min() < 0 or pos.max() + KMER_SIZE > len(aln.ref)):
        raise ValueError("a realigned k-mer runs past its reference segment")
    ref_km = aln.ref[pos[:, None] + np.arange(KMER_SIZE)]
    model_km = _COMP[ref_km][:, ::-1] if aln.rc else ref_km
    model_km = np.where((aln.state == BAD_EVENT)[:, None], np.uint8(ord("N")), model_km)
    ranks = (_CODE[model_km] << (2 * (KMER_SIZE - 1 - np.arange(KMER_SIZE)))).sum(1)
    return ref_km, model_km, ranks


def emit_tsv(aln: Alignment, events, model, sc, read_index, read_name, contig,
             sample_rate, print_read_names=False, scale_events=False,
             use_native: bool = True) -> str:
    """A read's eventalign TSV rows as one string: emit_tsv_lines'
    columns and printf formats (f32 values promoted to double), by the
    native block formatter (`emit_tsv_text_arrays`), or with
    `use_native=False` by the numpy emitter's f-strings
    (`emit_tsv_lines_arrays`)."""
    if len(aln.ref_pos) == 0:
        return ""
    st = np.where(aln.state == BAD_EVENT, np.uint8(ord("B")), np.uint8(ord("M"))).tobytes()
    args = (events, model, sc, aln.ref_pos, aln.event_idx, st, aln.ref.tobytes().decode(),
            aln.ref_offset, aln.rc, read_index, read_name, contig, sample_rate,
            print_read_names, scale_events)
    out = emit_tsv_text_arrays(*args) if use_native else emit_tsv_lines_arrays(*args)
    if out is None:
        raise ValueError("a realigned k-mer runs past its reference segment")
    return out[0] if use_native else "".join(out)


def summarize(aln: Alignment, events, model, sc, nm=0) -> dict:
    """summarize_alignment of a read's rows: counts of events, steps, skips
    (a backwards move wraps as the C's unsigned difference) and stays,
    and the sequential double sums of durations and M rows' z-scores."""
    n = len(aln.ref_pos)
    rp = aln.ref_pos.astype(np.int64)
    move = np.diff(rp, prepend=rp[:1])
    later = np.arange(n) > 0
    stays = int((move[later] == 0).sum()) + int(n > 0 and rp[0] == -1)
    out = {"num_events": n, "num_steps": int((later & (move == 1)).sum()),
           "num_stays": stays, "num_skips": int((later & ((move > 1) | (move < 0))).sum()),
           "sum_z_score": 0.0, "sum_duration": 0.0, "alignment_edit_distance": nm,
           "reference_span": int(rp[-1] - rp[0] + 1) if n else 0}
    if n == 0:
        return out
    ei = aln.event_idx
    out["sum_duration"] = _seq_sum(np.asarray(events["length"], np.float32)[ei]
                                   .astype(np.float64))
    m = aln.state == MATCH
    _, _, ranks = _kmers(aln)
    level = np.asarray(events["mean"], np.float32)[ei[m]]
    gp_mean = (np.float32(sc["scale"]) * np.asarray(model["level_mean"], np.float32)[ranks[m]]
               + np.float32(sc["shift"]))
    gp_stdv = np.asarray(model["level_stdv"], np.float32)[ranks[m]] * np.float32(sc["var"])
    out["sum_z_score"] = _seq_sum(((level - gp_mean) / gp_stdv).astype(np.float64))
    return out
