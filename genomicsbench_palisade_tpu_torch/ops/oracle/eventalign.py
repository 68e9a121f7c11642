"""f5c `eventalign`-mode postprocessing: read-space pairs -> reference-space TSV.

The port's own copy of genomicsbench_palisade_tpu/ops/oracle/eventalign.py
(the port imports nothing of the JAX package), kept as the spec: its
per-read loops are the ones the tests hold ops/eventalign.py's batch
functions to.

The ABEA kernel (ops/abea.py) ends at read-space event<->kmer pairs, which is
where the reference's timed region ends too.  The full eventalign mode
(benchmarks/abea/src/f5c.c scaling_single/meth_single mode==1) then runs, per
read:

  1. ``postalign``          pairs -> base_to_event_map + events_per_base +
                            read-space event_alignment (align.c:550-651)
  2. ``recalibrate_model``  weighted-least-squares re-fit of shift/scale/var
                            from the 'M' states (align.c:655-763); QC
                            FAILED_CALIBRATION when var > 2.5 (f5c.c:1300)
  3. QC                     events_per_base > 5.0 -> FAILED_QUALITY_CHK
                            (f5c.c:1321)
  4. ``realign_read``       segment-by-segment profile-HMM Viterbi alignment
                            of events to the REFERENCE sequence, walking the
                            BAM cigar (eventalign.c:1942-2036 ->
                            align_read_to_ref :1263-1543, profile_hmm_align
                            :703-918, fill :345-598)
  5. ``summarize_alignment`` + ``emit_event_alignment_tsv``
                            (eventalign.c:1580-1643, :1853-1941)

Everything here is a bit-faithful numpy/python transcription: f32 state
matrices, C operation order for every accumulation, the last-max tie rule of
ProfileHMMViterbiOutputR9::update_cell (eventalign.c:608-618), and the
backtrack that starts at the fixed last-(kmer,event) MATCH cell rather than
the recorded end cell (eventalign.c:815-817).
"""

from __future__ import annotations

import numpy as np

from .abea import KMER_SIZE, get_kmer_rank

TRANS_START_TO_CLIP = 0.5  # eventalign.c:25
TRANS_CLIP_SELF = 0.9      # eventalign.c:26
MIN_CALIBRATION_VAR = 2.5  # f5cmisc.h:9
FAILED_CALIBRATION = 0x001  # f5c.h:49-51
FAILED_ALIGNMENT = 0x002
FAILED_QUALITY_CHK = 0x004

# ProfileStateR9 / HMMMovementType (eventalign.c:40-57)
PSR9_KMER_SKIP, PSR9_BAD_EVENT, PSR9_MATCH, PSR9_NUM_STATES = 0, 1, 2, 3
(HMT_FROM_SAME_M, HMT_FROM_PREV_M, HMT_FROM_SAME_B, HMT_FROM_PREV_B,
 HMT_FROM_PREV_K, HMT_FROM_SOFT) = range(6)

_NEG_INF = np.float32(-np.inf)

_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}
# getPossibleSymbols first symbol (eventalign.c:1054-1091)
_DISAMBIG = {"M": "A", "R": "A", "W": "A", "S": "C", "Y": "C", "K": "G",
             "V": "A", "H": "A", "D": "A", "B": "C", "N": "A"}


def disambiguate(seq: str) -> str:
    """Upper-case + IUPAC codes -> lexicographically lowest base
    (eventalign.c:1091-1110)."""
    out = []
    for c in seq.upper():
        out.append(_DISAMBIG.get(c, c))
    return "".join(out)


def reverse_complement(seq: str) -> str:
    return "".join(_COMPLEMENT[c] for c in reversed(seq))


# ---------------------------------------------------------------------------
# 1/2/3: postalign + recalibration + QC (align.c, f5c.c scaling_single)
# ---------------------------------------------------------------------------

def postalign(sequence: str, pairs):
    """align.c:550-651.  ``pairs`` is the ABEA output [(kmer_idx, event_idx)]
    in forward order.  Returns (alignment, base_to_event_map, events_per_base)
    where alignment entries are dicts with read-space ref_position/kmers and
    hmm_state 'M'/'E'."""
    n_kmers = len(sequence) - KMER_SIZE + 1
    b2e = np.full((n_kmers, 2), -1, np.int32)
    max_event, min_event = 0, np.iinfo(np.int32).max
    prev_event_idx = -1
    for k_idx, event_idx in pairs:
        if event_idx != prev_event_idx:
            if b2e[k_idx, 0] == -1:
                b2e[k_idx, 0] = event_idx
            b2e[k_idx, 1] = event_idx
        max_event = max(max_event, event_idx)
        min_event = min(min_event, event_idx)
        prev_event_idx = event_idx
    events_per_base = float(max_event - min_event) / n_kmers

    alignment = []
    prev_kmer_rank = -1
    for ki in range(n_kmers):
        start, stop = int(b2e[ki, 0]), int(b2e[ki, 1])
        if start == -1:
            continue
        kmer = sequence[ki:ki + KMER_SIZE]
        kmer_rank = get_kmer_rank(kmer)
        for event_idx in range(start, stop + 1):
            alignment.append({
                "ref_position": ki, "ref_kmer": kmer, "event_idx": event_idx,
                "rc": False, "model_kmer": kmer,
                "hmm_state": "M" if prev_kmer_rank != kmer_rank else "E",
            })
            prev_kmer_rank = kmer_rank
    return alignment, b2e, events_per_base


def recalibrate_model(model, events, alignment, scale_var=True):
    """align.c:655-763 (double arithmetic, sequential accumulation).
    Returns (calibrated, scalings dict) — scalings has f32 shift/scale/var/
    log_var like scalings_t (f5c.h:140-151, CACHED_LOG on)."""
    num_m = sum(1 for ea in alignment if ea["hmm_state"] == "M")
    if num_m < 200:  # minNumEventsToRescale (align.c:677)
        return False, None
    lm = model["level_mean"]
    ls = model["level_stdv"]
    A00 = A01 = A11 = b0 = b1 = 0.0
    means = events["mean"]
    for ea in alignment:
        if ea["hmm_state"] != "M":
            continue
        rank = get_kmer_rank(ea["ref_kmer"])
        e = float(np.float64(means[ea["event_idx"]]))
        mu = float(np.float64(lm[rank]))
        stdv = float(np.float64(ls[rank]))
        inv_var = 1.0 / (stdv * stdv)
        A00 += inv_var
        A01 += mu * inv_var
        A11 += mu * mu * inv_var
        b0 += e * inv_var
        b1 += mu * e * inv_var
    A10 = A01
    div = A00 * A11 - A01 * A10
    shift = -(A01 * b1 - A11 * b0) / div
    scale = (A00 * b1 - A10 * b0) / div
    var = 1.0
    if scale_var:
        var = 0.0
        for ea in alignment:
            if ea["hmm_state"] != "M":
                continue
            rank = get_kmer_rank(ea["ref_kmer"])
            e = float(np.float64(means[ea["event_idx"]]))
            yi = e - shift - scale * float(np.float64(lm[rank]))
            stdv = float(np.float64(ls[rank]))
            var += yi * yi / (stdv * stdv)
        var /= num_m
        var = float(np.sqrt(var))
    # C sets log_var = log(var) from the DOUBLE local, then stores f32
    # (align.c:745-750) — not log of the already-rounded f32 var
    sc = {"shift": np.float32(shift), "scale": np.float32(scale),
          "var": np.float32(var),
          "log_var": np.float32(np.log(var))}
    return True, sc


def scaling_read(sequence, events, pairs, model):
    """f5c.c scaling_single (:1263-1330): postalign + recalibrate + QC.
    Returns (read_stat_flag, scalings, base_to_event_map, events_per_base)."""
    if not pairs:
        return FAILED_ALIGNMENT, None, None, 0.0
    alignment, b2e, events_per_base = postalign(sequence, pairs)
    calibrated, sc = recalibrate_model(model, events, alignment, scale_var=True)
    if not calibrated or float(sc["var"]) > MIN_CALIBRATION_VAR:
        return FAILED_CALIBRATION, None, b2e, events_per_base
    if events_per_base > 5.0:
        return FAILED_QUALITY_CHK, sc, b2e, events_per_base
    return 0, sc, b2e, events_per_base


# ---------------------------------------------------------------------------
# 4: realign to reference (eventalign.c)
# ---------------------------------------------------------------------------

# BAM cigar op semantics (eventalign.c:1112-1180)
_CIGAR_INC = {"M": (1, 1), "=": (1, 1), "X": (1, 1), "D": (0, 1),
              "I": (1, 0), "S": (1, 0), "H": (0, 0)}


def get_aligned_segments(record, read_stride=1):
    """Cigar walk -> [(ref_pos, read_pos)] segments, split at N ops
    (get_aligned_segments_two_params, eventalign.c:1112-1180).  ``record``
    is an io.bam.BamRecord."""
    segments = [[]]
    read_pos = 0
    ref_pos = record.pos
    for op, length in record.cigar:
        if op == "N":
            segments.append([])
            for _ in range(length):
                ref_pos += 1
            continue
        if op not in _CIGAR_INC:
            raise ValueError(f"Unhandled cigar operation {op}")
        read_inc, ref_inc = _CIGAR_INC[op]
        if op == "S":
            read_inc = 1  # special case, not read_stride
        elif read_inc:
            read_inc = read_stride
        is_aligned = op in ("M", "=", "X")
        for _ in range(length):
            if is_aligned:
                segments[-1].append((ref_pos, read_pos))
            read_pos += read_inc
            ref_pos += ref_inc
    return segments


def trim_aligned_pairs_to_ref_region(pairs, ref_start, ref_end):
    return [p for p in pairs if ref_start <= p[0] <= ref_end]


def trim_aligned_pairs_to_kmer(pairs, max_kmer_idx):
    idx = len(pairs) - 1
    while idx >= 0 and pairs[idx][1] > max_kmer_idx:
        idx -= 1
    return pairs[:idx + 1]


def get_next_event(start, stop, stride, b2e):
    while start != stop:
        ei = int(b2e[start, 0])
        if ei != -1:
            return ei
        start += stride
    return -1


def get_closest_event_to(k_idx, b2e, b2e_size):
    stop_before = max(0, k_idx - 1000)
    stop_after = min(k_idx + 1000, b2e_size - 1)
    event_before = get_next_event(k_idx, stop_before, -1, b2e)
    event_after = get_next_event(k_idx, stop_after, 1, b2e)
    if event_before == -1:
        return event_after
    return event_before


def get_end_pair(pairs, ref_pos_max, pair_idx):
    while pair_idx < len(pairs):
        if pairs[pair_idx][0] > ref_pos_max:
            return pair_idx - 1
        pair_idx += 1
    return len(pairs) - 1


def flip_k_strand(read_length, k_idx, k=KMER_SIZE):
    return read_length - k_idx - k


def make_pre_flanking(num_events):
    """eventalign.c:115-151 — f64 chain rounded to f32 per element."""
    pre = np.zeros(num_events + 1, np.float32)
    pre[0] = np.float32(np.log(1 - TRANS_START_TO_CLIP))
    if num_events + 1 > 1:
        pre[1] = np.float32(np.log(TRANS_START_TO_CLIP)
                            + np.float64(np.float32(-3.0))
                            + np.log(1 - TRANS_CLIP_SELF))
    for i in range(2, num_events + 1):
        pre[i] = np.float32(np.log(TRANS_CLIP_SELF)
                            + np.float64(np.float32(-3.0))
                            + np.float64(pre[i - 1]))
    return pre


def make_post_flanking(num_events):
    """eventalign.c:75-113."""
    post = np.zeros(num_events, np.float32)
    post[num_events - 1] = np.float32(np.log(1 - TRANS_START_TO_CLIP))
    if num_events > 1:
        post[num_events - 2] = np.float32(np.log(TRANS_START_TO_CLIP)
                                          + np.float64(np.float32(-3.0))
                                          + np.log(1 - TRANS_CLIP_SELF))
        for i in range(num_events - 3, -1, -1):
            post[i] = np.float32(np.log(TRANS_CLIP_SELF)
                                 + np.float64(np.float32(-3.0))
                                 + np.float64(post[i + 1]))
    return post


def calculate_transitions(num_kmers, events_per_base):
    """eventalign.c:171-243.  Returns [num_kmers, 10] f32 columns
    (mm_self, mb, mk, mm_next, bb, bk, bm_next, bm_self, kk, km)."""
    p_stay = np.float32(1 - (1 / np.float64(events_per_base)))
    p_skip = np.float32(0.0025)
    p_bad = np.float32(0.001)
    p_bad_self = p_bad
    p_skip_self = np.float32(0.3)
    p_mk, p_mb, p_mm_self = p_skip, p_bad, p_stay
    p_mm_next = np.float32(np.float32(1.0) - p_mm_self - p_mk - p_mb)
    p_bb = p_bad_self
    p_b3 = np.float32((np.float32(1.0) - p_bb) / np.float32(3))
    p_kk = p_skip_self
    p_km = np.float32(np.float32(1.0) - p_kk)
    row = np.array(
        [np.float32(np.log(np.float64(p))) for p in
         (p_mm_self, p_mb, p_mk, p_mm_next, p_bb, p_b3, p_b3, p_b3,
          p_kk, p_km)], np.float32)
    return np.tile(row, (num_kmers, 1))


def _log_emission_matrix(kmer_ranks, event_indices, event_means, model, sc):
    """log_probability_match_r9 over [rows, kmers] (eventalign.c:302-343),
    elementwise f32 — no accumulation so vectorizing is exact."""
    lm = model["level_mean"].astype(np.float32)
    ls = model["level_stdv"].astype(np.float32)
    lls = model["level_log_stdv"].astype(np.float32)
    gp_mean = (sc["scale"] * lm[kmer_ranks] + sc["shift"]).astype(np.float32)
    gp_stdv = (ls[kmer_ranks] * sc["var"]).astype(np.float32)
    gp_log_stdv = (lls[kmer_ranks] + sc["log_var"]).astype(np.float32)
    lvl = event_means[event_indices].astype(np.float32)[:, None]
    a = ((lvl - gp_mean[None, :]) / gp_stdv[None, :]).astype(np.float32)
    return (np.float32(-0.918938) - gp_log_stdv[None, :]
            + (np.float32(-0.5) * a * a)).astype(np.float32)


def profile_hmm_align(fwd_subseq, rc_subseq, events, sc, model,
                      events_per_base, rc, e_start, e_end, event_stride):
    """Viterbi profile HMM (eventalign.c:703-918).  Returns the backtracked
    [(event_idx, kmer_idx, state_char)] in forward order."""
    k = KMER_SIZE
    n_kmers = len(fwd_subseq) - k + 1
    n_events = (e_end - e_start if e_end > e_start else e_start - e_end) + 1
    assert n_events >= 2
    n_rows = n_events + 1
    num_blocks = n_kmers + 2
    last_kmer_idx = n_kmers - 1
    last_event_row_idx = n_rows - 1

    bt = calculate_transitions(n_kmers, events_per_base)
    (lp_mm_self, lp_mb, lp_mk, lp_mm_next, lp_bb, lp_bk, lp_bm_next,
     lp_bm_self, lp_kk, lp_km) = (bt[:, j] for j in range(10))

    seq_len = len(fwd_subseq)
    if not rc:
        kmer_ranks = np.array([get_kmer_rank(fwd_subseq[ki:ki + k])
                               for ki in range(n_kmers)], np.int64)
    else:
        kmer_ranks = np.array(
            [get_kmer_rank(rc_subseq[seq_len - ki - k:seq_len - ki])
             for ki in range(n_kmers)], np.int64)

    pre_flank = make_pre_flanking(n_events)
    post_flank = make_post_flanking(n_events)

    event_indices = e_start + np.arange(n_rows - 1, dtype=np.int64) * event_stride
    lp_em = _log_emission_matrix(kmer_ranks, event_indices,
                                 events["mean"], model, sc)

    # state matrices: one f32 row vector per state per event row
    M = np.full((n_rows, num_blocks), _NEG_INF, np.float32)
    B = np.full((n_rows, num_blocks), _NEG_INF, np.float32)
    K = np.full((n_rows, num_blocks), _NEG_INF, np.float32)
    fM = np.zeros((n_rows, num_blocks), np.uint8)
    fB = np.zeros((n_rows, num_blocks), np.uint8)
    fK = np.zeros((n_rows, num_blocks), np.uint8)

    def last_argmax(stack):
        # update_cell keeps the LAST index equal to the max
        # (eventalign.c:608-618); ties at -inf included, initial from=0
        mx = stack[0]
        frm = np.zeros(stack.shape[1], np.uint8)
        for i in range(1, stack.shape[0]):
            mx = np.maximum(mx, stack[i])
            frm = np.where(stack[i] == mx, np.uint8(i), frm)
        return mx, frm

    lp_end = _NEG_INF
    end_row = end_col = 0
    blocks = np.arange(1, num_blocks - 1)
    for row in range(1, n_rows):
        prev_m = M[row - 1]
        prev_b = B[row - 1]
        prev_k = K[row - 1]
        em = lp_em[row - 1]

        # PSR9_MATCH: all six sources from row-1 (soft only at kmer 0 when
        # event_idx == e_start, i.e. row == 1; hmm_flags == 0)
        soft = np.full(n_kmers, _NEG_INF, np.float32)
        if row == 1:
            soft[0] = pre_flank[row - 1]
        cand = np.stack([
            lp_mm_self + prev_m[blocks],
            lp_mm_next + prev_m[blocks - 1],
            lp_bm_self + prev_b[blocks],
            lp_bm_next + prev_b[blocks - 1],
            lp_km + prev_k[blocks - 1],
            soft,
        ]).astype(np.float32)
        mx, frm = last_argmax(cand)
        M[row, 1:num_blocks - 1] = mx + em
        fM[row, 1:num_blocks - 1] = frm

        # PSR9_BAD_EVENT: from same-block M/B at row-1 (emission 0)
        cand = np.stack([
            lp_mb + prev_m[blocks],
            np.full(n_kmers, _NEG_INF, np.float32),
            lp_bb + prev_b[blocks],
            np.full(n_kmers, _NEG_INF, np.float32),
            np.full(n_kmers, _NEG_INF, np.float32),
            np.full(n_kmers, _NEG_INF, np.float32),
        ]).astype(np.float32)
        mx, frm = last_argmax(cand)
        B[row, 1:num_blocks - 1] = mx
        fB[row, 1:num_blocks - 1] = frm

        # PSR9_KMER_SKIP: same-ROW previous block (sequential in block, the
        # C fills blocks left-to-right within a row; cumulative-scan
        # reformulations change f32 op order so keep the loop)
        m_row = M[row]
        b_row = B[row]
        k_row = K[row]
        for b in range(1, num_blocks - 1):
            ki = b - 1
            x1 = np.float32(lp_mk[ki] + m_row[b - 1])
            x3 = np.float32(lp_bk[ki] + b_row[b - 1])
            x4 = np.float32(lp_kk[ki] + k_row[b - 1])
            # replicate the exact last-max loop over the 6-vector
            xs = (_NEG_INF, x1, _NEG_INF, x3, x4, _NEG_INF)
            mxs = xs[0]
            frm_s = 0
            for i in range(1, 6):
                if xs[i] > mxs:
                    mxs = xs[i]
                if xs[i] == mxs:
                    frm_s = i
            k_row[b] = mxs
            fK[row, b] = frm_s

        # end-state updates from the last kmer block at the final row
        # (POST_CLIP not set: only row == last_event_row_idx)
        if row == last_event_row_idx:
            b = num_blocks - 2
            pf = post_flank[row - 1]
            for val, col_state in ((m_row[b], PSR9_MATCH),
                                   (b_row[b], PSR9_BAD_EVENT),
                                   (k_row[b], PSR9_KMER_SKIP)):
                v = np.float32(val + pf)
                if v > lp_end:
                    lp_end = v
                    end_row = row
                    end_col = PSR9_NUM_STATES * b + col_state

    # Backtrack (eventalign.c:808-891): start at last event x last kmer MATCH
    state_mats = {PSR9_KMER_SKIP: (K, fK), PSR9_BAD_EVENT: (B, fB),
                  PSR9_MATCH: (M, fM)}
    alignment = []
    row = n_rows - 1
    col = PSR9_NUM_STATES * n_kmers + PSR9_MATCH
    while row > 0:
        event_idx = e_start + (row - 1) * event_stride
        block = col // PSR9_NUM_STATES
        kmer_idx = block - 1
        curr_ps = col % PSR9_NUM_STATES
        vals, frms = state_mats[curr_ps]
        alignment.append((int(event_idx), int(kmer_idx), "KBM"[curr_ps]))
        movement = int(frms[row, block])
        if movement == HMT_FROM_SOFT:
            break
        if movement == HMT_FROM_SAME_M:
            next_ps = PSR9_MATCH
        elif movement == HMT_FROM_PREV_M:
            kmer_idx -= 1
            next_ps = PSR9_MATCH
        elif movement == HMT_FROM_SAME_B:
            next_ps = PSR9_BAD_EVENT
        elif movement == HMT_FROM_PREV_B:
            kmer_idx -= 1
            next_ps = PSR9_BAD_EVENT
        elif movement == HMT_FROM_PREV_K:
            kmer_idx -= 1
            next_ps = PSR9_KMER_SKIP
        else:
            raise AssertionError(movement)
        if curr_ps != PSR9_KMER_SKIP:
            row -= 1
        col = PSR9_NUM_STATES * (kmer_idx + 1) + next_ps
    alignment.reverse()
    return alignment


def align_read_to_ref(record, ref_seq, ref_offset, read_length, events, sc,
                      model, b2e, events_per_base, read_idx,
                      region_start=-1, region_end=-1):
    """eventalign.c:1263-1543.  ``ref_seq`` is the reference slice covering
    [ref_offset, bam_endpos).  Returns event_alignment_t dicts."""
    k = KMER_SIZE
    alignment_output = []
    ref_seq = disambiguate(ref_seq)
    rc_ref_seq = reverse_complement(ref_seq)
    aligned_segments = get_aligned_segments(record, 1)
    b2e_size = read_length - k + 1
    for aligned_pairs in aligned_segments:
        if region_start != -1 and region_end != -1:
            aligned_pairs = trim_aligned_pairs_to_ref_region(
                aligned_pairs, region_start, region_end)
        max_kmer_idx = read_length - k
        aligned_pairs = trim_aligned_pairs_to_kmer(aligned_pairs, max_kmer_idx)
        if not aligned_pairs:
            return alignment_output
        do_base_rc = record.is_reverse
        rc_flags = (do_base_rc, not do_base_rc)
        align_stride = 100
        output_stride = 50
        read_kidx_start = aligned_pairs[0][1]
        read_kidx_end = aligned_pairs[-1][1]
        if do_base_rc:
            read_kidx_start = flip_k_strand(read_length, read_kidx_start)
            read_kidx_end = flip_k_strand(read_length, read_kidx_end)
        assert read_kidx_start >= 0 and read_kidx_end >= 0
        first_event = get_closest_event_to(read_kidx_start, b2e, b2e_size)
        last_event = get_closest_event_to(read_kidx_end, b2e, b2e_size)
        forward = first_event < last_event
        curr_start_event = first_event
        curr_start_ref = aligned_pairs[0][0]
        curr_pair_idx = 0
        while ((forward and curr_start_event < last_event)
               or (not forward and curr_start_event > last_event)):
            end_pair_idx = get_end_pair(
                aligned_pairs, curr_start_ref + align_stride, curr_pair_idx)
            curr_end_ref = aligned_pairs[end_pair_idx][0]
            curr_end_read = aligned_pairs[end_pair_idx][1]
            if do_base_rc:
                curr_end_read = flip_k_strand(read_length, curr_end_read)
            assert curr_end_read >= 0
            s = curr_start_ref - ref_offset
            l = curr_end_ref - curr_start_ref + 1
            fwd_subseq = ref_seq[s:s + l]
            rc_subseq = rc_ref_seq[len(ref_seq) - s - l:len(ref_seq) - s]
            assert len(fwd_subseq) == len(rc_subseq)
            if len(fwd_subseq) < 2 * k:
                break
            input_event_stop_idx = get_closest_event_to(
                curr_end_read, b2e, b2e_size)
            if abs(curr_start_event - input_event_stop_idx) < 2:
                break
            event_stride = 1 if curr_start_event < input_event_stop_idx else -1
            input_rc = rc_flags[0]
            event_alignment = profile_hmm_align(
                fwd_subseq, rc_subseq, events, sc, model, events_per_base,
                input_rc, curr_start_event, input_event_stop_idx, event_stride)

            num_output = 0
            last_section = end_pair_idx == len(aligned_pairs) - 1
            last_event_output = 0
            last_ref_kmer_output = 0
            for as_ev, as_kmer, as_state in event_alignment:
                if not (num_output < output_stride or last_section):
                    break
                if as_state != "K" and as_ev != curr_start_event:
                    ref_position = curr_start_ref + as_kmer
                    ref_kmer = ref_seq[ref_position - ref_offset:
                                       ref_position - ref_offset + k]
                    if as_state != "B":
                        if rc_flags[0]:
                            model_kmer = rc_subseq[
                                len(rc_subseq) - as_kmer - k:
                                len(rc_subseq) - as_kmer]
                        else:
                            model_kmer = fwd_subseq[as_kmer:as_kmer + k]
                    else:
                        model_kmer = "N" * k
                    alignment_output.append({
                        "ref_position": ref_position, "ref_kmer": ref_kmer,
                        "read_idx": read_idx, "event_idx": as_ev,
                        "rc": rc_flags[0], "model_kmer": model_kmer,
                        "hmm_state": as_state,
                    })
                    last_event_output = as_ev
                    last_ref_kmer_output = curr_start_ref + as_kmer
                    num_output += 1
            curr_start_event = last_event_output
            curr_start_ref = last_ref_kmer_output
            curr_pair_idx = get_end_pair(
                aligned_pairs, curr_start_ref, curr_pair_idx)
            if num_output == 0:
                break
    return alignment_output


# ---------------------------------------------------------------------------
# 5: summary + TSV (eventalign.c:1580-1941)
# ---------------------------------------------------------------------------

def z_score(events, model, sc, kmer_rank, event_idx):
    level = np.float32(events["mean"][event_idx])
    gp_mean = np.float32(sc["scale"] * np.float32(model["level_mean"][kmer_rank])
                         + sc["shift"])
    gp_stdv = np.float32(np.float32(model["level_stdv"][kmer_rank]) * sc["var"])
    return np.float32((level - gp_mean) / gp_stdv)


def summarize_alignment(events, model, sc, alignments, sample_rate, nm=0):
    summary = {"num_events": 0, "num_steps": 0, "num_stays": 0,
               "num_skips": 0, "sum_z_score": 0.0, "sum_duration": 0.0,
               "alignment_edit_distance": nm, "reference_span": 0}
    # C: size_t prev_ref_pos = npos; ref_move is UNSIGNED, so a backwards
    # ref step wraps to a huge value and counts as a skip (i != 0)
    prev_ref_pos = (1 << 64) - 1
    for i, ea in enumerate(alignments):
        summary["num_events"] += 1
        ref_move = (ea["ref_position"] - prev_ref_pos) % (1 << 64)
        if ref_move == 0:
            summary["num_stays"] += 1
        elif i != 0 and ref_move > 1:
            summary["num_skips"] += 1
        elif i != 0 and ref_move == 1:
            summary["num_steps"] += 1
        summary["sum_duration"] += float(
            np.float32(events["length"][ea["event_idx"]]))
        if ea["hmm_state"] == "M":
            rank = get_kmer_rank(ea["model_kmer"])
            summary["sum_z_score"] += float(
                z_score(events, model, sc, rank, ea["event_idx"]))
        prev_ref_pos = ea["ref_position"]
    if alignments:
        summary["reference_span"] = (alignments[-1]["ref_position"]
                                     - alignments[0]["ref_position"] + 1)
    return summary


def emit_tsv_header(print_read_names=False, write_samples=False):
    name = "read_name" if print_read_names else "read_index"
    return ("contig\tposition\treference_kmer\t" + name + "\tstrand\t"
            "event_index\tevent_level_mean\tevent_stdv\tevent_length\t"
            "model_kmer\tmodel_mean\tmodel_stdv\tstandardized_level\n")


def emit_tsv_lines(events, model, sc, alignments, read_index, read_name,
                   ref_name, sample_rate, print_read_names=False,
                   scale_events=False):
    """emit_event_alignment_tsv (eventalign.c:1853-1941), %.2lf/%.3lf/%.5lf
    printf formats on the f32 values promoted to double."""
    lines = []
    lm, ls = model["level_mean"], model["level_stdv"]
    for ea in alignments:
        who = read_name if print_read_names else str(int(read_index))
        event_mean = np.float32(events["mean"][ea["event_idx"]])
        event_stdv = np.float32(events["stdv"][ea["event_idx"]])
        event_duration = np.float32(
            np.float32(events["length"][ea["event_idx"]]) / np.float32(sample_rate))
        rank = get_kmer_rank(ea["model_kmer"])
        model_mean = np.float32(0.0)
        model_stdv = np.float32(0.0)
        if scale_events:
            event_mean = np.float32(
                (event_mean - sc["shift"]) / sc["scale"])
            if ea["hmm_state"] != "B":
                model_mean = np.float32(lm[rank])
                model_stdv = np.float32(ls[rank])
        else:
            if ea["hmm_state"] != "B":
                model_mean = np.float32(sc["scale"] * np.float32(lm[rank])
                                        + sc["shift"])
                model_stdv = np.float32(np.float32(ls[rank]) * sc["var"])
        # C: float / (sqrt(double var) * float) — the denominator stays
        # double; only the final quotient rounds to f32.  B states have
        # model_stdv == 0 and print inf, like the reference's printf
        with np.errstate(divide="ignore"):
            standard_level = np.float32(
                np.float64(np.float32(event_mean - model_mean))
                / (np.sqrt(np.float64(sc["var"])) * np.float64(model_stdv)))
        lines.append(
            f"{ref_name}\t{ea['ref_position']}\t{ea['ref_kmer']}\t{who}\tt\t"
            f"{ea['event_idx']}\t{float(event_mean):.2f}\t"
            f"{float(event_stdv):.3f}\t{float(event_duration):.5f}\t"
            f"{ea['model_kmer']}\t{float(model_mean):.2f}\t"
            f"{float(model_stdv):.2f}\t{float(standard_level):.2f}\n")
    return lines
