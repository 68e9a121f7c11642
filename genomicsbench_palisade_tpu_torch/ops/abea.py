"""Adaptive banded event alignment (f5c eventalign's abea kernel).

Counterpart of genomicsbench_palisade_tpu/ops/abea.py (`lp_consts_f64`,
`_kmer_ranks`, the band-fill scan `abea_fill_bands`, the traceback and QC
of `_traceback_batch`, `align_events_batch`) and of the TPU kernels in
ops/abea_pallas.py: the fill `_kernel` and the walk `_walk_kernel` with
its decode `_decode_walk_read`.

Host prep in numpy (`prepare_batch`): per k-mer its rank and the f32
`gm = scale*level_mean[rank] + shift`, `stdv`, `lstdv`; per read the
double transition penalties.  A batch is flat, reads concatenated, no
padding (`convert.abea_batch_from_numpy` carries it to tensors):

    ev                       [E] f32    event means
    gm, stdv, lstdv          [K] f32    per k-mer
    ev_off, k_off, band_off  [B] int64  first event, k-mer, band row
    ne, nk                   [B] int32  events, k-mers (both >= 1)
    lp                       [B, 4] f64 lp_skip, lp_stay, lp_step, lp_trim

Read b has nb = ne + nk + 2 bands, rows band_off[b] .. + nb of the fill's
outputs, which are (`abea_fill`, [R] = sum of nb = E + K + 2B rows):

    trace     [R, 100] uint8  per band the move of each cell (FROM_D/U/L,
                              0 outside the band's valid cells)
    bll_e     [R] int32       the band's lower-left event index
    last_val  [R] f32         the cell of the last k-mer, -inf if outside
    seed      [B] int32       the backtrack's first event (align.c:417-433)

and the walk's (`abea_walk`, from (nk - 1, seed) down to a -1 index):

    pairs     [R, 2] int32    (kmer, event) in walk order (descending) at
                              rows band_off[b] .., zeros past the count
    n         [B] int32       pairs of the walk
    max_gap   [B] int32       longest run of FROM_L moves
    sum_em    [B] f64         the f32 emissions of the pairs summed in
                              double in walk order

Both run the CUDA kernels (csrc/abea_fill.cu, csrc/abea_walk.cu) for CUDA
tensors and the plain PyTorch versions for CPU tensors.  The plain fill
takes all reads in lockstep, one step per band over [B, 100] tensors; the
plain walk one step per move.  Arithmetic is the oracle's (align.c):
scores `(float)((double)prev + lp + (double)emission)` with real doubles,
the emission in f32 in the oracle's order, the trim cell
`(float)(lp_trim * (double)band)`, U over D and L over both on ties.  So
kernels, plain versions and oracle agree bit for bit; the JAX scan rounds
through compensated f32 sums instead (the TPU has no f64).

The decode and QC (`decode`) drop a read whose average emission is below
-5, whose walk does not span k-mers 0 to nk - 1, or whose longest skip
run is above 50 (postalign, align.c:443-548).

The JAX package's native host engines stand beside the kernels:
`align_events_batch_native` (native/abeafill.cpp: fill, traceback and QC
a read on the host; `align_events_batch(..., use_native=True)`) and
`traceback_host` (native/abea_tb.cpp: the walk and QC of the fill's
outputs, abea_walk plus decode).  The kernels stay the default and the
CLI's route (ROADMAP queue 3).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import default_device
from ..convert import abea_batch_from_numpy, abea_model_from_numpy
from ..io import native
from . import abea_cuda
from .oracle.abea import ALN_BANDWIDTH, FROM_D, FROM_L, FROM_U, KMER_SIZE

BW = ALN_BANDWIDTH
HALF = BW // 2
MIN_AVG_EMISSION = -5.0
MAX_GAP = 50
EMISSION_C = float(np.float32(-0.918938))  # log(1/sqrt(2 pi)), as the C's float

_RANK_TABLE = np.zeros(256, np.int64)
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _RANK_TABLE[ord(_ch)] = _v


def lp_consts_f64(n_events: int, n_kmers: int):
    """Transition penalties in DOUBLE, like align.c:199-205."""
    events_per_kmer = n_events / n_kmers
    p_stay = 1 - (1 / (events_per_kmer + 1))
    lp_skip = np.log(1e-10)
    lp_stay = np.log(p_stay)
    lp_step = np.log(1.0 - np.exp(lp_skip) - np.exp(lp_stay))
    lp_trim = np.log(0.01)
    return lp_skip, lp_stay, lp_step, lp_trim


def kmer_ranks(sequence: str, k: int, n_kmers: int) -> np.ndarray:
    """oracle.get_kmer_rank of every window, vectorised (the first base is
    the high bits; any base but ACGT ranks as A)."""
    codes = _RANK_TABLE[np.frombuffer(sequence.encode(), np.uint8)]
    ranks = np.zeros(max(n_kmers, 0), np.int64)
    for j in range(k):
        ranks |= codes[j : j + n_kmers] << (2 * (k - 1 - j))
    return ranks


def prepare_batch(sequences, event_means_list, model, scales, shifts):
    """(numpy flat batch, indices of the reads in it).  Reads with no k-mer
    or no event are left out (they align to nothing)."""
    idx = [i for i, (seq, ev) in enumerate(zip(sequences, event_means_list))
           if len(seq) - KMER_SIZE + 1 >= 1 and len(ev) >= 1]
    ne = np.array([len(event_means_list[i]) for i in idx], np.int64)
    nk = np.array([len(sequences[i]) - KMER_SIZE + 1 for i in idx], np.int64)
    model = abea_model_from_numpy(model)
    lm, ls, lls = model["level_mean"], model["level_stdv"], model["level_log_stdv"]
    ranks = np.concatenate([kmer_ranks(sequences[i], KMER_SIZE, int(n)) for i, n in zip(idx, nk)]
                           + [np.zeros(0, np.int64)])
    # the C computes the scaled level in float: scale*mean, then + shift
    sc = np.repeat(np.asarray([scales[i] for i in idx], np.float32), nk)
    sh = np.repeat(np.asarray([shifts[i] for i in idx], np.float32), nk)
    ev = [np.asarray(event_means_list[i], np.float32) for i in idx]
    ev_off = np.concatenate(([0], np.cumsum(ne)[:-1])).astype(np.int64)[: len(idx)]
    k_off = np.concatenate(([0], np.cumsum(nk)[:-1])).astype(np.int64)[: len(idx)]
    batch = {
        "ev": np.concatenate(ev + [np.zeros(0, np.float32)]),
        "gm": sc * lm[ranks] + sh,
        "stdv": ls[ranks],
        "lstdv": lls[ranks],
        "ev_off": ev_off,
        "k_off": k_off,
        "band_off": ev_off + k_off + 2 * np.arange(len(idx), dtype=np.int64),
        "ne": ne.astype(np.int32),
        "nk": nk.astype(np.int32),
        # per read, like the oracle (numpy's array loops may round otherwise)
        "lp": np.array([lp_consts_f64(int(a), int(b)) for a, b in zip(ne, nk)],
                       np.float64).reshape(len(idx), 4),
    }
    return batch, idx


def n_rows(batch) -> int:
    """Band rows of the batch: sum of ne + nk + 2."""
    return batch["ev"].shape[0] + batch["gm"].shape[0] + 2 * batch["ne"].shape[0]


def _emission(level, gm, stdv, lstdv):
    """log N(level; gm, stdv) in f32, in the oracle's order:
    (-0.918938 - lstdv) + ((-0.5 * a) * a), a = (level - gm) / stdv.  The
    two constants are f32 values, so PyTorch's cast of them is exact."""
    a = (level - gm) / stdv
    return (EMISSION_C - lstdv) + ((-0.5 * a) * a)


def abea_fill_plain(batch) -> dict:
    """The plain PyTorch fill: every read in lockstep, one step per band
    over [B, 100] tensors.  Same outputs as the kernel (module doc)."""
    ne, nk = batch["ne"].long(), batch["nk"].long()
    dev = ne.device
    b = ne.numel()
    rows = n_rows(batch)
    neg_inf = float("-inf")
    # one row past the end takes the writes of reads that have ended
    trace = torch.zeros((rows + 1, BW), dtype=torch.uint8, device=dev)
    bll_e = torch.zeros(rows + 1, dtype=torch.int32, device=dev)
    last_val = torch.full((rows + 1,), neg_inf, dtype=torch.float32, device=dev)
    seed = torch.zeros(b, dtype=torch.int64, device=dev)
    out = {"trace": trace[:rows], "bll_e": bll_e[:rows], "last_val": last_val[:rows]}
    if b == 0:
        return {**out, "seed": seed.int()}
    row0 = batch["band_off"]
    ev, gm, stdv, lstdv = batch["ev"], batch["gm"], batch["stdv"], batch["lstdv"]
    ev_off, k_off = batch["ev_off"], batch["k_off"]
    lp_skip, lp_stay, lp_step, lp_trim = (batch["lp"][:, j : j + 1] for j in range(4))
    nb = ne + nk + 2
    o = torch.arange(BW, device=dev)

    # bands 0 and 1: the origin and the first trim cell
    b2 = torch.full((b, BW), neg_inf, device=dev)
    b2[:, HALF] = 0.0
    b1 = torch.full((b, BW), neg_inf, device=dev)
    b1[:, HALF] = lp_trim[:, 0].float()
    trace[row0 + 1, HALF] = FROM_U
    bll_e[row0] = HALF - 1
    bll_e[row0 + 1] = HALF
    e1 = torch.full((b,), HALF, dtype=torch.int64, device=dev)
    k1 = torch.full((b,), -1 - HALF, dtype=torch.int64, device=dev)
    k2 = k1.clone()
    best = torch.full((b,), neg_inf, device=dev)
    neg_col = torch.full((b, 1), neg_inf, device=dev)
    neg2 = torch.full((b, 2), neg_inf, device=dev)
    u8 = {v: torch.tensor(v, dtype=torch.uint8, device=dev) for v in (FROM_D, FROM_U, FROM_L)}

    for bi in range(2, int(nb.max())):
        live = bi < nb
        ll, ur = b1[:, 0], b1[:, BW - 1]
        both = torch.isneginf(ll) & torch.isneginf(ur)
        right = torch.where(both, torch.full_like(both, bi % 2 == 1), ll < ur).long()
        be, bk = e1 + 1 - right, k1 + right
        ei = be[:, None] - o
        ki = bk[:, None] + o
        # the neighbours: up b1[o + right], left b1[o + right - 1], diag
        # b2[o + (bk - k2) - 1], -inf outside the band
        pad1 = torch.cat([neg_col, b1, neg_col], dim=1)
        up = pad1.gather(1, o + right[:, None] + 1)
        left = pad1.gather(1, o + right[:, None])
        pad2 = torch.cat([neg2, b2, neg2], dim=1)
        diag = pad2.gather(1, o + (bk - k2)[:, None] + 1)

        valid = (ki >= 0) & (ki < nk[:, None]) & (ei >= 0) & (ei < ne[:, None])
        kx = k_off[:, None] + torch.minimum(ki.clamp(min=0), nk[:, None] - 1)
        ex = ev_off[:, None] + torch.minimum(ei.clamp(min=0), ne[:, None] - 1)
        em = _emission(ev[ex], gm[kx], stdv[kx], lstdv[kx]).double()
        score_d = ((diag.double() + lp_step) + em).float()
        score_u = ((up.double() + lp_stay) + em).float()
        score_l = (left.double() + lp_skip).float()
        ms = torch.where(score_u > score_d, score_u, score_d)
        frm = torch.where(ms == score_u, u8[FROM_U], u8[FROM_D])
        ms = torch.where(score_l > ms, score_l, ms)
        frm = torch.where(ms == score_l, u8[FROM_L], frm)
        new = torch.where(valid, ms, neg_inf)
        tr = torch.where(valid, frm, u8[FROM_D])

        # the trim cell at k-mer -1 holds event bi - 1
        at_trim = o == (-1 - bk)[:, None]
        t_in = (bi - 1 < ne)[:, None]
        t_val = (lp_trim * bi).float()
        new = torch.where(at_trim, torch.where(t_in, t_val, neg_inf), new)
        tr = torch.where(at_trim & t_in, u8[FROM_U], tr)

        # the last k-mer's cell, and the seed: the first event maximising
        # (float)(last + (ne - ei) * lp_trim)
        lo = nk - 1 - bk
        l_ok = (lo >= 0) & (lo < BW)
        lv = torch.where(l_ok, new.gather(1, lo.clamp(0, BW - 1)[:, None])[:, 0], neg_inf)
        ei_s = bi - nk - 1
        s = (lv.double() + (ne - ei_s).double() * lp_trim[:, 0]).float()
        better = live & l_ok & (ei_s >= 0) & (ei_s < ne) & (s > best)
        best = torch.where(better, s, best)
        seed = torch.where(better, ei_s, seed)

        row = torch.where(live, row0 + bi, rows)
        trace.index_copy_(0, row, tr)
        bll_e.index_copy_(0, row, be.int())
        last_val.index_copy_(0, row, lv)
        b2, b1, k2, e1, k1 = b1, new, k1, be, bk
    return {**out, "seed": seed.int()}


def abea_walk_plain(batch, fill) -> dict:
    """The plain PyTorch walk: every read in lockstep, one step per move.
    Same outputs as the kernel (module doc).  An offset outside the band
    (only a walk from an all -inf seed column gets there) is clamped to
    the band's edge, as the JAX package's walk does."""
    ne, nk = batch["ne"].long(), batch["nk"].long()
    dev = ne.device
    b = ne.numel()
    rows = n_rows(batch)
    pairs = torch.zeros((rows + 1, 2), dtype=torch.int32, device=dev)
    cnt = torch.zeros(b, dtype=torch.int64, device=dev)
    max_gap = torch.zeros(b, dtype=torch.int64, device=dev)
    sum_em = torch.zeros(b, dtype=torch.float64, device=dev)
    out = {"pairs": pairs[:rows]}
    if b == 0:
        return {**out, "n": cnt.int(), "max_gap": max_gap.int(), "sum_em": sum_em}
    row0 = batch["band_off"]
    trace, bll_e = fill["trace"], fill["bll_e"]
    ck = nk - 1
    ce = fill["seed"].long()
    gap = torch.zeros_like(cnt)
    active = (ck >= 0) & (ce >= 0)
    for step in range(int((ne + nk).max())):
        if step % 1024 == 1023 and not bool(active.any()):
            break
        pairs.index_copy_(0, torch.where(active, row0 + cnt, rows),
                          torch.stack([ck, ce], dim=1).int())
        kx = batch["k_off"] + ck.clamp(min=0)
        ex = batch["ev_off"] + ce.clamp(min=0)
        em = _emission(batch["ev"][ex], batch["gm"][kx], batch["stdv"][kx], batch["lstdv"][kx])
        sum_em = torch.where(active, sum_em + em.double(), sum_em)
        cnt += active
        band = torch.where(active, row0 + ce + ck + 2, 0)
        off = (bll_e[band] - ce).clamp(0, BW - 1)
        frm = trace[band, off]
        is_d, is_u = frm == FROM_D, frm == FROM_U
        is_l = ~is_d & ~is_u
        ck = torch.where(active & ~is_u, ck - 1, ck)
        ce = torch.where(active & ~is_l, ce - 1, ce)
        gap = torch.where(active, torch.where(is_l, gap + 1, 0), gap)
        max_gap = torch.maximum(max_gap, gap)
        active = active & (ck >= 0) & (ce >= 0)
    return {**out, "n": cnt.int(), "max_gap": max_gap.int(), "sum_em": sum_em}


def abea_fill(batch) -> dict:
    """The fill's outputs (module doc) on the batch's device: the CUDA
    kernel for CUDA tensors (it launches or raises), the plain version for
    CPU tensors."""
    dev = batch["ne"].device
    if dev.type == "cuda":
        return abea_cuda.abea_fill(batch)
    if dev.type == "cpu":
        return abea_fill_plain(batch)
    raise ValueError(f"unsupported device {dev}")


def abea_walk(batch, fill) -> dict:
    """The walk's outputs (module doc) from a fill, on the batch's device:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    dev = batch["ne"].device
    if dev.type == "cuda":
        return abea_cuda.abea_walk(batch, fill)
    if dev.type == "cpu":
        return abea_walk_plain(batch, fill)
    raise ValueError(f"unsupported device {dev}")


def decode(band_off, walk_np) -> list:
    """Per read of the batch, its pairs [(kmer, event), ...] ascending, or
    [] when QC drops it (align.c:443-548).  walk_np: the walk's outputs as
    numpy arrays."""
    n = walk_np["n"].astype(np.int64)
    pairs = walk_np["pairs"]
    avg = walk_np["sum_em"] / np.maximum(n, 1)
    last_k = pairs[np.where(n > 0, band_off + n - 1, 0), 0]
    # the walk starts at k-mer nk - 1: it spans when it ends at k-mer 0
    keep = (n > 0) & (last_k == 0) & ~(avg < MIN_AVG_EMISSION) & ~(walk_np["max_gap"] > MAX_GAP)
    out = []
    for r in range(len(n)):
        if not keep[r]:
            out.append([])
            continue
        p = pairs[band_off[r] : band_off[r] + n[r]][::-1]
        out.append(list(zip(p[:, 0].tolist(), p[:, 1].tolist())))
    return out


def traceback_host(sequences, event_means_list, model, scales, shifts, fill) -> list:
    """abea_walk and decode of a fill on the host (native/abea_tb.cpp, the
    JAX package's `_traceback_batch`): per read its alignment or [], in
    input order, as align_events_batch gives them.  `fill`: the fill's
    outputs (tensors or numpy) for prepare_batch(sequences, ...); its flat
    rows go into the engine's [reads, nb_max, 100] planes."""
    idx = [i for i, (seq, ev) in enumerate(zip(sequences, event_means_list))
           if len(seq) - KMER_SIZE + 1 >= 1 and len(ev) >= 1]
    results = [[] for _ in sequences]
    if not idx:
        return results
    trace, bll_e, last_val = (np.asarray(fill[k].cpu() if isinstance(fill[k], torch.Tensor)
                                         else fill[k]) for k in ("trace", "bll_e", "last_val"))
    ne = np.array([len(event_means_list[i]) for i in idx], np.int64)
    nk = np.array([len(sequences[i]) - KMER_SIZE + 1 for i in idx], np.int64)
    nb = ne + nk + 2
    band_off = np.concatenate(([0], np.cumsum(nb)[:-1]))
    g_n, nb_max = len(idx), int(nb.max())
    trace_g = np.zeros((g_n, nb_max, BW), np.uint8)
    bll_g = np.zeros((g_n, nb_max), np.int64)
    lv_g = np.full((g_n, nb_max - 2), -np.inf)
    ranks = np.zeros((g_n, int(nk.max())), np.int32)
    evm = np.zeros((g_n, int(ne.max())), np.float32)
    for g, i in enumerate(idx):
        rows = slice(band_off[g], band_off[g] + nb[g])
        trace_g[g, : nb[g]] = trace[rows]
        bll_g[g, : nb[g]] = bll_e[rows]
        lv_g[g, : nb[g] - 2] = last_val[band_off[g] + 2 : band_off[g] + nb[g]]
        ranks[g, : nk[g]] = kmer_ranks(sequences[i], KMER_SIZE, int(nk[g]))
        evm[g, : ne[g]] = event_means_list[i]
    pairs = native.abea_traceback_native(
        trace_g, bll_g, lv_g, ranks, evm, abea_model_from_numpy(model),
        np.array([scales[i] for i in idx], np.float32),
        np.array([shifts[i] for i in idx], np.float32), ne, nk, BW, np.log(0.01))
    for i, p in zip(idx, pairs):
        results[i] = p
    return results


def align_events_batch_native(sequences, event_means_list, model, scales, shifts,
                              bandwidth: int = ALN_BANDWIDTH, k: int = KMER_SIZE) -> list:
    """The whole banded alignment, traceback and QC of each read on the
    host (native/abeafill.cpp), bit-equal to the oracle's `align`: per
    read its alignment or [], in input order."""
    lib = native._lib()
    p = native._p
    m = abea_model_from_numpy(model)
    lm, ls, lls = (np.ascontiguousarray(m[key], np.float32)
                   for key in ("level_mean", "level_stdv", "level_log_stdv"))
    out = []
    for seq, ev, sc, sh in zip(sequences, event_means_list, scales, shifts):
        n_events, n_kmers = len(ev), len(seq) - k + 1
        if n_kmers < 1 or n_events < 1:
            out.append([])
            continue
        ranks = np.ascontiguousarray(kmer_ranks(seq, k, n_kmers), np.int32)
        evf = np.ascontiguousarray(ev, np.float32)
        cap = n_events + n_kmers + 16
        ki, ei = np.empty(cap, np.int32), np.empty(cap, np.int32)
        n = lib.gt_abea_align(p(ranks), n_kmers, p(evf), n_events, p(lm), p(ls), p(lls),
                              float(sc), float(sh), bandwidth, p(ki), p(ei), cap)
        if n < 0:
            raise RuntimeError("gt_abea_align: the alignment exceeded its capacity")
        out.append(list(zip(ki[:n].tolist(), ei[:n].tolist())))
    return out


def align_events_batch(sequences, event_means_list, model, scales, shifts, device=None,
                       stats: dict | None = None, keep: dict | None = None,
                       use_native: bool = False):
    """Per read, its alignment [(kmer_idx, event_idx), ...] or [] (QC drop,
    no k-mer or no event), in input order: the oracle's `align` of each.

    One fill and one walk launch for the whole batch.  `stats`, when given,
    accumulates wall seconds: "pack_s" (the numpy batch), "h2d_s", "fill_s",
    "walk_s" (each to its end on the device), "d2h_s" and "decode_s" (the
    QC and the pair lists).  `keep`, when given, gets "batch", "fill" and
    "walk": the tensors the kernels were given and what they returned.
    `use_native=True` runs the host engine (align_events_batch_native)
    instead of the kernels: no device, no stats."""
    if use_native:
        return align_events_batch_native(sequences, event_means_list, model, scales, shifts)
    device = default_device(device)
    stats = {} if stats is None else stats
    for k in ("pack_s", "h2d_s", "fill_s", "walk_s", "d2h_s", "decode_s"):
        stats.setdefault(k, 0.0)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    batch_np, idx = prepare_batch(sequences, event_means_list, model, scales, shifts)
    t1 = time.perf_counter()
    batch = abea_batch_from_numpy(batch_np, device)
    sync()
    t2 = time.perf_counter()
    fill = abea_fill(batch)
    sync()
    t3 = time.perf_counter()
    walk = abea_walk(batch, fill)
    sync()
    t4 = time.perf_counter()
    walk_np = {k: v.cpu().numpy() for k, v in walk.items()}
    t5 = time.perf_counter()
    results = [[] for _ in sequences]
    for i, pairs in zip(idx, decode(batch_np["band_off"], walk_np)):
        results[i] = pairs
    t6 = time.perf_counter()
    if keep is not None:
        keep.update(batch=batch, fill=fill, walk=walk)
    for k, dt in (("pack_s", t1 - t0), ("h2d_s", t2 - t1), ("fill_s", t3 - t2),
                  ("walk_s", t4 - t3), ("d2h_s", t5 - t4), ("decode_s", t6 - t5)):
        stats[k] += dt
    return results


def align_events(sequence, event_means, model, scale, shift, device=None):
    """One read's alignment: the oracle's `align`."""
    return align_events_batch([sequence], [event_means], model, [scale], [shift], device)[0]
