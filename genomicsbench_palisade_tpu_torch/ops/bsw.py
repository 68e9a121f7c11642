"""Banded Smith-Waterman extension (bwa-mem ksw_extend semantics).

Counterpart of genomicsbench_palisade_tpu/ops/bsw.py (the row-step scan)
and ops/bsw_pallas.py (its TPU kernel, `_bsw_core` and `_kernel`).  A
batch is struct-of-arrays over one flat code buffer, the layout the pair
file parses into (io/pairs.parse_pairs_soa):

    codes  [N] int8   base codes 0..3, >= 4 ambiguous
    q_off, t_off [B] int64   offsets of each query and target in `codes`
    q_len, t_len [B] int32
    h0     [B] int32  seed score

`bsw_extend` runs the CUDA kernel (csrc/bsw_extend.cu) for CUDA tensors
and the plain PyTorch version for CPU tensors.  Both return a [6, B] int32
tensor whose rows are OUT_ORDER.

The plain version is the JAX scan written in torch: one vectorized step
per target row over the [B, Qe] H/E row, where the only sequential chain
inside a row (the lazy-F insertion run)
    F(i,j+1) = max(F(i,j) - e_ins, max(M(i,j) - oe_ins, 0))
unrolls to a running maximum
    F(i,j)   = max(0, max_{j'<j}(c_{j'} + j'*e_ins) - (j-1)*e_ins),
      c_j = max(M(i,j) - oe_ins, 0)
which is a `torch.cummax`.  Every value is int32, so kernel, plain
version, JAX scan and oracle agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bsw_cuda
from .oracle.bsw import DEFAULT_PARAMS, BswParams

OUT_ORDER = ("score", "qle", "tle", "gtle", "gscore", "max_off")
NEG = -(1 << 20)
AMBIG = 4  # codes >= 4 score `ambig`; also the query and target padding
PLAIN_CHUNK = 65536  # pairs per step of the plain version: bounds its [B, Qe] temporaries


def prepare_pairs(pairs, params: BswParams = DEFAULT_PARAMS, q_pad=None, t_pad=None):
    """pairs: list of (query_codes, target_codes, h0). Pads to fixed shapes."""
    if q_pad is None:
        q_pad = max(len(q) for q, _, _ in pairs)
    if t_pad is None:
        t_pad = max(len(t) for _, t, _ in pairs)
    b = len(pairs)
    query = np.full((b, q_pad), AMBIG, dtype=np.int8)
    target = np.full((b, t_pad), AMBIG, dtype=np.int8)
    qlen = np.zeros(b, dtype=np.int32)
    tlen = np.zeros(b, dtype=np.int32)
    h0 = np.zeros(b, dtype=np.int32)
    for i, (q, t, h) in enumerate(pairs):
        query[i, : len(q)] = q
        target[i, : len(t)] = t
        qlen[i] = len(q)
        tlen[i] = len(t)
        h0[i] = h
    return {"query": query, "target": target, "qlen": qlen, "tlen": tlen, "h0": h0}


def _params_tuple(p: BswParams):
    return (p.o_del, p.e_del, p.o_ins, p.e_ins, p.zdrop, p.end_bonus,
            p.match, p.mismatch, p.ambig, p.w)


DEFAULT_TUPLE = _params_tuple(DEFAULT_PARAMS)


def band_width(q_len: torch.Tensor, params=DEFAULT_TUPLE) -> torch.Tensor:
    """Per-pair band w = min(w0, max_ins, max_del) (bandedSWA.cpp:166-175).

    max_ins = int((qlen*max_sc + end_bonus - o_ins) / e_ins + 1.0), with the
    division an IEEE double division of two tensors, as the reference's
    double arithmetic (a tensor divided by a Python scalar may become a
    multiply by its reciprocal on CUDA).  max_sc is `match`, as in the JAX
    package."""
    o_del, e_del, o_ins, e_ins, _z, end_bonus, match, _x, _a, w0 = params
    base = q_len.to(torch.int64) * match + end_bonus

    def run_cap(o, e):
        num = (base - o).to(torch.float64)
        cap = (num / torch.full_like(num, float(e)) + 1.0).to(torch.int32)
        return torch.clamp(cap, min=1)

    w = torch.minimum(run_cap(o_ins, e_ins), run_cap(o_del, e_del))
    return torch.clamp(w, max=w0)


def first_row(h0: torch.Tensor, q_len: torch.Tensor, qe: int, params=DEFAULT_TUPLE):
    """The H row before target row 0, [B, qe] int32 (bandedSWA.cpp:158-162):
    eh[0] = h0, eh[1] = max(h0 - oe_ins, 0), then -e_ins per column while
    the previous entry is > e_ins and j <= qlen; the rest 0."""
    _od, _ed, o_ins, e_ins = params[:4]
    oe_ins = o_ins + e_ins
    j = torch.arange(qe, dtype=torch.int32, device=h0.device)[None, :]
    h = h0[:, None]
    decay = h - oe_ins - (j - 1) * e_ins
    prev = h - oe_ins - (j - 2) * e_ins
    write = (j <= 1) | ((prev > e_ins) & (j <= q_len[:, None]))
    row = torch.where(write, torch.clamp(decay, min=0), 0)
    row = torch.where(j == 0, h, row)
    return torch.where((j == 1) & (q_len[:, None] >= 1), torch.clamp(h - oe_ins, min=0), row)


def gather_codes(codes, off, ln, width: int) -> torch.Tensor:
    """[B, width] int32 rows codes[off : off+ln], padded with AMBIG."""
    j = torch.arange(width, dtype=torch.int64, device=codes.device)[None, :]
    valid = j < ln[:, None]
    idx = torch.where(valid, off[:, None] + j, 0)
    return torch.where(valid, codes[idx].to(torch.int32), AMBIG)


def _plain_chunk(batch, params, stats):
    o_del, e_del, o_ins, e_ins, zdrop, _eb, match, mismatch, ambig, _w0 = params
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qlen, tlen, h0 = batch["q_len"], batch["t_len"], batch["h0"]
    dev = h0.device
    b = h0.shape[0]
    qp = int(qlen.max())
    tp = int(tlen.max())
    qe = qp + 1  # eh entry j holds (H(i, j-1), E(i+1, j))
    q_codes = gather_codes(batch["codes"], batch["q_off"], qlen, qe)  # column qp: padding
    target = gather_codes(batch["codes"], batch["t_off"], tlen, tp)
    j = torch.arange(qe, dtype=torch.int32, device=dev)[None, :]
    j_e_ins = j * e_ins
    jm1_e_ins = (j - 1) * e_ins
    q_amb = q_codes >= AMBIG
    w = band_width(qlen, params)

    h = first_row(h0, qlen, qe, params)
    e = torch.zeros_like(h)
    neg_col = torch.full((b, 1), NEG, dtype=torch.int32, device=dev)
    zero_col = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    beg = torch.zeros(b, dtype=torch.int32, device=dev)
    end = qlen.clone()
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    mmax = h0.clone()
    max_i = torch.full((b,), -1, dtype=torch.int32, device=dev)
    max_j, max_ie, gscore = max_i.clone(), max_i.clone(), max_i.clone()
    max_off = torch.zeros(b, dtype=torch.int32, device=dev)
    cells = torch.zeros((), dtype=torch.int64, device=dev)
    rows = torch.zeros(b, dtype=torch.int64, device=dev)

    for i in range(tp):
        act = alive & (i < tlen)
        beg0, end0 = beg, end
        # band at row start (bandedSWA.cpp:180-183)
        beg = torch.maximum(beg0, i - w)
        end = torch.minimum(torch.minimum(end0, i + w + 1), qlen)
        h1_pre = torch.where(beg == 0, torch.clamp(h0 - (o_del + e_del * (i + 1)), min=0), 0)
        if stats is not None:
            cells += torch.where(act, torch.clamp(end - beg, min=0), 0).sum()
            rows += act

        t_char = target[:, i : i + 1]
        qsc = torch.where((t_char >= AMBIG) | q_amb, ambig,
                          torch.where(q_codes == t_char, match, -mismatch))
        in_band = (j >= beg[:, None]) & (j < end[:, None])

        m_val = torch.where(h != 0, h + qsc, 0)  # M(i, j)
        h0_val = torch.maximum(m_val, e)
        c = torch.clamp(m_val - oe_ins, min=0)
        g = torch.where(in_band, c + j_e_ins, NEG)
        gsh = torch.cat([neg_col, torch.cummax(g, dim=1).values[:, :-1]], dim=1)
        f = torch.clamp(gsh - jm1_e_ins, min=0)
        f = torch.where(gsh <= NEG // 2, 0, f)  # no contribution yet
        h_row = torch.maximum(h0_val, f)  # H(i, j)
        e_next = torch.maximum(e - e_del, torch.clamp(m_val - oe_del, min=0))

        # row max and its last argmax within the band
        m = torch.clamp(torch.where(in_band, h_row, 0).max(dim=1).values, min=0)
        mj = torch.where(in_band & (h_row == m[:, None]), j, -1).max(dim=1).values

        # h1 after the loop: H(i, end-1), or h1_pre if the band was empty
        h1_fin = h_row.gather(1, torch.clamp(end - 1, min=0)[:, None].long())[:, 0]
        h1_fin = torch.where(end > beg, h1_fin, h1_pre)

        # eh writes over [beg, end]: h[j] = H(i, j-1), h[beg] = h1_pre, e[end] = 0
        upd = (j >= beg[:, None]) & (j <= end[:, None]) & act[:, None]
        cand_h = torch.where(j == beg[:, None], h1_pre[:, None],
                             torch.cat([zero_col, h_row[:, :-1]], dim=1))
        h = torch.where(upd, cand_h, h)
        e = torch.where(upd, torch.where(j == end[:, None], 0, e_next), e)

        # gscore: the band reached the query's end (j == qlen after the loop)
        g_upd = act & (end == qlen) & (gscore <= h1_fin)
        max_ie = torch.where(g_upd, i, max_ie)
        gscore = torch.where(g_upd, h1_fin, gscore)

        # m == 0 break (after the gscore update)
        alive = alive & (~act | (m != 0))
        act2 = act & (m != 0)

        # running max, or z-drop
        improve = act2 & (m > mmax)
        di = i - max_i
        dj = mj - max_j
        zd = torch.where(di > dj, mmax - m - (di - dj) * e_del > zdrop,
                         mmax - m - (dj - di) * e_ins > zdrop)
        zbreak = act2 & ~improve & (zdrop > 0) & zd
        alive = alive & ~zbreak
        max_off = torch.where(improve, torch.maximum(max_off, (mj - i).abs()), max_off)
        mmax = torch.where(improve, m, mmax)
        max_i = torch.where(improve, i, max_i)
        max_j = torch.where(improve, mj, max_j)

        # band narrowing to the non-zero span of the updated eh row
        nz = (h != 0) | (e != 0)
        in_scan = (j >= beg[:, None]) & (j < end[:, None])
        beg_n = torch.where(in_scan & nz, j, end[:, None]).min(dim=1).values
        in_scan2 = (j >= beg_n[:, None]) & (j <= end[:, None])
        last_nz = torch.where(in_scan2 & nz, j, beg_n[:, None] - 1).max(dim=1).values
        end_n = torch.minimum(last_nz + 2, qlen)

        upd_band = act2 & ~zbreak
        beg = torch.where(act, torch.where(upd_band, beg_n, beg), beg0)
        end = torch.where(act, torch.where(upd_band, end_n, end), end0)

    if stats is not None:
        stats["cells"] = stats.get("cells", 0) + int(cells)
        stats["pair_rows"] = np.concatenate([stats.get("pair_rows", np.zeros(0, np.int64)),
                                             rows.cpu().numpy()])
    return torch.stack([mmax, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off])


def bsw_extend_plain(batch, params=DEFAULT_TUPLE, chunk: int = PLAIN_CHUNK,
                     stats: dict | None = None) -> torch.Tensor:
    """The plain PyTorch version: [6, B] int32 (OUT_ORDER rows), on the
    batch's device, `chunk` pairs at a time.  `stats`, when given, gets
    "cells" added: the band cells the recurrence visits (rows a pair is
    alive for, times their band width), the work the kernel must do, and
    "pair_rows" extended by each pair's rows alive (in the batch's order)."""
    n = batch["h0"].shape[0]
    out = torch.empty((6, n), dtype=torch.int32, device=batch["h0"].device)
    for lo in range(0, n, chunk):
        sub = {k: v if k == "codes" else v[lo : lo + chunk] for k, v in batch.items()}
        out[:, lo : lo + chunk] = _plain_chunk(sub, params, stats)
    return out


def bsw_extend(batch, params=DEFAULT_TUPLE, q_max=None) -> torch.Tensor:
    """[6, B] int32 (OUT_ORDER rows) on the batch's device: the CUDA kernel
    for CUDA tensors (it launches or raises), the plain version for CPU
    tensors.  `q_max`, when given, is at least every q_len of the batch
    (the bucket's query edge): the kernel picks its instance by it instead
    of reading the longest query back (see ops.bsw_cuda)."""
    dev = batch["h0"].device
    if dev.type == "cuda":
        return bsw_cuda.bsw_extend(batch, params, q_max)
    if dev.type == "cpu":
        return bsw_extend_plain(batch, params)
    raise ValueError(f"unsupported device {dev}")
