"""PairHMM forward likelihoods: host prep, lookup tables, dispatch.

Counterpart of genomicsbench_palisade_tpu/ops/phmm.py.  The path is

    prepare_batch (numpy, compact int8/int32 batch)
      -> phmm_forward: f32 raw sums, on CUDA the kernel csrc/phmm_forward.cu,
         on the CPU the plain version below
      -> host log10 and fallback flags (numpy float32, as the oracle)
      -> ops.phmm_f64.phmm_fallback_log10 for the flagged testcases.

Contract: the f32 raw result is bit-equal to the GKL oracle
(ops/oracle/phmm.py compute_full_prob), and the f64 raw result to its
double instance.  So every cell keeps the oracle's op tree with separate
roundings, and every per-row probability, 1-distm and distm/3 included, is
a lookup in a table numpy built once in the working dtype: no division
happens on the device (PyTorch on CUDA divides by a Python scalar as a
multiply by its reciprocal, which changes the bits).

Dropped from the JAX module: the pre-transposed f32 `*_t` planes (they
fed the TPU kernel through a slow relay) and the batch-size quanta of
`phmm_forward_auto` (they saved TPU compiles); a CUDA launch takes any B.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..convert import batch_from_numpy, tables_from_numpy
from . import phmm_cuda
from .oracle import phmm as oracle

MIN_ACCEPTED = oracle.MIN_ACCEPTED  # float32 1e-28
AMBIG = oracle.AMBIG_CODE  # N: matches every base
_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}

_TABLES: dict = {}
_DEVICE_TABLES: dict = {}
_DEVICE_INIT_Y: dict = {}


def tables(dtype) -> dict:
    """Lookup tables in numpy dtype `dtype` (float32 or float64).

    ph2pr[q], one_m_ph2pr[q] = 1 - ph2pr[q], ph2pr_div3[q] = ph2pr[q] / 3
    (IEEE division in numpy), m2m (matchToMatchProb, flat), and the
    initial constant and its log10, all as oracle.get_ctx(dtype) has them.
    """
    name = np.dtype(dtype).name
    if name not in _TABLES:
        ctx = oracle.get_ctx(dtype)
        dt = ctx.dtype
        _TABLES[name] = {
            "ph2pr": ctx.ph2pr,
            "one_m_ph2pr": (dt(1.0) - ctx.ph2pr).astype(dt),
            "ph2pr_div3": (ctx.ph2pr / dt(3.0)).astype(dt),
            "m2m": ctx.m2m,
            "initial_constant": ctx.initial_constant,
            "log10_initial_constant": ctx.log10_initial_constant,
        }
    return _TABLES[name]


def device_tables(dtype: torch.dtype, device) -> dict:
    """tables() as tensors on `device`, made once per (dtype, device)."""
    device = torch.device(device)
    key = (dtype, device)
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = tables_from_numpy(tables(_NP_DTYPES[dtype]), device)
    return _DEVICE_TABLES[key]


def init_y_table(np_dtype, hp: int) -> np.ndarray:
    """Row-0 Y for every haplen 0..hp: INITIAL_CONSTANT / haplen, divided
    on the host in the working dtype as the oracle does (0 for haplen 0).
    The kernel and the plain version look up entry haplen."""
    t = tables(np_dtype)
    dt = np.dtype(np_dtype).type
    h = np.arange(hp + 1)
    return np.where(h > 0, dt(t["initial_constant"]) / np.maximum(h, 1).astype(dt),
                    dt(0.0)).astype(dt)


def device_init_y(dtype: torch.dtype, device, hp: int) -> torch.Tensor:
    """init_y_table() as a tensor on `device`, made once per (dtype, device, hp)."""
    device = torch.device(device)
    key = (dtype, device, hp)
    if key not in _DEVICE_INIT_Y:
        _DEVICE_INIT_Y[key] = torch.from_numpy(init_y_table(_NP_DTYPES[dtype], hp)).to(device)
    return _DEVICE_INIT_Y[key]


def prepare_batch(reads, haps, pairs, r_pad: int | None = None,
                  h_pad: int | None = None) -> dict:
    """Host-side packing of testcases into the compact batch (numpy).

    reads: list of dicts with keys bases (int codes), q, i, d, c (normalized
           int quals)
    haps:  list of int-code arrays
    pairs: list of (read_idx, hap_idx)
    Row r of rs_row/q/i/d/c holds read base r-1 (row 0 is zero); hap pads
    with a code that matches nothing.  Each distinct read and hap is packed
    once and gathered per pair.
    """
    if r_pad is None:
        r_pad = max(len(r["bases"]) for r in reads) + 1
    if h_pad is None:
        h_pad = max(len(h) for h in haps)
    pr = np.array([p[0] for p in pairs], dtype=np.int64)
    ph = np.array([p[1] for p in pairs], dtype=np.int64)
    ur, inv_r = np.unique(pr, return_inverse=True)
    uh, inv_h = np.unique(ph, return_inverse=True)

    read_planes = np.zeros((5, len(ur), r_pad), dtype=np.int8)
    read_len = np.zeros(len(ur), dtype=np.int32)
    for j, ri in enumerate(ur):
        r = reads[ri]
        n = len(r["bases"])
        if n >= r_pad:
            raise ValueError(f"read {ri} of length {n} needs r_pad > {n}, got {r_pad}")
        for p, key in enumerate(("bases", "q", "i", "d", "c")):
            read_planes[p, j, 1 : n + 1] = r[key]
        read_len[j] = n
    hap_rows = np.full((len(uh), h_pad), AMBIG + 1, dtype=np.int8)
    hap_len = np.zeros(len(uh), dtype=np.int32)
    for j, hi in enumerate(uh):
        h = haps[hi]
        if len(h) > h_pad:
            raise ValueError(f"hap {hi} of length {len(h)} exceeds h_pad {h_pad}")
        hap_rows[j, : len(h)] = h
        hap_len[j] = len(h)

    planes = read_planes[:, inv_r]
    return {
        "rs_row": planes[0],
        "q": planes[1],
        "i": planes[2],
        "d": planes[3],
        "c": planes[4],
        "hap": hap_rows[inv_h],
        "rslen": read_len[inv_r],
        "haplen": hap_len[inv_h],
    }


def as_device_batch(batch, device=None) -> dict:
    """The compact batch as tensors.  A numpy batch goes to `device`
    (CUDA unless the caller names another); a tensor batch stays where it
    lies unless `device` is given."""
    if not isinstance(batch["rs_row"], torch.Tensor):
        return batch_from_numpy(batch, default_device(device))
    if device is not None:
        return {k: v.to(device) for k, v in batch.items()}
    return batch


def phmm_forward_plain(batch, dtype: torch.dtype = torch.float32, device=None):
    """Plain PyTorch forward pass: raw M+X sums [B] in `dtype`.

    The anti-diagonal sweep of genomicsbench_palisade_tpu/ops/phmm.py with
    the full `r <= rslen, c <= haplen` mask of its ops/phmm_f64.py.  Only
    separate `*`, `+` and `torch.where`, nothing fused, so each cell rounds
    as the oracle does; the result sums the last row's M and X into two
    accumulators in column order (one column per diagonal).
    """
    tb = as_device_batch(batch, device)
    dev = tb["rs_row"].device
    tab = device_tables(dtype, dev)
    rs = tb["rs_row"].long()
    hap = tb["hap"].long()
    rslen = tb["rslen"].long()
    haplen = tb["haplen"].long()
    b, rp = rs.shape
    hp = hap.shape[1]
    iy = device_init_y(dtype, dev, hp)[haplen]

    iq = tb["i"].long() & 127
    dq = tb["d"].long() & 127
    cq = tb["c"].long() & 127
    qq = tb["q"].long() & 127
    lo = torch.minimum(iq, dq)
    hi = torch.maximum(iq, dq)
    p_mm = tab["m2m"][((hi * (hi + 1)) >> 1) + lo]
    p_gapm = tab["one_m_ph2pr"][cq]
    p_mx = tab["ph2pr"][iq]
    p_xx = tab["ph2pr"][cq]
    p_my = tab["ph2pr"][dq]
    p_yy = p_xx
    one_m_distm = tab["one_m_ph2pr"][qq]
    distm3 = tab["ph2pr_div3"][qq]

    r_iota = torch.arange(rp, device=dev)[None, :]
    valid_row = (r_iota >= 1) & (r_iota <= rslen[:, None])
    rs_amb = rs == AMBIG
    hap_pad = torch.cat([hap, torch.full((b, rp), AMBIG + 2, dtype=torch.long, device=dev)], 1)
    lane = torch.arange(b, device=dev)
    sel = rslen.clamp(0, rp - 1)

    def shift_down(v):
        out = torch.zeros_like(v)
        out[:, 1:] = v[:, :-1]
        return out

    zeros = torch.zeros((b, rp), dtype=dtype, device=dev)
    m1, x1 = zeros, zeros
    y1 = zeros.clone()
    y1[:, 0] = iy
    m2s, x2s, y2s = zeros, zeros, zeros  # diagonal d-2, shifted down one row
    res_m = torch.zeros(b, dtype=dtype, device=dev)
    res_x = torch.zeros(b, dtype=dtype, device=dev)
    for d in range(1, rp + hp):
        cols = d - r_iota - 1  # hap index of each row on this diagonal
        hapd = hap_pad[:, cols.clamp(0, hp + rp - 1)[0]]
        hapd = torch.where(cols >= 0, hapd, AMBIG + 2)
        match = (rs == hapd) | rs_amb | (hapd == AMBIG)
        prior = torch.where(match, one_m_distm, distm3)
        c_idx = d - r_iota
        valid = valid_row & (c_idx >= 1) & (c_idx <= haplen[:, None])

        m1s, x1s, y1s = shift_down(m1), shift_down(x1), shift_down(y1)
        m_new = prior * ((m2s * p_mm + x2s * p_gapm) + y2s * p_gapm)
        x_new = m1s * p_mx + x1s * p_xx
        y_new = m1 * p_my + y1 * p_yy
        m_new = torch.where(valid, m_new, 0.0)
        x_new = torch.where(valid, x_new, 0.0)
        y_new = torch.where(valid, y_new, 0.0)
        y_new[:, 0] = iy

        c_at = d - rslen
        take = (c_at >= 1) & (c_at <= haplen)
        res_m = res_m + torch.where(take, m_new[lane, sel], 0.0)
        res_x = res_x + torch.where(take, x_new[lane, sel], 0.0)

        m2s, x2s, y2s = m1s, x1s, y1s
        m1, x1, y1 = m_new, x_new, y_new
    return res_m + res_x


def forward_raw(batch, dtype: torch.dtype) -> torch.Tensor:
    """Raw M+X sums [B] in `dtype` on the tensor batch's device: the CUDA
    kernel for CUDA tensors (it launches or raises), the plain version
    for CPU tensors."""
    dev = batch["rs_row"].device
    if dev.type == "cuda":
        hp = batch["hap"].shape[1]
        return phmm_cuda.KERNELS[dtype](batch, device_tables(dtype, dev),
                                        device_init_y(dtype, dev, hp))
    if dev.type == "cpu":
        return phmm_forward_plain(batch, dtype)
    raise ValueError(f"unsupported device {dev}")


def phmm_forward(batch, device=None):
    """Batched f32 forward pass.

    batch: a prepare_batch dict (numpy; runs on `device`, CUDA by default)
    or the same as tensors (runs where they lie).
    Returns numpy (log10 [B] f32, raw [B] f32, fallback [B] bool); the
    fallback flag is raw < 1e-28 or not finite, and the log10 is taken on
    the host in numpy float32, as the oracle's compute_likelihood takes it.
    """
    tb = as_device_batch(batch, device)
    raw = forward_raw(tb, torch.float32).cpu().numpy()
    fallback = (raw < MIN_ACCEPTED) | ~np.isfinite(raw)
    with np.errstate(divide="ignore", invalid="ignore"):
        log10 = np.log10(raw) - tables(np.float32)["log10_initial_constant"]
    return log10, raw, fallback


def phmm_likelihoods(batch, device=None) -> np.ndarray:
    """f32 pass, then the f64 pass for the testcases it flags.

    Mirrors computelikelihoodsboth (IntelPairHmmCSource.cpp:61-85): results
    below MIN_ACCEPTED in float are recomputed in double.  Returns float64
    log10 likelihoods [B].
    """
    from .phmm_f64 import phmm_fallback_log10

    tb = as_device_batch(batch, device)
    log10, _raw, fallback = phmm_forward(tb)
    out = log10.astype(np.float64)
    if fallback.any():
        vals, idx = phmm_fallback_log10(tb, fallback)
        out[idx] = vals
    return out
