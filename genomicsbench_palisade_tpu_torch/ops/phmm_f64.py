"""The float64 PairHMM pass for testcases whose float result underflows.

The reference recomputes testcases whose float result falls below
MIN_ACCEPTED in double (IntelPairHmmCSource.cpp:75-78).  The JAX package
runs that pass on the host (native/phmmf64.cpp or a numpy sweep); the H100
has real FP64, so the port runs it on the card as the double instance of
the same kernel (csrc/phmm_forward.cu), and on the CPU as the plain
version in double.  The JAX package's native pass is bound too
(`phmm_forward_f64_native`; `phmm_fallback_log10(..., use_native=True)`),
beside the kernel, which stays the default (ROADMAP queue 3).  All are
bit-equal to the oracle's double path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import INT8_KEYS, INT32_KEYS
from ..io import native
from .phmm import as_device_batch, forward_raw, tables


def fallback_batch(batch, mask, device=None):
    """The compact tensor batch of the testcases where `mask` is set, and
    their indices.

    batch: a prepare_batch dict (numpy, moved to `device`, CUDA by
    default) or its tensors (kept where they lie).
    """
    idx = np.nonzero(np.asarray(mask))[0]
    tb = as_device_batch(batch, device)
    sel = torch.from_numpy(idx).to(tb["rs_row"].device)
    # only the [B]-leading compact arrays
    return {k: tb[k].index_select(0, sel) for k in INT8_KEYS + INT32_KEYS}, idx


def log10_f64(raw: np.ndarray) -> np.ndarray:
    """log10 likelihoods of raw f64 sums, taken on the host in numpy
    float64 as the oracle takes them."""
    with np.errstate(divide="ignore"):
        return np.log10(raw) - tables(np.float64)["log10_initial_constant"]


def phmm_forward_f64_native(batch):
    """The native double pass on the host (native/phmmf64.cpp): raw f64
    sums [B], bit-equal to the oracle's double path.  batch: a
    prepare_batch dict (numpy; only its [B]-leading arrays are read)."""
    t = tables(np.float64)
    rs = np.ascontiguousarray(batch["rs_row"], np.int8)
    q, iq, dq, cq = (np.ascontiguousarray(batch[k], np.int32) for k in ("q", "i", "d", "c"))
    hap = np.ascontiguousarray(batch["hap"], np.int8)
    rslen = np.ascontiguousarray(batch["rslen"], np.int64)
    haplen = np.ascontiguousarray(batch["haplen"], np.int64)
    ph2pr = np.ascontiguousarray(t["ph2pr"], np.float64)
    m2m = np.ascontiguousarray(t["m2m"], np.float64)
    out = np.empty(rs.shape[0], np.float64)
    p = native._p
    native._lib().gt_phmm_f64(p(rs), p(q), p(iq), p(dq), p(cq), p(hap), p(rslen), p(haplen),
                              rs.shape[0], rs.shape[1], hap.shape[1], p(ph2pr), p(m2m),
                              float(t["initial_constant"]), p(out))
    return out


def phmm_fallback_log10(batch, mask, device=None, use_native: bool = False):
    """float64 log10 likelihoods for the testcases where `mask` is set.

    batch: as fallback_batch takes it.  Returns (log10 [n] f64, indices [n]).
    `use_native=True` runs the native pass on the host (a numpy batch)
    instead of the f64 kernel.
    """
    if use_native:
        idx = np.nonzero(np.asarray(mask))[0]
        if idx.size == 0:
            return np.zeros(0), idx
        sub = {k: np.asarray(batch[k])[idx] for k in INT8_KEYS + INT32_KEYS}
        return log10_f64(phmm_forward_f64_native(sub)), idx
    sub, idx = fallback_batch(batch, mask, device)
    if idx.size == 0:
        return np.zeros(0), idx
    return log10_f64(forward_raw(sub, torch.float64).cpu().numpy()), idx
