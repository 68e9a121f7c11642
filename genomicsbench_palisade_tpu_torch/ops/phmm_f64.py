"""The float64 PairHMM pass for testcases whose float result underflows.

The reference recomputes testcases whose float result falls below
MIN_ACCEPTED in double (IntelPairHmmCSource.cpp:75-78).  The JAX package
runs that pass on the host (native/phmmf64.cpp or a numpy sweep); the H100
has real FP64, so the port runs it on the card as the double instance of
the same kernel (csrc/phmm_forward.cu), and on the CPU as the plain
version in double.  Both are bit-equal to the oracle's double path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import INT8_KEYS, INT32_KEYS
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


def phmm_fallback_log10(batch, mask, device=None):
    """float64 log10 likelihoods for the testcases where `mask` is set.

    batch: as fallback_batch takes it.  Returns (log10 [n] f64, indices [n]).
    """
    sub, idx = fallback_batch(batch, mask, device)
    if idx.size == 0:
        return np.zeros(0), idx
    return log10_f64(forward_raw(sub, torch.float64).cpu().numpy()), idx
