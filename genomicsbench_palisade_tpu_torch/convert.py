"""Carry numpy data across into the port's tensors.

PairHMM's parameters are its probability tables, so these are the port's
"weights carried across": `batch_from_numpy` takes a `prepare_batch` dict
(the port's, or the JAX package's, whose `q/i/d/c` are int32 and which may
also hold pre-transposed `*_t` planes for the TPU) and `tables_from_numpy`
takes the numpy lookup tables built by `ops.phmm.tables`.
"""

from __future__ import annotations

import numpy as np
import torch

# the compact batch: int8 codes and quals, int32 lengths
INT8_KEYS = ("rs_row", "q", "i", "d", "c", "hap")
INT32_KEYS = ("rslen", "haplen")
TABLE_KEYS = ("ph2pr", "one_m_ph2pr", "ph2pr_div3", "m2m")


def batch_from_numpy(batch_np, device) -> dict:
    """Compact tensors on `device` from a prepare_batch dict of arrays.

    Quals go to int8: they are read `& 127`, which int8's two's complement
    keeps for any integer.  Keys other than the compact batch are dropped.
    """
    out = {}
    for k in INT8_KEYS:
        out[k] = torch.from_numpy(np.ascontiguousarray(np.asarray(batch_np[k]).astype(np.int8)))
    for k in INT32_KEYS:
        out[k] = torch.from_numpy(np.ascontiguousarray(np.asarray(batch_np[k]).astype(np.int32)))
    return {k: v.to(device) for k, v in out.items()}


def tables_from_numpy(tables_np, device) -> dict:
    """Lookup-table tensors on `device`, in the numpy tables' own dtype."""
    return {k: torch.from_numpy(np.ascontiguousarray(tables_np[k])).to(device)
            for k in TABLE_KEYS}
