"""Carry numpy data across into the port's tensors.

PairHMM's parameters are its probability tables, so these are the port's
"weights carried across": `batch_from_numpy` takes a `prepare_batch` dict
(the port's, or the JAX package's, whose `q/i/d/c` are int32 and which may
also hold pre-transposed `*_t` planes for the TPU) and `tables_from_numpy`
takes the numpy lookup tables built by `ops.phmm.tables`.

bsw's are its scoring parameters and the batch: `bsw_batch_from_numpy`
takes a `prepare_pairs` dict (padded [B, pad] query and target rows) and
returns the struct-of-arrays tensors `ops.bsw.bsw_extend` takes, with the
parameters as the kernel's int tuple.

chain's are the anchors and each call's gap table: `chain_batch_from_numpy`
takes a list of `prepare_call` dicts and returns the flat batch
`ops.chain.chain_dp` takes (see ops/chain.py), with (max_dist_x,
max_dist_y, bw).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.bsw import _params_tuple
from .ops.bsw_cuda import BATCH_DTYPES
from .ops.chain_cuda import BATCH_DTYPES as CHAIN_DTYPES
from .ops.oracle.bsw import DEFAULT_PARAMS

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


_NP = {torch.int8: np.int8, torch.int32: np.int32, torch.int64: np.int64}


def bsw_batch_from_numpy(batch_np, device, params=DEFAULT_PARAMS):
    """(tensors on `device`, params tuple) from a prepare_pairs dict.

    The padded rows become one flat code buffer, queries first: pair b's
    query at b*q_pad, its target at B*q_pad + b*t_pad.  `params` is a
    BswParams (the port's, or any object with the same fields)."""
    query = np.asarray(batch_np["query"]).astype(np.int8)
    target = np.asarray(batch_np["target"]).astype(np.int8)
    (b, q_pad), t_pad = query.shape, target.shape[1]
    arrays = {
        "codes": np.concatenate([query.ravel(), target.ravel()]),
        "q_off": np.arange(b, dtype=np.int64) * q_pad,
        "q_len": batch_np["qlen"],
        "t_off": b * q_pad + np.arange(b, dtype=np.int64) * t_pad,
        "t_len": batch_np["tlen"],
        "h0": batch_np["h0"],
    }
    out = {k: torch.from_numpy(np.ascontiguousarray(np.asarray(arrays[k]), dtype=_NP[dt])).to(device)
           for k, dt in BATCH_DTYPES.items()}
    return out, _params_tuple(params)


def chain_arrays(preps):
    """(numpy flat batch, (max_dist_x, max_dist_y, bw)) from prepare_call
    dicts that share those three ints: per-anchor arrays concatenated in
    call order, `off`/`n` per call, the gap tables stacked."""
    params = {(p["max_dist_x"], p["max_dist_y"], p["bw"]) for p in preps}
    if len(params) != 1:
        raise ValueError(f"a chain batch needs one (max_dist_x, max_dist_y, bw), got {params}")
    (mdx, mdy, bw), = params
    n = np.array([p["n"] for p in preps], np.int32)
    # 32-bit words as int32 (x_lo is uint32: its bits are kept)
    arrays = {k: np.concatenate([np.asarray(p[k]).view(np.int32) for p in preps])
              for k in ("x_lo", "qi", "qspan", "st_eff")}
    arrays["off"] = np.concatenate(([0], np.cumsum(n[:-1], dtype=np.int64)))
    arrays["n"] = n
    arrays["gap_table"] = np.stack([np.asarray(p["gap_table"], np.int32) for p in preps])
    return arrays, (int(mdx), int(mdy), int(bw))


def chain_batch_from_numpy(preps, device):
    """(tensors on `device`, (max_dist_x, max_dist_y, bw)) from a list of
    prepare_call dicts (the port's, or the JAX package's): the flat batch
    that `ops.chain.chain_dp` takes, with each call's gap table."""
    arrays, params = chain_arrays(preps)
    return {k: torch.from_numpy(arrays[k]).to(device) for k in CHAIN_DTYPES}, params
