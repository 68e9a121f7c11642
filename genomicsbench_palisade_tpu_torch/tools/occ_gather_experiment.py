"""Random 64-byte occ-row gathers: the CUDA kernels against the plain gather.

    python -m genomicsbench_palisade_tpu_torch.tools.occ_gather_experiment [--device cpu]

Port of tools/occ_gather_experiment.py:main.  The FM index's occ lookup
(ops/fmi.py occ_all) is one random 64-byte cp_occ row, and those gathers
are the fmi engine's only memory traffic, so their rate bounds it.  The
workload is the JAX tool's: a table of 4,000,000 random rows of 64 bytes
(256 MB, far past the 50 MB L2), rng seed 3, and 16,384 random row
indices from the same generator.  Variants, each timed as the mean of 10
calls after `tools.warm_up` (CUDA events on a card), each checked against
numpy:
  * xla_gather, xla_gather32, xla_gather128: the plain gather
    (`index_select` on the table, then an XOR fold), on the table's 64-byte
    rows, their first 32 bytes and 128-byte rows (the row twice): the JAX
    tool's `jnp.take` baseline and its row-versus-byte question;
  * cuda_row2, cuda_row8 (the tool's dma_k2, dma_k8): `occ_gather_row`
    with 2 or 8 rows in flight a thread;
  * cuda_tile8 (the tool's dma_bw32): `occ_gather_tile`, 512-byte groups
    of 8 rows, 8 in flight a warp.
It prints one JSON line: for each variant `<name>_ms`, `_mb_s` (the bytes
of the rows it gathers: 32, 64, 128 or 512 an index), `_mrows_s` and
`_correct`.  On the CPU (`--device cpu`) the CUDA variants run their plain
versions.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import default_device
from ..ops import occ_gather as G
from . import time_calls

BLOCKS = 4_000_000
N_IDX = 16_384
SEED = 3


def make_workload(blocks=BLOCKS, n=N_IDX, seed=SEED):
    """(table int64 [blocks, 8], idx int32 [n]): the JAX tool's u32 [blocks,
    16] table from rng `seed`, read as 64-byte rows, and its indices."""
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 2**32, (blocks, 16), dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, blocks, n).astype(np.int32)
    return tbl.view(np.int64), idx


def run(table_np, idx_np, device, iters=10) -> dict:
    """Every variant on `device` for the numpy table and indices."""
    dev = torch.device(device)
    table = torch.from_numpy(np.ascontiguousarray(table_np)).to(dev)
    idx = torch.from_numpy(np.ascontiguousarray(idx_np)).to(dev)
    n = len(idx_np)
    rows = table_np[idx_np]
    want = np.bitwise_xor.reduce(rows, axis=0)
    tiles = np.ascontiguousarray(table_np).reshape(-1, 64)
    want_tile = np.bitwise_xor.reduce(tiles[idx_np >> 3], axis=0)
    table32 = table[:, :4].contiguous()
    table128 = torch.cat([table, table], dim=1)
    variants = (
        ("xla_gather", lambda: G.occ_gather_row_plain(table, idx), want, 64),
        ("xla_gather32", lambda: G.occ_gather_row_plain(table32, idx), want[:4], 32),
        ("xla_gather128", lambda: G.occ_gather_row_plain(table128, idx),
         np.concatenate([want, want]), 128),
        ("cuda_row2", lambda: G.occ_gather_row(table, idx, 2), want, 64),
        ("cuda_row8", lambda: G.occ_gather_row(table, idx, 8), want, 64),
        ("cuda_tile8", lambda: G.occ_gather_tile(table, idx), want_tile, 512),
    )
    out = {"tool": "occ_gather_experiment", "rows": n, "row_bytes": 64,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    for name, fn, exp, row_b in variants:
        dt, val = time_calls(fn, dev, iters)
        out[name + "_ms"] = dt * 1e3
        out[name + "_mb_s"] = n * row_b / dt / 1e6
        out[name + "_mrows_s"] = n / dt / 1e6
        out[name + "_correct"] = bool(np.array_equal(val.cpu().numpy(), exp))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    table, idx = make_workload()
    print(json.dumps(run(table, idx, dev)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
