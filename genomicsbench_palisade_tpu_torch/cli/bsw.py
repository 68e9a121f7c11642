"""bsw driver: `python -m genomicsbench_palisade_tpu_torch.cli.bsw -pairs <file>`.

Mirrors the reference driver (benchmarks/bsw/main_banded.cpp:673-960), as
genomicsbench_palisade_tpu/cli/bsw.py does: reads 3-line pair records,
scores every pair with the banded SW extension kernel, and prints the
per-pair results plus total pairs and kernel time.  Runs on one device:
CUDA unless `--device cpu`.

The whole code buffer goes to the device once per call; the kernel reads
each query and target in place by (offset, length), so no padded copy is
built.  Pairs are grouped by padded (qlen, tlen) bucket: a launch's pairs
have similar lengths, and its bucket's query edge picks the kernel's
instance (no readback of the longest query).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import default_device
from ..io.pairs import parse_pairs_soa
from ..ops import bsw as B
from ..ops.oracle.bsw import DEFAULT_PARAMS, BswParams

EDGES = (32, 64, 128, 256, 512)
# pairs per launch; chip_smoke.py's launch-size sweep measures the choice
# against smaller and larger launches
DEV_BATCH = 1 << 14
SOA_DTYPES = {"q_off": np.int64, "q_len": np.int32, "t_off": np.int64,
              "t_len": np.int32, "h0": np.int32}


def score_pairs_soa(soa, params: BswParams = DEFAULT_PARAMS, edges=EDGES,
                    dev_batch: int = DEV_BATCH, device=None,
                    stats: dict | None = None, keep: list | None = None):
    """Bucketed scoring over a parse_pairs_soa dict; returns a dict of
    [n_pairs] int32 arrays (ops.bsw.OUT_ORDER) in input order.

    Pairs are bucketed by padded (qlen, tlen) (searchsorted on `edges`, a
    stable argsort on the bucket key) and launched in chunks of at most
    `dev_batch` pairs.  `stats`, when given, accumulates wall seconds per
    phase: "bucket_s" (host sort), "h2d_s" (codes and per-pair arrays to
    the device), "kernel_s" (all launches, to the last one's end) and
    "d2h_s" (results back, into input order).  `keep`, when given, gets
    one dict per launch: "bucket" (q_pad, t_pad), "batch" (the tensors it
    was given) and "out" (its [6, m] result on the device).
    """
    device = default_device(device)
    stats = {} if stats is None else stats
    for k in ("bucket_s", "h2d_s", "kernel_s", "d2h_s"):
        stats.setdefault(k, 0.0)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    ptuple = B._params_tuple(params)
    n_all = len(soa["h0"])
    results = {k: np.zeros(n_all, np.int32) for k in B.OUT_ORDER}
    if n_all == 0:
        return results

    t0 = time.perf_counter()
    q_len, t_len = soa["q_len"], soa["t_len"]
    e = np.asarray(edges, np.int64)
    qb = np.searchsorted(e, q_len)
    tb = np.searchsorted(e, t_len)
    if int(qb.max()) >= len(e) or int(tb.max()) >= len(e):
        bad = max(int(q_len.max(initial=0)), int(t_len.max(initial=0)))
        raise ValueError(f"length {bad} exceeds the largest bucket {edges[-1]}")
    key = qb * len(e) + tb
    order = np.argsort(key, kind="stable")
    starts = np.concatenate(([0], np.flatnonzero(np.diff(key[order])) + 1, [n_all]))
    sorted_np = {k: np.ascontiguousarray(np.asarray(soa[k])[order], dtype=dt)
                 for k, dt in SOA_DTYPES.items()}
    t1 = time.perf_counter()

    codes = torch.from_numpy(np.asarray(soa["codes"], np.int8)).to(device)
    per_pair = {k: torch.from_numpy(v).to(device) for k, v in sorted_np.items()}
    sync()
    t2 = time.perf_counter()

    outs = []
    for lo_b, hi_b in zip(starts[:-1], starts[1:]):
        bucket = (int(e[qb[order[lo_b]]]), int(e[tb[order[lo_b]]]))
        for lo in range(lo_b, hi_b, dev_batch):
            hi = min(lo + dev_batch, hi_b)
            batch = {"codes": codes, **{k: v[lo:hi] for k, v in per_pair.items()}}
            out = B.bsw_extend(batch, ptuple, q_max=bucket[0])
            outs.append(out)
            if keep is not None:
                keep.append({"bucket": bucket, "batch": batch, "out": out})
    sync()
    t3 = time.perf_counter()

    pooled = torch.cat(outs, dim=1).cpu().numpy()
    for row, k in enumerate(B.OUT_ORDER):
        results[k][order] = pooled[row]
    t4 = time.perf_counter()
    stats["bucket_s"] += t1 - t0
    stats["h2d_s"] += t2 - t1
    stats["kernel_s"] += t3 - t2
    stats["d2h_s"] += t4 - t3
    return results


def score_pairs(pairs, params: BswParams = DEFAULT_PARAMS, edges=EDGES,
                dev_batch: int = DEV_BATCH, device=None):
    """List-of-(q, t, h0) front end: converts to the SoA layout and
    delegates to score_pairs_soa (same outputs, input order)."""
    n = len(pairs)
    if n == 0:
        default_device(device)
        return {k: np.zeros(0, np.int32) for k in B.OUT_ORDER}
    q_len = np.fromiter((len(q) for q, _, _ in pairs), np.int32, n)
    t_len = np.fromiter((len(t) for _, t, _ in pairs), np.int32, n)
    h0 = np.fromiter((h for _, _, h in pairs), np.int32, n)
    codes = np.concatenate([np.asarray(a, np.int8) for q, t, _ in pairs for a in (q, t)])
    sizes = np.empty(2 * n, np.int64)
    sizes[0::2] = q_len
    sizes[1::2] = t_len
    offs = np.concatenate(([0], np.cumsum(sizes[:-1])))
    soa = {"codes": codes, "q_off": offs[0::2], "q_len": q_len,
           "t_off": offs[1::2], "t_len": t_len, "h0": h0}
    return score_pairs_soa(soa, params, edges, dev_batch, device)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bsw")
    ap.add_argument("-pairs", "--pairs", required=True, dest="pairs")
    ap.add_argument("-t", "--threads", type=int, default=1, help="ignored (device-parallel)")
    ap.add_argument("-b", "--batch", type=int, default=512, help="accepted for CLI parity")
    ap.add_argument("-m", "--match", type=int, default=1)
    ap.add_argument("-x", "--mismatch", type=int, default=4)
    ap.add_argument("-o", "--open", type=int, default=6, dest="gapo")
    ap.add_argument("-e", "--extend", type=int, default=1, dest="gape")
    ap.add_argument("--print-output", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs "
                         "the plain PyTorch version)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    params = BswParams(o_del=args.gapo, e_del=args.gape, o_ins=args.gapo, e_ins=args.gape,
                       match=args.match, mismatch=args.mismatch)
    t0 = time.perf_counter()
    soa = parse_pairs_soa(args.pairs)
    read_time = time.perf_counter() - t0
    n_pairs = len(soa["h0"])
    print(f"Read time = {read_time:.4f}")
    print(f"Total Pairs read: {n_pairs}")

    t0 = time.perf_counter()
    results = score_pairs_soa(soa, params, device=device)
    kernel_time = time.perf_counter() - t0
    if args.print_output:
        cols = np.stack([results[k] for k in B.OUT_ORDER], axis=1)
        sys.stdout.write("\n".join(" ".join(map(str, row)) for row in cols.tolist()) + "\n")
    print(f"Overall SW cycles(kernel time) = {kernel_time:.4f} sec")
    print(f"Total Pairs processed: {n_pairs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
