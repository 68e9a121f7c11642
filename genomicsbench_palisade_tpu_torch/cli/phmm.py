"""phmm driver: `python -m genomicsbench_palisade_tpu_torch.cli.phmm -f <testfile>`.

Reproduces the reference driver's contract (benchmarks/phmm/
PairHMMUnitTest.cpp:650-775 + IntelPairHmmCSource.cpp:61-85), as
genomicsbench_palisade_tpu/cli/phmm.py does: reads the batch test file,
computes the read x hap likelihoods per batch in testcase order, prints
per-testcase results and the kernel runtime.  Testcases are bucketed by
padded shape.  Runs on one device: CUDA unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import default_device
from ..io.bucketing import group_by_buckets
from ..io.phmm_batch import parse_testfile
from ..ops import phmm as P
from ..ops.phmm_f64 import fallback_batch, log10_f64
from ..utils.profiling import annotate, roi

# padded read-row and hap-column sizes of the buckets (as the JAX CLI's)
PHMM_EDGES = (64, 128, 256, 512)


def run_testcases(reads, haps, pairs, device=None, edges=PHMM_EDGES,
                  stats: dict | None = None, keep: list | None = None):
    """Compute likelihoods for an arbitrary testcase list, bucketed.

    Returns float64 log10 likelihoods in input order.  `stats`, when
    given, accumulates wall seconds per phase, "prep_s" (host packing),
    "f32_s" (f32 pass with host log10 and flags) and "f64_s" (fallback
    pass), and "fallback", the number of testcases sent to the f64 pass.
    `keep`, when given, gets one dict per bucket with what each pass was
    given and gave: "bucket", "batch" (tensors) and "raw_f32" (numpy),
    and for the flagged testcases "f64_batch" and "raw_f64" (or None).
    """
    device = default_device(device)
    results = np.zeros(len(pairs), dtype=np.float64)
    stats = {} if stats is None else stats
    for k in ("prep_s", "f32_s", "f64_s", "fallback"):
        stats.setdefault(k, 0)

    def size_of(pair):
        ri, hi = pair
        return (len(reads[ri]["bases"]) + 1, len(haps[hi]))

    groups = group_by_buckets(pairs, size_of, edges)
    for (r_pad, h_pad), members in groups.items():
        t0 = time.perf_counter()
        idxs = np.array([i for i, _ in members])
        batch = P.prepare_batch(reads, haps, [p for _, p in members],
                                r_pad=r_pad, h_pad=h_pad)
        t1 = time.perf_counter()
        with annotate(f"phmm_f32_{r_pad}x{h_pad}"):
            tb = P.as_device_batch(batch, device)
            log10, raw, fallback = P.phmm_forward(tb)
        t2 = time.perf_counter()
        out = log10.astype(np.float64)
        sub = raw64 = None
        if fallback.any():
            # double recompute (IntelPairHmmCSource.cpp:75-78)
            with annotate(f"phmm_f64_{r_pad}x{h_pad}"):
                sub, fidx = fallback_batch(tb, fallback)
                raw64 = P.forward_raw(sub, torch.float64).cpu().numpy()
            out[fidx] = log10_f64(raw64)
        t3 = time.perf_counter()  # both passes end in a device-to-host copy
        if keep is not None:
            keep.append({"bucket": (r_pad, h_pad), "batch": tb, "raw_f32": raw,
                         "f64_batch": sub, "raw_f64": raw64})
        results[idxs] = out
        stats["prep_s"] += t1 - t0
        stats["f32_s"] += t2 - t1
        stats["f64_s"] += t3 - t2
        stats["fallback"] += int(fallback.sum())
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(prog="phmm")
    ap.add_argument("-f", "--testfile", required=True)
    ap.add_argument("-t", "--threads", type=int, default=1, help="ignored (device-parallel)")
    ap.add_argument("-l", "--loop", type=int, default=1)
    ap.add_argument("--quiet", action="store_true", help="suppress per-testcase lines")
    ap.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler trace of the kernel region "
                         "(the VTune ITT ROI equivalent)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs "
                         "the plain PyTorch version)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    batches = parse_testfile(args.testfile)

    # the reference times only the kernel region (PairHMMUnitTest.cpp:560-594)
    runtime = 0.0
    with roi(trace_dir=args.trace_dir, name="phmm_kernel"):
        for batch in batches:
            t0 = time.perf_counter()
            res = run_testcases(batch.reads, batch.haps, batch.pairs, device)
            runtime += time.perf_counter() - t0
            if not args.quiet:
                for i, v in enumerate(res):
                    print(f"i: {i}; result_final: {v:f}")
    print(f"\nPairHMM completed. Kernel runtime: {runtime:.2f} sec")
    return 0


if __name__ == "__main__":
    sys.exit(main())
