"""chain driver: `python -m genomicsbench_palisade_tpu_torch.cli.chain -i <in> -o <out>`.

Mirrors the reference testbed driver (benchmarks/chain/src/main.cpp:41-137),
as genomicsbench_palisade_tpu/cli/chain.py does: reads anchor-dump
records, runs the chaining DP, writes per-anchor score/parent pairs and
prints "Time in kernel" to stderr.  Runs on one device: CUDA unless
`--device cpu`.

Calls with n_segs == 1 and sorted anchors go through `prepare_call` and
one flat batch per parameter group (`ops.chain.chain_calls`); the rest
(n_segs != 1, unsorted x) run the exact oracle on the host, as in the JAX
package.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .. import default_device
from ..io.chain_dump import parse_chain_dump, print_return
from ..ops import chain as C
from ..ops.oracle import chain as CO


def run_calls(calls, device=None, stats: dict | None = None, keep: list | None = None):
    """Returns a list of (scores, parents int64, peaks) in input order.

    `stats`, when given, accumulates "prep_s" (routing, the oracle calls
    and prepare_call on the host) and ops.chain.chain_calls's phases;
    `keep` is handed to chain_calls."""
    device = default_device(device)
    stats = {} if stats is None else stats
    stats.setdefault("prep_s", 0.0)
    t0 = time.perf_counter()
    results = [None] * len(calls)
    on_device, preps = [], []
    for i, call in enumerate(calls):
        if call.n == 0:
            results[i] = C.empty_result()
        elif call.n_segs != 1 or not np.all(call.x[1:] >= call.x[:-1]):
            res = CO.chain_dp(CO.ChainCall(
                n=call.n, avg_qspan=call.avg_qspan, max_dist_x=call.max_dist_x,
                max_dist_y=call.max_dist_y, bw=call.bw, n_segs=call.n_segs,
                x=call.x, y=call.y))
            results[i] = (res["scores"], res["parents"], res["peak_scores"])
        else:
            on_device.append(i)
            preps.append(C.prepare_call(call.x, call.y, call.avg_qspan, call.max_dist_x,
                                        call.max_dist_y, call.bw))
    stats["prep_s"] += time.perf_counter() - t0
    if preps:
        for i, out in zip(on_device, C.chain_calls(preps, device, stats=stats, keep=keep)):
            results[i] = out
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(prog="chain")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-t", "--threads", type=int, default=1, help="ignored (device-parallel)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs "
                         "the plain PyTorch version)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    calls = parse_chain_dump(args.input)
    t0 = time.perf_counter()
    results = run_calls(calls, device)
    dt = time.perf_counter() - t0
    if args.output:
        with open(args.output, "w") as f:
            for scores, parents, _ in results:
                print_return(f, scores, parents)
    print(f"Time in kernel: {dt:.2f} sec", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
