"""Dataset-scale chain rehearsal: the reference's input shape end to end.

    python -m genomicsbench_palisade_tpu_torch.tools.chain_scale_bench
        [--calls 1001] [--parity-cap 1500] [--parity-max 8] [--workdir DIR]
        [--smoke] [--out FILE] [--device cpu]

Counterpart of tools/chain_scale_bench.py.  The reference chain dataset is
1001 calls of up to 87,271 anchors (benchmarks/chain/src/main.cpp:100-101).
This writes the JAX tool's dump (log-uniform call sizes topping out at
exactly 87,271 anchors; default_rng(5), byte for byte) and drives the path
of `cli.chain`: `io.chain_dump.parse_chain_dump`, then `cli.chain.
run_calls` (one launch of `csrc/chain_dp.cu` on the card) once to warm
and the best of three timed.  Prints one JSON line with the JAX tool's
keys: read / warm / kernel seconds and anchors/s.  Up to `--parity-max`
calls of at most `--parity-cap` anchors are held to the port's oracle
(`ops.oracle.chain.chain_dp`): scores, parents and peaks exactly.

`--smoke` writes calls of 8-199 anchors and times one run; `--device cpu`
runs the plain PyTorch version.  The JAX tool's `force_cpu_backend` has no
counterpart: `--device` picks the device.  The dump is kept in
`--workdir` when one is given (and reused), else written to a temporary
directory that is removed; the line is appended to `--out` only when that
is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import default_device
from ..cli.chain import run_calls
from ..io.chain_dump import parse_chain_dump
from ..ops.oracle import chain as CO
from . import append_entry, work_dir

MAX_N = 87_271  # benchmarks/chain/src/main.cpp:100 reported maximum
SEED = 5


def synth_call(rng, n):
    """Anchors like the reference's minimap2 dumps: x non-decreasing with
    gaps of 1-39 and a rare jump of 5,000-20,000 (the max_dist and bw
    cutoffs), y within 400 of x (so y holds no query span)."""
    gaps = rng.integers(1, 40, n)
    jumps = rng.random(n) < 0.002
    gaps[jumps] += rng.integers(5_000, 20_000, int(jumps.sum()))
    x = np.cumsum(gaps.astype(np.int64)) + 10_000
    y = np.maximum(x + rng.integers(-400, 400, n), 0)
    return x.astype(np.uint64), y.astype(np.uint64)


def write_dump(path, rng, n_calls, smoke=False):
    """The JAX tool's dump: log-uniform call sizes from 63 anchors with one
    call of exactly MAX_N (8-199 anchors with `smoke`).  Returns the number
    of anchors."""
    sizes = np.round(10 ** rng.uniform(1.8, np.log10(MAX_N), n_calls)).astype(np.int64)
    if smoke:
        sizes = rng.integers(8, 200, n_calls)
    else:
        sizes[rng.integers(0, n_calls)] = MAX_N  # force the reference max
    with open(path, "w") as f:
        for n in sizes:
            x, y = synth_call(rng, int(n))
            aq = float(rng.uniform(10, 40))
            f.write(f"{n} {aq:.6f} 5000 5000 500 1\n")
            f.write("\n".join(f"{a} {b}" for a, b in zip(x, y)))
            f.write("\nEOR\n")
    return int(sizes.sum())


def oracle_check(calls, results, cap: int, most: int) -> int:
    """Hold the results of up to `most` calls of 1..cap anchors to the
    oracle; the number checked."""
    checked = 0
    for call, (sc, par, pk) in zip(calls, results):
        if not (0 < call.n <= cap) or checked >= most:
            continue
        res = CO.chain_dp(CO.ChainCall(
            n=call.n, avg_qspan=call.avg_qspan, max_dist_x=call.max_dist_x,
            max_dist_y=call.max_dist_y, bw=call.bw, n_segs=call.n_segs, x=call.x, y=call.y))
        for name, got, key in (("scores", sc, "scores"), ("parents", par, "parents"),
                               ("peaks", pk, "peak_scores")):
            if not np.array_equal(np.asarray(got)[: call.n], res[key]):
                raise AssertionError(f"call {checked} ({call.n} anchors): {name} differ "
                                     "from the oracle's")
        checked += 1
    return checked


def main(argv=None):
    ap = argparse.ArgumentParser(prog="chain_scale_bench")
    ap.add_argument("--workdir", default=None,
                    help="keep (and reuse) the dump here (default: a temporary directory, "
                         "removed)")
    ap.add_argument("--calls", type=int, default=1001)
    ap.add_argument("--parity-cap", type=int, default=1500,
                    help="oracle-check every call with n <= this")
    ap.add_argument("--parity-max", type=int, default=8,
                    help="max number of calls to oracle-check")
    ap.add_argument("--smoke", action="store_true", help="tiny calls, one timed run")
    ap.add_argument("--out", default=None, help="append the line to this file's list")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch version)")
    args = ap.parse_args(argv)
    device = default_device(args.device)

    with work_dir(args.workdir) as wd:
        dump = wd / ("calls_smoke.txt" if args.smoke else "calls.txt")
        if not dump.exists():
            t0 = time.perf_counter()
            total = write_dump(dump, np.random.default_rng(SEED), args.calls, smoke=args.smoke)
            print(f"[gen] {args.calls} calls / {total:,} anchors in "
                  f"{time.perf_counter() - t0:.0f} s", file=sys.stderr)
        t0 = time.perf_counter()
        calls = parse_chain_dump(str(dump))
        read_s = time.perf_counter() - t0
    total_anchors = int(sum(c.n for c in calls))
    print(f"[read] {len(calls)} calls / {total_anchors:,} anchors in {read_s:.1f} s",
          file=sys.stderr)

    t0 = time.perf_counter()
    results = run_calls(calls, device)
    warm_s = time.perf_counter() - t0
    kernel_s = float("inf")
    for _ in range(1 if args.smoke else 3):
        t0 = time.perf_counter()
        results = run_calls(calls, device)
        kernel_s = min(kernel_s, time.perf_counter() - t0)
    checked = oracle_check(calls, results, args.parity_cap, args.parity_max)

    out = {
        "tool": "chain_scale_bench",
        "calls": len(calls),
        "total_anchors": total_anchors,
        "max_call_n": int(max(c.n for c in calls)),
        "read_s": round(read_s, 1),
        "warm_s": round(warm_s, 1),
        "kernel_s": round(kernel_s, 2),
        "anchors_per_s": round(total_anchors / kernel_s, 1),
        "oracle_parity_calls": checked,
        "smoke": bool(args.smoke),
    }
    print(json.dumps(out), flush=True)
    if args.out:
        append_entry(args.out, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
