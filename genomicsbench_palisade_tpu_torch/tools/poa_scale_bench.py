"""Dataset-scale poa rehearsal at reference-like window shapes.

    python -m genomicsbench_palisade_tpu_torch.tools.poa_scale_bench
        [--windows 64] [--seqs 10] [--len 750] [--parity-windows 4]
        [--reps 2] [--engine device|host] [--smoke] [--out FILE]
        [--device cpu]

Counterpart of tools/poa_scale_bench.py.  The reference's poa input is
windows of ~0.5-1 kb sequences (benchmarks/poa/msa_spoa_omp.cpp:102-165).
This makes the JAX tool's windows (default_rng(23): a random sequence a
window, each of its sequences with 4% substitutions and 2 deletions) and
runs the consensus once to warm and `--reps` times timed: `--engine
device` (the default) through `ops.poa.msa_consensus_batch` (the windows'
alignments in lockstep as torch ops on the card, the graphs on the host;
no hand-written kernel on this path), `--engine host` through the port's
build of the JAX package's native engine (`msa_consensus_host`).  Prints
one JSON line with the JAX tool's keys: seqs/s and the align / add /
consensus split of the best run.  A sample of windows (drawn from the
generator's rng) must give exactly the port's oracle consensus
(`ops.oracle.poa.msa_consensus`).

`--smoke` runs 4 windows of 4 sequences of 120 bases; `--device cpu` runs
the torch ops on the CPU.  The JAX tool's default engine is `host`; the
port's is the device.  The line is appended to `--out` only when that is
given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import default_device
from ..ops.oracle.poa import msa_consensus
from ..ops.poa import msa_consensus_batch, msa_consensus_host
from . import append_entry

SEED = 23


def synth_windows(rng, n_win, n_seq, length):
    """`n_win` windows of `n_seq` sequences: a random base sequence a
    window, each of its sequences with 4% substitutions and 2 deletions."""
    batches = []
    for _ in range(n_win):
        base = rng.integers(0, 4, length)
        seqs = []
        for _ in range(n_seq):
            s = base.copy()
            mut = rng.random(length) < 0.04
            s[mut] = rng.integers(0, 4, int(mut.sum()))
            s = np.delete(s, np.sort(rng.choice(length, 2, replace=False)))
            seqs.append("".join("ACGT"[c] for c in s))
        batches.append(seqs)
    return batches


def main(argv=None):
    ap = argparse.ArgumentParser(prog="poa_scale_bench")
    ap.add_argument("--windows", type=int, default=64)
    ap.add_argument("--seqs", type=int, default=10)
    ap.add_argument("--len", type=int, default=750, dest="length")
    ap.add_argument("--parity-windows", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--engine", choices=["host", "device"], default="device",
                    help="device = the lockstep alignment on the device (default); host = "
                         "the native engine on the host")
    ap.add_argument("--smoke", action="store_true", help="4 windows of 4 x 120 bases")
    ap.add_argument("--out", default=None, help="append the line to this file's list")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the torch ops on the CPU)")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    if args.smoke:
        args.windows, args.seqs, args.length = 4, 4, 120
        args.parity_windows = 2

    rng = np.random.default_rng(SEED)
    batches = synth_windows(rng, args.windows, args.seqs, args.length)
    total_seqs = args.windows * args.seqs
    total_bases = sum(len(s) for b in batches for s in b)
    print(f"[gen] {args.windows} windows x {args.seqs} seqs, {total_bases:,} bases",
          file=sys.stderr)

    def run_engine(tm=None):
        if args.engine == "host":
            return msa_consensus_host(batches, timings=tm)
        return msa_consensus_batch(batches, timings=tm, device=device)

    t0 = time.perf_counter()
    out = run_engine()
    warm_s = time.perf_counter() - t0
    best, timings = float("inf"), {}
    for _ in range(args.reps):
        tm = {}
        t0 = time.perf_counter()
        out = run_engine(tm)
        dt = time.perf_counter() - t0
        if dt < best:
            best, timings = dt, tm
    if not all(out):
        raise AssertionError("empty consensus")
    print(f"[run] warm {warm_s:.1f} s, best {best:.2f} s ({timings})", file=sys.stderr)

    sel = rng.choice(args.windows, min(args.parity_windows, args.windows), replace=False)
    t0 = time.perf_counter()
    for wi in sel:
        if out[wi] != msa_consensus(batches[wi]):
            raise AssertionError(f"window {wi}: consensus != oracle")
    print(f"[parity] {len(sel)}/{len(sel)} oracle-exact in {time.perf_counter() - t0:.0f} s",
          file=sys.stderr)

    res = {
        "tool": "poa_scale_bench",
        "engine": args.engine,
        "windows": args.windows,
        "seqs_per_window": args.seqs,
        "seq_len": args.length,
        "total_bases": int(total_bases),
        "warm_s": round(warm_s, 1),
        "best_s": round(best, 2),
        "seqs_per_s": round(total_seqs / best, 1),
        "align_s": round(timings.get("align", 0.0), 2),
        "add_s": round(timings.get("add", 0.0), 2),
        "consensus_s": round(timings.get("consensus", 0.0), 2),
        "oracle_parity_windows": int(len(sel)),
        "smoke": bool(args.smoke),
    }
    print(json.dumps(res), flush=True)
    if args.out:
        append_entry(args.out, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
