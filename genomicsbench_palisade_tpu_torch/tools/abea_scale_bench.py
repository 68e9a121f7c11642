"""Nanopore-scale abea rehearsal: reads of 10-50 kb.

    python -m genomicsbench_palisade_tpu_torch.tools.abea_scale_bench
        [--reads 16] [--len-min 10000] [--len-max 50000] [--parity 8]
        [--reps 3] [--engine device|host] [--add-100k] [--smoke]
        [--out FILE] [--device cpu]

Counterpart of tools/abea_scale_bench.py.  Real f5c inputs are reads of
10-100 kb at ~1.5 events a base, so a read's bands reach 10^5
(benchmarks/abea/src/align.c:145-166).  This makes the JAX tool's model
and reads (default_rng(17): a random read and its event means, 1-2 events
a k-mer at the model's level plus N(0, 0.4)) and aligns them once to warm
and `--reps` times timed: `--engine device` (the default) through
`ops.abea.align_events_batch` (one launch each of `csrc/abea_fill.cu` and
`csrc/abea_walk.cu` on the card), `--engine host` through the port's
build of the JAX package's native fill and walk
(`align_events_batch(use_native=True)`).  Prints one JSON line with the
JAX tool's keys: the best time, reads/s, events/s, the reads aligned.
The first `--parity` reads (shortened to at most 15 kb when the rest go
unchecked: the Python oracle takes seconds a kb) must decode to exactly
the port's oracle alignment (`ops.oracle.abea.align`), QC drops included.

`--smoke` runs 2 reads of 400-800 bases; `--device cpu` runs the plain
PyTorch versions (or, with `--engine host`, the native engine, which
needs no device).  The JAX tool's default engine is `host`; the port's
is the kernels.  The line is appended to `--out` only when that is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import default_device
from ..ops.abea import align_events_batch
from ..ops.oracle import abea as AO
from . import append_entry

K = 6
SEED = 17


def synth_model(rng):
    """Levels N(90, 12), stdv 1-3 (f32), over the 4,096 6-mers."""
    model = {"level_mean": rng.normal(90, 12, 4096).astype(np.float32),
             "level_stdv": (rng.random(4096) * 2 + 1).astype(np.float32)}
    model["level_log_stdv"] = np.log(model["level_stdv"]).astype(np.float32)
    return model


def synth_read(rng, model, length):
    """A random read and its event means: 1-2 events a k-mer at the
    model's level plus N(0, 0.4).  A k-mer's rank has its first base in
    the high bits (the oracle's get_kmer_rank)."""
    codes = rng.integers(0, 4, length)
    seq = "".join("ACGT"[c] for c in codes)
    nk = length - K + 1
    ranks = np.zeros(nk, np.int64)
    for j in range(K):
        ranks = (ranks << 2) | codes[j : nk + j]
    counts = rng.integers(1, 3, nk)
    means = (np.repeat(model["level_mean"][ranks], counts)
             + rng.normal(0, 0.4, int(counts.sum())))
    return seq, means.astype(np.float32)


def read_lengths(n_reads: int, len_min: int, len_max: int, parity: int) -> np.ndarray:
    """The JAX tool's lengths: linspace(len_min, len_max), the first
    `parity` shortened to at most 15 kb when not every read is checked."""
    lens = np.linspace(len_min, len_max, n_reads).astype(int)
    if parity < n_reads:
        lens[:parity] = np.linspace(len_min, min(15_000, len_max), parity).astype(int)
    return lens


def main(argv=None):
    ap = argparse.ArgumentParser(prog="abea_scale_bench")
    ap.add_argument("--reads", type=int, default=16)
    ap.add_argument("--len-min", type=int, default=10_000)
    ap.add_argument("--len-max", type=int, default=50_000)
    ap.add_argument("--parity", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--engine", choices=["host", "device"], default="device",
                    help="device = the fill and walk kernels (default); host = the native "
                         "fill and walk on the host")
    ap.add_argument("--add-100k", action="store_true",
                    help="append one ~100 kb read (f5c's upper regime)")
    ap.add_argument("--smoke", action="store_true", help="2 reads of 400-800 bases")
    ap.add_argument("--out", default=None, help="append the line to this file's list")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    if args.smoke:
        args.reads = min(args.reads, 2)
        args.len_min, args.len_max = 400, 800
        args.parity = min(args.parity, 2)

    rng = np.random.default_rng(SEED)
    model = synth_model(rng)
    lens = read_lengths(args.reads, args.len_min, args.len_max, args.parity)
    t0 = time.perf_counter()
    seqs, evs = map(list, zip(*(synth_read(rng, model, int(n)) for n in lens)))
    if args.add_100k:
        s, e = synth_read(rng, model, 100_000)
        seqs.append(s)
        evs.append(e)
        lens = np.concatenate([lens, [100_000]])
        args.reads += 1
    n_events = int(sum(len(e) for e in evs))
    print(f"[gen] {args.reads} reads, {int(lens.sum()):,} bases, {n_events:,} events in "
          f"{time.perf_counter() - t0:.0f} s", file=sys.stderr)

    ones, zeros = [1.0] * args.reads, [0.0] * args.reads

    def run():
        return align_events_batch(seqs, evs, model, ones, zeros, device=device,
                                  use_native=args.engine == "host")

    t0 = time.perf_counter()
    res = run()
    warm_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(args.reps):
        t0 = time.perf_counter()
        res = run()
        best = min(best, time.perf_counter() - t0)
    aligned = sum(1 for r in res if r)
    print(f"[run] warm {warm_s:.1f} s, best {best:.2f} s, {aligned}/{args.reads} aligned",
          file=sys.stderr)

    t0 = time.perf_counter()
    for i in range(args.parity):
        want = AO.align(seqs[i], evs[i], model, 1.0, 0.0)
        if res[i] != want:
            raise AssertionError(f"read {i} (len {lens[i]}): {args.engine} != oracle "
                                 f"({len(res[i])} vs {len(want)} pairs)")
    print(f"[parity] {args.parity}/{args.parity} oracle-exact in "
          f"{time.perf_counter() - t0:.0f} s", file=sys.stderr)

    out = {
        "tool": "abea_scale_bench",
        "engine": args.engine,
        "reads": args.reads,
        "len_min": int(lens.min()),
        "len_max": int(lens.max()),
        "total_events": n_events,
        "max_bands": int(max(len(e) for e in evs) + max(len(s) for s in seqs) - K + 3),
        "warm_s": round(warm_s, 1),
        "best_s": round(best, 2),
        "reads_per_s": round(args.reads / best, 2),
        "events_per_s": round(n_events / best, 1),
        "aligned": aligned,
        "oracle_parity_reads": args.parity,
        "smoke": bool(args.smoke),
    }
    print(json.dumps(out), flush=True)
    if args.out:
        append_entry(args.out, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
