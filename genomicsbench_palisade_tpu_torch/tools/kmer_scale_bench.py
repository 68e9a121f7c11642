"""Dataset-scale kmer-cnt rehearsal: a Gbp of reads of at least 5 kb.

    python -m genomicsbench_palisade_tpu_torch.tools.kmer_scale_bench
        [--gbp 1.06] [--read-len 10000] [--genome-mbp 25]
        [--parity-reads 512] [--host-only] [--smoke] [--out FILE]
        [--device cpu]

Counterpart of tools/kmer_scale_bench.py.  The reference's kmer-cnt runs
on GB-scale read sets behind its minimum-length filter (benchmarks/
kmer-cnt/kmer_cnt.cpp:220-231).  This makes the JAX tool's coverage-style
reads (default_rng(29): one random genome, reads drawn from it with 0.1%
substitutions), counts them with the native host counter
(`ops.kmer.count_kmers_host`) and streams them through the device
accumulator (`ops.kmer.count_kmers_batched`, torch ops on the card; no
hand-written kernel on this path); the two metric sets must be equal.
The first `--parity-reads` reads are counted again by the one-shot counter
(`count_kmers`) and the streamed one in smaller batches: equal too.
Prints one JSON line with the JAX tool's keys.  `--host-only` skips the
device accumulator (the parity subset still runs on the device).

`--smoke` shrinks the set to 2 Mbp of a 1 Mbp genome and the subset to 64
reads; `--device cpu` runs the counters as torch ops on the CPU.  The line
is appended to `--out` only when that is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import default_device
from ..ops import kmer as K
from . import append_entry

SEED = 29


def synth_reads(rng, total_bases, read_len=10_000, genome_mbp=25, err=0.001):
    """Reads of `read_len` uint8 codes drawn from one uniform random genome
    of `genome_mbp` Mbp, each base substituted (a random code, maybe the
    same) with probability `err`; total_bases // read_len of them."""
    genome = rng.integers(0, 4, genome_mbp * 1_000_000).astype(np.uint8)
    n_reads = total_bases // read_len
    reads = []
    for s in rng.integers(0, len(genome) - read_len, n_reads):
        r = genome[s : s + read_len].copy()
        mut = rng.random(read_len) < err
        r[mut] = rng.integers(0, 4, int(mut.sum()))
        reads.append(r)
    return reads


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kmer_scale_bench")
    ap.add_argument("--gbp", type=float, default=1.06)
    ap.add_argument("--read-len", type=int, default=10_000)
    ap.add_argument("--genome-mbp", type=int, default=25)
    ap.add_argument("--parity-reads", type=int, default=512)
    ap.add_argument("--smoke", action="store_true", help="2 Mbp of reads, 64 in the subset")
    ap.add_argument("--host-only", action="store_true",
                    help="skip the device accumulator (its metrics are then the host's)")
    ap.add_argument("--out", default=None, help="append the line to this file's list")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the counters as torch ops on the CPU)")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    if args.smoke:
        args.gbp, args.genome_mbp = 0.002, 1
        args.parity_reads = 64

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    reads = synth_reads(rng, int(args.gbp * 1e9), args.read_len, args.genome_mbp)
    real_bases = sum(len(r) for r in reads)
    print(f"[gen] {len(reads):,} reads / {real_bases / 1e9:.2f} Gbp in "
          f"{time.perf_counter() - t0:.0f} s", file=sys.stderr)

    cap = 1 << 21 if args.smoke else 1 << 26
    t0 = time.perf_counter()
    host_metrics = K.count_kmers_host(reads)
    host_s = None
    if host_metrics is not None:  # None only where the host cannot hold the table
        host_s = time.perf_counter() - t0
        print(f"[host] {host_metrics} in {host_s:.1f} s", file=sys.stderr)
    if args.host_only:
        metrics, kernel_s = host_metrics, None
    else:
        t0 = time.perf_counter()
        metrics = K.count_kmers_batched(reads, cap=cap, device=device)
        kernel_s = time.perf_counter() - t0
        print(f"[device] {metrics} in {kernel_s:.1f} s", file=sys.stderr)
        if host_metrics is not None and host_metrics != metrics:
            raise AssertionError(f"host {host_metrics} != device {metrics}")

    sub = reads[: args.parity_reads]
    want = K.count_kmers(sub, device=device)
    got = K.count_kmers_batched(sub, batch_bases=max(len(sub) * args.read_len // 4, 100_000),
                                cap=cap, device=device)
    if got != want:
        raise AssertionError(f"batched {got} != one-shot {want}")
    print(f"[parity] batched == one-shot on {len(sub)} reads "
          f"({want['total_kmers']:,} distinct)", file=sys.stderr)

    out = {
        "tool": "kmer_scale_bench",
        "reads": len(reads),
        "gbp": round(real_bases / 1e9, 3),
        "read_len": args.read_len,
        "genome_mbp": args.genome_mbp,
        "distinct_kmers": metrics["total_kmers"],
        "hash_size": metrics["hash_size"],
        "device_s": round(kernel_s, 1) if kernel_s else None,
        "device_mbases_per_s": round(real_bases / kernel_s / 1e6, 1) if kernel_s else None,
        "host_s": round(host_s, 1) if host_s else None,
        "host_mbases_per_s": round(real_bases / host_s / 1e6, 1) if host_s else None,
        "host_device_metrics_equal": (host_metrics == metrics
                                      if host_metrics is not None and kernel_s else None),
        "host_only": bool(args.host_only),
        "parity_reads": len(sub),
        "smoke": bool(args.smoke),
    }
    print(json.dumps(out), flush=True)
    if args.out:
        append_entry(args.out, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
