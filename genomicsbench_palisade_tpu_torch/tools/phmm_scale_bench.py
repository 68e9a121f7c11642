"""End-to-end PairHMM at the reference dataset's shape.

    python -m genomicsbench_palisade_tpu_torch.tools.phmm_scale_bench
        [--batches 550] [--parity-sample 128] [--workdir DIR] [--smoke]
        [--out FILE] [--device cpu]

Counterpart of tools/phmm_scale_bench.py.  Writes the JAX tool's testfile
(550 batches of <=110 reads x <=37 haps, benchmarks/phmm/
PairHMMUnitTest.cpp:1-34,118-594; default_rng(20260824), byte for byte)
and drives the whole pipeline: `io.phmm_batch.parse_testfile`, the
testcases of every batch pooled into global shape buckets
(`io.bucketing.group_by_buckets`), `ops.phmm.prepare_batch`, the f32 pass
(`csrc/phmm_forward.cu` on the card) and the f64 pass of the testcases it
flags (`ops.phmm_f64.phmm_fallback_log10`, the kernel's double instance).
Prints one JSON line with the JAX tool's keys: the parse / prep / kernel /
fallback split and the end-to-end GCUPS.  A random sample (its own
default_rng(20260824)) is held to the port's oracle
(`ops.oracle.phmm.compute_likelihood`) within max(1e-5, 32 f32 ulps at the
result's magnitude), the JAX tool's gate.

`--smoke` shrinks the dataset (6 batches of <=8 reads x <=4 haps, a
sample of 16); `--device cpu` runs the plain PyTorch version.  The
testfile is kept in `--workdir` when one is given (and reused), else
written to a temporary directory that is removed; the line is appended to
`--out` only when that is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import default_device
from ..io.bucketing import group_by_buckets
from ..io.phmm_batch import parse_testfile
from ..ops import phmm as P
from ..ops.oracle.phmm import compute_likelihood
from ..ops.phmm_f64 import phmm_fallback_log10
from . import append_entry, work_dir

SEED = 20260824


def qual33(arr) -> str:
    return "".join(chr(int(v) + 33) for v in arr)


def synth_testfile(path, rng, n_batches=550, max_reads=110, max_haps=37,
                   read_len=(10, 151), hap_len=(50, 473)):
    """Reference-shaped batches (the JAX tool's bytes for the same rng):
    reads 10-151 bp, haps 50-473 bp; 60% of reads sampled from a hap with
    3% mutations (high likelihoods), the rest random (low likelihoods: the
    double fallback); q 6-40, i/d 30-45, c 10."""
    with open(path, "w") as f:
        for _ in range(n_batches):
            nr = int(rng.integers(1, max_reads + 1))
            nh = int(rng.integers(1, max_haps + 1))
            f.write(f"{nr} {nh}\n")
            haps = ["".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(
                hap_len[0], hap_len[1] + 1)))) for _ in range(nh)]
            for _ in range(nr):
                rl = int(rng.integers(read_len[0], read_len[1] + 1))
                if rng.random() < 0.6 and len(haps[0]) > rl:
                    hp = haps[int(rng.integers(nh))]
                    if len(hp) > rl:
                        s = int(rng.integers(0, len(hp) - rl))
                        bases = list(hp[s : s + rl])
                        for p in np.nonzero(rng.random(rl) < 0.03)[0]:
                            bases[p] = "ACGT"[int(rng.integers(4))]
                        bases = "".join(bases)
                    else:
                        bases = hp
                        rl = len(bases)
                else:
                    bases = "".join("ACGT"[c] for c in rng.integers(0, 4, rl))
                f.write(f"{bases} {qual33(rng.integers(6, 41, rl))} "
                        f"{qual33(rng.integers(30, 46, rl))} "
                        f"{qual33(rng.integers(30, 46, rl))} {qual33(np.full(rl, 10))}\n")
            for hp in haps:
                f.write(hp + "\n")


def rehearse(tf, device, parity_sample: int, smoke: bool) -> dict:
    t0 = time.perf_counter()
    batches = parse_testfile(tf)
    parse_s = time.perf_counter() - t0
    print(f"[parse] {parse_s:.1f} s", file=sys.stderr, flush=True)

    # the global pool: flat read and hap lists, the cross products' pairs
    reads, haps, pairs = [], [], []
    for b in batches:
        r0, h0 = len(reads), len(haps)
        reads.extend(b.reads)
        haps.extend(b.haps)
        pairs.extend((r0 + r, h0 + h) for r, h in b.pairs)
    n_pairs = len(pairs)
    cells = sum(len(reads[r]["bases"]) * len(haps[h]) for r, h in pairs)
    print(f"[pool] {len(batches)} batches, {n_pairs} testcases, {cells / 1e9:.2f} Gcells",
          file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    groups = group_by_buckets(pairs, lambda pr: (len(reads[pr[0]]["bases"]) + 1,
                                                 len(haps[pr[1]])))
    prepped = []
    for (r_pad, h_pad), members in groups.items():
        idxs = np.array([i for i, _ in members])
        prepped.append((idxs, P.prepare_batch(reads, haps, [p for _, p in members],
                                               r_pad=r_pad, h_pad=h_pad)))
    prep_s = time.perf_counter() - t0

    results = np.zeros(n_pairs, np.float64)
    kernel_s = fallback_s = 0.0
    n_fallback = 0
    for idxs, batch_np in prepped:
        t0 = time.perf_counter()
        tb = P.as_device_batch(batch_np, device)
        log10, _raw, fb = P.phmm_forward(tb)  # ends in the host copy of the raw sums
        dt = time.perf_counter() - t0
        kernel_s += dt
        print(f"[kernel] bucket {batch_np['rs_row'].shape} x h{batch_np['hap'].shape[1]}: "
              f"{dt:.3f} s", file=sys.stderr, flush=True)
        out = log10.astype(np.float64)
        t0 = time.perf_counter()
        if fb.any():
            vals, fidx = phmm_fallback_log10(tb, fb)
            out[fidx] = vals
            n_fallback += int(fb.sum())
        fallback_s += time.perf_counter() - t0
        results[idxs] = out
    total_s = parse_s + prep_s + kernel_s + fallback_s

    # its own seed: the sample does not depend on whether the testfile was
    # written in this run
    sel = np.random.default_rng(SEED).choice(n_pairs, min(parity_sample, n_pairs),
                                             replace=False)
    for i in sel:
        r, h = pairs[i]
        rd = reads[r]
        want = compute_likelihood(rd["bases"], haps[h], rd["q"], rd["i"], rd["d"], rd["c"])
        tol = max(1e-5, 32.0 * float(np.spacing(np.float32(abs(want)))))
        if not abs(want - results[i]) < tol:
            raise AssertionError(f"testcase {i}: {results[i]} against the oracle's {want} "
                                 f"(tolerance {tol})")
    print(f"[parity] {len(sel)}/{len(sel)} within max(1e-5, 32 ulp_f32)", file=sys.stderr)

    return {
        "tool": "phmm_scale_bench",
        "batches": len(batches),
        "pairs": n_pairs,
        "gcells": round(cells / 1e9, 2),
        "parse_s": round(parse_s, 2),
        "prep_s": round(prep_s, 2),
        "kernel_s": round(kernel_s, 2),
        "fallback_s": round(fallback_s, 2),
        "end_to_end_s": round(total_s, 2),
        "gcups_end_to_end": round(cells / total_s / 1e9, 2),
        "gcups_kernel_region": round(cells / max(kernel_s, 1e-9) / 1e9, 2),
        "fallback_frac": round(n_fallback / n_pairs, 4),
        "parity_sample": int(len(sel)),
        "smoke": bool(smoke),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="phmm_scale_bench")
    ap.add_argument("--batches", type=int, default=550)
    ap.add_argument("--parity-sample", type=int, default=128)
    ap.add_argument("--workdir", default=None,
                    help="keep (and reuse) the testfile here (default: a temporary directory, "
                         "removed)")
    ap.add_argument("--smoke", action="store_true", help="a tiny dataset (any device)")
    ap.add_argument("--out", default=None, help="append the line to this file's list")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch version)")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    if args.smoke:
        args.batches, args.parity_sample = 6, 16

    with work_dir(args.workdir) as wd:
        tf = wd / ("testfile_smoke.txt" if args.smoke else "testfile.txt")
        if not tf.exists():
            t0 = time.perf_counter()
            synth_testfile(tf, np.random.default_rng(SEED), n_batches=args.batches,
                           max_reads=8 if args.smoke else 110, max_haps=4 if args.smoke else 37)
            print(f"[gen] {tf} ({tf.stat().st_size / 1e6:.1f} MB, "
                  f"{time.perf_counter() - t0:.0f} s)", file=sys.stderr)
        res = rehearse(tf, device, args.parity_sample, args.smoke)
    print(json.dumps(res), flush=True)
    if args.out:
        append_entry(args.out, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
