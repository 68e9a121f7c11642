"""Dataset-scale bsw rehearsal: the reference's large-input shape.

    python -m genomicsbench_palisade_tpu_torch.tools.bsw_scale_bench
        [--pairs 10606460] [--parity-sample 512] [--workdir DIR] [--smoke]
        [--out FILE] [--device cpu]

Counterpart of tools/bsw_scale_bench.py.  The reference's bsw_large run
reads 10,606,460 pairs (scripts/bsw_large:5-8).  This writes the JAX
tool's pair file (its 3-line records, digit-coded bases; default_rng(9),
byte for byte) and drives the path of `cli.bsw`: `io.pairs.parse_pairs_soa`
(the native scan), then `cli.bsw.score_pairs_soa` (bucketed launches of
`csrc/bsw_extend.cu` on the card) once to warm and once timed.  Prints one
JSON line with the JAX tool's keys: read / warm / kernel seconds, pairs/s
and the GCUPS upper bound (every query x target cell).  A random sample of
pairs (drawn from the generator's rng after the file, as the JAX tool
draws it) is scored again by the plain version, `ops.bsw.bsw_extend_plain`
on the CPU (pinned to the 300 reference goldens), and all six outputs must
be equal.

`--smoke` caps the pairs at 2,048 with short reads (queries 8-23, targets
16-39); `--device cpu` runs the plain version.  The pair file is kept in
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
import torch

from .. import default_device
from ..cli.bsw import score_pairs_soa
from ..io.pairs import parse_pairs_soa
from ..ops import bsw as W
from . import append_entry, work_dir

REF_PAIRS = 10_606_460  # scripts/bsw_large:8
SEED = 9


def write_pairs(path, n_pairs, rng, chunk=8192, smoke=False):
    """The JAX tool's pair file, byte for byte from the same rng: chunks of
    pairs that share (ql, tl) (queries 96-151 and targets 192-256, or 8-23
    and 16-39 with `smoke`), each query its target's head with 8% mutations,
    h0 1-79.  Each chunk's records are laid out in one uint8 matrix (a
    1-digit h0 drops its first column) instead of one record at a time."""
    with open(path, "wb") as f:
        done = 0
        while done < n_pairs:
            m = min(chunk, n_pairs - done)
            ql = int(rng.integers(8, 24) if smoke else rng.integers(96, 152))
            tl = int(rng.integers(16, 40) if smoke else rng.integers(192, 257))
            tgt = rng.integers(0, 4, (m, tl), dtype=np.uint8)
            qry = tgt[:, :ql].copy()
            mut = rng.random((m, ql)) < 0.08
            qry[mut] = rng.integers(0, 4, int(mut.sum()), dtype=np.uint8)
            h0 = rng.integers(1, 80, m)
            head = np.frombuffer(b" %d %d\n" % (tl, ql), np.uint8)
            rec = np.empty((m, 2 + len(head) + tl + 1 + ql + 1), np.uint8)
            rec[:, 0] = 48 + h0 // 10
            rec[:, 1] = 48 + h0 % 10
            c = 2 + len(head)
            rec[:, 2:c] = head
            rec[:, c : c + tl] = tgt + 48
            rec[:, c + tl] = 10
            rec[:, c + tl + 1 : c + tl + 1 + ql] = qry + 48
            rec[:, -1] = 10
            keep = np.ones(rec.shape, bool)
            keep[:, 0] = h0 >= 10
            f.write(rec[keep].tobytes())
            done += m


def plain_scores(soa, sel) -> torch.Tensor:
    """The plain version's [6, len(sel)] outputs (ops.bsw.OUT_ORDER rows)
    for the pairs `sel` of a parse_pairs_soa dict, on the CPU."""
    batch = {"codes": torch.from_numpy(np.asarray(soa["codes"], np.int8))}
    for key, dtype in (("q_off", np.int64), ("q_len", np.int32), ("t_off", np.int64),
                       ("t_len", np.int32), ("h0", np.int32)):
        batch[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(soa[key])[sel], dtype))
    return W.bsw_extend_plain(batch)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bsw_scale_bench")
    ap.add_argument("--workdir", default=None,
                    help="keep (and reuse) the pair file here (default: a temporary "
                         "directory, removed)")
    ap.add_argument("--pairs", type=int, default=REF_PAIRS)
    ap.add_argument("--parity-sample", type=int, default=512)
    ap.add_argument("--smoke", action="store_true", help="at most 2,048 short pairs")
    ap.add_argument("--out", default=None, help="append the line to this file's list")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch version)")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    if args.smoke:
        args.pairs = min(args.pairs, 2048)

    with work_dir(args.workdir) as wd:
        pf = wd / f"pairs_{args.pairs}.txt"
        rng = np.random.default_rng(SEED)
        if not pf.exists():
            t0 = time.perf_counter()
            write_pairs(pf, args.pairs, rng, smoke=args.smoke)
            print(f"[gen] {args.pairs:,} pairs ({pf.stat().st_size / 1e9:.2f} GB) in "
                  f"{time.perf_counter() - t0:.0f} s", file=sys.stderr)
        input_gb = pf.stat().st_size / 1e9

        t0 = time.perf_counter()
        soa = parse_pairs_soa(str(pf))
        read_s = time.perf_counter() - t0
    n_pairs = len(soa["h0"])
    print(f"[read] {n_pairs:,} pairs in {read_s:.1f} s", file=sys.stderr)

    t0 = time.perf_counter()
    results = score_pairs_soa(soa, device=device)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = score_pairs_soa(soa, device=device)
    kernel_s = time.perf_counter() - t0

    sel = rng.choice(n_pairs, min(args.parity_sample, n_pairs), replace=False)
    want = plain_scores(soa, sel).numpy()
    for row, key in enumerate(W.OUT_ORDER):
        bad = np.flatnonzero(results[key][sel] != want[row])
        if bad.size:
            i = int(sel[bad[0]])
            raise AssertionError(f"pair {i}: {key} {int(results[key][i])} against the plain "
                                 f"version's {int(want[row, bad[0]])}")

    cells = float(soa["q_len"].astype(np.int64) @ soa["t_len"].astype(np.int64))
    out = {
        "tool": "bsw_scale_bench",
        "pairs": n_pairs,
        "input_gb": round(input_gb, 2),
        "read_s": round(read_s, 1),
        "warm_s": round(warm_s, 1),
        "kernel_s": round(kernel_s, 2),
        "pairs_per_s": round(n_pairs / kernel_s, 1),
        "gcups_upper": round(cells / kernel_s / 1e9, 2),
        "parity_sample": int(len(sel)),
        "smoke": bool(args.smoke),
    }
    print(json.dumps(out), flush=True)
    if args.out:
        append_entry(args.out, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
