"""PairHMM lane sweep: `phmm_forward` with L lanes a testcase and S rows a lane, per row edge and type.

    python -m genomicsbench_palisade_tpu_torch.tools.phmm_lanes [--cases 16384]
        [--reps 5] [--seed 1] [--dtypes f32,f64] [--edges 64,128,256,512]

csrc/phmm_forward.cu gives each row edge of cli/phmm.py (64-512 rows, the
bucket's r_pad) and each type an instance of PHMM_<T>_LANES_<edge> lanes a
testcase and PHMM_<T>_ROWS_<edge> rows a lane, compile-time constants; a
tile of L*S rows below the edge walks the rows in tiles.  This tool builds
the source once for each candidate of an edge (`candidates`: L of 8, 16 or
32, S of 2 to 16 (8 in double: a row is 20 registers), L*S from a quarter
of the edge to the edge; one nvcc a build, all at once), runs each build
on `--cases` testcases of that edge's bucket, holds every output to the
plain version bit for bit, and times the launch (best of `--reps` single
calls after `tools.warm_up`, CUDA events).  The testcases are the
dataset's kind (`make_cases`, rng `--seed`): reads of edge/2 to edge-1
bases, each a substring of its hap with 3% substituted, haps of the read's
length (at least 50) to 512 bases, q 6-40, i/d 30-45, c 10; the bucket is
edge x 512.  It prints one JSON line a build, with ptxas's registers and
spills for that instance, and a last line with the fastest shape of each
type and edge.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess

import numpy as np
import torch

from ..cli.phmm import PHMM_EDGES
from ..ops import phmm as P
from ..ops import phmm_cuda
from . import build_all, time_calls
from . import fastest as fastest_of
from . import ptxas_usage as entry_usage

LANES = (8, 16, 32)
MAX_ROWS = {"f32": 16, "f64": 8}  # rows a lane: ten values of T each in registers
DTYPES = {"f32": torch.float32, "f64": torch.float64}
H_PAD = 512  # the CLI's widest hap bucket


def candidates(dtypes=("f32", "f64"), edges=PHMM_EDGES):
    """(dtype, edge, lanes, rows) for every shape whose tile of lanes*rows
    holds from a quarter of the edge to the whole edge, rows 2 to MAX_ROWS."""
    out = []
    for dt in dtypes:
        for e in edges:
            for lanes in LANES:
                s = 2
                while s <= MAX_ROWS[dt]:
                    if e // 4 <= lanes * s <= e:
                        out.append((dt, e, lanes, s))
                    s *= 2
    return out


def defines_of(dtype, edge, lanes, rows):
    t = dtype.upper()
    return ((f"PHMM_{t}_LANES_{edge}", lanes), (f"PHMM_{t}_ROWS_{edge}", rows))


def make_cases(rng, n, edge):
    """`n` testcases of the bucket edge x H_PAD (reads, haps, pairs)."""
    reads, haps, pairs = [], [], []
    for k in range(n):
        rl = int(rng.integers(edge // 2, edge))
        hl = int(rng.integers(max(rl, 50), H_PAD + 1))
        hap = rng.integers(0, 4, hl)
        s = int(rng.integers(0, hl - rl + 1))
        bases = hap[s : s + rl].copy()
        mut = rng.random(rl) < 0.03
        bases[mut] = rng.integers(0, 4, int(mut.sum()))
        reads.append({"bases": bases, "q": rng.integers(6, 41, rl), "i": rng.integers(30, 46, rl),
                      "d": rng.integers(30, 46, rl), "c": np.full(rl, 10)})
        haps.append(hap)
        pairs.append((k, k))
    return reads, haps, pairs


_SHAPE = re.compile(r"phmm_forward_kernelI([fd])Li(\d+)ELi(\d+)E")


def ptxas_usage(log: str) -> dict:
    """{(dtype, lanes, rows): {"registers", "spill_stores", "spill_loads"}}
    of every phmm_forward_kernel instance in an nvcc -Xptxas -v log."""
    usage = {}
    for name, use in entry_usage(log).items():
        s = _SHAPE.search(name)
        if s:
            usage[("f32" if s.group(1) == "f" else "f64"), int(s.group(2)), int(s.group(3))] = use
    return usage


def run(cases=16384, reps=5, seed=1, dtypes=("f32", "f64"), edges=PHMM_EDGES) -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("phmm_lanes measures the kernel on a CUDA card")
    dev = torch.device("cuda")
    cands = candidates(dtypes, edges)
    kernels = {c: phmm_cuda.PhmmForwardKernel(DTYPES[c[0]], defines_of(*c)) for c in cands}
    libs = dict(zip(cands, build_all(kernels.values())))
    rng = np.random.default_rng(seed)
    rows = []
    for edge in edges:
        reads, haps, pairs = make_cases(rng, cases, edge)
        tb = P.as_device_batch(P.prepare_batch(reads, haps, pairs, r_pad=edge, h_pad=H_PAD), dev)
        cells = int((tb["rslen"].long() * tb["haplen"].long()).sum())
        for dt in dtypes:
            dtype = DTYPES[dt]
            want = P.phmm_forward_plain(tb, dtype)
            tabs = P.device_tables(dtype, dev)
            init_y = P.device_init_y(dtype, dev, H_PAD)
            for c, kern in kernels.items():
                if c[0] != dt or c[1] != edge:
                    continue
                sec, got = time_calls(lambda: kern(tb, tabs, init_y), dev, 1, reps)
                use = ptxas_usage(libs[c].with_suffix(".log").read_text()).get((dt, c[2], c[3]), {})
                rows.append({"dtype": dt, "edge": edge, "lanes": c[2], "rows": c[3],
                             "tiles": -(-(edge - 1) // (c[2] * c[3])), "cases": cases,
                             "ms": sec * 1e3, "cells": cells, "gcups": cells / sec / 1e9,
                             **use, "equal_to_plain": bool(torch.equal(got, want))})
    return rows


def fastest(rows) -> dict:
    """{"f32 64": [lanes, rows], ...}: the fastest shape of each type and edge."""
    return fastest_of(rows, lambda r: f"{r['dtype']} {r['edge']}",
                      lambda r: [r["lanes"], r["rows"]])


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--dtypes", default="f32,f64",
                    type=lambda s: tuple(v for v in s.split(",") if v))
    ap.add_argument("--edges", default=",".join(map(str, PHMM_EDGES)),
                    type=lambda s: tuple(int(v) for v in s.split(",") if v))
    args = ap.parse_args(argv)
    if not set(args.dtypes) <= set(DTYPES):
        ap.error(f"--dtypes: {sorted(DTYPES)}")
    if not set(args.edges) <= set(PHMM_EDGES):
        ap.error(f"--edges: {PHMM_EDGES}")
    return args


def main(argv=None):
    args = parse_args(argv)
    rows = run(args.cases, args.reps, args.seed, args.dtypes, args.edges)
    for row in rows:
        print(json.dumps(row))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    ok = all(r["equal_to_plain"] for r in rows)
    print(json.dumps({"fastest": fastest(rows), "all_equal_to_plain": ok,
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
