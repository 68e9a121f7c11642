"""bsw lane-group sweep: `bsw_extend` with 8, 16 or 32 lanes a pair, per query edge.

    python -m genomicsbench_palisade_tpu_torch.tools.bsw_lanes [--pairs 16384]
        [--reps 5] [--seed 1]

csrc/bsw_extend.cu gives each query edge of cli/bsw.py (32-512) a group of
BSW_LANES_<edge> lanes a pair, a compile-time constant that the wrapper
passes from its table (ops/bsw_cuda.LANES).  This tool builds
the source once for each candidate group of an edge (-DBSW_LANES_<edge>=L,
with K = edge / L entries a lane from 1 to 16), runs each build on
`--pairs` pairs of that edge's bucket, holds every output to the plain
version, and times the launch (best of `--reps` single calls after
`tools.warm_up`, CUDA events).  The pairs are tools/bench_all.py's kind,
drawn from rng `--seed`: random targets of edge+1 to 2*edge bases (at most
512), each query the target's head of edge/2+1 to edge bases with 8%
substituted, h0 20-59.  It prints one JSON line a build and a last line
with the fastest group of each edge.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..cli.bsw import EDGES
from ..convert import bsw_batch_from_numpy
from ..ops import bsw as W
from ..ops import bsw_cuda
from . import build_all, fastest, time_calls

LANES = (8, 16, 32)
MAX_K = 16  # entries a lane: each is three registers (code, H, E) and two temporaries


def candidates(edges=EDGES):
    """(edge, lanes) for every group that leaves 1 to MAX_K entries a lane."""
    return [(e, lanes) for e in edges for lanes in LANES if 1 <= e // lanes <= MAX_K]


def make_pairs(rng, n, edge):
    """`n` pairs of the bucket whose query edge is `edge`."""
    pairs = []
    t_hi = min(2 * edge, max(EDGES))
    for _ in range(n):
        tl = int(rng.integers(edge + 1, t_hi + 1)) if t_hi > edge else edge
        ql = int(rng.integers(edge // 2 + 1, edge + 1))
        t = rng.integers(0, 4, tl).astype(np.int8)
        q = t[:ql].copy()
        mut = rng.random(ql) < 0.08
        q[mut] = rng.integers(0, 4, int(mut.sum()))
        pairs.append((q, t, int(rng.integers(20, 60))))
    return pairs


def run(pairs=16384, reps=5, seed=1) -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("bsw_lanes measures the kernel on a CUDA card")
    dev = torch.device("cuda")
    cands = candidates()
    kernels = {c: bsw_cuda.BswExtendKernel(defines=((f"BSW_LANES_{c[0]}", c[1]),)) for c in cands}
    build_all(kernels.values())
    rng = np.random.default_rng(seed)
    rows = []
    for edge in EDGES:
        batch, params = bsw_batch_from_numpy(W.prepare_pairs(make_pairs(rng, pairs, edge)), dev)
        st: dict = {}
        want = W.bsw_extend_plain(batch, params, stats=st)
        for (e, lanes), kern in kernels.items():
            if e != edge:
                continue
            ms, got = time_calls(lambda: kern(batch, params, q_max=edge), dev, 1, reps)
            rows.append({"edge": edge, "lanes": lanes, "k": edge // lanes, "pairs": pairs,
                         "ms": ms * 1e3, "band_cells": st["cells"],
                         "ns_per_band_cell": ms * 1e9 / st["cells"],
                         "equal_to_plain": bool(torch.equal(got, want))})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    rows = run(args.pairs, args.reps, args.seed)
    for row in rows:
        print(json.dumps(row))
    print(json.dumps({"fastest_lanes": fastest(rows, lambda r: r["edge"], lambda r: r["lanes"]),
                      "all_equal_to_plain": all(r["equal_to_plain"] for r in rows),
                      "device": torch.cuda.get_device_name(0)}))
    return 0 if all(r["equal_to_plain"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
