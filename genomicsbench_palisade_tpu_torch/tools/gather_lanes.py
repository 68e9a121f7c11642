"""Occ-gather depth sweep: the rows in flight of `occ_gather_row` and the
tiles in flight of `occ_gather_tile`, on the card.

    python -m genomicsbench_palisade_tpu_torch.tools.gather_lanes [--indices 16777216]
        [--reps 5] [--seed 0] [--big-rows 40000000]

csrc/occ_gather.cu takes each launch's depth (DEPTH rows in flight a quad
of lanes, or tiles a warp) from compile-time constants that the wrapper
passes from its table (ops/occ_gather.LAYOUTS).  This tool builds the
source once for each depth of DEPTHS (every launch at that depth; one nvcc
a build, all at once) and runs each build on two tables of random 64-byte
rows: occ-gather-4m (the probe tool's, 4,000,000 rows, 256 MB, rng seed 3)
and occ-gather-40m (`--big-rows` rows, 2.56 GB at 40,000,000, made on the
card from `--seed`), with `--indices` random indices into each (from
`--seed`).  Each output is held to the plain version, and each launch timed
as the best of `--reps` means of 8 calls in a row after `tools.warm_up`
(CUDA events; a single call would also time the host's launch gap).  It
prints one JSON line a kernel, depth and table (with ptxas's registers and
spills of its instance), then a last line with the fastest depth of each
kernel and table.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import occ_gather as G
from . import build_all, occ_gather_experiment, ptxas_usage, time_calls
from . import fastest as fastest_of

ITERS = 8  # calls in a row a timing
DEPTHS = (1, 2, 4, 8, 16)


def tables(big_rows, n_idx, seed, dev):
    """{name: (table, idx)} on `dev`: occ-gather-4m and occ-gather-40m."""
    table_np, _ = occ_gather_experiment.make_workload()
    g = torch.Generator(device=dev).manual_seed(seed)
    big = torch.randint(-(1 << 62), 1 << 62, (big_rows, 8), generator=g, device=dev,
                        dtype=torch.int64)
    out = {}
    for name, table in (("occ-gather-4m", torch.from_numpy(table_np).to(dev)),
                        ("occ-gather-40m", big)):
        idx = torch.randint(0, table.shape[0], (n_idx,), generator=g, device=dev,
                            dtype=torch.int32)
        out[name] = (table, idx)
    return out


def kernel_tag(kernel: str, depth: int) -> str:
    """The mangled name's kernel and template argument of a depth's instance."""
    return f"occ_gather_{kernel}_kernelILi{depth}E"


def run(n_idx=1 << 24, reps=5, seed=0, big_rows=40_000_000) -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("gather_lanes measures the kernels on a CUDA card")
    dev = torch.device("cuda")
    kerns = [(G.OccGatherRowKernel(dict.fromkeys(G.LAYOUTS, d)),
              G.OccGatherTileKernel(dict.fromkeys(G.LAYOUTS, d))) for d in DEPTHS]
    libs = build_all(k for k, _ in kerns)
    out = []
    for name, (table, idx) in tables(big_rows, n_idx, seed, dev).items():
        want_row = G.occ_gather_row_plain(table, idx)
        want_tile = G.occ_gather_tile_plain(table, idx)
        for d, (row_k, tile_k), lib in zip(DEPTHS, kerns, libs):
            usage = ptxas_usage(lib.with_suffix(".log").read_text())
            for kernel, fn, want in (("row", lambda: row_k(table, idx, 8), want_row),
                                     ("tile", lambda: tile_k(table, idx), want_tile)):
                sec, got = time_calls(fn, dev, ITERS, reps)
                tag = kernel_tag(kernel, d)
                out.append({"table": name, "kernel": kernel, "depth": d, "indices": n_idx,
                            "ms": sec * 1e3, "equal_to_plain": bool(torch.equal(got, want)),
                            "ptxas": next((u for k, u in usage.items() if tag in k), {})})
        del table, idx
        torch.cuda.empty_cache()
    return out


def fastest(rows) -> dict:
    """{"<table>/<kernel>": {"depth", "ms"}} of the fastest depth of each."""
    return fastest_of(rows, lambda r: f"{r['table']}/{r['kernel']}",
                      lambda r: {"depth": r["depth"], "ms": r["ms"]})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--indices", type=int, default=1 << 24)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--big-rows", type=int, default=40_000_000)
    args = ap.parse_args(argv)
    rows = run(args.indices, args.reps, args.seed, args.big_rows)
    for row in rows:
        print(json.dumps(row), flush=True)
    ok = all(r["equal_to_plain"] for r in rows)
    print(json.dumps({"fastest": fastest(rows), "all_equal_to_plain": ok,
                      "device": torch.cuda.get_device_name(0)}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
