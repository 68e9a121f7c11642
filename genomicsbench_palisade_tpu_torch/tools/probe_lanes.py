"""Roofline-probe layout sweep: `bsw_stripped`'s lanes a pair per qe_pad edge
and `chain_micro`'s register banks, on the card.

    python -m genomicsbench_palisade_tpu_torch.tools.probe_lanes [--pairs 8192]
        [--tlen 256] [--calls 128] [--n-pad 4096] [--reps 5] [--seed 0]

csrc/bsw_stripped.cu gives each qe_pad edge (8-520) a group of
BSW_STRIPPED_LANES_<edge> lanes a pair, and csrc/chain_micro.cu keeps
CHAIN_MICRO_BANKS banks of 32 window slots in registers (the rest of a
wider window in shared memory); both are compile-time constants that the
wrappers pass from their tables (ops/bsw_stripped.LANES,
ops/chain_micro.BANKS).  This tool builds the sources once for each
candidate (-D..., one nvcc a build, all at once), and runs each build:
  * bsw_stripped on `--pairs` pairs of `--tlen` target rows at qe_pad =
    the edge, from the seeded start of chip_smoke.py's phase 13 (H 0-60, E
    0-30), the query the target's head with 8% substituted (the probe's
    kind), every lane count L of 8, 16 or 32 that leaves 1 to MAX_K rows a
    lane and no more lanes than rows;
  * chain_micro on the chain probe's workload (`--calls` x `--n-pad`,
    tools/chain_roofline.make_workload) at windows WINDOWS, bw 500, with
    1, 2, 4 or 8 register banks.
Each build's output is held to the plain version, and its launch timed as
the best of `--reps` single calls after `tools.warm_up` (CUDA events).  It
prints one JSON line a build (with ptxas's registers and spills of the
instance it times), and a last line with the fastest choice of each edge
and window.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import bsw_stripped as S
from ..ops import chain_micro as M
from . import build_all, chain_roofline, ptxas_usage, time_calls
from . import fastest as fastest_of

LANES = (8, 16, 32)
MAX_K = 17  # rows a lane: code, H, E, (j-1)*e_ins and two temporaries each
BANKS = (1, 2, 4, 8)
WINDOWS = (64, 129, 256, 700)
BW = 500


def strip_candidates(edges=S.EDGES):
    """(edge, lanes) for every group of at most `edge` lanes that leaves 1
    to MAX_K rows a lane."""
    return [(e, lanes) for e in edges for lanes in LANES
            if lanes <= e and -(-e // lanes) <= MAX_K]


def strip_inputs(rng, qe_pad, pairs, tlen, device):
    """(q_codes, target, h, e) on `device`: queries of qe_pad - 1 bases (or
    tlen), the seeded start."""
    t = rng.integers(0, 4, (tlen, pairs))
    ql = min(qe_pad - 1, tlen)
    q = np.full((qe_pad, pairs), S.PAD_CODE)
    q[:ql] = np.where(rng.random((ql, pairs)) < 0.08, rng.integers(0, 4, (ql, pairs)), t[:ql])
    h = rng.integers(0, 61, (qe_pad, pairs))
    e = rng.integers(0, 31, (qe_pad, pairs))
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
            for a in (q, t, h, e)]


def instance_usage(lib, tag: str) -> dict:
    """ptxas's registers and spills of the build's instance whose mangled
    template arguments are `tag` (e.g. "ILi17ELi8EE": K 17, L 8)."""
    usage = ptxas_usage(lib.with_suffix(".log").read_text())
    return next((u for name, u in usage.items() if tag in name), {})


def run(pairs=8192, tlen=256, calls=128, n_pad=4096, reps=5, seed=0) -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_lanes measures the kernels on a CUDA card")
    dev = torch.device("cuda")
    strips = {c: S.BswStrippedKernel(defines=((f"BSW_STRIPPED_LANES_{c[0]}", c[1]),))
              for c in strip_candidates()}
    micros = {nb: M.ChainMicroKernel(defines=(("CHAIN_MICRO_BANKS", nb),)) for nb in BANKS}
    kernels = [*strips.values(), *micros.values()]
    libs = dict(zip(kernels, build_all(kernels)))
    rng = np.random.default_rng(seed)
    rows = []
    for edge in S.EDGES:
        args = strip_inputs(rng, edge, pairs, tlen, dev)
        want = S.bsw_stripped_plain(*args)
        for (e, lanes), kern in strips.items():
            if e != edge:
                continue
            k = -(-edge // lanes)
            ms, got = time_calls(lambda: kern(*args), dev, 1, reps)
            rows.append({"kernel": "bsw_stripped", "qe_pad": edge, "lanes": lanes, "k": k,
                         "pairs": pairs, "tlen": tlen, "ms": ms * 1e3,
                         "ns_per_cell": ms * 1e9 / (edge * tlen * pairs),
                         "padding_share": 1 - edge / (lanes * k),
                         "equal_to_plain": bool(torch.equal(got, want)),
                         "ptxas": instance_usage(libs[kern], f"ILi{k}ELi{lanes}EE")})
    wl = chain_roofline.make_workload(calls, n_pad)
    margs = [torch.from_numpy(wl[k]).to(dev) for k in ("x", "qi", "qspan", "m_fp", "gap0")]
    for w in WINDOWS:
        want = M.chain_micro_plain(*margs, w, BW)
        for nb, kern in micros.items():
            ms, got = time_calls(lambda: kern(*margs, w, BW), dev, 1, reps)
            rows.append({"kernel": "chain_micro", "w": w, "banks": nb,
                         "shared_slots": max(w - 32 * nb, 0), "calls": calls, "n_pad": n_pad,
                         "ms": ms * 1e3, "ns_per_anchor": ms * 1e6 / n_pad,
                         "equal_to_plain": bool(torch.equal(got, want)),
                         "ptxas": instance_usage(libs[kern], f"ILi{min(-(-w // 32), nb)}EE")})
    return rows


def fastest(rows) -> dict:
    """{"bsw_stripped_lanes": {qe_pad: lanes}, "chain_micro_banks": {w: banks}}"""
    return {"bsw_stripped_lanes": fastest_of([r for r in rows if r["kernel"] == "bsw_stripped"],
                                             lambda r: r["qe_pad"], lambda r: r["lanes"]),
            "chain_micro_banks": fastest_of([r for r in rows if r["kernel"] == "chain_micro"],
                                            lambda r: r["w"], lambda r: r["banks"])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=8192)
    ap.add_argument("--tlen", type=int, default=256)
    ap.add_argument("--calls", type=int, default=128)
    ap.add_argument("--n-pad", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rows = run(args.pairs, args.tlen, args.calls, args.n_pad, args.reps, args.seed)
    for row in rows:
        print(json.dumps(row), flush=True)
    ok = all(r["equal_to_plain"] for r in rows)
    print(json.dumps({**fastest(rows), "all_equal_to_plain": ok,
                      "device": torch.cuda.get_device_name(0)}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
