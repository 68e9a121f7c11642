"""GRM block-size x precision sweep: throughput and error of each setting.

    python -m genomicsbench_palisade_tpu_torch.tools.grm_sweep [--m 32768]
        [--n 2048] [--reps 3] [--iters 5] [--out FILE] [--device cpu]

Counterpart of tools/grm_sweep.py.  Block sizes 1024-8192 x the four
precision modes of `ops.grm.grm_device` (DEFAULT: one bf16 pass,
COMPENSATED: bf16 split in three products, HIGH and HIGHEST: IEEE float32,
TF32 off) on `--m` variants x `--n` samples of the JAX tool's genotypes
(default_rng(5)).  Each setting is timed as the best over `--reps` of the
mean of `--iters` calls (`tools.time_calls`: CUDA events on a card), and
its GRM held to the float64 host product (plink2's double dsyrk,
plink2_matrix_calc.cc:3668-3704) by the largest relative error; plink2's
contract is 2e-5.  Prints one JSON line a setting, with the JAX tool's
keys; appends the sweep to `--out` only when that is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import default_device
from ..ops import grm as G
from . import append_entry, time_calls

BLOCKS = (1024, 2048, 4096, 8192)
MODES = (("DEFAULT", "DEFAULT"), ("COMPENSATED", "compensated"), ("HIGH", "HIGH"),
         ("HIGHEST", "HIGHEST"))
TOL = 2e-5


def genotypes(m: int, n: int) -> np.ndarray:
    """The JAX tool's [m, n] int8 dosages (0/1/2 at 0.5/0.3/0.15, 3 missing)."""
    rng = np.random.default_rng(5)
    return rng.choice([0, 1, 2, 3], size=(m, n), p=[0.5, 0.3, 0.15, 0.05]).astype(np.int8)


def reference(geno: np.ndarray):
    """(2f, 1/sd, ok, the float64 GRM, its scale max(|grm|, 1)) as the JAX
    tool computes them on the host."""
    miss = geno == 3
    g64 = np.where(miss, 0.0, geno.astype(np.float64))
    freqs = g64.sum(1) / np.maximum(2.0 * (~miss).sum(1), 1.0)
    var = 2.0 * freqs * (1.0 - freqs)
    ok = var > G.K_SMALL_EPSILON
    isd = np.where(ok, 1.0 / np.sqrt(np.where(ok, var, 1.0)), 0.0)
    z64 = (g64 - (2 * freqs)[:, None]) * isd[:, None]
    dead = miss | ~ok[:, None]
    z64[dead] = 0.0
    v64 = (~dead).astype(np.float64)
    grm64 = (z64.T @ z64) / np.maximum(v64.T @ v64, 1.0)
    return 2 * freqs, isd, ok, grm64, np.maximum(np.abs(grm64), 1.0)


def sweep(geno: np.ndarray, device, reps: int = 3, iters: int = 5):
    """One row a (precision, block): the JAX tool's keys."""
    m, n = geno.shape
    two_f, isd, ok, grm64, scale64 = reference(geno)
    args = (torch.from_numpy(geno).to(device),
            torch.from_numpy(two_f.astype(np.float32)).to(device),
            torch.from_numpy(isd.astype(np.float32)).to(device), torch.from_numpy(ok).to(device))
    flops = 2 * m * n * n * 2
    rows = []
    for prec_name, prec in MODES:
        for block in BLOCKS:
            best, (sums, counts) = time_calls(
                lambda: G.grm_device(*args, block=block, precision=prec), device, iters, reps)
            grm = sums.double().cpu().numpy() / np.maximum(counts.double().cpu().numpy(), 1.0)
            err = float(np.max(np.abs(grm - grm64) / scale64))
            row = {"precision": prec_name, "block": block,
                   "tflops": round(flops / best / 1e12, 2),
                   "max_rel_err": float(f"{err:.3e}"), "meets_2e5": bool(err < TOL)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="grm_sweep")
    ap.add_argument("--m", type=int, default=32768)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None, help="append the sweep to this file's list")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the products on the CPU)")
    args = ap.parse_args(argv)
    rows = sweep(genotypes(args.m, args.n), default_device(args.device), args.reps, args.iters)
    if args.out:
        append_entry(args.out, {"tool": "grm_sweep", "m": args.m, "n": args.n, "rows": rows})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
