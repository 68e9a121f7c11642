"""Where a band of the abea fill goes: SM cycles by part, on the card.

    python -m genomicsbench_palisade_tpu_torch.tools.abea_fill_clock [--bases 13450]
        [--seed 17] [--reps 3]

Builds csrc/abea_fill.cu with -DABEA_FILL_CLOCK, which reads the SM clock
(clock64) between the parts of a band (PARTS: the move, the window's slide,
the cells, the ends' broadcasts, the new band's halos, the next band's
emissions, the trace store, the rest) and writes each part's sum over the
read's bands where the fill's first rows of bll_e would go.  Runs it on one
read of `--bases` bases (13,450 by default: abea-512's longest) made by
tools/abea_scale_bench.py's recipe (`synth_read`: 1-2 events a k-mer at a
level of N(90, 12) plus N(0, 0.4); rng `--seed`), and prints one JSON line:
the read's bands, the clock build's ms (best of `--reps`, CUDA events), SM
cycles a band by part and in all, and the card.  The counters cost a few
cycles each; the default build's time is printed beside.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..convert import abea_batch_from_numpy
from ..ops import abea as A
from ..ops import abea_cuda
from . import time_calls

PARTS = ("move", "slide", "cells", "ends", "halos", "emissions", "trace_store", "rest")
DEFINES = (("ABEA_FILL_CLOCK", 1),)


def synth_read(rng, length):
    """A random read and its event means by tools/abea_scale_bench.py's
    recipe, with that tool's model (levels N(90, 12), stdv 1-3)."""
    model = {"level_mean": rng.normal(90, 12, 4096).astype(np.float32),
             "level_stdv": (rng.random(4096) * 2 + 1).astype(np.float32)}
    model["level_log_stdv"] = np.log(model["level_stdv"]).astype(np.float32)
    codes = rng.integers(0, 4, length)
    nk = length - 5
    ranks = np.zeros(nk, np.int64)
    for j in range(6):
        ranks = (ranks << 2) | codes[j : nk + j]
    counts = rng.integers(1, 3, nk)
    means = np.repeat(model["level_mean"][ranks], counts) + rng.normal(0, 0.4, int(counts.sum()))
    return "".join("ACGT"[c] for c in codes), means.astype(np.float32), model


def run(bases=13450, seed=17, reps=3) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("abea_fill_clock measures the kernel on a CUDA card")
    dev = torch.device("cuda")
    seq, events, model = synth_read(np.random.default_rng(seed), bases)
    batch_np, _ = A.prepare_batch([seq], [events], model, [1.0], [0.0])
    batch = abea_batch_from_numpy(batch_np, dev)
    bands = int(batch_np["ne"][0]) + int(batch_np["nk"][0])
    clocked = abea_cuda.AbeaFillKernel(DEFINES)
    sec, out = time_calls(lambda: clocked(batch), dev, 1, reps)
    plain_sec, _ = time_calls(lambda: abea_cuda.abea_fill(batch), dev, 1, reps)
    cycles = out["bll_e"][: len(PARTS)].cpu().numpy().astype(np.int64) / bands
    return {"bases": bases, "bands": bands, "clock_build_ms": sec * 1e3, "ms": plain_sec * 1e3,
            "cycles_per_band": dict(zip(PARTS, cycles.tolist())),
            "cycles_per_band_total": float(cycles.sum())}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bases", type=int, default=13450)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if args.bases < 6 + len(PARTS):
        ap.error(f"--bases: at least {6 + len(PARTS)} (the counters take the first rows)")
    return args


def main(argv=None):
    args = parse_args(argv)
    row = run(args.bases, args.seed, args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({**row, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
