"""The one-line benchmark contract: PairHMM GCUPS on one card, then the suite.

    python -m genomicsbench_palisade_tpu_torch.tools.bench [--device cpu]

Counterpart of bench.py at the repository's root.  Builds the native host
library first (`utils.native_build`), so the host engines' numbers are
always there, then measures the flagship first: the f32 PairHMM kernel
(`csrc/phmm_forward.cu`) on 8192 testcases of 250 x 302 (reads noisy
substrings of their haps; default_rng(0)) at r_pad 256 / h_pad 320, best
of 3 means of 20 calls in a row (synchronised around each), and its
companion `h512_gcups`, 4096 x (250 x 473) at h_pad 512, best of 2.  Then
`tools.bench_all`'s nine other benches (bsw, chain, kmer, fmi, grm, poa,
abea, pileup, dbg), one JSON line each, and as the last line the flagship
record: GCUPS, `vs_baseline`, `h512_gcups`, the f32 pass's fallback
fraction and every bench's numbers under `per_kernel`.

The JAX tool's baseline (5.8 GCUPS, bench.py:37) is a TPU figure;
BASELINE_GCUPS stays None until a card figure is recorded as the
baseline, so `vs_baseline` is 1.0.  The JAX tool's relay watchdog has no
counterpart.  A bench that raises prints the JAX error line (an `error:`
string in `h512_gcups`); the tool then returns 1 (the JAX tool returns 0).
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from .. import default_device
from ..ops import phmm as P
from ..utils import native_build
from . import bench_all as BA

BASELINE_GCUPS = None  # no card run is recorded as the baseline yet
FLAGSHIP = (8192, 250, 302, 256, 320)  # testcases, read, hap, r_pad, h_pad
H512 = (4096, 250, 473, 256, 512)
SECONDARY = (BA.bench_bsw, BA.bench_chain, BA.bench_kmer, BA.bench_fmi, BA.bench_grm,
             BA.bench_poa, BA.bench_abea, BA.bench_pileup, BA.bench_dbg)


def phmm_cases(rng, b, rl, hl):
    """b testcases: a random hap of hl bases, the read its substring of rl
    bases at a random start with 5% substitutions (the likelihoods of real
    data), quals 36-59 (reads, haps, pairs)."""
    reads, haps, pairs = [], [], []
    for i in range(b):
        hap = rng.integers(0, 4, hl)
        start = rng.integers(0, hl - rl)
        read = hap[start : start + rl].copy()
        noise = rng.random(rl) < 0.05
        read[noise] = rng.integers(0, 4, int(noise.sum()))
        reads.append({"bases": read, "q": rng.integers(36, 60, rl),
                      "i": rng.integers(36, 60, rl), "d": rng.integers(36, 60, rl),
                      "c": rng.integers(36, 60, rl)})
        haps.append(hap)
        pairs.append((i, i))
    return reads, haps, pairs


def measure_phmm(tb, b, rl, hl, device, iters=20, repeats=3) -> tuple:
    """(GCUPS of the f32 kernel: the best over `repeats` of the mean of
    `iters` calls in a row, one output fetched; the f32 pass's fallback
    fraction)."""
    fallback_frac = float(P.phmm_forward(tb)[2].mean())  # warm, and the flags
    best = math.inf
    for _ in range(repeats):
        BA.sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = P.forward_raw(tb, torch.float32)
        out[:1].cpu()
        BA.sync(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return b * rl * hl / best / 1e9, fallback_frac


def phmm_batch(rng, shape, device):
    b, rl, hl, r_pad, h_pad = shape
    batch = P.prepare_batch(*phmm_cases(rng, b, rl, hl), r_pad=r_pad, h_pad=h_pad)
    return P.as_device_batch(batch, device)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions; hours at these shapes)")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    native_build.load()

    rng = np.random.default_rng(0)
    b, rl, hl = FLAGSHIP[:3]
    gcups, fb_frac = measure_phmm(phmm_batch(rng, FLAGSHIP, device), b, rl, hl, device)
    ok = True
    try:
        b2, rl2, hl2 = H512[:3]
        g2, _ = measure_phmm(phmm_batch(rng, H512, device), b2, rl2, hl2, device, repeats=2)
        h512 = round(g2, 3)
    except Exception as e:  # keep the suite going
        h512, ok = f"error: {e!r}"[:120], False

    lines, ran = BA.run_benches(BA.on_device(SECONDARY, device))
    per_kernel = {r["kernel"]: {k: v for k, v in r.items() if k != "kernel"}
                  for r in lines if "value" in r}
    vs = 1.0 if BASELINE_GCUPS is None else gcups / BASELINE_GCUPS
    print(json.dumps({
        "metric": "phmm_forward_gcups_1chip",
        "value": round(gcups, 3),
        "unit": "GCUPS",
        "vs_baseline": round(vs, 3),
        "h512_gcups": h512,
        "f64_fallback_frac": round(fb_frac, 5),
        "per_kernel": per_kernel,
    }), flush=True)
    return 0 if ok and ran else 1


if __name__ == "__main__":
    raise SystemExit(main())
