"""bsw roofline probe: the production bsw kernel against the recurrence alone.

    python -m genomicsbench_palisade_tpu_torch.tools.bsw_roofline [--pairs 8192]
        [--qlen 128] [--tlen 256] [--reps 4] [--chain 8] [--device cpu]

Port of tools/bsw_roofline.py:main.  The workload is the JAX tool's:
`--pairs` random targets of `--tlen` bases from rng seed 5, each query the
target's first `--qlen` bases with 8% substituted, h0 30.  Two sides, each
timed as the best of `--reps` means of `--chain` calls in a row after
`tools.warm_up`, 0.1 s of calls (CUDA events on a card):
  * prod: `ops.bsw.bsw_extend` (csrc/bsw_extend.cu) on the pairs padded to
    qlen x tlen, one launch for all of them.  It visits ksw_extend's band
    cells only, the stripped side every cell of the padded grid;
  * strip: `ops.bsw_stripped.bsw_stripped` (csrc/bsw_stripped.cu) on the
    query codes padded to qe_pad rows with code 5 and the targets, both
    [rows, pairs], from zero H and E (the Pallas probe's start under
    interpret mode's zeroed scratch).
It prints the JAX tool's keys, one JSON line, with GCUPS over qlen x tlen
cells a pair for both sides as the JAX tool counts them, and `device`.  On
the CPU (`--device cpu`) both sides run their plain versions.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import default_device
from ..convert import bsw_batch_from_numpy
from ..ops import bsw as W
from ..ops import bsw_stripped as S
from . import time_calls

SEED = 5
H0 = 30  # the third element of each JAX pair: the seed score, not a band


def make_workload(pairs=8192, qlen=128, tlen=256, seed=SEED):
    """(pairs as (query, target, h0) tuples, q_codes int32 [qe_pad, pairs],
    target int32 [tlen, pairs]): the JAX tool's draws from rng `seed`."""
    rng = np.random.default_rng(seed)
    tgt = rng.integers(0, 4, (pairs, tlen), np.int32)
    qry = tgt[:, :qlen].copy()
    mut = rng.random((pairs, qlen)) < 0.08
    qry[mut] = rng.integers(0, 4, int(mut.sum()))
    qe_pad = S.qe_pad_of(qlen)
    q_codes = np.pad(qry.T, ((0, qe_pad - qlen), (0, 0)), constant_values=S.PAD_CODE)
    return ([(qry[i], tgt[i], H0) for i in range(pairs)],
            np.ascontiguousarray(q_codes, np.int32), np.ascontiguousarray(tgt.T, np.int32))


def run(device, pairs=8192, qlen=128, tlen=256, reps=4, chain=8) -> dict:
    """Both sides on `device`; the JAX tool's keys and `device`."""
    dev = torch.device(device)
    pair_list, q_np, t_np = make_workload(pairs, qlen, tlen)
    batch, params = bsw_batch_from_numpy(W.prepare_pairs(pair_list, q_pad=qlen, t_pad=tlen), dev)
    q_codes, target = torch.from_numpy(q_np).to(dev), torch.from_numpy(t_np).to(dev)
    zeros = torch.zeros_like(q_codes)
    t_prod, _ = time_calls(lambda: W.bsw_extend(batch, params, q_max=qlen), dev, chain, reps)
    t_strip, _ = time_calls(lambda: S.bsw_stripped(q_codes, target, zeros, zeros), dev,
                            chain, reps)
    cells = float(pairs) * qlen * tlen
    return {
        "tool": "bsw_roofline", "pairs": pairs, "qlen": qlen, "tlen": tlen,
        "prod_ms": t_prod * 1e3, "strip_ms": t_strip * 1e3,
        "prod_gcups": cells / t_prod / 1e9, "strip_gcups": cells / t_strip / 1e9,
        "overhead_vs_recurrence": t_prod / t_strip,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=8192)
    ap.add_argument("--qlen", type=int, default=128)
    ap.add_argument("--tlen", type=int, default=256)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--chain", type=int, default=8, help="calls in a row per timing")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    print(json.dumps(run(dev, args.pairs, args.qlen, args.tlen, args.reps, args.chain)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
