"""Chain roofline probe: the production chain kernel against the recurrence alone.

    python -m genomicsbench_palisade_tpu_torch.tools.chain_roofline [--calls 128]
        [--n-pad 4096] [--w 64] [--bw 500] [--iters 30] [--reps 3] [--device cpu]

Port of tools/chain_roofline.py:main.  The workload is the JAX tool's:
`--calls` calls of `--n-pad` anchors from rng seed 0, x and the query
positions cumulative sums of steps 1-39 and 1-29, query span 15, the Q20
gap slope 157,286 (0.01 x avg_qspan 15 = 0.15, times 2^20) and gap offset
0.  Two sides, each timed as the best of `--reps` means of
`--iters` calls in a row after `tools.warm_up` (CUDA events on a card):
  * micro: `ops.chain_micro.chain_micro` (csrc/chain_micro.cu), the
    recurrence alone over the `--w` anchors before each, with the Q20
    slope, max_dist 5000/5000 and `--bw`;
  * prod: `ops.chain.chain_dp` (csrc/chain_dp.cu, one launch) on the same
    anchors as a flat batch (x_lo = x, qi, qspan 15), each anchor's window
    starting `--w` anchors back (st_eff = max(i - w, 0)) so that it visits
    the same predecessors, with the exact float64 gap table of
    `ops.chain.prepare_call` at avg_qspan 15 instead of the slope.  It also
    keeps the reference's descending visit order, max_skip break, parents
    and peaks.
It prints the JAX tool's keys, one JSON line (`prod_over_bound` is prod
over micro), and `device`.  On the CPU (`--device cpu`) both sides run their
plain versions.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import default_device
from ..convert import chain_arrays
from ..ops import chain as C
from ..ops import chain_micro as M
from . import time_calls

SEED = 0
QSPAN = 15
M_FP = 157286  # the JAX tool's Q20 slope: 0.15 * 2^20, rounded down
MAX_DIST = M.MAX_DIST


def make_workload(calls=128, n_pad=4096, seed=SEED) -> dict:
    """The JAX tool's int32 arrays from rng `seed`: x, qi, qspan [calls,
    n_pad], m_fp, gap0 [calls]."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.integers(1, 40, (calls, n_pad)), axis=1).astype(np.int32)
    qi = np.cumsum(rng.integers(1, 30, (calls, n_pad)), axis=1).astype(np.int32)
    return {"x": x, "qi": qi, "qspan": np.full((calls, n_pad), QSPAN, np.int32),
            "m_fp": np.full(calls, M_FP, np.int32), "gap0": np.zeros(calls, np.int32)}


def prod_batch(wl: dict, w: int, bw: int, device):
    """(the flat batch of `ops.chain.chain_dp`, its params) for the
    workload's calls: each anchor's window the `w` anchors before it, the
    gap table of avg_qspan QSPAN."""
    n_pad = wl["x"].shape[1]
    st_eff = np.maximum(np.arange(n_pad) - w, 0).astype(np.int32)
    preps = []
    for x, qi in zip(wl["x"], wl["qi"]):
        y = (np.uint64(QSPAN) << np.uint64(32)) | qi.astype(np.uint32).astype(np.uint64)
        prep = C.prepare_call(x.astype(np.uint64), y, float(QSPAN), MAX_DIST, MAX_DIST, bw)
        preps.append({**prep, "st_eff": st_eff})
    arrays, params = chain_arrays(preps)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}, params


def run(device, calls=128, n_pad=4096, w=64, bw=500, iters=30, reps=3) -> dict:
    """Both sides on `device`; the JAX tool's keys and `device`."""
    dev = torch.device(device)
    wl = make_workload(calls, n_pad)
    x, qi, qspan, m_fp, gap0 = (torch.from_numpy(wl[k]).to(dev)
                                for k in ("x", "qi", "qspan", "m_fp", "gap0"))
    batch, params = prod_batch(wl, w, bw, dev)
    t_micro, _ = time_calls(lambda: M.chain_micro(x, qi, qspan, m_fp, gap0, w, bw), dev,
                            iters, reps)
    t_prod, _ = time_calls(lambda: C.chain_dp(batch, params), dev, iters, reps)
    anchors = calls * n_pad
    return {
        "shape": f"{calls}x{n_pad} w={w}", "micro_s": t_micro, "prod_s": t_prod,
        "micro_manchors_per_s": anchors / t_micro / 1e6,
        "prod_manchors_per_s": anchors / t_prod / 1e6, "prod_over_bound": t_prod / t_micro,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=128)
    ap.add_argument("--n-pad", type=int, default=4096)
    ap.add_argument("--w", type=int, default=64)
    ap.add_argument("--bw", type=int, default=500)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    print(json.dumps(run(dev, args.calls, args.n_pad, args.w, args.bw, args.iters, args.reps)),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
