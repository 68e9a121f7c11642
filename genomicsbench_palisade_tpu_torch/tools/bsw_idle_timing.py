"""The bsw probe's timings after the card idles while the host works.

    python -m genomicsbench_palisade_tpu_torch.tools.bsw_idle_timing [--gaps 3]
        [--gap-s 15] [--pairs 8192] [--qlen 128] [--tlen 256] [--device cpu]

Asks whether the bsw roofline probe's chained timings read slow after a
stretch in which the host is busy and the card idle (as after a long
host-bound phase), and whether the SM clock explains it.  On the probe's
workload (`tools.bsw_roofline.make_workload`) it runs, with the SM clock
and power sampled throughout (`tools.SmClock`):
  1. the probe tool once (`tools.bsw_roofline.run`);
  2. `--gaps` times: `--gap-s` seconds of host-only work (numpy sorts), then
     four 8-call means of `bsw_extend` and of `bsw_stripped` (from zero H/E),
     each after one warm-up call, except after the last gap, where each
     follows `tools.warm_up`; then five single `bsw_stripped` calls;
  3. the probe tool once more.
It prints one JSON line: each stage's times (ms, CUDA events on a card,
the host clock on the CPU) and the clock's min, median and max over the
stage.  On the CPU (`--device cpu`) the kernels' plain versions run and
the clock is not sampled.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import default_device
from ..convert import bsw_batch_from_numpy
from ..ops import bsw as W
from ..ops import bsw_stripped as S
from . import SmClock, warm_up
from . import bsw_roofline as T

CHAIN = 8  # calls a mean
REPS = 4
SINGLES = 5


def host_work(seconds) -> dict:
    """Keeps one host core busy for `seconds` with numpy sorts; the card idles."""
    x = np.random.default_rng(0).random(1 << 20)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        x = np.sort(x)[::-1].copy()
    return {"seconds": seconds}


def _span_ms(fn, dev, calls):
    """ms of `calls` calls in a row, CUDA events on a card."""
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e3


def chained_means(fn, dev, warm):
    """REPS means of CHAIN calls in a row, after one warm-up call
    (warm="one") or `tools.warm_up` (warm="fixed")."""
    if warm == "one":
        fn()
    else:
        warm_up(fn, dev)
    return [_span_ms(fn, dev, CHAIN) / CHAIN for _ in range(REPS)]


def run(device, gaps=3, gap_s=15.0, pairs=8192, qlen=128, tlen=256) -> dict:
    dev = torch.device(device)
    pair_list, q_np, t_np = T.make_workload(pairs, qlen, tlen)
    batch, params = bsw_batch_from_numpy(W.prepare_pairs(pair_list, q_pad=qlen, t_pad=tlen), dev)
    q, t = torch.from_numpy(q_np).to(dev), torch.from_numpy(t_np).to(dev)
    zeros = torch.zeros_like(q)

    def strip():
        return S.bsw_stripped(q, t, zeros, zeros)

    def prod():
        return W.bsw_extend(batch, params, q_max=qlen)

    stages = []
    with SmClock(enabled=dev.type == "cuda") as clock:

        def stage(name, fn):
            t0 = time.perf_counter()
            out = fn()
            stages.append({"stage": name, **out, "clock": clock.summary(t0, time.perf_counter())})

        stage("tool_run_1", lambda: {"tool": T.run(dev, pairs, qlen, tlen)})
        for k in range(gaps):
            stage(f"host_work_{k}", lambda: host_work(gap_s))
            warm = "fixed" if k == gaps - 1 else "one"
            stage(f"chained_{k}", lambda: {"warm": warm, "prod_ms": chained_means(prod, dev, warm),
                                           "strip_ms": chained_means(strip, dev, warm)})
            stage(f"single_{k}", lambda: {"strip_ms": [_span_ms(strip, dev, 1)
                                                       for _ in range(SINGLES)]})
        stage("tool_run_2", lambda: {"tool": T.run(dev, pairs, qlen, tlen)})
    return {"tool": "bsw_idle_timing", "pairs": pairs, "qlen": qlen, "tlen": tlen,
            "gaps": gaps, "gap_s": gap_s, "stages": stages,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gaps", type=int, default=3)
    ap.add_argument("--gap-s", type=float, default=15.0)
    ap.add_argument("--pairs", type=int, default=8192)
    ap.add_argument("--qlen", type=int, default=128)
    ap.add_argument("--tlen", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    print(json.dumps(run(dev, args.gaps, args.gap_s, args.pairs, args.qlen, args.tlen)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
