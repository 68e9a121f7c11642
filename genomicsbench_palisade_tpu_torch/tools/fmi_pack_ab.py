"""A/B of the host fmi engine's occ layouts at genome scale.

    python -m genomicsbench_palisade_tpu_torch.tools.fmi_pack_ab
        [--workdir DIR] [--reads 4096] [--read-len 151] [--min-seed-len 19]
        [--threads 1] [--repeats 2] [--sweep 4,8,16]

Counterpart of tools/fmi_pack_ab.py.  Host work only: no `--device`, and
nothing runs on a card.  Loads the index that `tools/genome_scale_fmi.py`
(the JAX tool or the port's) cached in `--workdir` (`big_index.npz`, with
its `big_ref.fa`) once, samples that tool's reads, then times the native
3-phase search (`io.native.fmi_search_native`) in each occ layout on the
same reads:
  v1        the 64-byte CP_OCC rows (the reference's own shape,
            tools/bwa-mem2/src/FMI_search.h:59-63; pack_mode 64)
  v2        the 32-byte bit-plane rows with superblock counts (pack_mode 32)
  v2+huge   v2 copied onto transparent huge pages (GT_FMI_HUGE=1)
and then v2+huge at each `--sweep` interleave width (GT_FMI_WIDTH).
Prints one JSON line a mode, with the JAX tool's keys; every mode's dump
must be v1's (`dump_parity`), and the tool returns 1 if one is not.  The
environment variables it sets are restored at the end; the engine writes
its packed rows beside the index.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from ..index import fmi_index as FI
from ..io.native import fmi_search_native
from .genome_scale_fmi import smem_key_set, synth_reads

MODES = (("v1", 64, "0"), ("v2", 32, "0"), ("v2+huge", 32, "1"))


def best_run(didx, enc, rl, args, pack_mode: int) -> tuple:
    """(the least seconds of `--repeats` searches of all reads, the last
    search's dump and totals)."""
    best = float("inf")
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        res = fmi_search_native(didx, enc, rl, min_seed_len=args.min_seed_len,
                                threads=args.threads, pack_mode=pack_mode)
        best = min(best, time.perf_counter() - t0)
    return best, res


def ab(didx, enc, rl, args) -> bool:
    """Print the modes' lines and the sweep's; whether every dump was v1's."""
    golden, same = None, True
    for mode, pack_mode, huge in MODES:
        os.environ["GT_FMI_HUGE"] = huge
        # drop the previous mode's huge-page copy, so the modes do not stack
        didx.__dict__.pop("_host_pack32_huge", None)
        t0 = time.perf_counter()
        fmi_search_native(didx, enc[:32], rl[:32], min_seed_len=args.min_seed_len,
                          threads=args.threads, pack_mode=pack_mode)
        warm_s = time.perf_counter() - t0
        best, (m, n1, n2, n3) = best_run(didx, enc, rl, args, pack_mode)
        key = smem_key_set(m)
        golden = key if golden is None else golden
        same &= key == golden
        print(json.dumps({
            "mode": mode, "reads": args.reads, "threads": args.threads,
            "warm_s": round(warm_s, 1), "best_s": round(best, 3),
            "reads_per_s": round(args.reads / best, 1), "total_smems": int(n1 + n2 + n3),
            "dump_parity": key == golden,
        }), flush=True)

    os.environ["GT_FMI_HUGE"] = "1"
    for width in [int(v) for v in args.sweep.split(",") if v]:
        os.environ["GT_FMI_WIDTH"] = str(width)
        best, (m, *_totals) = best_run(didx, enc, rl, args, 32)
        key = smem_key_set(m)
        same &= key == golden
        print(json.dumps({
            "mode": f"v2+huge w={width}", "best_s": round(best, 3),
            "reads_per_s": round(args.reads / best, 1), "dump_parity": key == golden,
        }), flush=True)
    return same


def main(argv=None):
    ap = argparse.ArgumentParser(prog="fmi_pack_ab")
    ap.add_argument("--workdir", default="/tmp/g3200",
                    help="the directory that holds big_index.npz and big_ref.fa")
    ap.add_argument("--reads", type=int, default=4096)
    ap.add_argument("--read-len", type=int, default=151)
    ap.add_argument("--min-seed-len", type=int, default=19)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--sweep", default="",
                    help="comma-separated interleave widths to sweep on v2+huge after the "
                         "three-mode A/B (GT_FMI_WIDTH)")
    args = ap.parse_args(argv)

    wd = Path(args.workdir)
    t0 = time.perf_counter()
    didx = FI.load_npz(str(wd / "big_index.npz"))
    print(f"[load] {time.perf_counter() - t0:.0f} s (text {int(didx.ref_seq_len):,})",
          file=sys.stderr)
    enc = synth_reads(wd / "big_ref.fa", args.reads, args.read_len)
    rl = np.full(args.reads, args.read_len, np.int32)

    saved = {k: os.environ.get(k) for k in ("GT_FMI_HUGE", "GT_FMI_WIDTH")}
    try:
        same = ab(didx, enc, rl, args)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
