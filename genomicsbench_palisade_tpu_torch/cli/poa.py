"""poa driver: `python -m genomicsbench_palisade_tpu_torch.cli.poa -s <fasta>
[-m 2 -x 4 -o 4,24 -e 2,1] [--oracle] [--engine auto|host|device] [--device cpu]`.

Mirrors genomicsbench_palisade_tpu/cli/poa.py, the reference driver's
contract (benchmarks/poa/msa_spoa_omp.cpp:96-500): a FASTA in which a
header whose second character is '0' starts a new batch (window), one POA
graph a window (convex NW, m=2 x=-4 o1=-4 e1=-2 o2=-24 e2=-1, handed to
the engine as oe1 = o1+e1 and oe2 = o2+e2, as the reference driver does),
each window's consensus printed.  Windows are aligned in device lockstep
(`ops.poa.msa_consensus_batch`) on one device: CUDA unless `--device cpu`.

`--engine auto` and `device` run that aligner; `--engine host` runs the
JAX package's native host engine (`ops.poa.msa_consensus_host`), with the
same consensus.  The JAX CLI's `auto` picks the host engine whenever its
native library is built, and the port always builds its own, so copying
that rule would take the device aligner off the poa path: the port's
`auto` is the device (ROADMAP queue 3).  `--oracle` runs the port's oracle
(`ops.oracle.poa.msa_consensus`) on the host.
"""

from __future__ import annotations

import argparse
import sys
import time

from .. import default_device
from ..utils.logger import get_peak_rss


def read_batches(path):
    """msa_spoa_omp.cpp readFile: '>0...' headers delimit batches."""
    batches = []
    cur = None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith(">"):
                if len(line) > 1 and line[1] == "0":
                    if cur:
                        batches.append(cur)
                    cur = []
            else:
                if cur is None:
                    cur = []
                cur.append(line)
    if cur:
        batches.append(cur)
    return batches


def main(argv=None):
    ap = argparse.ArgumentParser(prog="poa")
    ap.add_argument("-s", "--seq-file", required=True)
    ap.add_argument("-t", "--threads", type=int, default=1, help="ignored")
    ap.add_argument("-m", type=int, default=2)
    ap.add_argument("-x", type=int, default=4)
    ap.add_argument("-o", type=str, default="4,24")
    ap.add_argument("-e", type=str, default="2,1")
    ap.add_argument("--oracle", action="store_true", help="host-only path")
    ap.add_argument("--engine", choices=["auto", "host", "device"], default="auto",
                    help="auto (= device) = the lockstep aligner on the device, "
                         "host = the native engine on the host")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs the plain "
                         "PyTorch version)")
    args = ap.parse_args(argv)
    device = default_device(args.device) if args.engine != "host" else None

    o1, _, o2 = args.o.partition(",")
    e1, _, e2 = args.e.partition(",")
    o1, e1 = int(o1), int(e1)
    o2, e2 = int(o2 or 24), int(e2 or 1)
    # the reference driver hands spoa the COMBINED open+extend penalties
    # (oe1 = o1+e1, oe2 = o2+e2; msa_spoa_omp.cpp:341,309-312)
    params = (args.m, -args.x, -(o1 + e1), -e1, -(o2 + e2), -e2)

    batches = read_batches(args.seq_file)
    print(f"Number of batches: {len(batches)}")
    tm = {}
    t0 = time.perf_counter()
    if args.oracle:
        from ..ops.oracle.poa import PoaParams, msa_consensus

        p = PoaParams(*params)
        consensus = [msa_consensus(b, p) for b in batches]
    elif args.engine == "host":
        from ..ops.poa import msa_consensus_host

        consensus = msa_consensus_host(batches, params, timings=tm)
    else:
        from ..ops.poa import msa_consensus_batch

        consensus = msa_consensus_batch(batches, params, timings=tm, device=device)
    dt = time.perf_counter() - t0
    for i, cons in enumerate(consensus):
        print(f"batches[{i}].consensus_seq: {cons}")
    # the reference's stderr summary (msa_spoa_omp.cpp:504): runtime, phase
    # times, peak RSS in MB
    print(f"Runtime: {dt:.2f}, GraphCreate: 0.00, "
          f"Align: {tm.get('align', 0.0):.2f}, "
          f"AddSeqGraph: {tm.get('add', 0.0):.2f}, "
          f"Consensus {tm.get('consensus', 0.0):.2f} {dt:.2f} "
          f"{get_peak_rss() / 1024.0 / 1024.0:.3f}", file=sys.stderr)
    print(f"Runtime: {dt:.2f} sec")
    return 0


if __name__ == "__main__":
    sys.exit(main())
