"""fmi driver: `python -m genomicsbench_palisade_tpu_torch.cli.fmi <index> <reads> [batch] [minSeed] [threads]`.

Mirrors genomicsbench_palisade_tpu/cli/fmi.py, the reference driver
benchmarks/fmi/fmi.cpp:57-434: loads the FM index, reads all queries,
2-bit-encodes them, runs the 3-phase SMEM pipeline per batch, prints
per-batch num_smem1/2/3 and the global totalSmems (the parity metric),
optionally the PRINT_OUTPUT interval dump.  Same arguments and lines, plus
`--device`; the device engine runs on one device, CUDA unless `--device
cpu`.

Index argument: a `.npz` (the framework's format, either package's), a
`.bwt.2bit.64` file (bwa-mem2 binary index), or a FASTA to build from.

`prepare` loads and encodes; `run` is the timed search, one
`ops.fmi_pipeline.fmi_pipeline_batch` a batch.  `--engine tpu` (alias
`device`) is that pipeline; `--engine host` is native/fmsearch.cpp on the
host's cores (`run_host`, through `io.native.fmi_search_native`), with the
JAX CLI's order and lines: one warm call of one read builds the packed
occ rows outside the timer, one num_smem line for the whole search.
`auto` is the device pipeline: the JAX CLI's `auto` picks the host engine
whenever its native library is built, and the port always builds its own,
so copying that rule would take the device search off the fmi path.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass

import numpy as np

from .. import default_device
from ..convert import fmi_index_from_numpy
from ..index import fmi_index as FI
from ..io.fastq import encode_reads, read_all
from ..io.native import fmi_search_native
from ..ops import fmi_pipeline as FP


def load_index(path: str) -> FI.DeviceFmIndex:
    if path.endswith(".npz"):
        return FI.load_npz(path)
    if path.endswith(".bwt.2bit.64"):
        return FI.load_bwt2bit64(path)
    seq = "".join(s for _n, s, _q in read_all(path))
    return FI.build_from_sequence(seq.upper().replace("N", "A"))


def shard_work_imbalance(work_per_item, n_shards: int) -> float:
    """The reference's maxTicks/avgTicks load imbalance (fmi.cpp:362-370),
    statically sharded: item work is assigned round-robin to shards;
    returns max/avg shard work (genomicsbench_palisade_tpu/parallel/mesh.py
    :83-92)."""
    work = np.asarray(work_per_item, np.float64)
    shard_tot = np.zeros(n_shards)
    for i, w in enumerate(work):
        shard_tot[i % n_shards] += w
    avg = shard_tot.mean()
    return float(shard_tot.max() / avg) if avg > 0 else 1.0


@dataclass
class Prepared:
    """The index's tensors on the device and the encoded reads: enc int8
    [reads, longest] (4 past a read's end), rl int32 [reads]."""

    index: dict
    enc: np.ndarray
    rl: np.ndarray


def prepare(index, reads_path: str, device=None, limit: int | None = None,
            stats=None) -> Prepared:
    """Load (the index, a path or a built DeviceFmIndex, goes to `device`,
    CUDA by default; the reads are parsed) and encode (A0 C1 G2 T3, others
    4).  `stats` gets load_s and encode_s."""
    device = default_device(device)
    t0 = time.perf_counter()
    didx = load_index(index) if isinstance(index, str) else index
    tindex = fmi_index_from_numpy(didx, device)
    seqs = [s for _n, s, _q in read_all(reads_path, limit=limit)]
    t1 = time.perf_counter()
    enc, rl = encode_reads(seqs)
    if stats is not None:
        stats["load_s"] = t1 - t0
        stats["encode_s"] = time.perf_counter() - t1
    return Prepared(tindex, enc, rl)


def run(index, enc, rl, batch: int, min_seed_len: int, stats=None):
    """The search: every batch of `batch` reads through the pipeline on the
    index's device.  Returns a list of (sorted smem dict, n1, n2, n3,
    overflow) a batch, rids global."""
    return [FP.fmi_pipeline_batch(index, enc[s : s + batch], rl[s : s + batch],
                                  min_seed_len=min_seed_len, rid_base=s, stats=stats)
            for s in range(0, len(rl), batch)]


def run_host(didx: FI.DeviceFmIndex, enc, rl, min_seed_len: int, threads: int | None = None):
    """The host engine over every read: (smem dict sorted like a device
    batch's, rids global, n1, n2, n3)."""
    allm, n1, n2, n3 = fmi_search_native(didx, enc, rl, min_seed_len=min_seed_len,
                                         threads=threads)
    order = np.lexsort((-allm["n"], allm["m"], allm["rid"]))
    return {k: v[order] for k, v in allm.items()}, n1, n2, n3


def print_output(results, out=None):
    """The PRINT_OUTPUT dump: `rid:` for each read, then its `[m,n+1]`."""
    out = out or sys.stdout
    prev_rid = -1
    for allm, *_ in results:
        for rid, m, n in zip(allm["rid"], allm["m"], allm["n"]):
            if rid != prev_rid:
                for j in range(prev_rid + 1, rid + 1):
                    print(f"{j}:", file=out)
            prev_rid = int(rid)
            print(f"[{m},{n + 1}]", file=out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="fmi")
    ap.add_argument("index")
    ap.add_argument("reads")
    ap.add_argument("batch_size", type=int, nargs="?", default=512)
    ap.add_argument("min_seed_len", type=int, nargs="?", default=19)
    ap.add_argument("threads", type=int, nargs="?", default=1,
                    help="the host engine's threads past 1 (default: every core); "
                         "the device engine ignores it")
    ap.add_argument("--print-output", action="store_true")
    ap.add_argument("--limit", type=int, default=None, help="max reads")
    ap.add_argument("--repeat", type=int, default=1,
                    help="re-run the timed search N times in-process and print each Consumed")
    ap.add_argument("--engine", choices=("auto", "host", "tpu", "device"), default="auto",
                    help="host = native C++ search on the host's cores; tpu (alias "
                         "device) = the 3-phase pipeline on the device (auto picks it)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs "
                         "the plain PyTorch version)")
    args = ap.parse_args(argv)
    if args.batch_size < 1:
        ap.error("batch_size must be positive")
    if args.engine == "host":
        return main_host(args)

    device = default_device(args.device)
    prep = prepare(args.index, args.reads, device, limit=args.limit)
    print(f"numReads = {len(prep.rl)}, max_readlength = {int(prep.rl.max())}, "
          f"min_readlength = {int(prep.rl.min())}")

    dts = []
    for _rep in range(max(args.repeat, 1)):
        t0 = time.perf_counter()
        results = run(prep.index, prep.enc, prep.rl, args.batch_size, args.min_seed_len)
        dts.append(time.perf_counter() - t0)
    batch_totals = []
    for bi, (_allm, n1, n2, n3, ovf) in enumerate(results):
        if ovf:
            print(f"WARNING: match-buffer overflow in batch {bi}", file=sys.stderr)
        print(f"num_smem1: {n1}, num_smem2: {n2}, num_smem3: {n3}")
        batch_totals.append(n1 + n2 + n3)
    if len(dts) > 1:
        print("repeat Consumed: " + ", ".join(f"{d:.4f}" for d in dts) + " sec")
    report(batch_totals, min(dts))
    if args.print_output:
        print_output(results)
    return 0


def report(batch_totals, consumed_s: float):
    """The reference driver's metric lines (fmi.cpp:351-381).  One device
    (or the host) runs every batch: one shard."""
    print(f"load imbalance = {shard_work_imbalance(batch_totals, 1):f}")
    print(f"Consumed: {consumed_s:.4f} sec")
    for bi, bt in enumerate(batch_totals):
        print(f"batch_id: {bi}, numTotalSmem[batch_id]: {bt}")
    print(f"totalSmems = {sum(batch_totals)}")


def main_host(args):
    """`--engine host`: the JAX CLI's host branch (its cli/fmi.py:115-160).
    The encode and the warm call of one read (which builds or loads the
    packed occ rows) precede the timer, as the reference's encode and
    load_index precede its batch loop (fmi.cpp:141-177, 241-253)."""
    didx = load_index(args.index)
    enc, rl = encode_reads([s for _n, s, _q in read_all(args.reads, limit=args.limit)])
    print(f"numReads = {len(rl)}, max_readlength = {int(rl.max())}, "
          f"min_readlength = {int(rl.min())}")
    threads = args.threads if args.threads > 1 else None
    fmi_search_native(didx, enc[:1], rl[:1], min_seed_len=args.min_seed_len)
    dts = []
    for _rep in range(max(args.repeat, 1)):
        t0 = time.perf_counter()
        allm, n1, n2, n3 = run_host(didx, enc, rl, args.min_seed_len, threads)
        dts.append(time.perf_counter() - t0)
    print(f"num_smem1: {n1}, num_smem2: {n2}, num_smem3: {n3}")
    if len(dts) > 1:
        print("repeat Consumed: " + ", ".join(f"{d:.4f}" for d in dts) + " sec")
    per_read = np.bincount(allm["rid"], minlength=len(rl))
    report([int(per_read[s : s + args.batch_size].sum())
            for s in range(0, len(rl), args.batch_size)], min(dts))
    if args.print_output:
        print_output([(allm,)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
