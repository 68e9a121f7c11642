"""dbg driver: `python -m genomicsbench_palisade_tpu_torch.cli.dbg <bam> <region> <ref.fa> [threads]`.

Mirrors genomicsbench_palisade_tpu/cli/dbg.py, the reference driver
benchmarks/dbg/debruijn.cpp:1438-1630: reads the region's alignments,
slides 1500bp assembly windows (shift 750), builds the colored de Bruijn
graph a window (k=15, minQual=20) and prints the same three lines.  The
same arguments; no `--device`: the assembly is host work
(native/dbg.cpp through `io.native.dbg_window_native`, whose contract is
`ops.dbg.assemble_window`).

`region_reads` loads, `assemble` runs the windows (`engine="python"`
runs `ops.dbg.assemble_window` instead of the native engine).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..io.bam import SEQ_NT16_STR, read_bam, read_bam_region
from ..io.fastq import read_all
from ..io.native import dbg_window_native
from ..ops.dbg import assemble_window, window_batches

KMER_SIZE, MIN_QUAL, MIN_READS = 15, 20, 2


def parse_region(region: str, ref_len: int):
    """`chrom[:beg-end]` (1-based, inclusive) -> (chrom, beg0, end)."""
    chrom, _, rng = region.partition(":")
    if rng:
        beg, end = (int(v) for v in rng.split("-"))
        return chrom, beg - 1, end
    return chrom, 0, ref_len


def region_reads(bam: str, chrom: str, beg: int, end: int):
    """(pos, ref_end, seq, quals, flag) of the records on `chrom`, through
    the `.bai` when there is one."""
    if os.path.exists(bam + ".bai"):
        refs, records = read_bam_region(bam, chrom, beg, end)
    else:
        refs, records = read_bam(bam)
    rid = [n for n, _l in refs].index(chrom)
    lut = np.frombuffer(SEQ_NT16_STR.encode(), dtype=np.uint8)
    reads = []
    for rec in records:
        if rec.ref_id != rid:
            continue
        seq = lut[rec.seq_nt16].tobytes().decode()
        span = sum(ln for op, ln in rec.cigar if op in "MDN=X")
        reads.append((rec.pos, rec.pos + span, seq, rec.qual, rec.flag))
    return reads


class WindowReads:
    """A window's overlapping reads.  Reads are coordinate-sorted (BAM), so
    a window's overlap set lives in pos range [assem_start - max_span,
    assem_end): searchsorted keeps the loop O(reads a window) instead of
    rescanning every region read a 1.5 kb window (the reference's
    debruijn.cpp:1492-1516 gets this from its per-window htslib
    iterators).  An unsorted BAM falls back to a full scan."""

    def __init__(self, reads):
        self.reads = reads
        self.pos = np.array([r[0] for r in reads], np.int64)
        self.rend = np.array([r[1] for r in reads], np.int64)
        self.sorted = bool(np.all(self.pos[1:] >= self.pos[:-1]))
        self.max_span = int((self.rend - self.pos).max()) if len(reads) else 0

    def __call__(self, assem_start: int, assem_end: int):
        if not self.sorted:
            return [(s, q, f) for p, re_, s, q, f in self.reads
                    if p < assem_end and re_ > assem_start]
        lo = int(np.searchsorted(self.pos, assem_start - self.max_span))
        hi = int(np.searchsorted(self.pos, assem_end))
        return [(self.reads[i][2], self.reads[i][3], self.reads[i][4])
                for i in range(lo, hi) if self.rend[i] > assem_start]


def assemble(ref: str, reads, beg: int, end: int, engine: str = "native",
             max_windows: int | None = None, stats=None):
    """Every window of [beg, end): (windows, total graph nodes, total read
    bubbles).  `stats` gets select_s and assemble_s."""
    select = WindowReads(reads)
    n_windows = total_nodes = total_bubbles = 0
    select_s = assemble_s = 0.0
    for assem_start, assem_end, ref_start, ref_end in window_batches(beg, end)[:max_windows]:
        t0 = time.perf_counter()
        window_reads = select(assem_start, assem_end)
        t1 = time.perf_counter()
        if engine == "native":
            n_nodes, bubbles = dbg_window_native(ref[ref_start:ref_end], ref_start,
                                                 window_reads, KMER_SIZE, MIN_QUAL, MIN_READS)
        elif engine == "python":
            g, bubbles = assemble_window(ref[ref_start:ref_end], ref_start, window_reads,
                                         KMER_SIZE, MIN_QUAL, MIN_READS)
            n_nodes = len(g.nodes)
        else:
            raise ValueError(f"unknown dbg engine {engine!r}")
        select_s += t1 - t0
        assemble_s += time.perf_counter() - t1
        n_windows += 1
        total_nodes += n_nodes
        total_bubbles += len(bubbles)
    if stats is not None:
        stats.update(select_s=select_s, assemble_s=assemble_s)
    return n_windows, total_nodes, total_bubbles


def main(argv=None, stats=None):
    """The driver; `stats` (a dict) gets load_s (the FASTA and the BAM),
    select_s, assemble_s and windows."""
    ap = argparse.ArgumentParser(prog="dbg")
    ap.add_argument("bam")
    ap.add_argument("region")
    ap.add_argument("ref_fasta")
    ap.add_argument("threads", type=int, nargs="?", default=1, help="ignored")
    args = ap.parse_args(argv)

    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    chrom = args.region.partition(":")[0]
    ref = {name: seq for name, seq, _q in read_all(args.ref_fasta)}[chrom].upper()
    chrom, beg, end = parse_region(args.region, len(ref))
    reads = region_reads(args.bam, chrom, beg, end)

    t1 = time.perf_counter()
    n_windows, total_nodes, total_bubbles = assemble(ref, reads, beg, end, stats=stats)
    dt = time.perf_counter() - t1
    stats.update(load_s=t1 - t0, windows=n_windows)
    print(f"Found {n_windows} batches.")
    print(f"total graph nodes: {total_nodes}, read bubbles: {total_bubbles}")
    print(f"Time in kernel: {dt:.2f} sec", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
