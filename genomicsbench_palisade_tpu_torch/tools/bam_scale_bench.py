"""Indexed-BAM rehearsal: a region query must cost the region, not the file.

    python -m genomicsbench_palisade_tpu_torch.tools.bam_scale_bench
        [--workdir DIR] [--records 8000000] [--read-len 300]
        [--ref-len 60000000] [--queries 20] [--region-bp 100000]
        [--whole-contig-pileup] [--out FILE]

Counterpart of tools/bam_scale_bench.py, on the port's `io.bam` and
`ops.pileup`.  The reference's pileup and dbg iterate htslib region
queries over prom-scale BAMs (benchmarks/pileup/medaka_counts.c:330-340
`chr20:1-64444167` on a multi-GB BAM; debruijn.cpp:1492-1499).  This writes
the JAX tool's coordinate-sorted BAM (default_rng(3), one contig, one M a
read; byte for byte) in streaming BGZF blocks, builds its `.bai` with
`io.bam.build_bai`, and measures:
  * region query latency and records/s of `read_bam_region` (BGZF streamed
    from the index's lower bound; the native decode),
  * the peak RSS growth over the queries (region-sized, not file-sized),
  * a pileup count over one region (`calculate_pileup`, the medaka case),
  * with `--whole-contig-pileup`, the fused native region pileup over the
    whole contig in 100 kb chunks.
The BAM and its index are kept in `--workdir` when one is given (and
reused), else written to a temporary directory that is removed.  Prints
one JSON line (two with `--whole-contig-pileup`, the second appended to
`--out` only when that is given).  Host work only: no `--device`.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import resource
import struct
import sys
import time

import numpy as np

from ..io.bam import bgzf_compress, build_bai, read_bai, read_bam_region
from ..ops.pileup import calculate_pileup, calculate_pileup_region
from . import append_entry, work_dir

CONTIG = "chr20"


def synth_bam(path: pathlib.Path, n_records: int, read_len: int, ref_len: int, seed: int = 3):
    """Coordinate-sorted synthetic BAM written in streaming BGZF chunks
    (records packed directly: millions of BamRecord objects would be
    RAM-heavy).  Returns the sorted positions."""
    rng = np.random.default_rng(seed)
    name = CONTIG.encode() + b"\x00"
    header = (b"BAM\x01" + struct.pack("<i", 0) + struct.pack("<i", 1)
              + struct.pack("<i", len(name)) + name + struct.pack("<i", ref_len))
    cigar = struct.pack("<I", (read_len << 4) | 0)  # <len>M
    n_half = (read_len + 1) // 2
    chunk = 200_000
    positions = np.sort(rng.integers(0, ref_len - read_len, n_records))
    with open(path, "wb") as f:
        f.write(bgzf_compress(header))
        for s in range(0, n_records, chunk):
            m = min(chunk, n_records - s)
            seqs = rng.integers(1, 16, (m, n_half * 2)).astype(np.uint8)
            packed = (seqs[:, 0::2] << 4) | seqs[:, 1::2]
            quals = rng.integers(10, 40, (m, read_len)).astype(np.uint8)
            body = bytearray()
            for i in range(m):
                qname = b"r%d\x00" % (s + i)
                rec = struct.pack("<iiBBHHHiiii", 0, int(positions[s + i]), len(qname),
                                  60, 0, 1, 0, read_len, -1, -1, 0)
                rec += qname + cigar + packed[i].tobytes() + quals[i].tobytes()
                body += struct.pack("<i", len(rec)) + rec
            f.write(bgzf_compress(bytes(body)))
    return positions


def rehearse(wd: pathlib.Path, args) -> dict:
    bam = wd / f"scale_{args.records}.bam"
    if not bam.exists():
        t0 = time.perf_counter()
        synth_bam(bam, args.records, args.read_len, args.ref_len)
        print(f"[synth] {bam.stat().st_size / 1e9:.2f} GB BAM in "
              f"{time.perf_counter() - t0:.0f} s", file=sys.stderr)
    bai = bam.with_suffix(".bam.bai")
    if not bai.exists():
        t0 = time.perf_counter()
        build_bai(str(bam), str(bai))
        print(f"[bai] built in {time.perf_counter() - t0:.0f} s", file=sys.stderr)

    rng = np.random.default_rng(11)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    # warm one query (page cache + code paths)
    read_bam_region(str(bam), CONTIG, 0, args.region_bp, bai_path=str(bai))
    t0 = time.perf_counter()
    n_recs = 0
    for _ in range(args.queries):
        beg = int(rng.integers(0, args.ref_len - args.region_bp))
        _, recs = read_bam_region(str(bam), CONTIG, beg, beg + args.region_bp,
                                  bai_path=str(bai))
        n_recs += len(recs)
    q_dt = (time.perf_counter() - t0) / args.queries
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

    beg = args.ref_len // 2
    _, recs = read_bam_region(str(bam), CONTIG, beg, beg + args.region_bp, bai_path=str(bai))
    t0 = time.perf_counter()
    out = calculate_pileup(recs, 0, beg, beg + args.region_bp)
    p_dt = time.perf_counter() - t0

    print(json.dumps({
        "tool": "bam_scale_bench",
        "bam_gb": round(bam.stat().st_size / 1e9, 2),
        "records": args.records,
        "region_bp": args.region_bp,
        "s_per_query": round(q_dt, 4),
        "records_per_query": n_recs // args.queries,
        "query_records_per_s": round(n_recs / (q_dt * args.queries), 1),
        "rss_growth_mb": round((rss1 - rss0) / 1024, 1),
        "pileup_cols": int(out["n_cols"]),
        "pileup_s": round(p_dt, 3),
    }), flush=True)

    if not args.whole_contig_pileup:
        return None
    index = read_bai(str(bai))
    t0 = time.perf_counter()
    cols = 0
    for cs in range(0, args.ref_len, 100_000):
        ce = min(cs + 100_000, args.ref_len)
        cols += calculate_pileup_region(str(bam), CONTIG, cs, ce, index=index)["n_cols"]
    wc_s = time.perf_counter() - t0
    rss2 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    entry = {
        "tool": "bam_scale_whole_contig_pileup",
        "engine": "fused native region path",
        "region": f"{CONTIG}:1-{args.ref_len}",
        "chunks": args.ref_len // 100_000,
        "kernel_s": round(wc_s, 1),
        "records": args.records,
        "records_per_s": round(args.records / wc_s, 1),
        "pileup_cols": int(cols),
        "peak_rss_mb": round(rss2 / 1024, 1),
    }
    print(json.dumps(entry))
    return entry


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bam_scale_bench")
    ap.add_argument("--workdir", default=None,
                    help="keep (and reuse) the BAM and its .bai here (default: a temporary "
                         "directory, removed)")
    ap.add_argument("--records", type=int, default=8_000_000)
    ap.add_argument("--read-len", type=int, default=300)
    ap.add_argument("--ref-len", type=int, default=60_000_000)
    ap.add_argument("--queries", type=int, default=20)
    ap.add_argument("--region-bp", type=int, default=100_000)
    ap.add_argument("--whole-contig-pileup", action="store_true",
                    help="also run the fused native region pileup over the WHOLE contig in "
                         "100 kb chunks (the medaka chr20:1-64444167 use case)")
    ap.add_argument("--out", default=None,
                    help="append the whole-contig line to this file's list")
    args = ap.parse_args(argv)

    with work_dir(args.workdir) as wd:
        entry = rehearse(wd, args)
    if entry is not None and args.out:
        append_entry(args.out, entry)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
