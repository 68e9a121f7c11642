"""pileup driver: `python -m genomicsbench_palisade_tpu_torch.cli.pileup <bam> <region> [threads] [dtypes...]`.

Mirrors genomicsbench_palisade_tpu/cli/pileup.py, the reference driver
benchmarks/pileup/medaka_counts.c:498-560: splits the region into 100 kb
chunks, computes the medaka counts matrix a chunk (num_homop=5) and prints
each chunk's matrix in print_pileup_data format.  The same arguments
(`dtypes`, `--num-homop`, `--weibull`); no `--device`: the counting is
host work (numpy and native/pileup_events.cpp).

With a `.bai` and a bounded region, each chunk is its own index query
(medaka_counts.c:330-340 inside the :545-555 chunk loop); then, without
--weibull or dtypes, a chunk runs the fused native path
(`ops.pileup.calculate_pileup_region`: decode, events, layout and
histogram in C).  `chunks` yields each chunk's result; `main` prints them.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time

from ..io.bam import read_bai, read_bam, read_bam_region
from ..ops.pileup import calculate_pileup, calculate_pileup_region, print_pileup

CHUNK_LEN = 100000


class MissingContig(LookupError):
    """The region's contig is not in the BAM's header."""


def parse_region(region: str):
    m = re.match(r"^(.+?)(?::(\d+)-(\d+))?$", region)
    chrom = m.group(1)
    start = int(m.group(2)) - 1 if m.group(2) else 0
    end = int(m.group(3)) if m.group(3) else None
    return chrom, start, end


def chunks(bam: str, region: str, num_homop: int = 5, weibull: bool = False, dtypes=None,
           stats=None):
    """Yields (cs, ce, result) a chunk; raises MissingContig when the
    region's contig is not in the BAM.  `stats` gets fused (bool) and, summed over
    the chunks, fetch_s (decode outside the fused path) and count_s."""
    chrom, start, end = parse_region(region)
    fetch_chunk = None
    if end is not None and os.path.exists(bam + ".bai"):
        bai = read_bai(bam + ".bai")
        refs, _ = read_bam_region(bam, chrom, 0, 0, index=bai)

        def fetch_chunk(cs, ce):
            return read_bam_region(bam, chrom, cs, ce, parse_tags=weibull, index=bai)[1]
    else:
        refs, records = read_bam(bam, parse_tags=weibull)
    names = [n for n, _l in refs]
    if chrom not in names:
        raise MissingContig(chrom)
    chrom_id = names.index(chrom)
    if end is None:
        end = refs[chrom_id][1]
    fused = fetch_chunk is not None and not weibull and not dtypes
    st = {"fused": fused, "fetch_s": 0.0, "count_s": 0.0}
    for cs in range(start, end, CHUNK_LEN):
        ce = min(cs + CHUNK_LEN, end)
        # the reference driver formats each chunk as "chr:<cs>-<ce>" with
        # 0-based cs and calculate_pileup RE-parses it as 1-based
        # (medaka_counts.c:545-555 vs :313-318), shifting every chunk's
        # start down one position: mirror that quirk exactly
        cs = max(cs - 1, 0)
        t0 = time.perf_counter()
        if fused:
            res = calculate_pileup_region(bam, chrom, cs, ce, index=bai, num_homop=num_homop,
                                          refs=refs)
            t1 = t0
        else:
            chunk_records = fetch_chunk(cs, ce) if fetch_chunk else records
            t1 = time.perf_counter()
            res = calculate_pileup(chunk_records, chrom_id, cs, ce, num_homop=num_homop,
                                   weibull_summation=weibull, dtypes=dtypes or None)
        st["fetch_s"] += t1 - t0
        st["count_s"] += time.perf_counter() - t1
        if stats is not None:
            stats.update(st)
        yield cs, ce, res


def main(argv=None, stats=None):
    ap = argparse.ArgumentParser(prog="pileup")
    ap.add_argument("bam")
    ap.add_argument("region")
    ap.add_argument("threads", type=int, nargs="?", default=1, help="ignored")
    ap.add_argument("dtypes", nargs="*", default=None,
                    help="read-name prefixes for multi-datatype counting "
                         "(medaka num_dtypes > 1)")
    ap.add_argument("--num-homop", type=int, default=5)
    ap.add_argument("--weibull", action="store_true",
                    help="homopolymer partial counts from WL/WK tags "
                         "(calculate_pileup's weibull_summation)")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    try:
        for _cs, _ce, res in chunks(args.bam, args.region, args.num_homop, args.weibull,
                                    args.dtypes, stats):
            print_pileup(res, num_homop=args.num_homop)
    except MissingContig as e:
        print(f"Reference {e.args[0]} not in BAM", file=sys.stderr)
        return 1
    print(f"Kernel time: {time.perf_counter() - t0:.3f} sec", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
