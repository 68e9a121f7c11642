"""kmer-cnt driver: `python -m genomicsbench_palisade_tpu_torch.cli.kmer_cnt
--reads <fasta> --config <cfg> [--threads N] [--debug] [--device cpu]`.

Mirrors genomicsbench_palisade_tpu/cli/kmer_cnt.py, the reference driver's
contract (benchmarks/kmer-cnt/kmer_cnt.cpp:143-287): Flye-style flags, the
key=value config, FASTA/FASTQ read with the max(minReadLength, minOverlap)
filter (kmer_cnt.cpp:220-231), canonical k-mer counting, and the same
lines: `readsFasta:` / `minReadLength:` / `readsFile:` / `useMinimizers:`
on stdout, the logger's DEBUG `Hash size:` / `Total k-mers` lines
(vertex_index.cpp:657-658), the minimizer lines and `Peak RAM usage`, and
`Kernel time: %.3f sec` on stderr (kmer_cnt.cpp:284).  Runs on one
device: CUDA unless `--device cpu`.

Reads come from the port's `io.fastq.read_sequences` (the JAX CLI's path
when its native parser is not built).  Above 192,000,000 bases the JAX CLI
tries its native host counter first; the port has none (ROADMAP queue 1
item 15: `count_kmers_host`, `parse_reads_native`,
`minimizer_counts_native`), so it streams the reads through
`ops.kmer.count_kmers_batched` on the device.  The minimizer index is the
oracle's deque walk on the host, as the JAX CLI's without its native
library.
"""

from __future__ import annotations

import argparse
import sys
import time

from .. import default_device
from ..config import load_flye_cfg
from ..io.fastq import read_sequences
from ..ops import kmer as K
from ..utils.logger import Logger, get_memory_size, get_peak_rss

BATCHED_BASES = 192_000_000  # read sets above this stream through the accumulator


def read_reads(paths: str, min_read_length: int) -> list:
    """The reads of the comma-separated files strictly longer than
    min_read_length, printing a `readsFile:` line a file."""
    reads = []
    for reads_file in paths.split(","):
        print(f"readsFile: {reads_file}")
        for _name, seq, _q in read_sequences(reads_file):
            if len(seq) > min_read_length:
                reads.append(seq)
    return reads


def count(reads, kmer_size: int, min_read_length: int, device=None,
          stats: dict | None = None) -> dict:
    """The driver's counter: one read matrix, or past BATCHED_BASES bases
    the streamed accumulator (`stats` goes to count_kmers_batched)."""
    if sum(len(r) for r in reads) > BATCHED_BASES:
        return K.count_kmers_batched(reads, k=kmer_size, min_read_length=min_read_length,
                                     device=device, stats=stats)
    return K.count_kmers(reads, k=kmer_size, min_read_length=min_read_length, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kmer-cnt")
    ap.add_argument("--reads", required=True, help="comma-separated FASTA/FASTQ paths")
    ap.add_argument("--config", required=True, help="Flye key=value config file")
    ap.add_argument("--threads", type=int, default=1, help="ignored (device-parallel)")
    ap.add_argument("--kmer", type=int, default=-1, help="override config kmer_size")
    ap.add_argument("--min-ovlp", type=int, default=5000, dest="min_ovlp")
    ap.add_argument("--min-read", type=int, default=0, dest="min_read")
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--log", default="", help="log file sink")
    ap.add_argument("--meta", action="store_true", help="uneven coverage mode flag")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs the plain "
                         "PyTorch version)")
    args = ap.parse_args(argv)
    device = default_device(args.device)

    log = Logger.get()
    log.set_debugging(args.debug)
    if args.log:
        log.set_output_file(args.log)
    log.debug(f"Total RAM: {get_memory_size() // 1024**3} Gb")

    cfg = load_flye_cfg(args.config)
    kmer_size = args.kmer if args.kmer != -1 else int(cfg.get("kmer_size", 17))
    log.debug(f"Running with k-mer size: {kmer_size}")
    log.debug(f"Running with minimum overlap {args.min_ovlp}")
    log.debug("Metagenome mode: " + ("Y" if args.meta else "N"))
    print(f"readsFasta: {args.reads}")

    log.info("Reading sequences")
    min_read_length = max(args.min_read, args.min_ovlp)
    print(f"minReadLength: {min_read_length}")
    reads = read_reads(args.reads, min_read_length)

    use_minimizers = bool(cfg.get("use_minimizers", False))
    print(f"useMinimizers: {int(use_minimizers)}")

    t0 = time.perf_counter()
    if use_minimizers:
        # buildIndexMinimizers (vertex_index.cpp:391-489)
        log.info("Building minimizer index")
        wnd = int(cfg.get("minimizer_window", 5))
        rate = float(cfg.get("repeat_kmer_rate", 1.0))
        r = K.build_minimizer_index(reads, k=kmer_size, window=wnd, min_coverage=1,
                                    repeat_rate=rate, min_read_length=min_read_length)
        runtime = time.perf_counter() - t0
        log.debug(f"Mean k-mer frequency: {r['mean_frequency']}")
        log.debug(f"Repetitive k-mer frequency: {r['repetitive_frequency']}")
        log.debug(f"Filtered {r['filtered']} repetitive k-mers ({r['filtered_rate']})")
        log.debug(f"Selected k-mers: {r['selected_kmers']}")
        log.debug(f"Index size: {r['index_size']}")
        log.debug(f"Mean k-mer index frequency: {r['mean_index_frequency']}")
        log.debug(f"Peak RAM usage: {get_peak_rss() // 1024**3} Gb")
        print(f"Kernel time: {runtime:.3f} sec", file=sys.stderr)
        return 0
    metrics = count(reads, kmer_size, min_read_length, device)
    runtime = time.perf_counter() - t0

    log.debug(f"Hash size: {metrics['hash_size']}")
    log.debug(f"Total k-mers {metrics['total_kmers']}")
    log.debug(f"Peak RAM usage: {get_peak_rss() // 1024**3} Gb")
    print(f"Kernel time: {runtime:.3f} sec", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
