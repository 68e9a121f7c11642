"""abea driver, read-coordinate mode: `python -m
genomicsbench_palisade_tpu_torch.cli.abea --reads <fasta> --raw
<signals.npz|.fast5> --model <pore_model.tsv>`.

Mirrors the read mode of genomicsbench_palisade_tpu/cli/abea.py, the f5c
eventalign pipeline the reference benchmarks (benchmarks/abea/src/main.c:70
meth_main -> align.c): per read, detect events in the raw signal (events.c
getevents), estimate shift and scale by the method of moments
(align.c:49-95), run the adaptive banded event alignment, and write the
eventalign TSV in read coordinates, then `[eventalign] N reads, M aligned
event-kmer pairs` and "Kernel time" on stderr.  Same flags, same bytes,
plus `--device`; runs on one device, CUDA unless `--device cpu`.

Reads go in f5c's batches (`batches`): a batch ends once it holds -K reads
or its bases reach -B.  Each batch goes through `prepare_reads` (events and
scalings of its reads: ops.events) and `run_reads` (one batch alignment:
ops.abea, one fill and one walk launch); `emit_read` writes a read's rows.  The
eventalign mode (-b/-g: BAM-driven realignment to the reference) is not
ported yet (ROADMAP queue 1); those flags stop with an error.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from dataclasses import dataclass

import numpy as np

from .. import default_device
from ..io.fastq import read_sequences
from ..io.signal import load_pore_model, load_signals_fast5, load_signals_npz
from ..ops import abea as A
from ..ops.events import detect_events_batch, estimate_scalings_mom_batch
from ..ops.oracle.abea import KMER_SIZE

HEADER = ("contig\tposition\treference_kmer\tevent_index\tevent_level_mean\tevent_stdv\t"
          "event_length\tmodel_kmer\tmodel_mean\tmodel_stdv\tstandardized_level\n")


@dataclass
class PreparedReads:
    """The reads that have a signal (`n_reads`), and of those the ones
    long enough to align: names, sequences, events, shifts and scales."""

    n_reads: int
    names: list
    seqs: list
    events: list
    shifts: list
    scales: list


def parse_bases(text) -> int:
    """f5c's -B value: a number with an optional K, M or G (10^3, 10^6, 10^9)."""
    mult = {"K": 1e3, "M": 1e6, "G": 1e9}.get(str(text)[-1:].upper())
    return int(float(text[:-1] if mult else text) * (mult or 1))


def batches(records, max_reads: int, max_bases: int):
    """The records in f5c's batches, in order: a batch ends once it holds
    `max_reads` records or its sequences reach `max_bases` bases."""
    batch, bases = [], 0
    for rec in records:
        batch.append(rec)
        bases += len(rec[1])
        if len(batch) >= max_reads or bases >= max_bases:
            yield batch
            batch, bases = [], 0
    if batch:
        yield batch


def prepare_reads(records, signals, model, stats: dict | None = None) -> PreparedReads:
    """Events and method-of-moments scalings of every (name, seq, qual)
    record that has a signal, in record order; a record without one gets a
    warning on stderr.  `stats`, when given, accumulates "events_s" and
    "mom_s" (wall seconds)."""
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    names, seqs, raws = [], [], []
    for name, seq, _q in records:
        if name not in signals:
            print(f"WARNING: no raw signal for read {name}, skipped", file=sys.stderr)
            continue
        names.append(name)
        seqs.append(seq)
        raws.append(signals[name])
    events = detect_events_batch(raws)
    t1 = time.perf_counter()
    keep = [i for i, (seq, ev) in enumerate(zip(seqs, events))
            if len(ev) >= 2 and len(seq) >= KMER_SIZE + 1]
    shifts, scales = estimate_scalings_mom_batch([seqs[i] for i in keep], model,
                                                 [events[i] for i in keep])
    t2 = time.perf_counter()
    stats["events_s"] = stats.get("events_s", 0.0) + t1 - t0
    stats["mom_s"] = stats.get("mom_s", 0.0) + t2 - t1
    return PreparedReads(len(names), [names[i] for i in keep], [seqs[i] for i in keep],
                         [events[i] for i in keep], [float(v) for v in shifts],
                         [float(v) for v in scales])


def run_reads(prep: PreparedReads, model, device=None, stats: dict | None = None,
              keep: dict | None = None) -> list:
    """Each prepared read's alignment (ops.abea.align_events_batch)."""
    return A.align_events_batch(prep.seqs, [e["mean"] for e in prep.events], model,
                                prep.scales, prep.shifts, device=device, stats=stats, keep=keep)


def emit_read(name, seq, events, shift, scale, pairs, model, out) -> int:
    """Write one read's TSV rows (the JAX CLI's bytes); returns the rows."""
    if not pairs:
        return 0
    p = np.asarray(pairs, np.int64)
    ki, ei = p[:, 0], p[:, 1]
    ranks = A.kmer_ranks(seq, KMER_SIZE, len(seq) - KMER_SIZE + 1)[ki]
    ev = events[ei]
    lm = model["level_mean"][ranks]
    ls = model["level_stdv"][ranks]
    std_level = (ev["mean"] - shift - scale * lm) / (scale * ls)
    kmers = [seq[k : k + KMER_SIZE] for k in ki.tolist()]
    out.write("".join(
        f"{name}\t{k}\t{km}\t{e}\t{m:.2f}\t{s:.3f}\t{ln:.0f}\t{km}\t{a:.2f}\t{b:.2f}\t{z:.2f}\n"
        for k, km, e, m, s, ln, a, b, z in zip(
            ki.tolist(), kmers, ei.tolist(), ev["mean"].tolist(), ev["stdv"].tolist(),
            ev["length"].tolist(), lm.tolist(), ls.tolist(), std_level.tolist())))
    return len(p)


def emit(prep: PreparedReads, results, model, out) -> int:
    """Every read's rows; returns the aligned event-k-mer pairs."""
    return sum(emit_read(name, seq, ev, shift, scale, pairs, model, out)
               for name, seq, ev, shift, scale, pairs in zip(
                   prep.names, prep.seqs, prep.events, prep.shifts, prep.scales, results))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="abea")
    ap.add_argument("--reads", "-r", required=True, help="FASTA/FASTQ of read sequences")
    ap.add_argument("--raw", required=True,
                    help=".npz (name->signal pA) or .fast5 raw signals")
    ap.add_argument("--model", required=True, help="pore model TSV (nanopolish format)")
    ap.add_argument("-b", "--bam", default=None,
                    help="alignments: the eventalign mode, not ported yet")
    ap.add_argument("-g", "--genome", default=None,
                    help="reference FASTA: the eventalign mode, not ported yet")
    ap.add_argument("-B", "--max-bases", default="2.0M",
                    help="max bases of a batch, FLOAT[K/M/G] (f5c's -B)")
    ap.add_argument("-K", "--batchsize", type=int, default=512,
                    help="max reads of a batch (f5c's -K)")
    ap.add_argument("-w", "--window", default=None, help="eventalign mode only")
    ap.add_argument("--min-mapq", type=int, default=20)
    ap.add_argument("--secondary", choices=("yes", "no"), default="no")
    ap.add_argument("--sample-rate", type=float, default=4000.0)
    ap.add_argument("--summary", default=None, help="eventalign mode only")
    ap.add_argument("--print-read-names", action="store_true")
    ap.add_argument("--scale-events", action="store_true")
    ap.add_argument("-o", "--output", default="-")
    ap.add_argument("-t", "--threads", type=int, default=1, help="ignored (device-parallel)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs "
                         "the plain PyTorch version)")
    args = ap.parse_args(argv)
    if args.bam is not None or args.genome is not None:
        ap.error("the eventalign mode (-b/-g) is not ported yet (ROADMAP queue 1); "
                 "this driver runs the read-coordinate mode (--reads --raw --model)")

    try:
        max_bases = parse_bases(args.max_bases)
    except ValueError:
        max_bases = 0
    if max_bases < 1 or args.batchsize < 1:
        ap.error("-K and -B must be positive")

    device = default_device(args.device)
    model = load_pore_model(args.model)
    signals = (load_signals_fast5(args.raw) if args.raw.endswith(".fast5")
               else load_signals_npz(args.raw))
    with (contextlib.nullcontext(sys.stdout) if args.output == "-"
          else open(args.output, "w")) as out:
        out.write(HEADER)
        t0 = time.perf_counter()
        n_reads = n_aligned = 0
        for records in batches(read_sequences(args.reads), args.batchsize, max_bases):
            prep = prepare_reads(records, signals, model)
            n_aligned += emit(prep, run_reads(prep, model, device), model, out)
            n_reads += prep.n_reads
        runtime = time.perf_counter() - t0
    print(f"[eventalign] {n_reads} reads, {n_aligned} aligned event-kmer pairs",
          file=sys.stderr)
    print(f"Kernel time: {runtime:.3f} sec", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
