"""The abea CLI: `python -m genomicsbench_palisade_tpu_torch.cli.abea --reads
<fasta> --raw <signals.npz|.fast5> --model <pore_model.tsv>`, or f5c's
eventalign surface `-b <reads.bam> -g <genome.fa> -r <reads.fastq> --raw
<signals.npz> --model <pore_model.tsv> [-w ctg[:beg-end]] [--summary
<file>]` (scripts/run-gpu.sh:32 `f5c eventalign -b ... -g ... -r ... -B
3.7M`).

Mirrors genomicsbench_palisade_tpu/cli/abea.py, the f5c eventalign
pipeline the reference benchmarks (benchmarks/abea/src/main.c:70 meth_main
-> align.c): per read, detect events in the raw signal (events.c
getevents), estimate shift and scale by the method of moments
(align.c:49-95) and run the adaptive banded event alignment.  Same flags,
same bytes, plus `--device`; runs on one device, CUDA unless `--device
cpu`.

Reads go in f5c's batches (`batches`): a batch ends once it holds -K reads
or its bases reach -B.  Without -b the reads come from --reads: each batch
goes through `prepare_reads` (events and scalings: ops.events) and
`run_reads` (one batch alignment: ops.abea, one fill and one walk launch),
and `emit_read` writes a read's rows in read coordinates, then
`[eventalign] N reads, M aligned event-kmer pairs` and "Kernel time" on
stderr.  With -b/-g the records of the BAM (`load_bam`; -w reads the
region through `<bam>.bai` when there is one) take a read index each and
pass f5c's filters (`bam_entries`); each batch then goes through
`eventalign_batch`: events, scalings, `run_reads`, then
`ops.eventalign`'s postalign with the WLS recalibration and QC gates, the
reference-space profile-HMM realign (on the device) and the f5c TSV and
--summary lines, then the entry counts, the TSV rows and "Kernel time" on
stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

from .. import default_device
from ..io import bam as B
from ..io.fastq import read_sequences
from ..io.signal import load_pore_model, load_signals_fast5, load_signals_npz
from ..ops import abea as A
from ..ops import eventalign as EA
from ..ops.events import detect_events_batch, estimate_scalings_mom_batch
from ..ops.oracle.abea import KMER_SIZE

HEADER = ("contig\tposition\treference_kmer\tevent_index\tevent_level_mean\tevent_stdv\t"
          "event_length\tmodel_kmer\tmodel_mean\tmodel_stdv\tstandardized_level\n")
COUNTS = ("total", "qc_fail", "no_calib", "no_aln", "bad_sig")


def eventalign_header(print_read_names=False) -> str:
    """The eventalign mode's TSV header (emit_tsv_header)."""
    return ("contig\tposition\treference_kmer\t"
            + ("read_name" if print_read_names else "read_index")
            + "\tstrand\tevent_index\tevent_level_mean\tevent_stdv\tevent_length\t"
            "model_kmer\tmodel_mean\tmodel_stdv\tstandardized_level\n")


@dataclass
class EventalignOptions:
    """The eventalign mode's output options; region_start/region_end are
    -w's 0-based bounds (both -1 without a span), which clip the realign."""

    region_start: int = -1
    region_end: int = -1
    sample_rate: float = 4000.0
    print_read_names: bool = False
    scale_events: bool = False
    summary: bool = False


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


def load_bam(path, window=None):
    """(reference names, records, region_start, region_end) of the BAM, as
    the JAX CLI reads them: with -w `ctg[:beg-end]` the records overlapping
    the region, through `<path>.bai` when it exists (0-based begin; the
    1-based end stays as given and clips inclusively, like f5c's)."""
    region_start = region_end = -1
    if not window:
        refs, records = B.read_bam(path, parse_tags=True)
        return [r[0] for r in refs], records, region_start, region_end
    ctg, _, span = window.partition(":")
    if span:
        beg, _, end = span.partition("-")
        region_start = int(beg) - 1
        region_end = int(end) if end else (1 << 62)
    lo, hi = max(region_start, 0), region_end if region_end != -1 else (1 << 62)
    if os.path.exists(path + ".bai"):
        refs, records = B.read_bam_region(path, ctg, lo, hi, parse_tags=True)
        return [r[0] for r in refs], records, region_start, region_end
    refs, records = B.read_bam(path, parse_tags=True)
    ref_names = [r[0] for r in refs]
    rid = ref_names.index(ctg)
    records = [r for r in records if r.ref_id == rid and (region_end == -1 or r.pos < hi)
               and r.pos + B._cigar_ref_len(r.cigar) > lo]
    return ref_names, records, region_start, region_end


def bam_entries(records, reads, signals, counts: dict, min_mapq=20, secondary=False):
    """The records f5c aligns, in order, as (name, sequence, read index,
    record, signal): every record takes a read index; unmapped, MAPQ below
    `min_mapq` and (unless `secondary`) secondary records are skipped
    (f5c.c:713); the rest count in `counts["total"]`, and those without a
    read or a signal in `counts["bad_sig"]`."""
    for read_idx, rec in enumerate(records):
        if rec.flag & B.FUNMAP or rec.mapq < min_mapq:
            continue
        if rec.flag & B.FSECONDARY and not secondary:
            continue
        counts["total"] += 1
        seq, sig = reads.get(rec.name), signals.get(rec.name)
        if seq is None or sig is None:
            counts["bad_sig"] += 1
            continue
        yield rec.name, seq, read_idx, rec, sig


def eventalign_batch(entries, contigs, model, opts: EventalignOptions, counts: dict,
                     device=None, stats: dict | None = None, keep: dict | None = None):
    """One batch of bam_entries through the eventalign mode: (TSV text,
    --summary text, TSV rows).  `contigs[ref_id]` is a reference's (name,
    sequence or None).  Events and scalings on the host, the abea kernels
    (`run_reads`), `ops.eventalign.scaling_batch` (QC), the realign on
    `device`, the emit.  `counts` takes the QC outcomes ("no_aln",
    "no_calib", "qc_fail").  `stats`, when given, accumulates wall seconds
    "events_s", "mom_s", "abea_s", "scaling_s", "realign_s" and "emit_s",
    the events detected ("events"), and the counters of run_reads and
    realign_batch under "abea" and "realign".  `keep`, when given, gets
    "scaling": per entry with enough events its (read index, status,
    scalings, events_per_base), "prep" and "pairs": those entries'
    PreparedReads and abea pairs (scaling_batch's inputs), and "realign"
    and "alignments": the RealignReads of the reads that passed QC and
    their Alignments."""
    stats = {} if stats is None else stats
    for k in ("events_s", "mom_s", "abea_s", "scaling_s", "realign_s", "emit_s"):
        stats.setdefault(k, 0.0)
    t0 = time.perf_counter()
    events = detect_events_batch([e[4] for e in entries])
    stats["events"] = stats.get("events", 0) + sum(len(ev) for ev in events)
    t1 = time.perf_counter()
    work = [(e, ev) for e, ev in zip(entries, events)
            if len(ev) >= 2 and len(e[1]) >= KMER_SIZE + 1]
    counts["no_aln"] += len(entries) - len(work)
    shifts, scales = estimate_scalings_mom_batch([e[1] for e, _ in work], model,
                                                 [ev for _, ev in work])
    t2 = time.perf_counter()
    prep = PreparedReads(len(work), [e[0] for e, _ in work], [e[1] for e, _ in work],
                         [ev for _, ev in work], [float(v) for v in shifts],
                         [float(v) for v in scales])
    pairs = run_reads(prep, model, device, stats=stats.setdefault("abea", {})) if work else []
    t3 = time.perf_counter()
    todo, scaled = [], []
    for ((_, seq, read_idx, rec, _), ev), (status, sc, b2e, epb) in zip(
            work, EA.scaling_batch(prep.seqs, prep.events, pairs, model)):
        scaled.append((read_idx, status, sc, epb))
        if status & EA.FAILED_ALIGNMENT:
            counts["no_aln"] += 1
        elif status & EA.FAILED_CALIBRATION:
            counts["no_calib"] += 1
        elif status & EA.FAILED_QUALITY_CHK:
            counts["qc_fail"] += 1
        else:
            contig, genome = contigs[rec.ref_id]
            if genome is None:
                raise KeyError(f"reference {contig} is not in the genome FASTA")
            segment = genome[rec.pos : rec.pos + B._cigar_ref_len(rec.cigar)]
            todo.append((read_idx, contig, EA.RealignRead(rec, segment, len(seq), ev, sc, b2e,
                                                          epb)))
    t4 = time.perf_counter()
    alns = EA.realign_batch([t[2] for t in todo], model, device, opts.region_start,
                            opts.region_end, stats=stats.setdefault("realign", {}))
    t5 = time.perf_counter()
    tsv, summary, n_rows = [], [], 0
    for (read_idx, contig, rr), aln in zip(todo, alns):
        rec, sc = rr.record, rr.sc
        tsv.append(EA.emit_tsv(aln, rr.events, model, sc, read_idx, rec.name, contig,
                               opts.sample_rate, opts.print_read_names, opts.scale_events))
        n_rows += len(aln.ref_pos)
        if opts.summary and len(aln.ref_pos):
            s = EA.summarize(aln, rr.events, model, sc, nm=rec.tags.get("NM", 0))
            summary.append(
                f"{read_idx}\t{rec.name}\t.\tdna\ttemplate\t{s['num_events']}\t"
                f"{s['num_steps']}\t{s['num_skips']}\t{s['num_stays']}\t"
                f"{s['sum_duration'] / opts.sample_rate:.2f}\t{float(sc['shift']):.3f}\t"
                f"{float(sc['scale']):.3f}\t0.000\t{float(sc['var']):.3f}\n")
    t6 = time.perf_counter()
    if keep is not None:
        keep.update(scaling=scaled, prep=prep, pairs=pairs, realign=[t[2] for t in todo],
                    alignments=alns)
    for k, dt in (("events_s", t1 - t0), ("mom_s", t2 - t1), ("abea_s", t3 - t2),
                  ("scaling_s", t4 - t3), ("realign_s", t5 - t4), ("emit_s", t6 - t5)):
        stats[k] += dt
    return "".join(tsv), "".join(summary), n_rows


def eventalign_bam(args, model, signals, out, device, max_bases: int) -> int:
    """The eventalign mode (-b/-g): the TSV on `out`, --summary's file, and
    the entry counts, the rows and "Kernel time" on stderr."""
    genome = {name: seq.upper() for name, seq, _q in read_sequences(args.genome)}
    reads = {name: seq for name, seq, _q in read_sequences(args.reads)}
    ref_names, records, region_start, region_end = load_bam(args.bam, args.window)
    contigs = [(name, genome.get(name)) for name in ref_names]
    opts = EventalignOptions(region_start, region_end, args.sample_rate,
                             args.print_read_names, args.scale_events, args.summary is not None)
    out.write(eventalign_header(args.print_read_names))
    t0 = time.perf_counter()
    counts = dict.fromkeys(COUNTS, 0)
    n_rows = 0
    with (open(args.summary, "w") if args.summary else contextlib.nullcontext()) as summary:
        entries = bam_entries(records, reads, signals, counts, args.min_mapq,
                              args.secondary == "yes")
        for batch in batches(entries, args.batchsize, max_bases):
            text, summ, n = eventalign_batch(batch, contigs, model, opts, counts, device)
            out.write(text)
            if summary is not None:
                summary.write(summ)
            n_rows += n
    runtime = time.perf_counter() - t0
    print(f"[eventalign] total entries: {counts['total']}, qc fail: {counts['qc_fail']}, "
          f"could not calibrate: {counts['no_calib']}, no alignment: {counts['no_aln']}, "
          f"bad fast5: {counts['bad_sig']}", file=sys.stderr)
    print(f"[eventalign] {n_rows} TSV rows", file=sys.stderr)
    print(f"Kernel time: {runtime:.3f} sec", file=sys.stderr)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="abea")
    ap.add_argument("--reads", "-r", required=True, help="FASTA/FASTQ of read sequences")
    ap.add_argument("--raw", required=True,
                    help=".npz (name->signal pA) or .fast5 raw signals")
    ap.add_argument("--model", required=True, help="pore model TSV (nanopolish format)")
    ap.add_argument("-b", "--bam", default=None,
                    help="alignments; enables the eventalign mode")
    ap.add_argument("-g", "--genome", default=None,
                    help="reference FASTA (the eventalign mode)")
    ap.add_argument("-B", "--max-bases", default="2.0M",
                    help="max bases of a batch, FLOAT[K/M/G] (f5c's -B)")
    ap.add_argument("-K", "--batchsize", type=int, default=512,
                    help="max reads of a batch (f5c's -K)")
    ap.add_argument("-w", "--window", default=None,
                    help="limit to region ctg[:start-end] (f5c -w; uses the .bai index "
                         "when present; the eventalign mode)")
    ap.add_argument("--min-mapq", type=int, default=20)
    ap.add_argument("--secondary", choices=("yes", "no"), default="no",
                    help="process secondary alignments (f5c --secondary)")
    ap.add_argument("--sample-rate", type=float, default=4000.0)
    ap.add_argument("--summary", default=None,
                    help="per-read summary TSV (the eventalign mode)")
    ap.add_argument("--print-read-names", action="store_true")
    ap.add_argument("--scale-events", action="store_true")
    ap.add_argument("-o", "--output", default="-")
    ap.add_argument("-t", "--threads", type=int, default=1, help="ignored (device-parallel)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs "
                         "the plain PyTorch version)")
    args = ap.parse_args(argv)
    if args.bam is not None and args.genome is None:
        ap.error("-b requires -g <genome.fa>")
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
    if args.bam is not None:
        with (contextlib.nullcontext(sys.stdout) if args.output == "-"
              else open(args.output, "w")) as out:
            return eventalign_bam(args, model, signals, out, device, max_bases)
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
