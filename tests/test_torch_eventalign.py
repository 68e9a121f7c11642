"""The port's eventalign mode (genomicsbench_palisade_tpu_torch: ops.eventalign,
cli.abea -b/-g) against the reference-built goldens, both oracles and the
JAX CLI, on the CPU.

tests/fixtures/eventalign_golden.json comes from the reference's own
align.c/eventalign.c (tools/golden/eventalign_harness.cpp): per read the
QC status, the recalibrated scalings, the summary and the verbatim TSV
rows.  All 25 cases go through the port's production path (the CLI's
`bam_entries` and `eventalign_batch`: events, scalings, the abea plain
versions, QC, the realign wavefront, the emit) as one batch, the way the
CLI batches a BAM.  Tolerance: none; scalings are compared as f32 hex, sums
as f64 hex, rows byte for byte.  Every test pins torch to one thread,
which keeps parallel test workers from oversubscribing the cores.
"""

import contextlib
import io
import itertools
import json
import pathlib

import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu.cli import abea as jcli
from genomicsbench_palisade_tpu.ops.oracle import eventalign as JEAO
from genomicsbench_palisade_tpu_torch.cli import abea as cli
from genomicsbench_palisade_tpu_torch.io import bam as B
from genomicsbench_palisade_tpu_torch.ops import abea as A
from genomicsbench_palisade_tpu_torch.ops import eventalign as EA
from genomicsbench_palisade_tpu_torch.ops import events as EV
from genomicsbench_palisade_tpu_torch.ops.oracle import eventalign as EAO

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "eventalign_golden.json"
SAMPLE_RATE = 4000.0
ORACLE_CASES = (0, 7, 13, 19, 24)
CLI_CASES = (1, 7, 12)  # a secondary record (case 7) and a QC failure (case 12)
_NT16 = {c: i for i, c in enumerate(B.SEQ_NT16_STR)}


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cases():
    with open(FIXTURE) as f:
        return json.load(f)["cases"]


def _levels():
    """tests/test_eventalign.py's model levels, quantized to %.2f."""
    i = np.arange(4096, dtype=np.int64)
    return np.array([float(f"{x:.2f}") for x in 60.0 + 80.0 * ((i * 2654435761) % 4096) / 4096.0])


def _model():
    stdv = np.full(4096, 1.50, np.float32)
    return {"level_mean": _levels().astype(np.float32), "level_stdv": stdv,
            "level_log_stdv": np.float32(np.log(np.float64(stdv)))}


def _records(case, ref_id=0, prefix=""):
    """A case's reads as BAM records (port's BamRecord), coordinate-sorted."""
    rows = [B.BamRecord(name=prefix + rd["qname"], flag=rd["flag"], ref_id=ref_id, pos=rd["pos"],
                        mapq=rd["mapq"], cigar=[tuple(c) for c in rd["cigar"]],
                        seq_nt16=np.array([_NT16[ch] for ch in rd["query"]], np.uint8),
                        qual=np.full(len(rd["query"]), 30, np.uint8), tags={"NM": rd["nm"]})
            for rd in case["reads"]]
    return sorted(rows, key=lambda r: r.pos)


def _signal(rd):
    return np.array([float(x) for x in rd["signal"]], np.float32)


def _f32(h):
    return np.float32(float.fromhex(h))


@pytest.fixture(scope="module")
def golden_run():
    """All 25 cases as one batch through bam_entries + eventalign_batch;
    per case its entries' read indices, and what eventalign_batch kept."""
    torch.set_num_threads(1)
    cases, model = _cases(), _model()
    counts = dict.fromkeys(cli.COUNTS, 0)
    entries, contigs, per_case = [], [], []
    for ci, case in enumerate(cases):
        reads = {rd["qname"]: rd["fastq"] for rd in case["reads"]}
        signals = {rd["qname"]: _signal(rd) for rd in case["reads"]}
        ents = list(cli.bam_entries(_records(case, ci), reads, signals, counts))
        per_case.append(len(ents))
        entries += ents
        contigs.append(("ctg1", case["genome"]))
    keep, stats = {}, {}
    text, summary, n_rows = cli.eventalign_batch(
        entries, contigs, model, cli.EventalignOptions(summary=True), counts, "cpu",
        stats=stats, keep=keep)
    return {"cases": cases, "model": model, "entries": entries, "per_case": per_case,
            "text": text, "summary": summary, "n_rows": n_rows, "counts": counts,
            "keep": keep, "stats": stats}


def _case_slice(run, ci):
    lo = sum(run["per_case"][:ci])
    return lo, lo + run["per_case"][ci]


@pytest.mark.parametrize("ci", range(25))
def test_golden_case_exact(golden_run, ci):
    """Status, scalings (hex), events_per_base, summary and every TSV row
    of each read of case ci, through the production path."""
    run = golden_run
    case, model = run["cases"][ci], run["model"]
    lo, hi = _case_slice(run, ci)
    scaled = run["keep"]["scaling"][lo:hi]
    passed = {(rr.record.ref_id, rr.record.name, rr.record.pos): (rr, aln)
              for rr, aln in zip(run["keep"]["realign"], run["keep"]["alignments"])}
    assert len(scaled) == len(case["results"])
    for (read_idx, status, sc, epb), want, ent in zip(scaled, case["results"],
                                                      run["entries"][lo:hi]):
        assert (ent[0], read_idx, status) == (want["qname"], want["read_idx"], want["status"])
        if status:
            continue
        w_shift, w_scale, w_var, w_epb = want["scale"]
        assert (sc["shift"], sc["scale"], sc["var"]) == (_f32(w_shift), _f32(w_scale),
                                                         _f32(w_var))
        assert epb == float.fromhex(w_epb)
        rr, aln = passed[ci, ent[3].name, ent[3].pos]
        s = EA.summarize(aln, rr.events, model, sc, nm=ent[3].tags["NM"])
        wn = want["summary"]
        assert [s["num_events"], s["num_steps"], s["num_skips"], s["num_stays"]] == \
            [int(x) for x in wn[:4]]
        assert s["sum_duration"] == float.fromhex(wn[4])
        assert s["sum_z_score"] == float.fromhex(wn[5])
        assert s["alignment_edit_distance"] == int(wn[6])
        assert s["reference_span"] == int(wn[7])
        rows = EA.emit_tsv(aln, rr.events, model, sc, read_idx, ent[0], "ctg1", SAMPLE_RATE)
        assert rows.splitlines() == want["tsv"], ent[0]
        assert EA.emit_tsv(aln, rr.events, model, sc, read_idx, ent[0], "ctg1", SAMPLE_RATE,
                           use_native=False) == rows


def test_golden_batch_text_and_counts(golden_run):
    """The batch's TSV text is every golden row in order; the counts are
    the goldens' statuses."""
    run = golden_run
    want = [t for c in run["cases"] for r in c["results"] for t in r.get("tsv", [])]
    assert run["text"].splitlines() == want and run["n_rows"] == len(want)
    statuses = [r["status"] for c in run["cases"] for r in c["results"]]
    assert run["counts"] == {"total": len(statuses), "qc_fail": statuses.count(4),
                             "no_calib": statuses.count(1), "no_aln": statuses.count(2),
                             "bad_sig": 0}
    assert len(run["summary"].splitlines()) == statuses.count(0)
    st = run["stats"]["realign"]
    assert st["window_steps"] > 0 and st["wavefront_steps"] > st["window_steps"]


def _as_dicts(aln, read_idx):
    """An Alignment as the oracle's event_alignment dicts."""
    out = []
    ref = aln.ref.tobytes().decode()
    for p, e, s in zip(aln.ref_pos.tolist(), aln.event_idx.tolist(), aln.state.tolist()):
        ref_kmer = ref[p - aln.ref_offset : p - aln.ref_offset + 6]
        model = ("N" * 6 if s == EA.BAD_EVENT
                 else EAO.reverse_complement(ref_kmer) if aln.rc else ref_kmer)
        out.append({"ref_position": p, "ref_kmer": ref_kmer, "read_idx": read_idx,
                    "event_idx": e, "rc": aln.rc, "model_kmer": model,
                    "hmm_state": "KBM"[s]})
    return out


def _oracle_check(oracle, rr, aln, model, region=(-1, -1)):
    """The oracle's align_read_to_ref, summary and TSV equal the port's."""
    want = oracle.align_read_to_ref(rr.record, rr.ref_segment, rr.record.pos, rr.read_length,
                                    rr.events, rr.sc, model, rr.b2e, rr.events_per_base, 3,
                                    *region)
    assert _as_dicts(aln, 3) == want
    assert EA.summarize(aln, rr.events, model, rr.sc, 2) == oracle.summarize_alignment(
        rr.events, model, rr.sc, want, SAMPLE_RATE, nm=2)
    for names, scaled, native in itertools.product((False, True), repeat=3):
        assert EA.emit_tsv(aln, rr.events, model, rr.sc, 3, "rd", "chr", SAMPLE_RATE, names,
                           scaled, native) == "".join(oracle.emit_tsv_lines(
                               rr.events, model, rr.sc, want, 3, "rd", "chr", SAMPLE_RATE,
                               names, scaled))
    return want


@pytest.mark.parametrize("ci", ORACLE_CASES)
def test_realign_equals_oracle_on_goldens(golden_run, ci):
    """realign_batch's output (from the batch of all 25 cases) equals the
    port's oracle, read by read."""
    run = golden_run
    n = 0
    for rr, aln in zip(run["keep"]["realign"], run["keep"]["alignments"]):
        if rr.record.ref_id == ci:
            assert _oracle_check(EAO, rr, aln, run["model"])
            n += 1
    assert n == sum(r["status"] == 0 for r in run["cases"][ci]["results"])


def test_scaling_equals_both_oracles(golden_run):
    """scaling_batch equals scaling_read of both oracles on every golden
    read, b2e included."""
    run = golden_run
    model = run["model"]
    entries = run["entries"]
    events = EV.detect_events_batch([e[4] for e in entries])
    seqs = [e[1] for e in entries]
    shifts, scales = EV.estimate_scalings_mom_batch(seqs, model, events)
    pairs = A.align_events_batch(seqs, [ev["mean"] for ev in events], model,
                                 [float(v) for v in scales], [float(v) for v in shifts], "cpu")
    got = EA.scaling_batch(seqs, events, pairs, model)
    plain = EA.scaling_batch(seqs, events, pairs, model, use_native=False)
    for oracle in (EAO, JEAO):
        for g, seq, ev, p in zip(got + plain, seqs + seqs, events + events, pairs + pairs):
            w = oracle.scaling_read(seq, ev, p, model)
            assert g[0] == w[0] and g[3] == w[3]
            assert (g[1] is None) == (w[1] is None)
            if g[1] is not None:
                assert {k: v.tobytes() for k, v in g[1].items()} == \
                    {k: v.tobytes() for k, v in w[1].items()}
            assert (g[2] is None and w[2] is None) or np.array_equal(g[2], w[2])


# ---------------------------------------------------------------- synthetic


def _golden_recipe(rng, seq):
    """A raw signal by the golden recipe (tests/generate_fixtures.py): per
    k-mer 3-13 samples at its level, N(0, 0.8) noise, N(0, 6) for 20%."""
    levels = _levels()
    ranks = A.kmer_ranks(seq, 6, len(seq) - 5)
    dwell = rng.integers(3, 14, len(ranks))
    sigma = np.where(rng.random(len(ranks)) < 0.8, 0.8, 6.0)
    return (np.repeat(levels[ranks], dwell)
            + rng.normal(0, 1, int(dwell.sum())) * np.repeat(sigma, dwell)).astype(np.float32)


def _revcomp(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


@pytest.fixture(scope="module")
def synthetic():
    """Seeded reads on a random genome, half reverse: soft and hard clips,
    insertions, deletions, a cigar split by N, and N, IUPAC and lower-case
    reference bases under the reads; each through the production prep and
    QC to RealignReads."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(12)
    model = _model()
    genome = "".join(rng.choice(list("ACGT"), 6000))
    iupac = list(genome)
    reads = []
    for r, p0 in enumerate((100, 1300, 2500, 3700)):
        parts = [("S", 6), ("M", 140), ("I", 2), ("M", 90), ("D", 3), ("M", 110)]
        if r % 2:
            parts[3:] = [("M", 90), ("N", 60), ("M", 110), ("H", 5)]
        seq, ref = "".join(rng.choice(list("ACGT"), 6)), p0
        for op, ln in parts[1:]:
            if op == "M":
                seq += genome[ref : ref + ln]
                ref += ln
            elif op == "I":
                seq += "".join(rng.choice(list("ACGT"), ln))
            elif op in "DN":
                ref += ln
        for q, code in zip(range(p0 + 20, ref, 37), "NRYSWKMBDHVnry"):
            iupac[q] = code
        rev = bool(r % 2)
        reads.append((B.BamRecord(f"s{r}", 16 if rev else 0, 0, p0, 60, parts, np.zeros(0),
                                  np.zeros(0), {"NM": 5}),
                      _revcomp(seq) if rev else seq))
    genome = "".join(iupac)
    seqs = [s for _, s in reads]
    events = EV.detect_events_batch([_golden_recipe(rng, s) for s in seqs])
    shifts, scales = EV.estimate_scalings_mom_batch(seqs, model, events)
    pairs = A.align_events_batch(seqs, [e["mean"] for e in events], model,
                                 [float(v) for v in scales], [float(v) for v in shifts], "cpu")
    out = []
    for (rec, seq), ev, (status, sc, b2e, epb) in zip(
            reads, events, EA.scaling_batch(seqs, events, pairs, model)):
        assert status == 0, rec.name
        segment = genome[rec.pos : rec.pos + B._cigar_ref_len(rec.cigar)]
        out.append(EA.RealignRead(rec, segment, len(seq), ev, sc, b2e, epb))
    return out, model


@pytest.mark.parametrize("region", [(-1, -1), (1350, 2700)])
def test_realign_synthetic_equals_both_oracles(synthetic, region):
    """realign_batch on the synthetic reads (rc strands, B states, N and
    IUPAC reference bases, an N-split cigar; and clipped by -w's bounds)
    equals the port's oracle and the JAX package's."""
    reads, model = synthetic
    alns = EA.realign_batch(reads, model, "cpu", *region)
    states = np.concatenate([a.state for a in alns])
    assert (states == EA.BAD_EVENT).any() and any(a.rc for a in alns)
    for rr, aln in zip(reads, alns):
        if region[0] == -1:
            assert len(aln.ref_pos)
        want = _oracle_check(EAO, rr, aln, model, region)
        assert want == JEAO.align_read_to_ref(
            rr.record, rr.ref_segment, rr.record.pos, rr.read_length, rr.events, rr.sc, model,
            rr.b2e, rr.events_per_base, 3, *region)
        for oracle in (EAO, JEAO):
            assert oracle.summarize_alignment(rr.events, model, rr.sc, want, SAMPLE_RATE, 2) == \
                EA.summarize(aln, rr.events, model, rr.sc, 2)
        assert JEAO.emit_tsv_lines(rr.events, model, rr.sc, want, 3, "rd", "chr", SAMPLE_RATE,
                                   True, True) == EAO.emit_tsv_lines(
            rr.events, model, rr.sc, want, 3, "rd", "chr", SAMPLE_RATE, True, True)
        if len(want) and region[0] != -1:
            assert region[0] <= min(a["ref_position"] for a in want)
    if region[0] != -1:
        assert sum(len(a.ref_pos) for a in alns) > 0


def test_aligned_segments_equal_oracle(synthetic):
    reads, _ = synthetic
    for rr in reads:
        want = EAO.get_aligned_segments(rr.record)
        got = EA.aligned_segments(rr.record.cigar, rr.record.pos)
        assert [list(zip(a.tolist(), b.tolist())) for a, b in got] == want
    assert len(EA.aligned_segments(reads[1].record.cigar, 0)) == 2


def test_transitions_equal_oracle():
    for epb in (0.5, 1.0, 1.37, 2.0, 4.9):
        with np.errstate(divide="ignore", invalid="ignore"):  # log(0), log(<0) at epb <= 1
            want = EAO.calculate_transitions(3, epb)
        assert all(np.array_equal(EA.transitions(epb), row, equal_nan=True) for row in want)


def test_unknown_reference_base_raises(synthetic):
    reads, model = synthetic
    rr = reads[0]
    bad = EA.RealignRead(rr.record, rr.ref_segment[:50] + "X" + rr.ref_segment[51:],
                         rr.read_length, rr.events, rr.sc, rr.b2e, rr.events_per_base)
    with pytest.raises(ValueError, match="not a nucleotide"):
        EA.realign_batch([bad], model, "cpu")


# ---------------------------------------------------------------- the CLIs


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """CLI_CASES as one BAM (a contig each), with its genome, reads,
    signals and model; and a copy of the BAM with its .bai."""
    d = tmp_path_factory.mktemp("eventalign_cli")
    cases = _cases()
    refs, records, fq, sig, fa = [], [], [], {}, []
    for rid, ci in enumerate(CLI_CASES):
        case = cases[ci]
        refs.append((f"ctg{ci}", len(case["genome"])))
        fa.append(f">ctg{ci}\n{case['genome']}\n")
        records += _records(case, rid, f"c{ci}_")
        for rd in case["reads"]:
            fq.append(f"@c{ci}_{rd['qname']}\n{rd['fastq']}\n+\n{'I' * len(rd['fastq'])}\n")
            sig[f"c{ci}_{rd['qname']}"] = _signal(rd)
    B.write_bam(str(d / "reads.bam"), refs, records)
    (d / "indexed").mkdir()
    B.write_bam(str(d / "indexed" / "reads.bam"), refs, records)
    B.build_bai(str(d / "indexed" / "reads.bam"))
    (d / "genome.fa").write_text("".join(fa))
    (d / "reads.fq").write_text("".join(fq))
    np.savez(d / "sig.npz", **sig)
    with open(d / "pore.tsv", "w") as f:
        f.write("kmer\tlevel_mean\tlevel_stdv\n")
        for kmer, lv in zip(itertools.product("ACGT", repeat=6), _levels()):
            f.write(f"{''.join(kmer)}\t{lv:.2f}\t1.50\n")
    return d


def _run(main, d, extra, bam="reads.bam", name="out"):
    """A CLI's TSV, --summary and stderr lines but "Kernel time"."""
    out, summ = d / f"{name}.tsv", d / f"{name}.summary"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(["-r", str(d / "reads.fq"), "--raw", str(d / "sig.npz"), "--model",
                   str(d / "pore.tsv"), "-b", str(d / bam), "-g", str(d / "genome.fa"),
                   "-o", str(out), "--summary", str(summ), *extra])
    assert rc == 0
    lines = [ln for ln in err.getvalue().splitlines() if not ln.startswith("Kernel time")]
    return out.read_bytes(), summ.read_bytes(), lines


def _port(d, extra, **kw):
    return _run(cli.main, d, [*extra, "--device", "cpu"], **kw)


@pytest.mark.parametrize("extra", [[], ["--secondary", "yes", "--print-read-names",
                                        "--scale-events"]], ids=["bam", "flags"])
def test_cli_equals_jax_cli(cli_files, extra):
    """TSV, --summary and stderr bytes (time aside) equal the JAX CLI's,
    at -K 512 and (BAM mode) at -K 1, a batch a read."""
    want = _run(jcli.main, cli_files, extra, name="jax")
    assert want[0].count(b"\n") > 1000 and want[1]
    assert _port(cli_files, extra) == want
    if not extra:
        assert _port(cli_files, ["-K", "1"], name="k1") == want


def test_cli_window_equals_jax_cli(cli_files):
    """-w ctg:beg-end: the port through the .bai and through the record
    filter (no .bai) equals the JAX CLI's record filter.  (The JAX CLI's
    own .bai branch assigns read_bam_region's (refs, records) pair to its
    records, so it cannot run; the port unpacks it.)"""
    window = ["-w", "ctg7:1201-1500"]
    want = _run(jcli.main, cli_files, window, name="jax_w")
    rows = want[0].decode().splitlines()[1:]
    assert rows and all(1200 <= int(r.split("\t")[1]) <= 1500 for r in rows)
    assert _port(cli_files, window) == want
    got = _port(cli_files, window, bam="indexed/reads.bam")
    assert got == want
