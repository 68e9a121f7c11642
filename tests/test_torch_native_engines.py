"""The JAX package's native host engines as the port binds them
(genomicsbench_palisade_tpu_torch/io/native.py and its callers), on the CPU.

Each engine is held three ways on the same inputs: the port's native
engine, the port's plain version (its numpy, Python or device path, on
the CPU) and the JAX package's function.  This checkout does not build
native/libgenomics_native.so, so the JAX functions run their numpy or
Python paths, and the port's native library is its own build under
build/native/ (utils/native_build.py, shared by the test workers behind a
file lock).  Inputs: the committed goldens and small inputs made from a
seed with numpy.  Tolerance: none.  Integers and codes equal, floats
bit-equal, TSV, FASTA and consensus text byte-equal.
"""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu.io import bam as JB
from genomicsbench_palisade_tpu.io import fastq as JFQ
from genomicsbench_palisade_tpu.io import pairs as JPIO
from genomicsbench_palisade_tpu.models import bonito as JBO
from genomicsbench_palisade_tpu.ops import abea as JA
from genomicsbench_palisade_tpu.ops import eventalign as JEA
from genomicsbench_palisade_tpu.ops import kmer as JK
from genomicsbench_palisade_tpu.ops import phmm as JP
from genomicsbench_palisade_tpu.ops import phmm_f64 as JF64
from genomicsbench_palisade_tpu.ops.oracle import events as JEO
from genomicsbench_palisade_tpu.ops.oracle import fmi as JFO
from genomicsbench_palisade_tpu.ops.oracle import kmer as JKO
from genomicsbench_palisade_tpu.ops.oracle import poa as JPO
from genomicsbench_palisade_tpu_torch.cli import abea as cli_abea
from genomicsbench_palisade_tpu_torch.cli import kmer_cnt as cli_kmer
from genomicsbench_palisade_tpu_torch.io import bam as B
from genomicsbench_palisade_tpu_torch.io import fastq as FQ
from genomicsbench_palisade_tpu_torch.io import native
from genomicsbench_palisade_tpu_torch.io import pairs as PIO
from genomicsbench_palisade_tpu_torch.models import bonito as BO
from genomicsbench_palisade_tpu_torch.ops import abea as A
from genomicsbench_palisade_tpu_torch.ops import eventalign as EA
from genomicsbench_palisade_tpu_torch.ops import events as EV
from genomicsbench_palisade_tpu_torch.ops import kmer as K
from genomicsbench_palisade_tpu_torch.ops import phmm as P
from genomicsbench_palisade_tpu_torch.ops import phmm_f64 as F64
from genomicsbench_palisade_tpu_torch.ops import poa as POA
from genomicsbench_palisade_tpu_torch.ops.oracle import abea as AO
from genomicsbench_palisade_tpu_torch.ops.oracle import eventalign as EAO
from genomicsbench_palisade_tpu_torch.ops.oracle import phmm as PHO
from genomicsbench_palisade_tpu_torch.ops.oracle import poa as PO
from genomicsbench_palisade_tpu_torch.utils import native_build

FIX = Path(__file__).parent / "fixtures"
BAM = FIX / "indexed_bam" / "toy.bam"
SAMPLE_RATE = 4000.0
EVENT_KEYS = ("start", "length", "mean", "stdv")


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _golden(name):
    return json.loads((FIX / name).read_text())


def _same_events(a, b):
    assert a.dtype == b.dtype and len(a) == len(b)
    for key in EVENT_KEYS:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# ---------------------------------------------------------------------------
# A1-A3: the readers
# ---------------------------------------------------------------------------

def _write_pairs(path, pairs, terminated=True):
    rows = [f"{h0}{' x' if i % 5 == 0 else ''}\n{''.join(map(str, t))}\n{''.join(map(str, q))}"
            for i, (q, t, h0) in enumerate(pairs)]
    path.write_text("\n".join(rows) + ("\n" if terminated else ""))


@pytest.mark.parametrize("source", ["golden", "seeded", "seeded_unterminated"])
def test_pair_scan(tmp_path, source):
    """A1: parse_pairs_struct_native + sub48_native (parse_pairs_soa's
    default) = the numpy parse = the JAX parse, every array and dtype."""
    if source == "golden":
        pairs = [(c["query"], c["target"], c["h0"]) for c in _golden("bsw_golden.json")]
    else:
        rng = np.random.default_rng(3)
        pairs = [(rng.integers(0, 5, rng.integers(0, 150)),
                  rng.integers(0, 5, rng.integers(1, 260)), int(rng.integers(-99, 1000)))
                 for _ in range(200)]
    path = tmp_path / "pairs.txt"
    _write_pairs(path, pairs, terminated=not source.endswith("unterminated"))
    got = PIO.parse_pairs_soa(path)
    plain = PIO.parse_pairs_soa(path, use_native=False)
    want = JPIO.parse_pairs_soa(str(path))
    assert len(got["h0"]) == len(pairs)
    for key in want:
        assert got[key].dtype == plain[key].dtype, key
        np.testing.assert_array_equal(got[key], plain[key], err_msg=key)
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    t_off, t_len, q_off, q_len, h0 = native.parse_pairs_struct_native(np.fromfile(path, np.uint8))
    np.testing.assert_array_equal(h0, [p[2] for p in pairs])
    short = PIO.parse_pairs_soa(path, max_pairs=7)
    assert all(np.array_equal(short[k], plain[k][:7]) for k in short if k != "codes")


def _read_files(tmp_path, seqs):
    fa, fq = tmp_path / "r.fa", tmp_path / "r.fq"
    fa.write_text("".join(f">r{i} c\n{s[:70]}\n{s[70:]}\n" if len(s) > 70 else f">r{i}\n{s}\n"
                          for i, s in enumerate(seqs)))
    fq.write_text("".join(f"@r{i} c\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(seqs)))
    return fa, fq


@pytest.mark.parametrize("source", ["kmer_golden", "seeded"])
def test_read_parse(tmp_path, source):
    """A2: parse_reads_native, as the kmer CLI's read (2-bit codes, non-ACGT
    3, the length filter) and the fmi CLIs' (codes 0-4, padded), = the
    Python reader's strings encoded = the JAX reader's, FASTA and FASTQ."""
    if source == "kmer_golden":
        seqs = [r for c in _golden("kmer_golden.json")["cases"] for r in c["reads"]]
    else:
        rng = np.random.default_rng(5)
        seqs = ["".join(rng.choice(list("ACGTNacgtRY"), rng.integers(1, 400)))
                for _ in range(60)]
    for path in _read_files(tmp_path, seqs):
        with contextlib.redirect_stdout(io.StringIO()):
            got = cli_kmer.read_reads(str(path), 60)
            plain = cli_kmer.read_reads(str(path), 60, use_native=False)
        want = [s for _n, s, _q in JFQ.read_sequences(str(path)) if len(s) > 60]
        assert plain == want and len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, JK.encode_reads_np([w])[0][0])
        for limit in (None, 9):
            enc, rl = FQ.read_codes(path, limit)
            penc, prl = FQ.read_codes(path, limit, use_native=False)
            jseqs = [s for _n, s, _q in JFQ.read_all(str(path), limit=limit)]
            assert enc.dtype == penc.dtype == np.int8 and rl.dtype == prl.dtype == np.int32
            np.testing.assert_array_equal(enc, penc)
            np.testing.assert_array_equal(rl, [len(s) for s in jseqs])
            for row, s in zip(enc, jseqs):
                np.testing.assert_array_equal(row[: len(s)], JFO.encode_read(s))
                assert (row[len(s):] == 4).all()
    codes, quals, offsets, lengths = native.parse_reads_native(str(_read_files(tmp_path, seqs)[1]))
    assert quals is not None and (quals == ord("I") - 33).all() and len(lengths) == len(seqs)


def _same_records(got, want):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        for f in ("name", "flag", "ref_id", "pos", "mapq", "cigar", "tags"):
            assert getattr(x, f) == getattr(y, f), f
        for f in ("seq_nt16", "qual"):
            a, b = getattr(x, f), getattr(y, f)
            assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b), f


@pytest.mark.parametrize("region", [None, (0, 1 << 29), (2000, 9000),
                                    (0, 0)])
def test_bam_decoders(region):
    """A3: read_bam_native and the `.bai` region decode (read_bam's and
    read_bam_region's default without tags) = the Python decoders = the
    JAX ones, record for record."""
    if region is None:
        got = B.read_bam(str(BAM))
        plain = B.read_bam(str(BAM), use_native=False)
        want = JB.read_bam(str(BAM))
    else:
        args = (str(BAM), "tig1", *region)
        got = B.read_bam_region(*args)
        plain = B.read_bam_region(*args, use_native=False)
        want = JB.read_bam_region(*args)
    assert got[0] == plain[0] == want[0]
    _same_records(got[1], plain[1])
    _same_records(got[1], want[1])
    assert region == (0, 0) or len(got[1]) > 0
    refs, cols = native.read_bam_native(str(BAM))
    assert refs == want[0] and len(cols["pos"]) == len(JB.read_bam(str(BAM))[1])


def test_dbg_region_reads_decode_natively(tmp_path):
    """The dbg driver's region read (cli.dbg.region_reads) through the
    native decoder, with and without the `.bai`, = the Python decode."""
    from genomicsbench_palisade_tpu_torch.cli import dbg

    lone = tmp_path / "toy.bam"
    lone.write_bytes(BAM.read_bytes())
    for path in (str(BAM), str(lone)):
        got = dbg.region_reads(path, "tig1", 1000, 60_000)
        assert len(got) > 0
        refs, recs = B.read_bam(path, use_native=False)
        want = [r for r in recs if r.ref_id == 0]
        if path == str(BAM):
            want = B.read_bam_region(path, "tig1", 1000, 60_000, use_native=False)[1]
        assert [(g[0], g[2], g[4]) for g in got] == [
            (r.pos, "".join(B.SEQ_NT16_STR[c] for c in r.seq_nt16), r.flag) for r in want]


# ---------------------------------------------------------------------------
# A4-A7, B3, B5, B6: nanopore
# ---------------------------------------------------------------------------

def _golden_levels():
    i = np.arange(4096, dtype=np.int64)
    return np.array([float(f"{x:.2f}") for x in 60.0 + 80.0 * ((i * 2654435761) % 4096) / 4096.0])


def _ea_model():
    stdv = np.full(4096, 1.50, np.float32)
    return {"level_mean": _golden_levels().astype(np.float32), "level_stdv": stdv,
            "level_log_stdv": np.float32(np.log(np.float64(stdv)))}


@pytest.fixture(scope="module")
def abea_golden(tmp_path_factory):
    """The 25 abea goldens, their signals and their pore model (the
    fixture generator's levels, as tests/test_torch_abea.py loads them)."""
    import sys

    from genomicsbench_palisade_tpu_torch.io import signal as SIG

    sys.path.insert(0, str(FIX.parent))
    from generate_fixtures import _pore_levels

    path = tmp_path_factory.mktemp("abea") / "pore.tsv"
    path.write_text("kmer\tlevel_mean\tlevel_stdv\n" + "".join(
        f"{km}\t{mean:.2f}\t1.50\n" for km, mean in _pore_levels().items()))
    cases = _golden("abea_golden.json")["cases"]
    sigs = [np.array([float(x) for x in c["signal"]], np.float32) for c in cases]
    return cases, sigs, SIG.load_pore_model(str(path))


def _seeded_signals(seed, lengths):
    rng = np.random.default_rng(seed)
    levels = rng.uniform(60, 140, 4096)
    out = []
    for n in lengths:
        codes = rng.integers(0, 4, n + 5)
        ranks = np.zeros(n, np.int64)
        for j in range(6):
            ranks = (ranks << 2) | codes[j : j + n]
        dwell = rng.integers(3, 14, n)
        noise = np.where(rng.random(n) < 0.8, 0.8, 6.0)
        out.append((np.repeat(levels[ranks], dwell)
                    + rng.normal(0, 1, dwell.sum()) * np.repeat(noise, dwell)).astype(np.float32))
    return out + [np.zeros(0, np.float32), np.full(5, 100.0, np.float32), np.zeros(1, np.float32)]


def test_event_detection(abea_golden):
    """A4: detect_events_native (detect_events_batch's default) = the numpy
    lockstep = the JAX numpy detector and the port's oracle, on the 25 abea
    goldens' signals (and their recorded events) and seeded ones, empty
    and 1-sample signals included."""
    cases, sigs, _model = abea_golden
    sigs = sigs + _seeded_signals(7, [900, 40, 3, 250])
    got = EV.detect_events_batch(sigs)
    plain = EV.detect_events_batch(sigs, use_native=False)
    for s, g, p in zip(sigs, got, plain):
        _same_events(g, p)
        _same_events(g, JEO.detect_events(s, use_native=False))
        if len(s):
            _same_events(native.detect_events_native(s), g)
    for c, g in zip(cases, got):
        assert g["start"].astype(np.int64).tolist() == [e[0] for e in c["events"]]
        np.testing.assert_array_equal(
            g["mean"], np.array([float.fromhex(e[2]) for e in c["events"]], np.float32))


def test_mom_scalings(abea_golden):
    """A5: gt_mom_scalings (estimate_scalings_mom_batch's default) = numpy's
    sequential sums = the JAX estimate_scalings_mom_fast (its oracle here),
    bit for bit, on the abea goldens and seeded short reads."""
    cases, sigs, model = abea_golden
    seqs = [c["seq"] for c in cases]
    events = EV.detect_events_batch(sigs[: len(seqs)])
    rng = np.random.default_rng(9)
    seqs += ["".join(rng.choice(list("ACGTN"), n)) for n in (7, 30, 400)]
    events += EV.detect_events_batch(_seeded_signals(10, [20, 60, 500])[:3])
    got = EV.estimate_scalings_mom_batch(seqs, model, events)
    plain = EV.estimate_scalings_mom_batch(seqs, model, events, use_native=False)
    for a, b in zip(got, plain):
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    for i, (seq, ev) in enumerate(zip(seqs, events)):
        want = JEA.estimate_scalings_mom_fast(seq, model, ev)
        assert (got[0][i], got[1][i]) == tuple(np.float32(w) for w in want), i
    for c, sh, sc in zip(cases, got[0], got[1]):
        assert (float(sh), float(sc)) == (float.fromhex(c["shift"]), float.fromhex(c["scale"]))


def test_abea_host_fill_and_traceback(abea_golden):
    """B3 and B6: the host fill (align_events_batch(use_native=True),
    native/abeafill.cpp) and the host walk of the port's fill outputs
    (traceback_host, native/abea_tb.cpp) = the plain fill and walk with
    decode = the JAX package (its scan and numpy traceback) = the golden
    pairs, QC drops included."""
    cases, sigs, model = abea_golden
    cases = cases[:10]
    seqs = [c["seq"] for c in cases]
    evs = [e["mean"] for e in EV.detect_events_batch(sigs[:10])]
    scales = [float(np.float32(float.fromhex(c["scale"]))) for c in cases]
    shifts = [float(np.float32(float.fromhex(c["shift"]))) for c in cases]
    rng = np.random.default_rng(11)  # a noisy read QC drops, and reads that align to nothing
    seqs += [seqs[0], "ACG", "ACGTACGT"]
    evs += [(evs[0] + rng.normal(0, 25, len(evs[0]))).astype(np.float32),
            np.zeros(0, np.float32), np.zeros(0, np.float32)]
    scales += [scales[0], 1.0, 1.0]
    shifts += [shifts[0], 0.0, 0.0]
    keep = {}
    plain = A.align_events_batch(seqs, evs, model, scales, shifts, "cpu", keep=keep)
    host = A.align_events_batch(seqs, evs, model, scales, shifts, use_native=True)
    walked = A.traceback_host(seqs, evs, model, scales, shifts, keep["fill"])
    want = JA.align_events_batch(seqs, evs, model, scales, shifts, use_native=False)
    assert plain == host == walked == [list(map(tuple, w)) for w in want]
    for c, got in zip(cases, plain):
        assert got == [tuple(p) for p in c["pairs"]]
    assert plain[10] == [] and plain[11] == []


@pytest.fixture(scope="module")
def ea_reads():
    """Eventalign golden reads through the host engines to the realign's
    inputs: (RealignRead, contig) of the reads that pass QC."""
    cases, model = _golden("eventalign_golden.json")["cases"], _ea_model()
    nt16 = {c: i for i, c in enumerate(B.SEQ_NT16_STR)}
    counts = dict.fromkeys(cli_abea.COUNTS, 0)
    out = []
    for ci, case in enumerate(cases):
        recs = sorted((B.BamRecord(rd["qname"], rd["flag"], 0, rd["pos"], rd["mapq"],
                                   [tuple(c) for c in rd["cigar"]],
                                   np.array([nt16[ch] for ch in rd["query"]], np.uint8),
                                   np.full(len(rd["query"]), 30, np.uint8), {"NM": rd["nm"]})
                       for rd in case["reads"]), key=lambda r: r.pos)
        reads = {rd["qname"]: rd["fastq"] for rd in case["reads"]}
        sigs = {rd["qname"]: np.array([float(x) for x in rd["signal"]], np.float32)
                for rd in case["reads"]}
        for name, seq, read_idx, rec, sig in cli_abea.bam_entries(recs, reads, sigs, counts):
            ev = EV.detect_events_batch([sig])[0]
            if len(ev) < 2:
                continue
            sh, sc = EA.estimate_scalings_mom_fast(seq, model, ev)
            pairs = A.align_events_batch([seq], [ev["mean"]], model, [float(sc)], [float(sh)],
                                         use_native=True)[0]
            status, scal, b2e, epb = EA.scaling_read_fast(seq, ev, pairs, model)
            if status == 0:
                seg = case["genome"][rec.pos : rec.pos + B._cigar_ref_len(rec.cigar)]
                out.append((EA.RealignRead(rec, seg, len(seq), ev, scal, b2e, epb), ci,
                            seq, pairs))
    return model, out


def test_eventalign_scaling(ea_reads):
    """A6: gt_eventalign_scaling (scaling_batch's default) = the numpy pass
    = the JAX scaling_read_fast (its oracle here): status, scalings' bits,
    b2e, events_per_base; on the eventalign goldens' reads and with their
    pairs cut (calibration and alignment failures)."""
    model, reads = ea_reads
    seqs = [r[2] for r in reads] * 3
    evs = [r[0].events for r in reads] * 3
    pairs = ([r[3] for r in reads] + [r[3][:150] for r in reads] + [[] for _ in reads])
    got = EA.scaling_batch(seqs, evs, pairs, model)
    plain = EA.scaling_batch(seqs, evs, pairs, model, use_native=False)
    statuses = set()
    for g, p, seq, ev, pr in zip(got, plain, seqs, evs, pairs):
        for w in (p, JEA.scaling_read_fast(seq, ev, pr, model)):
            assert g[0] == w[0] and g[3] == w[3]
            assert (g[1] is None) == (w[1] is None)
            if g[1] is not None:
                assert {k: np.float32(v).tobytes() for k, v in g[1].items()} == \
                    {k: np.float32(v).tobytes() for k, v in w[1].items()}
            assert (g[2] is None) == (w[2] is None)
            if g[2] is not None:
                np.testing.assert_array_equal(g[2], w[2])
        statuses.add(g[0])
    assert statuses == {0, EA.FAILED_CALIBRATION, EA.FAILED_ALIGNMENT}


def _alignment(rr, rp, ei, st, ref_seq):
    ref = np.frombuffer(ref_seq.encode(), np.uint8)
    state = np.where(np.frombuffer(st, np.uint8) == ord("B"), EA.BAD_EVENT, EA.MATCH)
    return EA.Alignment(ref, rr.record.pos, rr.record.is_reverse, rp.astype(np.int64),
                        ei.astype(np.int64), state)


def test_eventalign_emit(ea_reads):
    """A7: the native block formatter (emit_tsv's default,
    emit_tsv_text_arrays) = the f-string rows (emit_tsv(use_native=False))
    = the port's numpy emitters (emit_tsv_lines_arrays,
    emit_tsv_lines_fast) = the JAX numpy emitters, byte for byte, for
    every --print-read-names / --scale-events pair."""
    model, reads = ea_reads
    for rr, _ci, _seq, _p in reads:
        rp, ei, st, ref_seq = EA.realign_read_arrays(rr.record, rr.ref_segment, rr.record.pos,
                                                     rr.read_length, rr.events, rr.sc, model,
                                                     rr.b2e, rr.events_per_base)
        aln = _alignment(rr, rp, ei, st, ref_seq)
        dicts = EA.realign_read(rr.record, rr.ref_segment, rr.record.pos, rr.read_length,
                                rr.events, rr.sc, model, rr.b2e, rr.events_per_base, 3)
        for names in (False, True):
            for scaled in (False, True):
                args = (rr.events, model, rr.sc, rp, ei, st, ref_seq, rr.record.pos,
                        rr.record.is_reverse, 3, "rd", "ctg1", SAMPLE_RATE, names, scaled)
                text, n = EA.emit_tsv_text_arrays(*args)
                assert n == len(rp) > 0
                assert text == "".join(EA.emit_tsv_lines_arrays(*args))
                assert text == "".join(JEA.emit_tsv_lines_arrays(*args))
                fast = (rr.events, model, rr.sc, dicts, 3, "rd", "ctg1", SAMPLE_RATE, names,
                        scaled)
                assert text == "".join(EA.emit_tsv_lines_fast(*fast))
                assert text == "".join(JEA.emit_tsv_lines_fast(*fast))
                assert text == EA.emit_tsv(aln, rr.events, model, rr.sc, 3, "rd", "ctg1",
                                           SAMPLE_RATE, names, scaled)
                assert text == EA.emit_tsv(aln, rr.events, model, rr.sc, 3, "rd", "ctg1",
                                           SAMPLE_RATE, names, scaled, use_native=False)
    assert EA.emit_tsv_text_arrays(None, model, None, np.zeros(0, np.int32), None, b"", "",
                                   0, False, 0, "", "", SAMPLE_RATE) == ("", 0)


def test_eventalign_host_realign(ea_reads):
    """B5: the native realign (realign_read_arrays, realign_read) = the
    device wavefront on the CPU (realign_batch, the CLI's route) = the
    oracle (realign_read(use_native=False)) = the JAX realign_read on its
    oracle, on three golden reads, with and without a -w clip."""
    model, reads = ea_reads
    picks = sorted(reads, key=lambda r: r[0].read_length)[:3]
    for region in ((-1, -1), (picks[0][0].record.pos + 40, picks[0][0].record.pos + 200)):
        batch = EA.realign_batch([r[0] for r in picks], model, "cpu", *region)
        for (rr, *_), aln in zip(picks, batch):
            args = (rr.record, rr.ref_segment, rr.record.pos, rr.read_length, rr.events, rr.sc,
                    model, rr.b2e, rr.events_per_base)
            rp, ei, st, ref_seq = EA.realign_read_arrays(*args, *region)
            np.testing.assert_array_equal(rp, aln.ref_pos)
            np.testing.assert_array_equal(ei, aln.event_idx)
            np.testing.assert_array_equal(
                np.frombuffer(st, np.uint8) == ord("B"), aln.state == EA.BAD_EVENT)
            got = EA.realign_read(*args, 3, *region)
            assert got == EA.realign_read(*args, 3, *region, use_native=False)
            assert got == JEA.realign_read(*args, 3, *region, use_native=False)
            assert len(got) == len(rp)


# ---------------------------------------------------------------------------
# A8, A9, B1, B2, B4
# ---------------------------------------------------------------------------

def test_ctc_beam():
    """A8: ctc_beam_native (beam_search_decode's default) = the Python walk
    = the JAX beam (its Python walk here), on the bonito golden's logits
    and seeded posteriors, beams 1-8, with a fully pruned step."""
    z = np.load(FIX / "bonito_golden.npz")
    logits = [torch.log_softmax(torch.from_numpy(z["logits"][i]).float(), -1).numpy()
              for i in range(z["logits"].shape[0])]
    rng = np.random.default_rng(13)
    for temp in (0.3, 1.0, 3.0):
        lp = np.log(rng.dirichlet(np.full(5, temp), 250)).astype(np.float32)
        lp[120] = -20.0
        logits.append(lp)
    for lp in logits:
        for beam in (1, 3, 5, 8):
            got = BO.beam_search_decode(lp, beam_size=beam)
            assert got == BO.beam_search_decode(lp, beam_size=beam, use_native=False)
            assert got == JBO.beam_search_decode(lp, beam_size=beam)
            assert "".join("NACGT"[c] for c in native.ctc_beam_native(lp, beam, 1e-3)) == got


@pytest.mark.parametrize("source", ["kmer_golden", "seeded"])
def test_minimizer_walk(source):
    """A9: minimizer_counts_native (build_minimizer_index's default) = the
    oracle's deque walk in the port = the JAX build_minimizer_index (its
    oracle walk here): the counter and every metric."""
    if source == "kmer_golden":
        runs = [(c["reads"], c["k"], c["min_read_length"])
                for c in _golden("kmer_golden.json")["cases"][:12]]
    else:
        rng = np.random.default_rng(17)
        reads = ["".join(rng.choice(list("ACGTN"), rng.integers(20, 600))) for _ in range(40)]
        codes = [JKO.encode_seq(r).astype(np.uint8) for r in reads[:10]]
        runs = [(reads, 15, 100), (reads, 31, 0), (codes, 9, 50)]
    for reads, k, min_len in runs:
        for window in (3, 5):
            kw = dict(k=k, window=window, min_read_length=min_len)
            got = K.build_minimizer_index(reads, **kw)
            assert got == K.build_minimizer_index(reads, use_native=False, **kw)
            assert got == JK.build_minimizer_index(reads, **kw)


def test_kmer_host_counter():
    """B2: count_kmers_host (native/kmercnt.cpp) = the port's device
    counter on the CPU = the JAX counter = the 25 goldens, and on seeded
    reads as strings and as codes (N kept as 4 or mapped to 3), k 5-32."""
    for case in _golden("kmer_golden.json")["cases"]:
        kw = dict(k=case["k"], min_read_length=case["min_read_length"])
        got = K.count_kmers_host(case["reads"], **kw)
        assert got == K.count_kmers(case["reads"], device="cpu", **kw)
        assert (got["total_kmers"], got["hash_size"]) == (case["total_kmers"], case["hash_size"])
    rng = np.random.default_rng(19)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    reads = [genome[s : s + n] for s, n in zip(rng.integers(0, 1500, 80), rng.integers(50, 1500, 80))]
    reads += ["".join(rng.choice(list("ACGTN"), 300)) for _ in range(5)]
    codes = [np.frombuffer(r.encode(), np.uint8) for r in reads]
    lut = np.full(256, 4, np.int8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    codes = [lut[c] for c in codes]
    for k in (5, 17, 31, 32):
        kw = dict(k=k, min_read_length=100)
        got = K.count_kmers_host(reads, **kw)
        assert got == K.count_kmers_host(codes, **kw) == K.count_kmers(reads, device="cpu", **kw)
        assert got == JK.count_kmers(reads, **kw) and got["hash_size"] > 0
    assert K.count_kmers_host(reads, k=33) is None
    assert K.count_kmers_host(reads, min_read_length=10_000) == {
        "total_kmers": 0, "hash_size": 0, "occurrences": 0}


def test_poa_host_engine():
    """B1: msa_consensus_host = the device aligner's consensus on the CPU
    (msa_consensus_batch) = the oracles = the goldens; NativePoaGraph's
    alignments, consensus and rank-space arrays = the port's and the JAX
    oracle graph's, nw/sw/ov, and to_python() rebuilds the graph."""
    cases = _golden("poa_golden.json")["cases"][:6]
    wins = [b for c in cases for b in c["batches"]]
    want = [cons for c in cases for cons in c["consensus"]]
    tm = {}
    got = POA.msa_consensus_host(wins + [[]], timings=tm)
    assert got == want + [""] and set(tm) == {"align", "add", "consensus"}
    assert POA.msa_consensus_batch(wins[1:4], device="cpu") == got[1:4]
    assert got[1:4] == [JPO.msa_consensus(w) for w in wins[1:4]]
    swov = _golden("poa_swov_golden.json")["cases"][0]["seqs"]
    params = (2, -4, -6, -2, -25, -1)
    for atype in ("nw", "sw", "ov"):
        ng, pg, jg = POA.NativePoaGraph(), PO.PoaGraph(), JPO.PoaGraph()
        for s in swov[:3] + wins[3][:3]:
            a = ng.align(s, params, atype)
            assert a == PO.convex_align(s, pg, PO.PoaParams(*params), atype)
            assert a == JPO.convex_align(s, jg, JPO.PoaParams(*params), atype)
            ng.add_alignment(a, s)
            pg.add_alignment(a, s)
            jg.add_alignment(a, s)
        assert ng.generate_consensus() == pg.generate_consensus() == jg.generate_consensus()
        cmap = {"A": 0, "C": 1, "G": 2, "T": 3}
        garr, r2n = ng.arrays(2048, 64, cmap)
        ref = POA.graph_to_arrays(pg, 2048, 64, cmap)
        assert r2n == pg.rank_to_node_id and all(np.array_equal(garr[k], ref[k]) for k in ref)
        assert ng.arrays(8, 16, cmap) == (None, None)
        back = ng.to_python()
        assert back.rank_to_node_id == pg.rank_to_node_id
        assert [(e.begin, e.end) for e in back.edges] == [(e.begin, e.end) for e in pg.edges]


def test_phmm_f64_host_pass():
    """B4: phmm_forward_f64_native = the plain double pass (the f64
    kernel's plain version on the CPU) = the JAX numpy sweep, raw sums bit
    for bit, on the 40 GKL goldens and seeded cases;
    phmm_fallback_log10(use_native=True) = the kernel route = the JAX
    fallback."""
    cases = _golden("phmm_golden.json")
    reads = [{"bases": PHO.encode_bases(c["rs"]),
              **{key: np.array([ord(ch) for ch in c[key]]) for key in "qidc"}} for c in cases]
    haps = [PHO.encode_bases(c["hap"]) for c in cases]
    pairs = [(k, k) for k in range(len(cases))]
    batch = P.prepare_batch(reads, haps, pairs)
    raw = F64.phmm_forward_f64_native(batch)
    plain = P.phmm_forward_plain(batch, torch.float64, "cpu").numpy()
    jb = JP.prepare_batch(reads, haps, pairs, transposed=False)
    np.testing.assert_array_equal(raw, plain)
    np.testing.assert_array_equal(raw, JF64.phmm_forward_f64(jb))
    mask = np.arange(len(pairs)) % 3 != 1
    got, idx = F64.phmm_fallback_log10(batch, mask, use_native=True)
    dev, didx = F64.phmm_fallback_log10(batch, mask, "cpu")
    want, jidx = JF64.phmm_fallback_log10({k: np.asarray(v) for k, v in jb.items()}, mask)
    np.testing.assert_array_equal(idx, didx)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(got, dev)
    np.testing.assert_array_equal(got, want)
    empty = F64.phmm_fallback_log10(batch, np.zeros(len(pairs), bool), use_native=True)
    assert empty[0].size == 0 and empty[1].size == 0


# ---------------------------------------------------------------------------
# a failed build raises: no Group A entry point falls back to its plain path
# ---------------------------------------------------------------------------

def test_failed_build_raises_at_every_native_default(tmp_path, monkeypatch, abea_golden):
    """With the library's build failing, every entry point whose default
    is a native engine raises instead of returning its plain result."""
    from genomicsbench_palisade_tpu_torch.cli import fmi as cli_fmi

    cases, sigs, _model = abea_golden
    pf = tmp_path / "pairs.txt"
    _write_pairs(pf, [([0, 1, 2], [0, 1, 2, 3], 5)])
    fa, _fq = _read_files(tmp_path, ["ACGT" * 30])
    model = _ea_model()
    ev = EV.detect_events_batch(sigs[:1])[0]
    aln = EA.Alignment(np.frombuffer(b"ACGTACGTAC", np.uint8), 0, False, np.array([0, 1]),
                       np.array([0, 1]), np.array([EA.MATCH, EA.MATCH]))
    sc = {"shift": np.float32(0), "scale": np.float32(1), "var": np.float32(1),
          "log_var": np.float32(0)}
    lp = np.log(np.full((4, 5), 0.2, np.float32))
    entry_points = {
        "parse_pairs_soa": lambda: PIO.parse_pairs_soa(pf),
        "kmer read_reads": lambda: cli_kmer.read_reads(str(fa), 10),
        "fmi read_codes": lambda: FQ.read_codes(fa),
        "fmi prepare": lambda: cli_fmi.prepare(str(fa), str(fa), "cpu"),
        "read_bam": lambda: B.read_bam(str(BAM)),
        "read_bam_region": lambda: B.read_bam_region(str(BAM), "tig1", 0, 5000),
        "detect_events_batch": lambda: EV.detect_events_batch(sigs[:1]),
        "estimate_scalings_mom_batch": lambda: EV.estimate_scalings_mom_batch(
            [cases[0]["seq"]], model, [ev]),
        "scaling_batch": lambda: EA.scaling_batch([cases[0]["seq"]], [ev],
                                                  [[(0, 0), (1, 1)]], model),
        "emit_tsv": lambda: EA.emit_tsv(aln, ev, model, sc, 0, "r", "c", SAMPLE_RATE),
        "beam_search_decode": lambda: BO.beam_search_decode(lp),
        "build_minimizer_index": lambda: K.build_minimizer_index(["ACGT" * 30], k=5,
                                                                 min_read_length=10),
    }

    def broken():
        raise RuntimeError("g++ failed to build native/: test")

    monkeypatch.setattr(native_build, "load", broken)
    native._lib.cache_clear()
    try:
        for name, fn in entry_points.items():
            with contextlib.redirect_stdout(io.StringIO()):
                with pytest.raises(RuntimeError, match="failed to build native/"):
                    fn()
                    pytest.fail(f"{name} returned without the native library")
    finally:
        monkeypatch.undo()
        native._lib.cache_clear()
    assert PIO.parse_pairs_soa(pf)["h0"].tolist() == [5]
