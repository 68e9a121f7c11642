"""The port's pileup slice on the CPU (ops/pileup.py, cli/pileup.py and the
native engines of io/native.py): the reference-binary goldens
(fixtures/pileup_golden.json, as tests/test_pileup_golden.py holds the JAX
package), the native event extraction against the numpy walk and the JAX
package, the fused region path against the chunked one, and the port's
CLI against the JAX CLI (whose native paths are not built here) on
tests/fixtures/indexed_bam/toy.bam.  Exact: the outputs are counts."""

import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from genomicsbench_palisade_tpu.cli import pileup as jcli
from genomicsbench_palisade_tpu.io import bam as JB
from genomicsbench_palisade_tpu.ops import pileup as JP
from genomicsbench_palisade_tpu_torch.cli import pileup as cli
from genomicsbench_palisade_tpu_torch.io import bam as B
from genomicsbench_palisade_tpu_torch.io import native
from genomicsbench_palisade_tpu_torch.ops import pileup as P

REPO = Path(__file__).resolve().parents[1]
TOY = REPO / "tests" / "fixtures" / "indexed_bam" / "toy.bam"


def _same(a: dict, b: dict):
    assert a["n_cols"] == b["n_cols"]
    for key in ("major", "minor", "matrix"):
        np.testing.assert_array_equal(np.asarray(a[key], np.int64), np.asarray(b[key], np.int64))


@pytest.mark.parametrize("native_events", [True, False])
def test_pileup_matches_reference_golden(native_events):
    cases = json.loads((REPO / "tests" / "fixtures" / "pileup_golden.json").read_text())["cases"]
    idx16 = {c: i for i, c in enumerate(B.SEQ_NT16_STR)}
    for case in cases:
        recs = [B.BamRecord(name=r["name"], flag=r["flag"], ref_id=0, pos=r["pos"],
                            mapq=r["mapq"], cigar=[tuple(c) for c in r["cigar"]],
                            seq_nt16=np.array([idx16[ch] for ch in r["seq"]], np.uint8),
                            qual=np.array(r["qual"], np.uint8), tags={})
                for r in case["records"]]
        start, end = (int(x) for x in case["region"].split(":")[1].split("-"))
        # 1-based region, and the driver's chunk string re-parsed as 1-based
        # (medaka_counts.c:545-555): the chunk starts two below
        res = P.calculate_pileup(recs, 0, max(start - 2, 0), end, num_homop=5,
                                 native_events=native_events)
        rows = np.array(case["rows"], np.int64).reshape(-1, 2 + 50 + 1)
        assert res["n_cols"] == len(rows)
        np.testing.assert_array_equal(res["major"], rows[:, 0])
        np.testing.assert_array_equal(res["minor"], rows[:, 1])
        np.testing.assert_array_equal(res["matrix"], rows[:, 2:-1])
        np.testing.assert_array_equal(res["matrix"].sum(1), rows[:, -1])


def _random_records(rng, n, span=300, ops="MIDSN=X", name=lambda i: f"dt{i % 2}_r{i}"):
    recs = []
    for i in range(n):
        cigar, qlen = [], 0
        for _ in range(int(rng.integers(1, 7))):
            op = str(rng.choice(list(ops)))
            ln = int(rng.integers(1, 25))
            if cigar and cigar[-1][0] == op:
                continue
            cigar.append((op, ln))
            qlen += ln if op in "MIS=X" else 0
        if not any(op in "M=X" for op, _ in cigar):
            cigar.insert(0, ("M", 10))
            qlen += 10
        flag = (B.FREVERSE if rng.random() < 0.5 else 0) | int(
            rng.choice([0, 0, 0, 0, 0, 0, B.FSECONDARY, B.FDUP, B.FQCFAIL]))
        recs.append(B.BamRecord(name(i), flag, 0, int(rng.integers(0, span)),
                                int(rng.choice([0, 5, 60, 60])), cigar,
                                rng.integers(1, 16, qlen).astype(np.uint8),
                                rng.integers(0, 40, qlen).astype(np.uint8), {}))
    return recs


def _as_jax(recs):
    return [JB.BamRecord(r.name, r.flag, r.ref_id, r.pos, r.mapq, r.cigar, r.seq_nt16, r.qual,
                         r.tags) for r in recs]


@pytest.mark.parametrize("seed", [12, 13])
def test_native_events_equal_numpy_walk_and_jax(seed):
    recs = _random_records(np.random.default_rng(seed), 60)
    for dtypes in (None, ["dt0", "dt1"]):
        got = P.calculate_pileup(recs, 0, 0, 400, dtypes=dtypes)
        _same(got, P.calculate_pileup(recs, 0, 0, 400, dtypes=dtypes, native_events=False))
        _same(got, JP.calculate_pileup(_as_jax(recs), 0, 0, 400, dtypes=dtypes))
    kept = [r for r in recs if not r.flag & P.FILTER_FLAGS]
    nat = native.pileup_events_native(kept, P.NUM2COUNTBASE, P.FWD_DEL, P.REV_DEL, 5)
    walk = [P.read_events(r, 5) for r in kept]
    for col, key in enumerate(("pos", "minor", "feat", "qstrat")):
        np.testing.assert_array_equal(nat[col], np.concatenate([w[col] for w in walk]), key)
    np.testing.assert_array_equal(nat[5], [a for w in walk for a in w[4]])
    np.testing.assert_array_equal(nat[6], [b for w in walk for b in w[5]])


def test_read_events_fast_equals_slow_and_jax():
    rng = np.random.default_rng(8)
    for rec in _random_records(rng, 30, ops="MIDSN=X"):
        fast = P.read_events(rec, 5)
        slow = P.read_events(rec, 5, weibull=True, bad_reads=set())
        jfast = JP.read_events(_as_jax([rec])[0], 5)
        for a, b, c in zip(fast[:4], slow[:4], jfast[:4]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
        assert list(fast[4]) == list(slow[4]) == list(jfast[4])
        assert list(fast[5]) == list(slow[5]) == list(jfast[5])
    np.testing.assert_array_equal(P.weibull_fractions(2.0, 1.5, 5),
                                  JP.weibull_fractions(2.0, 1.5, 5))


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    """A sorted, indexed BAM of varied cigars over 60 kb (every filter)."""
    rng = np.random.default_rng(21)
    recs = _random_records(rng, 900, span=60_000, name=lambda i: f"q{i}")
    recs.sort(key=lambda r: r.pos)
    path = tmp_path_factory.mktemp("pileup") / "var.bam"
    B.write_bam(str(path), [("ctg", 60_200)], recs)
    B.build_bai(str(path))
    return path


@pytest.mark.parametrize("cs,ce", [(0, 20_000), (19_999, 40_000), (39_999, 60_000),
                                   (1234, 1300), (59_990, 60_200)])
def test_fused_region_path_equals_chunked_path(indexed, cs, ce):
    bai = B.read_bai(str(indexed) + ".bai")
    fused = P.calculate_pileup_region(str(indexed), "ctg", cs, ce, index=bai)
    _refs, recs = B.read_bam_region(str(indexed), "ctg", cs, ce, index=bai)
    _same(fused, P.calculate_pileup(recs, 0, cs, ce, native_events=False))
    _same(fused, P.calculate_pileup(recs, 0, cs, ce))
    two = P.calculate_pileup_region(str(indexed), "ctg", cs, ce, index=bai, dtypes=["q1", "q"])
    _same(two, P.calculate_pileup(recs, 0, cs, ce, dtypes=["q1", "q"], native_events=False))
    missing = P.calculate_pileup_region(str(indexed), "chrZ", cs, ce, index=bai)
    assert missing["n_cols"] == 0 and missing["matrix"].shape == (0, P.FEATLEN * 5)


def test_chunks_use_the_fused_path_only_when_allowed(tmp_path):
    bam = tmp_path / "toy.bam"
    shutil.copy(TOY, bam)
    shutil.copy(str(TOY) + ".bai", str(bam) + ".bai")
    for region, extra, fused in (("tig1:1-160000", {}, True), ("tig1", {}, False),
                                 ("tig1:1-160000", {"weibull": True}, False),
                                 ("tig1:1-160000", {"dtypes": ["r1", "r"]}, False)):
        stats = {}
        got = list(cli.chunks(str(bam), region, stats=stats, **extra))
        assert stats["fused"] is fused and len(got) == 2, region
    with pytest.raises(cli.MissingContig):
        list(cli.chunks(str(bam), "chrZ:1-10"))


@pytest.mark.parametrize("extra", [[], ["--weibull"], ["r1", "r"], ["--num-homop", "3"]])
@pytest.mark.parametrize("region", ["tig1:1-160000", "tig1", "tig1:5001-100000"])
@pytest.mark.parametrize("with_bai", [True, False])
def test_cli_prints_the_jax_clis_lines(tmp_path, capsys, monkeypatch, extra, region, with_bai):
    monkeypatch.setenv("GENOMICS_TPU_CACHE_DIR", str(tmp_path / "xla"))
    bam = tmp_path / "toy.bam"
    shutil.copy(TOY, bam)
    if with_bai:
        shutil.copy(str(TOY) + ".bai", str(bam) + ".bai")
    args = [str(bam), region, "1"] + extra
    assert cli.main(args) == 0
    out = capsys.readouterr()
    assert jcli.main(args) == 0
    jout = capsys.readouterr()
    assert out.out == jout.out and out.out.startswith("pos\tins\t")
    assert out.out.count("\n") > 100
    assert out.err.startswith("Kernel time: ") and jout.err.startswith("Kernel time: ")


def test_cli_missing_contig_and_print_format(tmp_path, capsys):
    assert cli.main([str(TOY), "chrZ:1-100"]) == 1
    assert "Reference chrZ not in BAM" in capsys.readouterr().err
    res = P.calculate_pileup_region(str(TOY), "tig1", 0, 3000)
    ours, theirs = io.StringIO(), io.StringIO()
    P.print_pileup(res, out=ours)
    JP.print_pileup(res, out=theirs)
    assert ours.getvalue() == theirs.getvalue() and ours.getvalue().count("\n") > 10
