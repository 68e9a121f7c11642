"""The port's BAM module (genomicsbench_palisade_tpu_torch.io.bam) against the
JAX package's (genomicsbench_palisade_tpu.io.bam) on the CPU.

tests/fixtures/indexed_bam/ holds a BAM and a .bai built by htslib's
sam_index_build.  Both readers take it whole and by region (through
htslib's index and through each package's own), and must return the same
records field by field, tags included; BAMs and indexes written by the
port must be byte-equal to the JAX package's for the same records, and
read back alike by both.  Tolerance: none (bytes and integers).
"""

import pathlib

import numpy as np
import pytest

from genomicsbench_palisade_tpu.io import bam as JB
from genomicsbench_palisade_tpu_torch.io import bam as B

BAM = str(pathlib.Path(__file__).parent / "fixtures" / "indexed_bam" / "toy.bam")
REGIONS = [(0, 500), (1, 2), (40_000, 55_000), (100_000, 100_001), (149_000, 160_000),
           (0, 160_000)]


def _same_records(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.name, a.flag, a.ref_id, a.pos, a.mapq, a.cigar, a.is_reverse) == \
            (b.name, b.flag, b.ref_id, b.pos, b.mapq, b.cigar, b.is_reverse)
        np.testing.assert_array_equal(a.seq_nt16, b.seq_nt16)
        np.testing.assert_array_equal(a.qual, b.qual)
        assert a.tags.keys() == b.tags.keys()
        for k, v in a.tags.items():
            w = b.tags[k]
            if isinstance(v, np.ndarray):
                assert v.dtype == w.dtype
                np.testing.assert_array_equal(v, w)
            else:
                assert type(v) is type(w) and v == w


def _tagged_records(seed=5, n=40, ref_len=6000):
    """Coordinate-sorted records on two references with every tag type
    the writer takes (i, f, Z, A, B arrays) and cigars with S, I, D, N, H."""
    rng = np.random.default_rng(seed)
    rows = []
    for rid in range(2):
        for i, p in enumerate(np.sort(rng.integers(0, ref_len - 200, n // 2))):
            length = int(rng.integers(1, 90))
            cig = ([("S", 2), ("M", length), ("I", 1), ("M", 3), ("D", 2), ("N", 40), ("M", 4),
                    ("H", 5)] if i % 3 == 0 else [("M", length)])
            l_seq = sum(ln for op, ln in cig if op in "MIS=X")
            tags = {"NM": int(rng.integers(0, 9)), "AS": float(np.float32(rng.normal())),
                    "RG": "grp1", "XT": "U",
                    "ZB": rng.integers(-9, 9, 3).astype(np.int16),
                    "ZF": rng.random(2).astype(np.float32)} if i % 2 else {}
            rows.append(B.BamRecord(
                name=f"t{rid}_{i}", flag=[0, 16, 256, 1024][i % 4], ref_id=rid, pos=int(p),
                mapq=int(rng.integers(0, 61)), cigar=cig,
                seq_nt16=rng.integers(0, 16, l_seq).astype(np.uint8),
                qual=rng.integers(0, 45, l_seq).astype(np.uint8), tags=tags))
    return [("chrA", ref_len), ("chrB", ref_len)], rows


@pytest.mark.parametrize("parse_tags", [False, True])
def test_read_bam_whole_equals_jax(parse_tags):
    refs, got = B.read_bam(BAM, parse_tags=parse_tags)
    jrefs, want = JB.read_bam(BAM, parse_tags=parse_tags)
    assert refs == jrefs and len(got) == 200
    _same_records(got, want)


@pytest.mark.parametrize("index", ["htslib", "own"])
@pytest.mark.parametrize("beg,end", REGIONS)
def test_read_bam_region_equals_jax(tmp_path, index, beg, end):
    kw = {}
    if index == "own":
        kw["bai_path"] = B.build_bai(BAM, str(tmp_path / "own.bai"))
    refs, got = B.read_bam_region(BAM, "tig1", beg, end, parse_tags=True, **kw)
    jrefs, want = JB.read_bam_region(BAM, "tig1", beg, end, parse_tags=True, **kw)
    assert refs == jrefs
    _same_records(got, want)
    _, whole = B.read_bam(BAM)
    assert [r.name for r in got] == [
        r.name for r in whole
        if r.pos < end and r.pos + max(B._cigar_ref_len(r.cigar), 1) > beg]


def test_bai_reader_equals_jax():
    got, want = B.read_bai(BAM + ".bai"), JB.read_bai(BAM + ".bai")
    assert len(got) == len(want)
    for (bins, lin), (jbins, jlin) in zip(got, want):
        assert bins == jbins
        np.testing.assert_array_equal(lin, jlin)


@pytest.mark.parametrize("source", ["toy", "tagged"])
def test_write_bam_and_bai_byte_equal_to_jax(tmp_path, source):
    if source == "toy":
        refs, recs = B.read_bam(BAM, parse_tags=True)
    else:
        refs, recs = _tagged_records()
    ours, theirs = tmp_path / "ours.bam", tmp_path / "theirs.bam"
    B.write_bam(str(ours), refs, recs)
    JB.write_bam(str(theirs), refs, recs)
    assert ours.read_bytes() == theirs.read_bytes()
    assert (pathlib.Path(B.build_bai(str(ours))).read_bytes()
            == pathlib.Path(JB.build_bai(str(theirs))).read_bytes())
    for reader in (B, JB):
        got_refs, got = reader.read_bam(str(ours), parse_tags=True)
        assert got_refs == refs
        _same_records(got, recs)
    for rid, (name, length) in enumerate(refs):
        _, got = B.read_bam_region(str(ours), name, length // 3, length // 2, parse_tags=True)
        _, want = JB.read_bam_region(str(theirs), name, length // 3, length // 2,
                                     parse_tags=True)
        assert got and all(r.ref_id == rid for r in got)
        _same_records(got, want)


def test_bgzf_round_trip_equals_jax():
    data = np.random.default_rng(3).integers(0, 256, 200_000).astype(np.uint8).tobytes()
    packed = B.bgzf_compress(data)
    assert packed == JB.bgzf_compress(data)
    assert B.bgzf_decompress(packed) == data == JB.bgzf_decompress(packed)
