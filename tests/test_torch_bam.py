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


def _streamed_bam(path, n_chunks=3, per_chunk=400, read_len=120, ref_len=30_000, seed=8):
    """A coordinate-sorted BAM written as tools/bam_scale_bench.py writes
    one: the header and each run of records by its own bgzf_compress call,
    so that an empty BGZF block follows the header and every run.  Returns
    the records."""
    import struct

    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(0, ref_len - read_len, n_chunks * per_chunk))
    name = b"c1\x00"
    blocks = [B.bgzf_compress(b"BAM\x01" + struct.pack("<ii", 0, 1)
                              + struct.pack("<i", len(name)) + name
                              + struct.pack("<i", ref_len))]
    recs = []
    for c in range(n_chunks):
        body = bytearray()
        for i in range(c * per_chunk, (c + 1) * per_chunk):
            seq = rng.integers(1, 16, read_len).astype(np.uint8)
            qual = rng.integers(10, 40, read_len).astype(np.uint8)
            qname = b"r%d\x00" % i
            rec = struct.pack("<iiBBHHHiiii", 0, int(pos[i]), len(qname), 60, 0, 1, 16 * (i % 2),
                              read_len, -1, -1, 0)
            rec += (qname + struct.pack("<I", read_len << 4)
                    + ((seq[0::2] << 4) | seq[1::2]).tobytes() + qual.tobytes())
            body += struct.pack("<i", len(rec)) + rec
            recs.append(B.BamRecord(f"r{i}", 16 * (i % 2), 0, int(pos[i]), 60,
                                    [("M", read_len)], seq, qual, {}))
        blocks.append(B.bgzf_compress(bytes(body)))
    pathlib.Path(path).write_bytes(b"".join(blocks))
    B.build_bai(str(path))
    return recs


def test_region_reads_cross_empty_bgzf_blocks(tmp_path):
    """An empty BGZF block inside a region's .bai window (after the header,
    between runs of records) does not end the native region decode:
    read_bam_region's native default and the fused pileup equal the Python
    decode, the JAX reader and the records that overlap each region (and
    the whole-file native decode reads every record)."""
    from genomicsbench_palisade_tpu_torch.ops import pileup as PU

    bam = tmp_path / "streamed.bam"
    recs = _streamed_bam(bam)
    raw = bam.read_bytes()
    assert raw.count(B.bgzf_compress(b"")[-28:]) == 4  # empty blocks: header, 3 runs
    _same_records(B.read_bam(str(bam))[1], recs)
    index = B.read_bai(str(bam) + ".bai")
    for beg, end in [(0, 5_000), (0, 30_000), (7_000, 12_000), (9_000, 21_000),
                     (29_000, 30_000)]:
        want = [r for r in recs if r.pos < end and r.pos + 120 > beg]
        got = B.read_bam_region(str(bam), "c1", beg, end, index=index)
        _same_records(got[1], want)
        _same_records(B.read_bam_region(str(bam), "c1", beg, end, index=index,
                                        use_native=False)[1], want)
        _same_records(JB.read_bam_region(str(bam), "c1", beg, end)[1], want)
        fused = PU.calculate_pileup_region(str(bam), "c1", beg, end, index=index)
        plain = PU.calculate_pileup(want, 0, beg, end)
        for key in ("major", "minor", "matrix"):
            np.testing.assert_array_equal(fused[key], plain[key], err_msg=key)
