"""The port's index builder on the CPU (index/builder.py with the native
SA-IS route, index/fmi_index.py's suffix-array lookups, cli/fmi_build.py):
its files are byte for byte the JAX builder's, its CLI prints the JAX
CLI's lines, its lookups equal the JAX ones.  Exact: the outputs are
integers and bytes."""

import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

from genomicsbench_palisade_tpu.cli import fmi_build as jcli
from genomicsbench_palisade_tpu.index import builder as JB
from genomicsbench_palisade_tpu.index import fmi_index as JFI
from genomicsbench_palisade_tpu.ops.oracle import fmi as JO
from genomicsbench_palisade_tpu_torch.cli import fmi_build as cli
from genomicsbench_palisade_tpu_torch.index import builder as IB
from genomicsbench_palisade_tpu_torch.index import fmi_index as FI

REPO = Path(__file__).resolve().parents[1]

TRICKY = (">c1 first contig\nNNACGTNNNACGTRACnnRRN\n>c2\nGGTTAA\n>c3 third one here\n"
          "ACGTYYYYACGTNNNN\n>c4\nNRN\n")


def _genome_fasta(path: Path, seed: int, n_bases=6000, n_contigs=3):
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke.write_genome_fasta(path, n_bases, n_contigs, 4, np.random.default_rng(seed))


def _npz_members(path: Path) -> dict:
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


@pytest.mark.parametrize("text", [TRICKY, None])
def test_pack_fasta_with_holes_equals_jax(tmp_path, text):
    fa = tmp_path / "ref.fa"
    if text is None:
        _genome_fasta(fa, 3)
    else:
        fa.write_text(text)
    for holes in (False, True):
        got, want = IB.pack_fasta(str(fa), with_holes=holes), JB.pack_fasta(str(fa), with_holes=holes)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and got[2].tolist() == want[2].tolist()
        if holes:
            assert got[3] == want[3] and len(got[3]) >= 5


@pytest.mark.parametrize("bwt2bit,bntseq", [(True, True), (False, False)])
@pytest.mark.parametrize("fasta", ["tricky", "genome"])
def test_files_are_the_jax_builders_bytes(tmp_path, bwt2bit, bntseq, fasta):
    fa = tmp_path / "ref.fa"
    if fasta == "tricky":
        fa.write_text(TRICKY)
    else:
        _genome_fasta(fa, 5)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    idx, names, lengths = IB.build_from_fasta(str(fa), ours, bwt2bit, bntseq, device="cpu")
    jidx, jnames, jlengths = JB.build_from_fasta(str(fa), theirs, bwt2bit, bntseq)
    assert names == jnames and lengths.tolist() == jlengths.tolist()
    assert _npz_members(Path(ours + ".npz")) == _npz_members(Path(theirs + ".npz"))
    suffixes = [".bwt.2bit.64"] * bwt2bit + [".ann", ".amb", ".pac"] * bntseq
    for suffix in suffixes:
        assert Path(ours + suffix).read_bytes() == Path(theirs + suffix).read_bytes(), suffix
    for suffix in {".bwt.2bit.64", ".ann", ".amb", ".pac"} - set(suffixes):
        assert not Path(ours + suffix).exists()
    back = FI.load_bwt2bit64(ours + ".bwt.2bit.64", load_sa=True) if bwt2bit else None
    if back is not None:
        np.testing.assert_array_equal(back.cp_occ, idx.cp_occ)
        np.testing.assert_array_equal(back.sa_ls_word, idx.sa_ls_word)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 777, 3000])
@pytest.mark.parametrize("sa_compression", [False, True])
def test_sais_route_equals_doubling_route(n, sa_compression):
    codes = np.random.default_rng(n).integers(0, 4, n).astype(np.uint8)
    stats = {}
    host = IB.build_arrays(codes, sa_compression, device="cpu", sa_engine="sais", stats=stats)
    dev = IB.build_arrays(codes, sa_compression, device="cpu")
    assert (host.ref_seq_len, host.sentinel_index) == (dev.ref_seq_len, dev.sentinel_index)
    for key in ("count", "cp_occ", "sa_ms_byte", "sa_ls_word"):
        np.testing.assert_array_equal(getattr(host, key), getattr(dev, key), key)
    assert stats["sa_s"] >= 0 and stats["rest_s"] >= 0
    with pytest.raises(ValueError, match="sa_engine"):
        IB.build_arrays(codes, device="cpu", sa_engine="gpu")


def test_cli_prints_the_jax_clis_lines(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("GENOMICS_TPU_CACHE_DIR", str(tmp_path / "xla"))
    fa = tmp_path / "ref.fa"
    _genome_fasta(fa, 7)
    stats = {}
    assert cli.main([str(fa), "-p", str(tmp_path / "a"), "--bwt2bit", "--bntseq",
                     "--device", "cpu"], stats=stats) == 0
    out = capsys.readouterr()
    assert jcli.main([str(fa), "-p", str(tmp_path / "b"), "--bwt2bit", "--bntseq"]) == 0
    jout = capsys.readouterr()
    assert out.out.replace(str(tmp_path / "a"), "P") == jout.out.replace(str(tmp_path / "b"), "P")
    assert out.out.count("\n* count[") == 5 and out.err.startswith("* Build time: ")
    assert set(stats) == {"pack_s", "sa_s", "rest_s", "write_s"}
    assert _npz_members(tmp_path / "a.npz") == _npz_members(tmp_path / "b.npz")
    for suffix in (".bwt.2bit.64", ".ann", ".amb", ".pac"):
        assert (tmp_path / f"a{suffix}").read_bytes() == (tmp_path / f"b{suffix}").read_bytes()
    # the default prefix is the FASTA's path
    assert cli.main([str(fa), "--device", "cpu"]) == 0
    assert (tmp_path / "ref.fa.npz").exists() and "* Index prefix: " + str(fa) in \
        capsys.readouterr().out


@pytest.fixture(scope="module")
def lookup_indexes():
    codes = np.random.default_rng(3).integers(0, 4, 777).astype(np.uint8)
    return {comp: (IB.build_arrays(codes, comp, device="cpu", sa_engine="sais"),
                   JB.build_arrays(codes, sa_compression=comp))
            for comp in (False, True)}


@pytest.mark.parametrize("comp", [False, True])
def test_sa_lookups_equal_jax(lookup_indexes, comp):
    idx, jidx = lookup_indexes[comp]
    rows = np.arange(idx.ref_seq_len)
    want = JFI.get_sa_entries(jidx, rows)
    np.testing.assert_array_equal(FI.get_sa_entries(idx, rows), want)
    for pos in list(range(0, 40)) + [100, 555, idx.ref_seq_len - 1, idx.sentinel_index]:
        assert FI.get_sa_entry(idx, pos) == JFI.get_sa_entry(jidx, pos) == want[pos]
    for pp in range(0, idx.ref_seq_len + 1, 7):
        for c in range(4):
            assert FI.host_occ(idx, pp, c) == JFI.host_occ(jidx, pp, c), (pp, c)
    assert [FI.host_bwt_char(idx, p) for p in rows] == [JFI.host_bwt_char(jidx, p) for p in rows]
    ks, ss = [0, 5, 100, 700, 1500], [3, 40, 1, 0, 17]
    for max_occ in (1, 4, 16):
        got = FI.get_sa_entries_smems(idx, ks, ss, max_occ)
        exp = JFI.get_sa_entries_smems(jidx, ks, ss, max_occ)
        np.testing.assert_array_equal(got[0], exp[0])
        np.testing.assert_array_equal(got[1], exp[1])
        assert got[1].dtype == np.int32 and got[0].dtype == np.int64


def test_sa_entries_smems_locate_a_read():
    """An exact read's SMEM coordinates include its true position
    (tests/test_index_builder.py's check, on the port's index)."""
    rng = np.random.default_rng(4)
    seq = "".join(rng.choice(list("ACGT"), 2000))
    codes = IB._CODE_TABLE[np.frombuffer(seq.encode(), np.uint8)]
    didx = IB.build_arrays(codes, sa_compression=True, device="cpu", sa_engine="sais")
    smems = JO.get_smems_all_pos(JO.build_index(seq),
                                 np.array([JO._CODE[c] for c in seq[700:780]], np.int64),
                                 min_intv=1, min_seed_len=19)
    coords, counts = FI.get_sa_entries_smems(didx, [m["k"] for m in smems],
                                             [m["s"] for m in smems], max_occ=16)
    assert counts.sum() == len(coords) and 700 in coords.tolist()
    with pytest.raises(ValueError, match="no SA arrays"):
        FI.get_sa_entry(FI.build_from_sequence("ACGTACGT"), 3)


def test_builder_raises_without_cuda_unless_told_the_cpu(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa = tmp_path / "ref.fa"
    fa.write_text(TRICKY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(fa), "-p", str(tmp_path / "x")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IB.build_from_fasta(str(fa), str(tmp_path / "x"))
    assert not (tmp_path / "x.npz").exists()
    IB.build_from_fasta(str(fa), str(tmp_path / "x"), device="cpu")
    assert (tmp_path / "x.npz").exists()
