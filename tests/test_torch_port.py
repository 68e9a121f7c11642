"""The port's host layers, CLI and package rules (genomicsbench_palisade_tpu_torch),
on the CPU: parsing, bucketing and batch packing equal the JAX package's;
the CLI prints the JAX CLI's lines (within 1e-5, the tolerance of
tests/test_torch_phmm.py) and exactly the port oracle's; the package
imports no JAX; entry points raise without a GPU unless told the CPU."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu.io import bucketing as JB
from genomicsbench_palisade_tpu.io import phmm_batch as JPB
from genomicsbench_palisade_tpu.ops import phmm as JP
from genomicsbench_palisade_tpu_torch import default_device
from genomicsbench_palisade_tpu_torch.cli import abea as cli_abea
from genomicsbench_palisade_tpu_torch.cli import bsw as cli_bsw
from genomicsbench_palisade_tpu_torch.cli import chain as cli_chain
from genomicsbench_palisade_tpu_torch.cli import fmi as cli_fmi
from genomicsbench_palisade_tpu_torch.cli import phmm as cli
from genomicsbench_palisade_tpu_torch.convert import (abea_batch_from_numpy, batch_from_numpy,
                                                      bsw_batch_from_numpy, chain_batch_from_numpy,
                                                      tables_from_numpy)
from genomicsbench_palisade_tpu_torch.io import bucketing as B
from genomicsbench_palisade_tpu_torch.io import chain_dump
from genomicsbench_palisade_tpu_torch.io import pairs as bsw_pairs
from genomicsbench_palisade_tpu_torch.io import phmm_batch as PB
from genomicsbench_palisade_tpu_torch.ops import abea as AB
from genomicsbench_palisade_tpu_torch.ops import abea_cuda
from genomicsbench_palisade_tpu_torch.ops import bsw as W
from genomicsbench_palisade_tpu_torch.ops import bsw_cuda
from genomicsbench_palisade_tpu_torch.ops import chain as CH
from genomicsbench_palisade_tpu_torch.ops import chain_cuda
from genomicsbench_palisade_tpu_torch.ops import phmm as P
from genomicsbench_palisade_tpu_torch.ops import phmm_cuda
from genomicsbench_palisade_tpu_torch.ops.oracle import phmm as O
from genomicsbench_palisade_tpu_torch.ops import bsw_stripped, chain_micro, occ_gather
from genomicsbench_palisade_tpu_torch.tools import bsw_idle_timing as bsw_idle
from genomicsbench_palisade_tpu_torch.tools import bsw_roofline as bsw_probe
from genomicsbench_palisade_tpu_torch.tools import chain_roofline as chain_probe
from genomicsbench_palisade_tpu_torch.tools import occ_gather_experiment as occ_tool
from genomicsbench_palisade_tpu_torch.utils import build, profiling

REPO = Path(__file__).resolve().parents[1]


def _q33(arr):
    return "".join(chr(int(v) + 33) for v in arr)


def _write_testfile(path, seed, n_batches=3, max_reads=5, max_haps=4):
    """A small testfile in the reference benchmark's format; half the reads
    come from a hap (high likelihood), lowercase and N bases included."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n_batches):
            nr, nh = int(rng.integers(1, max_reads + 1)), int(rng.integers(1, max_haps + 1))
            haps = ["".join("ACGTNacgt"[c] for c in rng.integers(0, 9, int(rng.integers(20, 60))))
                    for _ in range(nh)]
            f.write(f"{nr} {nh}\n")
            for _ in range(nr):
                rl = int(rng.integers(5, 19))
                if rng.random() < 0.5:
                    s = int(rng.integers(0, len(haps[0]) - rl))
                    bases = haps[0][s : s + rl].upper()
                else:
                    bases = "".join("ACGT"[c] for c in rng.integers(0, 4, rl))
                f.write(f"{bases} {_q33(rng.integers(0, 41, rl))} {_q33(rng.integers(25, 46, rl))} "
                        f"{_q33(rng.integers(25, 46, rl))} {_q33(np.full(rl, 10))}\n")
            for h in haps:
                f.write(h + "\n")


def test_parse_testfile_matches_jax(tmp_path):
    tf = tmp_path / "t.txt"
    _write_testfile(tf, seed=0, n_batches=4)
    got, want = PB.parse_testfile(tf), JPB.parse_testfile(tf)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.id == w.id and g.pairs == w.pairs
        assert len(g.reads) == len(w.reads) and len(g.haps) == len(w.haps)
        for gr, wr in zip(g.reads, w.reads):
            for k in ("bases", "q", "i", "d", "c"):
                np.testing.assert_array_equal(gr[k], wr[k])
                assert gr[k].dtype == wr[k].dtype
        for gh, wh in zip(g.haps, w.haps):
            np.testing.assert_array_equal(gh, wh)
    with open(tf) as fh:
        assert [b.pairs for b in PB.parse_testfile(fh)] == [b.pairs for b in got]


@pytest.mark.parametrize("edges", [B.DEFAULT_EDGES, (64, 128, 256, 512)])
def test_group_by_buckets_matches_jax(edges):
    rng = np.random.default_rng(1)
    items = [(int(a), int(b)) for a, b in rng.integers(1, 500, (200, 2))]
    assert B.group_by_buckets(items, lambda t: t, edges) == JB.group_by_buckets(items, lambda t: t, edges)
    assert B.group_by_buckets(items, lambda t: t[0], edges) == JB.group_by_buckets(
        items, lambda t: t[0], edges)
    assert B.bucket_size(65, edges) == JB.bucket_size(65, edges)
    with pytest.raises(ValueError):
        B.bucket_size(10**6, edges)


@pytest.mark.parametrize("pads", [(None, None), (64, 128)])
def test_prepare_batch_matches_jax(tmp_path, pads):
    tf = tmp_path / "t.txt"
    _write_testfile(tf, seed=2, n_batches=3)
    reads, haps, pairs = [], [], []
    for bt in PB.parse_testfile(tf):
        r0, h0 = len(reads), len(haps)
        reads += bt.reads
        haps += bt.haps
        pairs += [(r0 + r, h0 + h) for r, h in bt.pairs]
    pairs = pairs[::-1]  # order and repeats must not matter
    got = P.prepare_batch(reads, haps, pairs, *pads)
    want = JP.prepare_batch(reads, haps, pairs, *pads, transposed=False)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].astype(np.int64), want[k].astype(np.int64))
    assert got["rs_row"].dtype == got["q"].dtype == got["hap"].dtype == np.int8
    assert got["rslen"].dtype == got["haplen"].dtype == np.int32
    with pytest.raises(ValueError):
        P.prepare_batch(reads, haps, pairs, r_pad=4)


def test_convert_carries_jax_batch_and_tables():
    """A JAX prepare_batch dict (int32 quals, *_t planes) carried across
    gives the same raw results as the port's own batch."""
    rng = np.random.default_rng(3)
    reads = [{"bases": rng.integers(0, 5, 12), **{k: rng.integers(0, 127, 12) for k in "qidc"}}
             for _ in range(6)]
    haps = [rng.integers(0, 5, 20) for _ in range(3)]
    pairs = [(r, h) for r in range(6) for h in range(3)]
    jb = JP.prepare_batch(reads, haps, pairs)
    tb = batch_from_numpy(jb, "cpu")
    assert set(tb) == {"rs_row", "q", "i", "d", "c", "hap", "rslen", "haplen"}
    assert tb["q"].dtype == torch.int8 and tb["rslen"].dtype == torch.int32
    np.testing.assert_array_equal(tb["q"].numpy().astype(np.int64) & 127, jb["q"] & 127)
    own = P.phmm_forward_plain(P.prepare_batch(reads, haps, pairs), torch.float32, "cpu")
    assert torch.equal(P.phmm_forward_plain(tb, torch.float32), own)
    tabs = tables_from_numpy(P.tables(np.float64), "cpu")
    assert tabs["m2m"].dtype == torch.float64
    np.testing.assert_array_equal(tabs["ph2pr"].numpy(), O.get_ctx(np.float64).ph2pr)


def _likelihood_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("i: ")]


def test_cli_matches_jax_cli_and_oracle(tmp_path, capsys, monkeypatch):
    from genomicsbench_palisade_tpu.cli import phmm as jax_cli

    tf = tmp_path / "t.txt"
    _write_testfile(tf, seed=4, n_batches=3)
    assert cli.main(["-f", str(tf), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    monkeypatch.setenv("GENOMICS_TPU_CACHE_DIR", str(tmp_path / "xla"))
    assert jax_cli.main(["-f", str(tf)]) == 0
    jout = capsys.readouterr().out
    got, want = _likelihood_lines(out), _likelihood_lines(jout)
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert g.split(";")[0] == w.split(";")[0]
        assert abs(float(g.rsplit(" ", 1)[1]) - float(w.rsplit(" ", 1)[1])) <= 1e-5 + 1e-6
    assert "PairHMM completed. Kernel runtime:" in out.splitlines()[-1]
    expected = []
    for bt in PB.parse_testfile(tf):
        for i, (r, h) in enumerate(bt.pairs):
            rd = bt.reads[r]
            v = O.compute_likelihood(rd["bases"], bt.haps[h], rd["q"], rd["i"], rd["d"], rd["c"])
            expected.append(f"i: {i}; result_final: {v:f}")
    assert got == expected


def test_run_testcases_keeps_what_each_pass_gave(tmp_path):
    """`keep` holds, per bucket, the tensors each pass was given and its raw
    outputs; they equal the plain versions and cover every testcase."""
    tf = tmp_path / "t.txt"
    _write_testfile(tf, seed=7, n_batches=2)
    reads, haps, pairs = [], [], []
    for bt in PB.parse_testfile(tf):
        r0, h0 = len(reads), len(haps)
        reads += bt.reads
        haps += bt.haps
        pairs += [(r0 + r, h0 + h) for r, h in bt.pairs]
    # a read of 30 mismatches at q 60 underflows f32: the f64 pass takes it
    reads.append({"bases": np.zeros(30, np.int64), **{k: np.full(30, 60) for k in "qidc"}})
    haps.append(np.ones(40, np.int64))
    pairs.append((len(reads) - 1, len(haps) - 1))
    stats, keep = {}, []
    res = cli.run_testcases(reads, haps, pairs, device="cpu", stats=stats, keep=keep)
    assert sum(len(k["raw_f32"]) for k in keep) == len(pairs)
    n_f64 = 0
    for k in keep:
        assert set(k["bucket"]) <= set(cli.PHMM_EDGES)
        assert torch.equal(torch.from_numpy(k["raw_f32"]),
                           P.phmm_forward_plain(k["batch"], torch.float32))
        if k["raw_f64"] is not None:
            n_f64 += len(k["raw_f64"])
            assert torch.equal(torch.from_numpy(k["raw_f64"]),
                               P.phmm_forward_plain(k["f64_batch"], torch.float64))
    assert n_f64 == stats["fallback"] >= 1
    rd = reads[-1]
    assert res[-1] == O.compute_likelihood(rd["bases"], haps[-1], rd["q"], rd["i"], rd["d"], rd["c"])
    assert np.isfinite(res).all()


def test_cli_quiet_and_trace_dir(tmp_path, capsys):
    tf = tmp_path / "t.txt"
    _write_testfile(tf, seed=5, n_batches=2)
    assert cli.main(["-f", str(tf), "--device", "cpu", "--quiet",
                     "--trace-dir", str(tmp_path / "trace")]) == 0
    out = capsys.readouterr().out
    assert not _likelihood_lines(out) and "PairHMM completed" in out
    assert (tmp_path / "trace" / "phmm_kernel.json").stat().st_size > 0


def test_import_without_jax():
    """Every module of the port (and chip_smoke.py) imports with jax
    blocked, and none of the JAX package's modules gets loaded."""
    code = r"""
import importlib, pkgutil, sys
class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked")
sys.meta_path.insert(0, BlockJax())
import genomicsbench_palisade_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = [m for m in sys.modules if m == "genomicsbench_palisade_tpu"
       or m.startswith("genomicsbench_palisade_tpu.") or m.split(".")[0] in ("jax", "jaxlib")]
assert not bad, bad
assert "genomicsbench_palisade_tpu_torch.ops.phmm_cuda" in names, names
assert "genomicsbench_palisade_tpu_torch.ops.bsw_cuda" in names, names
assert "genomicsbench_palisade_tpu_torch.ops.chain_cuda" in names, names
assert "genomicsbench_palisade_tpu_torch.ops.abea_cuda" in names, names
for n in ("cli.fmi", "ops.fmi", "ops.fmi_pipeline", "ops.occ_gather", "ops.oracle.fmi",
          "index.builder", "index.fmi_index", "tools.occ_gather_experiment",
          "ops.bsw_stripped", "ops.chain_micro", "tools.bsw_roofline", "tools.chain_roofline",
          "tools.bsw_idle_timing", "tools.probe_lanes", "io.plink", "ops.grm", "cli.grm",
          "models.bonito", "models.clair", "io.flax_msgpack", "cli.basecall", "cli.call_var",
          "utils.precision"):
    assert "genomicsbench_palisade_tpu_torch." + n in names, n
print("ok", len(names))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reads = [{"bases": np.array([0, 1, 2]), **{k: np.full(3, 30) for k in "qidc"}}]
    batch = P.prepare_batch(reads, [np.array([0, 1, 2, 3])], [(0, 0)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.phmm_forward(batch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.phmm_likelihoods(batch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run_testcases(reads, [np.array([0, 1, 2, 3])], [(0, 0)])
    tf = tmp_path / "t.txt"
    _write_testfile(tf, seed=6, n_batches=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-f", str(tf)])
    pairs = [(np.array([0, 1, 2], np.int8), np.array([0, 1, 2, 3], np.int8), 10)]
    pf = tmp_path / "pairs.txt"
    pf.write_text("10\n0123\n012\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_bsw.score_pairs(pairs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_bsw.score_pairs_soa(bsw_pairs.parse_pairs_soa(pf))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_bsw.main(["-pairs", str(pf)])
    cf = tmp_path / "calls.txt"
    cf.write_text("2 20.0 5000 5000 500 1\n100 64424509490\n150 64424509540\nEOR\n")
    calls = chain_dump.parse_chain_dump(cf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_chain.run_calls(calls)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CH.chain_calls([CH.prepare_call(calls[0].x, calls[0].y, 20.0)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_chain.main(["-i", str(cf), "-o", str(tmp_path / "out.txt")])
    assert not (tmp_path / "out.txt").exists()
    model = _abea_model()
    fa, npz, tsv = _abea_files(tmp_path, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AB.align_events_batch(["ACGTACGTAC"], [np.full(6, 90.0, np.float32)], model, [1.0], [0.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_abea.main(["--reads", str(fa), "--raw", str(npz), "--model", str(tsv),
                       "-o", str(tmp_path / "abea.tsv")])
    assert not (tmp_path / "abea.tsv").exists()
    gfa, fq = tmp_path / "g.fa", tmp_path / "q.fq"
    gfa.write_text(">g\nACGTTGCAACGGTACCATGATTACAGGCATTACCGAT\n")
    fq.write_text("@q\nGTTGCAACGGTACCATGA\n+\nIIIIIIIIIIIIIIIIII\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_fmi.main([str(gfa), str(fq)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_fmi.prepare(str(gfa), str(fq))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        occ_tool.main([])
    for probe in (bsw_probe, chain_probe, bsw_idle):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probe.main([])
    # grm and the two NN drivers
    from genomicsbench_palisade_tpu_torch.cli import basecall as cli_basecall
    from genomicsbench_palisade_tpu_torch.cli import call_var as cli_call_var
    from genomicsbench_palisade_tpu_torch.cli import grm as cli_grm
    from genomicsbench_palisade_tpu_torch.io.plink import write_bed
    from genomicsbench_palisade_tpu_torch.ops import grm as G

    geno = np.array([[0, 1, 2, 3], [2, 2, 1, 0], [1, 0, 0, 1]], np.int8)
    write_bed(str(tmp_path / "g"), geno)
    np.savez(tmp_path / "sig.npz", r0=np.random.default_rng(0).normal(90, 5, 900).astype(np.float32))
    np.savez(tmp_path / "x.npz", X=np.zeros((2, 33, 8, 4), np.float32))
    entry_points = (
        lambda: G.compute_grm(geno),
        lambda: cli_grm.main(["--bfile", str(tmp_path / "g"), "--out", str(tmp_path / "o")]),
        lambda: cli_basecall.main(["random", str(tmp_path / "sig.npz")]),
        lambda: cli_call_var.main(["--input_fn", str(tmp_path / "x.npz"),
                                   "--output_fn", str(tmp_path / "p.npz")]))
    for call in entry_points:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "o.grm.bin").exists() and not (tmp_path / "p.npz").exists()
    assert cli_grm.main(["--bfile", str(tmp_path / "g"), "--out", str(tmp_path / "o"),
                         "--device", "cpu"]) == 0
    assert (tmp_path / "o.grm.N.bin").stat().st_size == 4 * 10
    assert cli_call_var.main(["--input_fn", str(tmp_path / "x.npz"), "--output_fn",
                              str(tmp_path / "p.npz"), "--device", "cpu"]) == 0
    assert np.load(tmp_path / "p.npz")["gt21"].shape == (2, 21)
    # told the CPU, they run
    prep = cli_fmi.prepare(str(gfa), str(fq), "cpu")
    smems = cli_fmi.run(prep.index, prep.enc, prep.rl, 1, 10)[0][0]
    # the read is genome[2:20]: its whole-read SMEM, and the LAST seed that
    # ends once 11 bases (min_seed_len + 1) occur fewer than 20 times
    assert (smems["m"].tolist(), smems["n"].tolist()) == ([0, 0], [17, 10])
    assert cli_abea.main(["--reads", str(fa), "--raw", str(npz), "--model", str(tsv),
                          "-o", str(tmp_path / "abea.tsv"), "--device", "cpu"]) == 0
    assert (tmp_path / "abea.tsv").read_text().count("\nr0\t") > 20
    assert np.isfinite(P.phmm_likelihoods(batch, "cpu")).all()
    assert cli_bsw.score_pairs(pairs, device="cpu")["score"].tolist() == [13]
    assert cli_chain.main(["-i", str(cf), "-o", str(tmp_path / "out.txt"), "--device", "cpu"]) == 0
    # y = 15 << 32 | q: the second anchor chains to the first (tests/test_chain_jax.py:48)
    assert (tmp_path / "out.txt").read_text() == "2\n15\t-1\n30\t0\nEOR\n"


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never falls back: CPU tensors are refused before
    any build or launch."""
    reads = [{"bases": np.array([0, 1]), **{k: np.full(2, 30) for k in "qidc"}}]
    tb = P.as_device_batch(P.prepare_batch(reads, [np.array([0, 1])], [(0, 0)]), "cpu")
    kern = phmm_cuda.phmm_forward_f32
    before = kern.launches
    with pytest.raises(ValueError, match="CUDA"):
        kern(tb, P.device_tables(torch.float32, "cpu"), P.device_init_y(torch.float32, "cpu", 2))
    assert kern.launches == before
    assert phmm_cuda.KERNELS[torch.float64].name == "phmm_forward_f64"
    # the roofline probes' kernels
    z = torch.zeros((8, 4), dtype=torch.int32)
    zc = torch.zeros(4, dtype=torch.int32)
    for kern, args in ((bsw_stripped.bsw_stripped_cuda, (z, z, z, z)),
                       (chain_micro.chain_micro_cuda, (z.T.contiguous(), z.T.contiguous(),
                                                       z.T.contiguous(), zc, zc, 64, 500))):
        before = kern.launches
        with pytest.raises(ValueError, match="CUDA"):
            kern(*args)
        assert kern.launches == before


def test_bsw_cuda_wrapper_rejects_cpu_tensors():
    """The bsw kernel wrapper never falls back either: CPU tensors are
    refused before any build or launch, and `ops.bsw.bsw_extend` sends them
    to the plain version instead."""
    tb, ptuple = bsw_batch_from_numpy(
        W.prepare_pairs([(np.array([0, 1]), np.array([0, 1, 2]), 5)]), "cpu")
    kern = bsw_cuda.bsw_extend
    before = kern.launches
    with pytest.raises(ValueError, match="CUDA"):
        kern(tb, ptuple)
    assert kern.launches == before
    assert torch.equal(W.bsw_extend(tb, ptuple), W.bsw_extend_plain(tb, ptuple))
    assert kern.launches == before
    assert build.library_path(bsw_cuda.SOURCE).name.startswith("libbsw_extend-")


def test_chain_cuda_wrapper_rejects_cpu_tensors():
    """The chain kernel wrapper never falls back either: CPU tensors are
    refused before any build or launch, and `ops.chain.chain_dp` sends them
    to the plain version instead."""
    x = np.array([100, 150, 160], np.uint64)
    y = (np.uint64(15) << np.uint64(32)) | np.array([50, 100, 105], np.uint64)
    tb, params = chain_batch_from_numpy([CH.prepare_call(x, y, 20.0)], "cpu")
    kern = chain_cuda.chain_dp
    before = kern.launches
    with pytest.raises(ValueError, match="CUDA"):
        kern(tb, params)
    assert kern.launches == before
    assert torch.equal(CH.chain_dp(tb, params), CH.chain_dp_plain(tb, params))
    assert kern.launches == before
    assert build.library_path(chain_cuda.SOURCE).name.startswith("libchain_dp-")


def _abea_model():
    rng = np.random.default_rng(8)
    model = {"level_mean": rng.normal(90, 12, 4096).astype(np.float32),
             "level_stdv": (rng.random(4096) * 2 + 1).astype(np.float32)}
    model["level_log_stdv"] = np.log(model["level_stdv"]).astype(np.float32)
    return model


def _abea_files(tmp_path, model):
    """One read of 60 bases, its raw signal (10 samples a k-mer at the
    model's level) and the model as a TSV."""
    rng = np.random.default_rng(9)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 60))
    ranks = AB.kmer_ranks(seq, 6, 55)
    raw = np.repeat(model["level_mean"][ranks], 10) + rng.normal(0, 0.5, 550)
    fa, npz, tsv = tmp_path / "r.fa", tmp_path / "s.npz", tmp_path / "m.tsv"
    fa.write_text(f">r0\n{seq}\n")
    np.savez(npz, r0=raw.astype(np.float32))
    with open(tsv, "w") as f:
        f.write("kmer\tlevel_mean\tlevel_stdv\n")
        for r in range(4096):
            kmer = "".join("ACGT"[(r >> (2 * (5 - j))) & 3] for j in range(6))
            f.write(f"{kmer}\t{model['level_mean'][r]:.3f}\t{model['level_stdv'][r]:.3f}\n")
    return fa, npz, tsv


def test_abea_cuda_wrappers_reject_cpu_tensors():
    """The abea kernel wrappers never fall back either: CPU tensors are
    refused before any build or launch, and `ops.abea.abea_fill`/`abea_walk`
    send them to the plain versions instead."""
    model = _abea_model()
    seq = "ACGTACGTACGTAC"
    ev = model["level_mean"][AB.kmer_ranks(seq, 6, 9)].repeat(2)
    tb = abea_batch_from_numpy(AB.prepare_batch([seq], [ev], model, [1.0], [0.0])[0], "cpu")
    fill_k, walk_k = abea_cuda.abea_fill, abea_cuda.abea_walk
    before = (fill_k.launches, walk_k.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fill_k(tb)
    fill = AB.abea_fill(tb)
    with pytest.raises(ValueError, match="CUDA"):
        walk_k(tb, fill)
    walk = AB.abea_walk(tb, fill)
    assert (fill_k.launches, walk_k.launches) == before
    assert all(torch.equal(fill[k], v) for k, v in AB.abea_fill_plain(tb).items())
    assert all(torch.equal(walk[k], v) for k, v in AB.abea_walk_plain(tb, fill).items())
    assert walk["n"].item() == 18
    assert build.library_path(abea_cuda.FILL_SOURCE).name.startswith("libabea_fill-")
    assert build.library_path(abea_cuda.WALK_SOURCE).name.startswith("libabea_walk-")


def test_occ_gather_wrappers_reject_cpu_tensors():
    """The occ-gather kernel wrappers never fall back either: CPU tensors are
    refused before any build or launch, and the dispatchers send them to the
    plain versions instead."""
    table = torch.arange(8 * 16 * 8, dtype=torch.int64).view(-1, 8)
    idx = torch.tensor([3, 9, 3, 127], dtype=torch.int32)
    before = [k.launches for k in occ_gather.KERNELS]
    with pytest.raises(ValueError, match="CUDA"):
        occ_gather.occ_gather_row_cuda(table, idx, 8)
    with pytest.raises(ValueError, match="CUDA"):
        occ_gather.occ_gather_tile_cuda(table, idx)
    assert torch.equal(occ_gather.occ_gather_row(table, idx), table[9] ^ table[127])
    assert torch.equal(occ_gather.occ_gather_tile(table, idx),
                       (table[8:16] ^ table[120:128]).reshape(-1))
    assert [k.launches for k in occ_gather.KERNELS] == before
    assert build.library_path(occ_gather.SOURCE).name.startswith("libocc_gather-")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "CUDA_HOMES", ())
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(phmm_cuda.SOURCE)
    assert not (tmp_path / "build").exists()
    # the library name follows the source and the flags
    assert build.library_path(phmm_cuda.SOURCE).name.startswith("libphmm_forward-")
    assert "-fmad=false" in build.NVCC_FLAGS and "--use_fast_math" not in build.NVCC_FLAGS


def test_profiling_noop_when_disabled(monkeypatch):
    monkeypatch.delenv(profiling.ENV_VAR, raising=False)
    with profiling.roi(), profiling.annotate("x"):
        y = torch.ones(3) * 2
    assert float(y.sum()) == 6.0
