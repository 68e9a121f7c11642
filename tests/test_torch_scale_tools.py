"""The port's measurement harnesses, on the CPU, each case cheap: the six
scale benches, genome_scale_fmi, fmi_pack_ab, bench_all and bench
(genomicsbench_palisade_tpu_torch/tools/), against the JAX system's tools
in tools/ and bench.py.

For each tool:
  * its generators give the JAX tool's bytes or arrays for the same seed
    and arguments, at its smoke sizes and at chip_smoke.py's arguments
    (which import them); bench_all's and bench's inputs are caught where
    the JAX benches hand them to their first kernel or engine, which the
    test replaces;
  * `main` at its smoke size on the CPU returns 0, prints the JAX tool's
    keys (read from the JAX source, or from its own run for bsw and chain,
    whose counts must agree), its parity keys are true, and it writes no
    file unless `--out` names one;
  * without a card and without `--device cpu` it raises.
The JAX abea tool is never run (interpret-mode Pallas: minutes here).
"""

from __future__ import annotations

import ast
import contextlib
import functools
import importlib.util
import io
import json
import os
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
from genomicsbench_palisade_tpu_torch.index.builder import pack_fasta
from genomicsbench_palisade_tpu_torch.io.native import fmi_search_native
from genomicsbench_palisade_tpu_torch.index import fmi_index as FI
from genomicsbench_palisade_tpu_torch.ops import chain as C
from genomicsbench_palisade_tpu_torch.ops import phmm as P
from genomicsbench_palisade_tpu_torch.tools import abea_scale_bench as AB
from genomicsbench_palisade_tpu_torch.tools import bench as BE
from genomicsbench_palisade_tpu_torch.tools import bench_all as BA
from genomicsbench_palisade_tpu_torch.tools import bsw_scale_bench as BS
from genomicsbench_palisade_tpu_torch.tools import chain_scale_bench as CS
from genomicsbench_palisade_tpu_torch.tools import fmi_pack_ab as PA
from genomicsbench_palisade_tpu_torch.tools import genome_scale_fmi as GF
from genomicsbench_palisade_tpu_torch.tools import kmer_scale_bench as KS
from genomicsbench_palisade_tpu_torch.tools import phmm_scale_bench as PS
from genomicsbench_palisade_tpu_torch.tools import poa_scale_bench as POS

REPO = Path(__file__).resolve().parents[1]
PHMM_KEYS = ("rs_row", "q", "i", "d", "c", "hap", "rslen", "haplen")


@contextlib.contextmanager
def tools_on_path():
    """tools/ on sys.path, as the JAX tools run (they import each other)."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        yield
    finally:
        sys.path.remove(str(REPO / "tools"))


def jax_tool(name, where="tools"):
    """<where>/<name>.py of the JAX system as a module."""
    with tools_on_path():
        spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                      REPO / where / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def run_jax_main(name, argv):
    with tools_on_path():
        return run_main(jax_tool(name).main, argv)


def run_main(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]


def literal_keys(node, marker) -> list:
    """The key sets of the dict literals under `node` that hold `marker`
    (error and note lines left out)."""
    found = []
    for d in ast.walk(node):
        if isinstance(d, ast.Dict):
            keys = {k.value for k in d.keys if isinstance(k, ast.Constant)}
            if marker in keys and not keys & {"error", "note"}:
                found.append(keys)
    return found


def jax_source(path):
    return ast.parse((REPO / path).read_text())


def jax_keys(path, marker="tool", having=None) -> set:
    """The keys of the JAX tool's printed line: its one dict literal with
    `marker` (and `having`, where it prints two)."""
    sets = [k for k in literal_keys(jax_source(path), marker) if having is None or having in k]
    assert len(sets) == 1, sets
    return sets[0]


def jax_bench_keys(name) -> set:
    """The keys of tools/bench_all.py's `name` line: its dict literal and
    the keys its function then sets one by one in the dict's variable."""
    fn = next(n for n in ast.walk(jax_source("tools/bench_all.py"))
              if isinstance(n, ast.FunctionDef) and n.name == name)
    (keys,) = literal_keys(fn, "kernel")
    assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
    var = {t.id for n in assigns if isinstance(n.value, ast.Dict) and keys <= {
        k.value for k in n.value.keys if isinstance(k, ast.Constant)} for t in n.targets}
    for node in assigns:
        keys |= {t.slice.value for t in node.targets
                 if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                 and t.value.id in var}
    return keys


@pytest.fixture
def no_files(tmp_path, monkeypatch):
    """Run in an empty directory with temporary files in another; both must
    be empty at the end."""
    cwd, tmp = tmp_path / "cwd", tmp_path / "tmp"
    cwd.mkdir()
    tmp.mkdir()
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    yield
    assert not list(cwd.iterdir()) and not list(tmp.iterdir())


@pytest.mark.parametrize("main, argv", [
    (PS.main, ["--smoke"]), (BS.main, ["--smoke"]), (CS.main, ["--smoke"]),
    (AB.main, ["--smoke"]), (KS.main, ["--smoke"]), (POS.main, ["--smoke"]),
    (GF.main, ["--mbp", "1"]), (BA.main, []), (BE.main, [])])
def test_without_a_card_and_without_device_cpu_it_raises(main, argv, no_files):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


# ---------------------------------------------------------------- phmm_scale_bench


@pytest.mark.parametrize("seed, batches, reads, haps", [
    (PS.SEED, 6, 8, 4),  # the smoke's file
    (0, 3, 110, 37)])  # chip_smoke.py's (seed 0, the 550-batch file's head)
def test_phmm_testfile_is_the_jax_tools(tmp_path, seed, batches, reads, haps):
    jt = jax_tool("phmm_scale_bench")
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    jt.synth_testfile(a, np.random.default_rng(seed), n_batches=batches, max_reads=reads,
                      max_haps=haps)
    PS.synth_testfile(b, np.random.default_rng(seed), n_batches=batches, max_reads=reads,
                      max_haps=haps)
    assert a.read_bytes() == b.read_bytes()


def test_chip_smokes_testfile_head_is_the_shorter_file(tmp_path):
    """Phase 26 shards dataset-550's head: the bytes the tool writes for
    that many batches from the same rng."""
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    PS.synth_testfile(a, np.random.default_rng(0), n_batches=12, max_reads=20, max_haps=5)
    PS.synth_testfile(b, np.random.default_rng(0), n_batches=5, max_reads=20, max_haps=5)
    assert chip_smoke.testfile_head(a.read_bytes(), 5) == b.read_bytes()


def test_phmm_scale_bench_smoke(no_files):
    rc, (row,) = run_main(PS.main, ["--smoke", "--device", "cpu"])
    assert rc == 0 and set(row) == jax_keys("tools/phmm_scale_bench.py")
    assert row["batches"] == 6 and row["parity_sample"] == 16 and row["smoke"]
    assert row["pairs"] > 0 and 0 < row["fallback_frac"] < 1


# ---------------------------------------------------------------- bsw_scale_bench


@pytest.mark.parametrize("seed, n, smoke", [(BS.SEED, 2048, True), (chip_smoke.BSW_SEED, 9000,
                                                                     False)])
def test_bsw_pairs_are_the_jax_tools(tmp_path, seed, n, smoke):
    jt = jax_tool("bsw_scale_bench")
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    jt.write_pairs(a, n, np.random.default_rng(seed), smoke=smoke)
    BS.write_pairs(b, n, np.random.default_rng(seed), smoke=smoke)
    assert a.read_bytes() == b.read_bytes()


def test_bsw_scale_bench_against_the_jax_tool(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--smoke", "--pairs", "512", "--parity-sample", "64"]
    rc, (want,) = run_jax_main("bsw_scale_bench", argv + ["--workdir", "jax"])
    assert rc == 0
    rc, (row,) = run_main(BS.main, argv + ["--workdir", "port", "--device", "cpu", "--out",
                                           "h.json"])
    assert rc == 0 and set(row) == set(want)
    assert [row[k] for k in ("pairs", "input_gb", "parity_sample")] == [
        want[k] for k in ("pairs", "input_gb", "parity_sample")]
    assert (tmp_path / "port/pairs_512.txt").read_bytes() == (
        tmp_path / "jax/pairs_512.txt").read_bytes()
    run_main(BS.main, argv + ["--workdir", "port", "--device", "cpu", "--out", "h.json"])
    assert [r["pairs"] for r in json.loads((tmp_path / "h.json").read_text())] == [512, 512]


def test_bsw_scale_bench_no_file(no_files):
    rc, (row,) = run_main(BS.main, ["--smoke", "--device", "cpu"])
    assert rc == 0 and row["pairs"] == 2048 and row["parity_sample"] == 512


def test_bsw_scale_bench_catches_a_wrong_score(monkeypatch, no_files):
    real = BS.plain_scores
    monkeypatch.setattr(BS, "plain_scores", lambda soa, sel: real(soa, sel) + 1)
    with pytest.raises(AssertionError, match="against the plain version"):
        run_main(BS.main, ["--smoke", "--pairs", "64", "--device", "cpu"])


# ---------------------------------------------------------------- chain_scale_bench


def test_chain_dump_is_the_jax_tools(tmp_path):
    jt = jax_tool("chain_scale_bench")
    for smoke, n_calls in ((True, 40), (False, 2)):
        a, b = tmp_path / f"a{smoke}.txt", tmp_path / f"b{smoke}.txt"
        assert jt.write_dump(a, np.random.default_rng(CS.SEED), n_calls, smoke=smoke) == \
            CS.write_dump(b, np.random.default_rng(CS.SEED), n_calls, smoke=smoke)
        assert a.read_bytes() == b.read_bytes()
    # chip_smoke.py's dump without spans is the tool's
    a, b = tmp_path / "c.txt", tmp_path / "d.txt"
    chip_smoke.write_dump(a, np.random.default_rng(chip_smoke.CHAIN_SEED), 2)
    CS.write_dump(b, np.random.default_rng(chip_smoke.CHAIN_SEED), 2)
    assert a.read_bytes() == b.read_bytes()


def test_chain_scale_bench_against_the_jax_tool(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--smoke", "--calls", "12", "--parity-max", "4"]
    rc, (want,) = run_jax_main("chain_scale_bench", argv + ["--workdir", "jax"])
    assert rc == 0
    rc, (row,) = run_main(CS.main, argv + ["--workdir", "port", "--device", "cpu"])
    assert rc == 0 and set(row) == set(want)
    keys = ("calls", "total_anchors", "max_call_n", "oracle_parity_calls")
    assert [row[k] for k in keys] == [want[k] for k in keys] and row["oracle_parity_calls"] == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["jax", "port"]


def test_chain_scale_bench_no_file(no_files):
    rc, (row,) = run_main(CS.main, ["--smoke", "--calls", "20", "--device", "cpu"])
    assert rc == 0 and row["calls"] == 20 and row["oracle_parity_calls"] == 8


# ---------------------------------------------------------------- abea_scale_bench


def test_abea_reads_are_the_jax_tools():
    """At the smoke's lengths and chip_smoke.py's (abea-bench-128's, the
    long reads')."""
    jt = jax_tool("abea_scale_bench")
    a, b = np.random.default_rng(AB.SEED), np.random.default_rng(AB.SEED)
    ma, mb = jt.synth_model(a), AB.synth_model(b)
    assert all(np.array_equal(ma[k], mb[k]) for k in ma) and set(ma) == set(mb)
    for n in (400, 800, 1000, 4000, 10_000):
        sa, ea = jt.synth_read(a, ma, n)
        sb, eb = AB.synth_read(b, mb, n)
        assert sa == sb and np.array_equal(ea, eb)


def test_abea_scale_bench_smoke(no_files):
    jt = jax_tool("abea_scale_bench")
    rng = np.random.default_rng(AB.SEED)
    model = jt.synth_model(rng)
    events = sum(len(jt.synth_read(rng, model, n)[1]) for n in (400, 800))
    for engine, parity in (("device", 2), ("host", 1)):
        rc, (row,) = run_main(AB.main, ["--smoke", "--reps", "1", "--engine", engine,
                                        "--parity", str(parity), "--device", "cpu"])
        assert rc == 0 and set(row) == jax_keys("tools/abea_scale_bench.py")
        assert (row["engine"], row["reads"], row["len_min"], row["len_max"]) == (
            engine, 2, 400, 800)
        assert row["total_events"] == events
        assert row["aligned"] == 2 and row["oracle_parity_reads"] == parity


def test_abea_read_lengths_shorten_the_checked_prefix():
    lens = AB.read_lengths(16, 10_000, 50_000, 8)
    assert list(lens[:8]) == list(np.linspace(10_000, 15_000, 8).astype(int))
    assert list(lens[8:]) == list(np.linspace(10_000, 50_000, 16).astype(int)[8:])
    assert list(AB.read_lengths(2, 400, 800, 2)) == [400, 800]


# ---------------------------------------------------------------- kmer_scale_bench


def test_kmer_reads_are_the_jax_tools():
    jt = jax_tool("kmer_scale_bench")
    a = jt.synth_reads(np.random.default_rng(KS.SEED), 2_000_000, 10_000, 1)
    b = KS.synth_reads(np.random.default_rng(KS.SEED), 2_000_000, 10_000, 1)
    assert len(a) == len(b) == 200 and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_kmer_scale_bench_smoke(no_files):
    rc, (row,) = run_main(KS.main, ["--smoke", "--device", "cpu"])
    assert rc == 0 and set(row) == jax_keys("tools/kmer_scale_bench.py")
    assert row["reads"] == 200 and row["parity_reads"] == 64
    assert row["host_device_metrics_equal"] is True and row["distinct_kmers"] > 0
    rc, (row,) = run_main(KS.main, ["--smoke", "--host-only", "--device", "cpu"])
    assert rc == 0 and row["host_only"] and row["device_s"] is None
    assert row["host_device_metrics_equal"] is None


# ---------------------------------------------------------------- poa_scale_bench


@pytest.mark.parametrize("seed, shape", [(POS.SEED, (4, 4, 120)), (0, (3, 10, 750))])
def test_poa_windows_are_the_jax_tools(seed, shape):
    """The smoke's and chip_smoke.py's (poa-64x10x750's head, seed 0)."""
    jt = jax_tool("poa_scale_bench")
    assert jt.synth_windows(np.random.default_rng(seed), *shape) == POS.synth_windows(
        np.random.default_rng(seed), *shape)


def test_poa_scale_bench_smoke(no_files):
    for engine in ("device", "host"):
        rc, (row,) = run_main(POS.main, ["--smoke", "--engine", engine, "--device", "cpu"])
        assert rc == 0 and set(row) == jax_keys("tools/poa_scale_bench.py")
        assert row["engine"] == engine and row["oracle_parity_windows"] == 2
        assert row["seqs_per_s"] > 0


# ---------------------------------------------------------------- genome_scale_fmi, fmi_pack_ab


def test_fmi_reference_and_reads_are_the_jax_tools(tmp_path):
    jt = jax_tool("genome_scale_fmi")
    a, b = tmp_path / "a.fa", tmp_path / "b.fa"
    jt.synth_reference(a, 1)
    GF.synth_reference(b, 1)
    assert a.read_bytes() == b.read_bytes()
    assert np.array_equal(jt.synth_reads(a, 64, 151), GF.synth_reads(b, 64, 151))
    # chip_smoke.py's: the codes from --seed, the reads from --seed + 1
    codes = GF.reference_codes(1, np.random.default_rng(5))
    ref = tmp_path / "ref.fa"
    jt.synth_reference(ref, 1, seed=5)
    assert np.array_equal(codes, pack_fasta(str(ref))[0])
    assert np.array_equal(GF.sample_reads(codes, 40, 151, np.random.default_rng(6)),
                          jt.synth_reads(ref, 40, 151, seed=6))


@pytest.fixture(scope="module")
def fmi_workdir(tmp_path_factory):
    """genome_scale_fmi's run at 1 Mbp and 64 reads, its directory kept."""
    wd = tmp_path_factory.mktemp("gfmi")
    rc, lines = run_main(GF.main, ["--mbp", "1", "--reads", "64", "--workdir", str(wd),
                                   "--device", "cpu"])
    return wd, rc, lines


def test_genome_scale_fmi(fmi_workdir):
    wd, rc, (row,) = fmi_workdir
    assert rc == 0 and set(row) == jax_keys("tools/genome_scale_fmi.py", having="dump_parity")
    assert row["dump_parity"] is True and row["totals_match"] is True
    assert row["total_smems"] > 0 and row["build_s"] is not None
    assert sorted(p.name for p in wd.iterdir()) == [
        "big_index.npz", "big_index.npz.hostpack32.npy", "big_ref.fa"]
    # the SMEM key set is the JAX tool's
    didx = FI.load_npz(str(wd / "big_index.npz"))
    enc = GF.synth_reads(wd / "big_ref.fa", 16, 151)
    m = fmi_search_native(didx, enc, np.full(16, 151, np.int32))[0]
    assert GF.smem_key_set(m) == jax_tool("genome_scale_fmi").smem_key_set(m)


def test_genome_scale_fmi_host_only_no_file(no_files):
    rc, (row,) = run_main(GF.main, ["--mbp", "1", "--reads", "32", "--host-only",
                                    "--device", "cpu"])
    assert rc == 0
    assert set(row) == jax_keys("tools/genome_scale_fmi.py", having="pack_build_s")


def test_genome_scale_fmi_reports_a_wrong_dump(tmp_path, monkeypatch):
    real = GF.fmi_pipeline_batch

    def drop_one(*args, **kwargs):
        allm, n1, n2, n3, ovf = real(*args, **kwargs)
        return {k: v[1:] for k, v in allm.items()}, n1, n2, n3, ovf

    monkeypatch.setattr(GF, "fmi_pipeline_batch", drop_one)
    rc, (row,) = run_main(GF.main, ["--mbp", "1", "--reads", "16", "--batch", "16",
                                    "--workdir", str(tmp_path), "--device", "cpu"])
    assert rc == 1 and row["dump_parity"] is False and row["totals_match"] is True


def test_fmi_pack_ab(fmi_workdir, monkeypatch):
    wd, _, _ = fmi_workdir
    monkeypatch.delenv("GT_FMI_HUGE", raising=False)
    monkeypatch.delenv("GT_FMI_WIDTH", raising=False)
    before = sorted(p.name for p in wd.iterdir())
    rc, rows = run_main(PA.main, ["--workdir", str(wd), "--reads", "64", "--repeats", "1",
                                  "--sweep", "4,8"])
    assert rc == 0 and [r["mode"] for r in rows] == ["v1", "v2", "v2+huge", "v2+huge w=4",
                                                     "v2+huge w=8"]
    assert all(r["dump_parity"] is True for r in rows)
    assert len({r["total_smems"] for r in rows[:3]}) == 1
    sets = literal_keys(jax_source("tools/fmi_pack_ab.py"), "mode")
    mode_keys = next(k for k in sets if "warm_s" in k)
    sweep_keys = next(k for k in sets if "warm_s" not in k)
    assert [set(r) for r in rows] == [mode_keys] * 3 + [sweep_keys] * 2
    assert "GT_FMI_HUGE" not in os.environ and "GT_FMI_WIDTH" not in os.environ
    # the 64-byte rows' sidecar joins the 32-byte one; nothing else is written
    assert sorted(p.name for p in wd.iterdir()) == sorted(before + ["big_index.npz.hostpack.npy"])


# ---------------------------------------------------------------- bench_all


class Caught(Exception):
    pass


@pytest.fixture
def jax_bench_all(monkeypatch):
    """tools/bench_all.py with its timers calling each timed function once
    (no timing, no kernel)."""
    jb = jax_tool("bench_all")

    def timeit(fn, fetch, iters=10, repeats=3):
        fn()
        return 1.0

    monkeypatch.setattr(jb, "_timeit", timeit)
    monkeypatch.setattr(jb, "_timeit_host", lambda fn, iters=1, repeats=3: (1.0, fn()))
    return jb


def catch(monkeypatch, module, name, ret=None, raise_=False):
    """Replace module.name by a function that keeps its arguments (in the
    returned list) and returns `ret`, or raises Caught."""
    seen = []

    def fake(*args, **kwargs):
        seen.append((args, kwargs))
        if raise_:
            raise Caught
        return ret

    monkeypatch.setattr(module, name, fake)
    return seen


def test_bench_phmm_and_bsw_inputs_are_the_jax_benchs(jax_bench_all, monkeypatch):
    import genomicsbench_palisade_tpu.ops.bsw as JW
    import genomicsbench_palisade_tpu.ops.phmm as JP

    seen = catch(monkeypatch, JP, "prepare_batch", raise_=True)
    with pytest.raises(Caught):
        jax_bench_all.bench_phmm()
    (reads, haps, pairs), kw = seen[0]
    want = BA.phmm_cases(np.random.default_rng(0), 2048, 250, 302)
    assert kw == {"r_pad": 256, "h_pad": 320} and pairs == want[2]
    assert all(np.array_equal(a[k], b[k]) for a, b in zip(reads, want[0]) for k in a)
    assert all(np.array_equal(a, b) for a, b in zip(haps, want[1]))

    seen = catch(monkeypatch, JW, "prepare_pairs", raise_=True)
    with pytest.raises(Caught):
        jax_bench_all.bench_bsw()
    (pairs,), kw = seen[0]
    assert kw == {"q_pad": 128, "t_pad": 256}
    for (qa, ta, ha), (qb, tb, hb) in zip(pairs, BA.bsw_pairs(np.random.default_rng(1), 8192,
                                                              128, 256), strict=True):
        assert np.array_equal(qa, qb) and np.array_equal(ta, tb) and ha == hb


def test_bench_phmm_cases_are_bench_pys(tmp_path):
    """bench.py's _synth_phmm_batch, at the flagship's head (chip_smoke.py's
    bench-302 and bench-473 draw from one rng(0) in that order)."""
    jb = jax_tool("bench", where=".")
    rng_a, rng_b = np.random.default_rng(0), np.random.default_rng(0)
    for b, hl, h_pad in ((64, 302, 320), (32, 473, 512)):
        want = jb._synth_phmm_batch(rng_a, b, 250, hl, r_pad=256, h_pad=h_pad)
        got = P.prepare_batch(*BE.phmm_cases(rng_b, b, 250, hl), r_pad=256, h_pad=h_pad)
        assert all(np.array_equal(np.asarray(want[k]), got[k]) for k in PHMM_KEYS)


def test_bench_chain_inputs_are_the_jax_benchs(jax_bench_all, monkeypatch):
    import genomicsbench_palisade_tpu.ops.chain as JC
    import genomicsbench_palisade_tpu.ops.chain_pallas as JCP

    gap_fixed_point = JCP.gap_fixed_point
    catch(monkeypatch, JCP, "chain_dp_pallas_batch")
    real = JC.prepare_call
    preps = []
    monkeypatch.setattr(JC, "prepare_call", lambda *a, **k: preps.append(real(*a, **k))
                        or preps[-1])
    catch(monkeypatch, JC, "chain_calls_batched", raise_=True)
    res = jax_bench_all.bench_chain()
    assert "error" in res["mixed_batch_ok"]  # the caught call
    draws, mixed = preps[:-4], preps[-4:]
    ok = [bool(gap_fixed_point(p["gap_table"][None, :], p["bw"])[2].all()) for p in draws]
    assert ok == [BA.slope_feasible(p["gap_table"], p["bw"]) for p in draws]
    rng = np.random.default_rng(2)
    calls = BA.chain_bench_calls(rng, 4096, 128)
    keys = ("x_lo", "qi", "qspan", "st_eff", "gap_table")
    for a, b in zip([p for p, o in zip(draws, ok) if o], calls, strict=True):
        assert all(np.array_equal(np.asarray(a[k]).view(np.int32) if k == "x_lo" else a[k],
                                  np.asarray(b[k]).view(np.int32) if k == "x_lo" else b[k])
                   for k in keys)
    for a, q in zip(mixed, (18.5, 25.0, 31.25, 22.0)):
        b = C.prepare_call(*BA.chain_anchors(rng, 256), avg_qspan=q)
        assert all(np.array_equal(a[k], b[k]) for k in keys[1:])


def test_bench_kmer_and_grm_inputs_are_the_jax_benchs(jax_bench_all, monkeypatch):
    import genomicsbench_palisade_tpu.ops.kmer as JK

    seen = catch(monkeypatch, JK, "encode_reads_np", raise_=True)
    with pytest.raises(Caught):
        jax_bench_all.bench_kmer()
    assert seen[0][0][0] == BA.kmer_reads(np.random.default_rng(3), 512, 5500)

    # the genotypes are its first draw: catch them there, before its float64
    # statistics over the 67 M of them
    drawn = []

    class Rng:
        def __init__(self, seed):
            self.seed, self.rng = seed, np.random.default_rng(seed)

        def choice(self, *args, **kwargs):
            drawn.append((self.seed, self.rng.choice(*args, **kwargs)))
            raise Caught

    monkeypatch.setattr(jax_bench_all, "np", SimpleNamespace(
        random=SimpleNamespace(default_rng=Rng)))
    with pytest.raises(Caught):
        jax_bench_all.bench_grm()
    (seed, geno), = drawn
    assert seed == 5 and np.array_equal(geno.astype(np.int8), BA.genotypes(32768, 2048))


def test_bench_fmi_inputs_are_the_jax_benchs(jax_bench_all, monkeypatch, tmp_path):
    import genomicsbench_palisade_tpu.index.builder as JIB
    import genomicsbench_palisade_tpu.index.fmi_index as JFI
    import genomicsbench_palisade_tpu.io.native as JN
    import genomicsbench_palisade_tpu.ops.fmi_pipeline as JFP

    class Index:
        def as_device_arrays(self):
            return {}

    built = catch(monkeypatch, JIB, "build_arrays", ret=Index())
    dev = catch(monkeypatch, JFP, "fmi_pipeline_batch", ret=(None, 1, 0, 0, False))
    host = catch(monkeypatch, JN, "fmi_search_native", ret=(None, 1, 0, 0))
    monkeypatch.setattr(JN, "available", lambda: True)
    catch(monkeypatch, JFI, "load_npz", ret=Index())
    monkeypatch.setenv("HOME", str(tmp_path))  # the JAX bench's ~/.cache index: present
    cache = tmp_path / ".cache/genomicsbench_palisade_tpu/bench_fmi_idx64.npz"
    cache.parent.mkdir(parents=True)
    cache.touch()
    res = jax_bench_all.bench_fmi()
    assert set(res) == jax_bench_keys("bench_fmi")

    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, 5_000_000).astype(np.uint8)
    assert np.array_equal(built[0][0][0], genome)
    enc = BA.fmi_reads(rng, genome, 512, 101)
    assert np.array_equal(dev[0][0][1], enc)
    assert np.array_equal(host[0][0][1], enc.astype(np.int8))
    assert np.array_equal(host[1][0][1], BA.genome_scale_reads(64, 2048, 151)[1])


def test_bench_host_benchs_inputs_are_the_jax_benchs(jax_bench_all, monkeypatch):
    import genomicsbench_palisade_tpu.io.native as JN
    import genomicsbench_palisade_tpu.ops.abea as JA
    import genomicsbench_palisade_tpu.ops.abea_pallas as JAP
    import genomicsbench_palisade_tpu.ops.pileup as JPU
    import genomicsbench_palisade_tpu.ops.poa as JPOA

    seen = catch(monkeypatch, JPOA, "msa_consensus_batch", ret=["A"] * 32)
    catch(monkeypatch, JPOA, "msa_consensus_host")
    jax_bench_all.bench_poa()
    assert seen[0][0][0] == BA.poa_windows(np.random.default_rng(6), 32, 6, 200)

    seen = catch(monkeypatch, JAP, "align_events_batch_pallas", ret=[[(0, 0)]] * 64)
    catch(monkeypatch, JA, "align_events_batch_native")
    jax_bench_all.bench_abea()
    rng = np.random.default_rng(7)
    model = AB.synth_model(rng)
    seqs, evs = BA.abea_reads(rng, model, 64, 500)
    (j_seqs, j_evs, j_model, *_), _ = seen[0]
    assert j_seqs == seqs and all(np.array_equal(a, b) for a, b in zip(j_evs, evs, strict=True))
    assert all(np.array_equal(j_model[k], model[k]) for k in model)

    seen = catch(monkeypatch, JPU, "calculate_pileup", ret={"n_cols": 1})
    jax_bench_all.bench_pileup()
    recs = BA.pileup_records(np.random.default_rng(9), 2000, 300, 50000)
    for a, b in zip(seen[0][0][0], recs, strict=True):
        assert (a.name, a.flag, a.ref_id, a.pos, a.mapq, a.cigar, a.tags) == (
            b.name, b.flag, b.ref_id, b.pos, b.mapq, b.cigar, b.tags)
        assert np.array_equal(a.seq_nt16, b.seq_nt16) and np.array_equal(a.qual, b.qual)

    monkeypatch.setattr(JN, "available", lambda: True)
    seen = catch(monkeypatch, JN, "dbg_window_native", ret=(0, []))
    jax_bench_all.bench_dbg()
    wins = BA.dbg_windows(np.random.default_rng(12), 24, 1500, 60, 80)
    for ((ref, _start, reads, *params), _), (w_ref, w_reads) in zip(seen, wins, strict=True):
        assert ref == w_ref and params == [15, 20, 2]
        assert all(s == ws and np.array_equal(q, wq) and f == wf
                   for (s, q, f), (ws, wq, wf) in zip(reads, w_reads, strict=True))


SMALL = {
    "bench_phmm": dict(b=8, rl=20, hl=30, r_pad=32, h_pad=32),
    "bench_bsw": dict(b=16, ql=16, tl=32),
    "bench_chain": dict(n=64, n_calls=4, w=16, nm=64),
    "bench_kmer": dict(n_reads=4, read_len=300),
    "bench_fmi": dict(genome_bp=20_000, b=8, rl=51, genome_mbp=1, genome_reads=16,
                      genome_rl=51),
    "bench_poa": dict(w_n=2, s_n=3, length=40),
    "bench_abea": dict(b=2, seq_len=60),
    "bench_pileup": dict(n_reads=50, read_len=30, span=500, region=600),
    "bench_dbg": dict(n_win=2, w_len=200, n_reads=10, r_len=40),
    "bench_grm": dict(m=256, n=32, block=64),
}


@pytest.fixture
def small_benches(monkeypatch, tmp_path):
    """bench_all's benches at SMALL's shapes (fmi's genome-scale index in a
    temporary directory)."""
    small = {name: functools.partial(getattr(BA, name), **kw) for name, kw in SMALL.items()}
    small["bench_fmi"] = functools.partial(small["bench_fmi"], cache_dir=tmp_path)
    host = tuple(small[f.__name__] for f in BA.HOST_BENCHES)
    monkeypatch.setattr(BA, "HOST_BENCHES", host)
    monkeypatch.setattr(BA, "BENCHES", tuple(small[f.__name__] for f in BA.BENCHES))
    monkeypatch.setattr(BE, "SECONDARY", tuple(small[f.__name__] for f in BE.SECONDARY))
    return small


def test_bench_all_main(small_benches, no_files):
    rc, rows = run_main(BA.main, ["--device", "cpu"])
    assert rc == 0
    assert [set(r) for r in rows] == [jax_bench_keys(name) for name in SMALL]
    # rates of such tiny shapes on the CPU may round to 0
    assert all(r["value"] >= 0 for r in rows) and rows[2]["mixed_batch_ok"] is True


def test_bench_all_reports_a_failing_bench(monkeypatch, no_files):
    def bench_bsw(device=None):
        raise ValueError("no")

    monkeypatch.setattr(BA, "BENCHES", (bench_bsw,))
    rc, rows = run_main(BA.main, ["--device", "cpu"])
    assert rc == 1 and rows == [{"kernel": "bench_bsw", "error": "ValueError('no')"}]


# ---------------------------------------------------------------- bench


def test_bench_runs_bench_alls_other_nine_in_the_jax_order():
    main = next(n for n in ast.walk(jax_source("bench.py"))
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    (benches,) = [n.iter for n in ast.walk(main) if isinstance(n, ast.For)
                  and isinstance(n.iter, ast.Tuple)]
    assert [f.__name__ for f in BE.SECONDARY] == [e.attr for e in benches.elts]


def test_bench_main(small_benches, monkeypatch, no_files):
    """The flagship and h512 at small shapes, then two of the nine (the
    nine's lines are bench_all's: test_bench_all_main)."""
    monkeypatch.setattr(BE, "FLAGSHIP", (8, 20, 30, 32, 32))
    monkeypatch.setattr(BE, "H512", (4, 20, 47, 32, 64))
    monkeypatch.setattr(BE, "SECONDARY", BA.HOST_BENCHES)
    rc, rows = run_main(BE.main, ["--device", "cpu"])
    last = rows[-1]
    assert rc == 0 and [r["kernel"] for r in rows[:-1]] == ["pileup", "dbg"]
    (want,) = literal_keys(jax_source("bench.py"), "metric")
    assert set(last) == want and last["vs_baseline"] == 1.0 and BE.BASELINE_GCUPS is None
    assert isinstance(last["value"], float) and isinstance(last["h512_gcups"], float)
    assert 0 <= last["f64_fallback_frac"] <= 1
    assert last["per_kernel"] == {r["kernel"]: {k: v for k, v in r.items() if k != "kernel"}
                                  for r in rows[:-1]}


def test_bench_reports_a_failing_companion(small_benches, monkeypatch, no_files):
    monkeypatch.setattr(BE, "FLAGSHIP", (8, 20, 30, 32, 32))
    monkeypatch.setattr(BE, "H512", (4, 20, 47, 32, 16))  # haps longer than h_pad
    monkeypatch.setattr(BE, "SECONDARY", ())
    rc, rows = run_main(BE.main, ["--device", "cpu"])
    assert rc == 1 and rows[-1]["h512_gcups"].startswith("error: ValueError")
