"""The port's counterparts of the JAX system's tools, on the CPU, each case
cheap: fuzz_parity, scaling_bench, kmer_sharded_bench, grm_sweep,
synth_fastq and bam_scale_bench (genomicsbench_palisade_tpu_torch/tools/).

  * every fuzz suite for 2 rounds from seed 0 (its plain versions and the
    native engines against the oracles), and a mutant plain bsw that main
    must report;
  * scaling_bench at 1 and 2 ranks: the JAX tool's keys and points, not
    its speed (a CPU's ranks share its cores);
  * kmer_sharded_bench --smoke on 2 CPU ranks: the metrics equal the native
    host counter's;
  * grm_sweep at 512 x 64: HIGH and HIGHEST within plink2's 2e-5 of the
    float64 product, DEFAULT and COMPENSATED within the bounds that
    tests/test_torch_grm.py holds them to; no file without --out;
  * synth_fastq: the JAX tool's bytes for the same seed;
  * bam_scale_bench at 3,000 records: the JAX tool's BAM, index and keys,
    and its region records equal to the JAX read_bam_region's.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu_torch.io import bam as B
from genomicsbench_palisade_tpu_torch.ops import bsw as W
from genomicsbench_palisade_tpu_torch.tools import bam_scale_bench as BS
from genomicsbench_palisade_tpu_torch.tools import fuzz_parity as F
from genomicsbench_palisade_tpu_torch.tools import grm_sweep as GS
from genomicsbench_palisade_tpu_torch.tools import kmer_sharded_bench as KS
from genomicsbench_palisade_tpu_torch.tools import scaling_bench as SB
from genomicsbench_palisade_tpu_torch.tools import synth_fastq as SF

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GRM_TOL = 2e-5  # plink2's contract, tests/test_torch_grm.py's HIGH and HIGHEST bound
GRM_DEFAULT_TOL = 4e-3  # tests/test_torch_grm.py's bound for one bf16 pass


def jax_tool(name):
    """tools/<name>.py, the JAX system's tool, as a module (its own
    directory on sys.path, as it runs)."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                      REPO / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(REPO / "tools"))
    return mod


def run_main(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue()


def json_lines(lines):
    return [json.loads(ln) for ln in lines if ln.startswith("{")]


# ---------------------------------------------------------------- fuzz_parity


def test_the_suites_are_the_jax_tools():
    jf = jax_tool("fuzz_parity")
    assert [name for name, _ in F.SUITES] == [name for name, _ in jf.SUITES]


@pytest.mark.parametrize("suite", [name for name, _ in F.SUITES])
def test_fuzz_suite_two_rounds(suite):
    fn = dict(F.SUITES)[suite]
    rng = np.random.default_rng(0)
    for _ in range(2):
        fn(rng, CPU)


def test_fuzz_reports_a_wrong_plain_bsw(monkeypatch):
    """One score of the plain bsw version off by one: main prints FAIL bsw
    and returns 1; with --seconds 0 every other suite passes its one round."""
    real = W.bsw_extend_plain

    def bent(batch, params=W.DEFAULT_TUPLE, *args, **kwargs):
        out = real(batch, params, *args, **kwargs).clone()
        out[0, 0] += 1
        return out

    monkeypatch.setattr(W, "bsw_extend_plain", bent)
    rc, lines, _ = run_main(F.main, ["--seconds", "0", "--device", "cpu"])
    assert rc == 1
    assert lines[0].startswith("FAIL bsw: AssertionError")
    assert lines[1:] == ["OK   bsw: 0 rounds"] + [f"OK   {name}: 1 rounds"
                                                 for name, _ in F.SUITES[1:]]


# ---------------------------------------------------------------- scaling_bench


@pytest.fixture(scope="module")
def jax_phmm_points():
    """The JAX tool's phmm lines at 1 and 2 of the conftest's virtual
    devices (its kmer points compile for ~30 s; their keys are the same)."""
    rc, lines, _ = run_main(jax_tool("scaling_bench").main, [
        "--kernel", "phmm", "--devices", "1,2", "--batch", "16", "--iters", "1"])
    assert rc == 0
    return json_lines(lines)


@pytest.mark.parametrize("kernel", ["phmm", "kmer"])
def test_scaling_bench_points(kernel, jax_phmm_points):
    rc, lines, err = run_main(SB.main, ["--kernel", kernel, "--devices", "1,2", "--batch",
                                        "16", "--iters", "1", "--device", "cpu"])
    rows, want = json_lines(lines), jax_phmm_points
    assert rc == 0 and [set(r) for r in rows] == [set(r) for r in want]
    assert [r["devices"] for r in rows[:2]] == [r["devices"] for r in want[:2]] == [1, 2]
    assert [r["kernel"] for r in rows[:2]] == [kernel] * 2
    assert rows[0]["scaling_efficiency"] == 1.0 and rows[2]["unit"] == "fraction_of_linear"
    assert rows[2]["metric"] == f"{kernel}_scaling_eff_2dev"
    assert all(r["items_per_s"] > 0 for r in rows[:2])
    if kernel == "kmer":  # equal read lengths: every static shard holds the same work
        assert [r["load_imbalance"] for r in rows[:2]] == [1.0, 1.0]
    else:  # the same batch, so the same static shards
        assert [r["load_imbalance"] for r in rows[:2]] == [w["load_imbalance"] for w in want[:2]]
    assert "share the CPU's cores" in err


# ---------------------------------------------------------------- kmer_sharded_bench


def test_kmer_sharded_smoke_equals_host_counter(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc, lines, err = run_main(KS.main, ["--smoke", "--devices", "2", "--device", "cpu"])
    (row,) = json_lines(lines)
    assert rc == 0 and row["metrics_equal"] and "equal=True" in err
    assert row["devices"] == 2 and row["reads"] == 66 and row["group_backend"] == "gloo"
    assert sum(row["per_shard_occupancy"]) == row["metrics"]["occurrences"]
    assert sum(row["per_shard_distinct"]) == row["metrics"]["total_kmers"]
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------- grm_sweep


def test_grm_sweep_errors_and_no_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc, lines, _ = run_main(GS.main, ["--m", "512", "--n", "64", "--reps", "1", "--iters", "1",
                                      "--device", "cpu"])
    rows = json_lines(lines)
    assert rc == 0 and len(rows) == 16 and list(tmp_path.iterdir()) == []
    assert {(r["precision"], r["block"]) for r in rows} == {
        (p, b) for p, _ in GS.MODES for b in GS.BLOCKS}
    assert all(set(r) == {"precision", "block", "tflops", "max_rel_err", "meets_2e5"}
               for r in rows)
    for r in rows:
        bound = GRM_DEFAULT_TOL if r["precision"] == "DEFAULT" else GRM_TOL
        assert r["max_rel_err"] < bound, r
        assert r["meets_2e5"] == (r["max_rel_err"] < GRM_TOL)
    assert all(r["meets_2e5"] for r in rows if r["precision"] in ("HIGH", "HIGHEST"))
    out = tmp_path / "sweep.json"
    assert GS.main(["--m", "256", "--n", "16", "--reps", "1", "--iters", "1", "--device", "cpu",
                    "--out", str(out)]) == 0
    (entry,) = json.loads(out.read_text())
    assert (entry["tool"], entry["m"], entry["n"], len(entry["rows"])) == ("grm_sweep", 256, 16, 16)


# ---------------------------------------------------------------- synth_fastq


def test_synth_fastq_equals_the_jax_tools(tmp_path):
    rng = np.random.default_rng(2)
    seq = "".join("ACGTN"[i] for i in rng.integers(0, 5, 5000))
    ref = tmp_path / "ref.fa"
    ref.write_text(">c1\n" + "\n".join(seq[i : i + 80] for i in range(0, len(seq), 80)) + "\n")
    args = ["--reads", "300", "--read-len", "60", "--seed", "4"]
    assert SF.main([str(ref), str(tmp_path / "port.fq")] + args) == 0
    assert jax_tool("synth_fastq").main([str(ref), str(tmp_path / "jax.fq")] + args) == 0
    got = (tmp_path / "port.fq").read_bytes()
    assert got == (tmp_path / "jax.fq").read_bytes() and got.count(b"\n") == 1200


# ---------------------------------------------------------------- bam_scale_bench


def test_bam_scale_bench_equals_the_jax_tools(tmp_path):
    from genomicsbench_palisade_tpu.io import bam as JB

    size = ["--records", "3000", "--ref-len", "60000", "--queries", "3", "--region-bp", "5000"]
    rc, lines, _ = run_main(BS.main, ["--workdir", str(tmp_path / "port")] + size)
    jrc, jlines, _ = run_main(jax_tool("bam_scale_bench").main,
                              ["--workdir", str(tmp_path / "jax")] + size)
    (row,), (want,) = json_lines(lines), json_lines(jlines)
    assert rc == jrc == 0 and set(row) == set(want)
    for key in ("tool", "bam_gb", "records", "region_bp", "records_per_query", "pileup_cols"):
        assert row[key] == want[key], key
    assert row["records_per_query"] > 0 and row["pileup_cols"] > 0
    bam = tmp_path / "port" / "scale_3000.bam"
    for name in ("scale_3000.bam", "scale_3000.bam.bai"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    got = B.read_bam_region(str(bam), "chr20", 30_000, 35_000, bai_path=str(bam) + ".bai")
    jgot = JB.read_bam_region(str(bam), "chr20", 30_000, 35_000, bai_path=str(bam) + ".bai")
    assert got[0] == jgot[0] and len(got[1]) == len(jgot[1]) > 0
    for a, b in zip(got[1], jgot[1]):
        assert (a.name, a.flag, a.pos, a.mapq, a.cigar) == (b.name, b.flag, b.pos, b.mapq,
                                                           b.cigar)
        assert np.array_equal(a.seq_nt16, b.seq_nt16) and np.array_equal(a.qual, b.qual)


def test_bam_scale_bench_whole_contig(tmp_path, monkeypatch):
    """--whole-contig-pileup: every chunk through the fused native region
    path; the line goes to --out only when that is given."""
    monkeypatch.chdir(tmp_path)
    size = ["--records", "2000", "--ref-len", "300000", "--queries", "2", "--region-bp", "5000",
            "--whole-contig-pileup"]
    rc, lines, _ = run_main(BS.main, size)
    rows = json_lines(lines)
    assert rc == 0 and len(rows) == 2 and list(tmp_path.iterdir()) == []
    assert rows[1]["chunks"] == 3 and rows[1]["records"] == 2000 and rows[1]["pileup_cols"] > 0
    out = tmp_path / "scale.json"
    assert BS.main(size + ["--out", str(out)]) == 0
    (entry,) = json.loads(out.read_text())
    assert entry == {**rows[1], "kernel_s": entry["kernel_s"],
                     "records_per_s": entry["records_per_s"], "peak_rss_mb": entry["peak_rss_mb"]}
