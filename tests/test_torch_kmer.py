"""The port's k-mer counter (ops/kmer.py, cli/kmer_cnt.py) on the CPU,
against the JAX package and the reference goldens.

Seeded reads go through the JAX package's functions and the port's: the
packed and canonical codes (the port's one int64 against the JAX uint32
hi/lo planes), the metrics of the one-shot and the streamed counters, the
streamed accumulator array for array, both of the streamed counter's
RuntimeErrors, the minimizer index, and the CLI's lines.  Tolerance 0:
every output is an integer or a string.
"""

import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu.cli import kmer_cnt as jcli
from genomicsbench_palisade_tpu.ops import kmer as JK
from genomicsbench_palisade_tpu.utils import compile_cache
from genomicsbench_palisade_tpu_torch.cli import kmer_cnt as cli
from genomicsbench_palisade_tpu_torch.config import load_flye_cfg
from genomicsbench_palisade_tpu_torch.convert import kmer_batch_from_numpy
from genomicsbench_palisade_tpu_torch.ops import kmer as K

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
KS = [5, 13, 17, 31, 32]
CPU = "cpu"


def _reads(seed, n, lo, hi, alphabet="ACGTN"):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(alphabet), int(rng.integers(lo, hi)))) for _ in range(n)]


def _coverage_reads(seed, n=50, genome_len=1_000, read_len=400):
    """Reads off one genome as strings: k-mers repeat across batches and
    pass the saturation count."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, genome_len - read_len))
        r = genome[s : s + read_len].copy()
        mut = rng.random(read_len) < 0.01
        r[mut] = rng.integers(0, 4, int(mut.sum()))
        out.append("".join("ACGT"[c] for c in r))
    return out


def _planes(code):
    u = code.numpy().view(np.uint64)
    return (u >> np.uint64(32)).astype(np.uint32), (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _jax_stream(bases, lengths, k):
    """The JAX package's flattened (inv, canonical hi, lo) stream of a read
    matrix (its _batch_kmers without the 2-bit relay packing)."""
    hi, lo, valid = JK.pack_kmers(jnp.asarray(bases.astype(np.int32)), jnp.asarray(lengths), k)
    chi, clo = JK.canonical(hi, lo, k)
    return (~valid).astype(jnp.uint32).ravel(), chi.ravel(), clo.ravel()


def _port_stream(bases, lengths, k):
    code, valid = K.pack_kmers(*kmer_batch_from_numpy(bases, lengths, CPU), k)
    return K.canonical(code, k)[valid]


@pytest.mark.parametrize("k", KS)
def test_pack_and_canonical_equal_jax(k):
    reads = _reads(k, 12, 40, 90)
    bases, lengths = K.encode_reads_np(reads)
    jb, jl = JK.encode_reads_np(reads)
    assert (bases == jb).all() and (lengths == jl).all()
    hi, lo, valid = JK.pack_kmers(jnp.asarray(jb.astype(np.int32)), jnp.asarray(jl), k)
    chi, clo = JK.canonical(hi, lo, k)
    code, tvalid = K.pack_kmers(*kmer_batch_from_numpy(bases, lengths, CPU), k)
    canon = K.canonical(code, k)
    for got, want in zip(_planes(code) + _planes(canon), (hi, lo, chi, clo)):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    if k == 32:  # bit 63 is reached, so the unsigned order is the one tested
        assert bool((code < 0).any()) and bool((canon < 0).any())


@pytest.mark.parametrize("k", [1, 2] + KS)
def test_counters_equal_jax(k):
    reads = _coverage_reads(k) + _reads(100 + k, 8, 150, 420)
    want = JK.count_kmers(reads, k=k, min_read_length=200)
    assert want["hash_size"] > 0
    assert K.count_kmers(reads, k=k, min_read_length=200, device=CPU) == want
    stats = {}
    got = K.count_kmers_batched(reads, k=k, min_read_length=200, batch_bases=4_000,
                                cap=1 << 15, device=CPU, stats=stats)
    assert got == want and stats["merges"] >= 3
    assert JK.count_kmers_batched(reads, k=k, min_read_length=200, batch_bases=4_000,
                                  cap=1 << 15) == want


@pytest.mark.parametrize("k", KS)
def test_merge_acc_equals_jax_array_for_array(k):
    reads = _coverage_reads(200 + k, n=12)
    cap = 1 << 13
    jacc = (jnp.zeros(cap, jnp.uint32), jnp.zeros(cap, jnp.uint32), jnp.zeros(cap, jnp.int32),
            jnp.int32(0))
    acc = (torch.zeros(cap, dtype=torch.int64), torch.zeros(cap, dtype=torch.int32), 0)
    for chunk in (reads[:5], reads[5:]):
        bases, lengths = K.encode_reads_np(chunk)
        jacc = JK._merge_acc(*jacc, *_jax_stream(bases, lengths, k), cap)
        acc = K._merge_acc(*acc, _port_stream(bases, lengths, k), cap)
        hi, lo = _planes(acc[0])
        np.testing.assert_array_equal(hi, np.asarray(jacc[0]))
        np.testing.assert_array_equal(lo, np.asarray(jacc[1]))
        np.testing.assert_array_equal(acc[1].numpy(), np.asarray(jacc[2]))
        assert acc[2] == int(jacc[3]) > 0
    assert K._acc_metrics(acc[1], acc[2], 15) == tuple(
        int(x) for x in JK._acc_metrics(jacc[2], jacc[3], 15))


def test_kmer_goldens():
    """The 25 reference-binary cases (tests/fixtures/kmer_golden.json):
    Total k-mers and Hash size through both counters."""
    cases = json.loads((FIXTURES / "kmer_golden.json").read_text())["cases"]
    assert len(cases) == 25
    for case in cases:
        args = dict(k=case["k"], min_read_length=case["min_read_length"], device=CPU)
        for got in (K.count_kmers(case["reads"], **args),
                    K.count_kmers_batched(case["reads"], batch_bases=600, cap=1 << 13, **args)):
            assert (got["total_kmers"], got["hash_size"]) == (case["total_kmers"],
                                                              case["hash_size"])


def test_code_arrays_map_n_to_three():
    """Code arrays with raw code 4 (N not mapped): every counter maps it to 3."""
    rng = np.random.default_rng(23)
    reads = [rng.integers(0, 5, int(rng.integers(300, 500))).astype(np.int8) for _ in range(8)]
    want = JK.count_kmers([np.where(r >= 4, 3, r) for r in reads], min_read_length=200)
    assert K.count_kmers(reads, min_read_length=200, device=CPU) == want
    assert K.count_kmers_batched(reads, min_read_length=200, batch_bases=1_000, cap=1 << 13,
                                 device=CPU) == want


def test_no_kept_reads():
    reads = _reads(5, 4, 50, 100)
    zero = {"total_kmers": 0, "hash_size": 0, "occurrences": 0}
    assert K.count_kmers(reads, device=CPU) == zero == K.count_kmers_batched(reads, device=CPU)


def _error(fn):
    with pytest.raises(RuntimeError) as e:
        fn()
    return str(e.value)


def test_occurrence_guard_raises_where_jax_does(monkeypatch):
    """The int32 occurrence bound trips before the merge that would cross
    it (the bound shrunk so no GB input is needed), on the same batch and
    with the same message as the JAX package's."""
    reads = _reads(29, 6, 600, 700, "ACGT")
    monkeypatch.setattr(K, "_OCC_CUMSUM_BOUND", 2_000)
    monkeypatch.setattr(JK, "_OCC_CUMSUM_BOUND", 2_000)
    args = dict(min_read_length=100, batch_bases=1_300, cap=1 << 13)
    msg = _error(lambda: K.count_kmers_batched(reads, device=CPU, **args))
    assert re.search("2\\^31|cumsum", msg)
    assert msg == _error(lambda: JK.count_kmers_batched(reads, **args))


def test_cap_error_raises_where_jax_does():
    reads = _reads(7, 4, 600, 700, "ACGT")
    args = dict(min_read_length=100, batch_bases=1_000, cap=1 << 10)
    msg = _error(lambda: K.count_kmers_batched(reads, device=CPU, **args))
    assert "cap" in msg and msg == _error(lambda: JK.count_kmers_batched(reads, **args))


@pytest.mark.parametrize("k,w", [(15, 5), (17, 1), (7, 8)])
def test_minimizer_index_equals_jax(k, w):
    reads = _coverage_reads(40 + k, n=10, genome_len=1_500, read_len=300) + _reads(k, 3, 250, 300)
    got = K.build_minimizer_index(reads, k=k, window=w, min_read_length=200)
    want = JK.build_minimizer_index(reads, k=k, window=w, min_read_length=200)
    assert got == want and got["selected_kmers"] > 0


@pytest.fixture
def kmer_files(tmp_path):
    fa = tmp_path / "reads.fa"
    reads = _coverage_reads(3, n=12, genome_len=2_000, read_len=450) + _reads(8, 4, 100, 200)
    fa.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    fq = tmp_path / "reads.fq"
    fq.write_text("".join(f"@q{i}\n{s}\n+\n{'I' * len(s)}\n"
                          for i, s in enumerate(_reads(9, 5, 300, 500))))
    cfgs = {}
    for name, text in (("count", "kmer_size = 17\nuse_minimizers = 0 ; a comment\n"),
                       ("minimizers", "kmer_size = 15\nuse_minimizers = 1\n"
                                      "minimizer_window = 4\nrepeat_kmer_rate = 1.5 # x\n")):
        cfgs[name] = tmp_path / f"{name}.cfg"
        cfgs[name].write_text(text)
    return f"{fa},{fq}", cfgs


def _masked(text):
    """A run's lines with the timestamps, Kernel time and memory figures masked."""
    text = re.sub(r"^\[[0-9: -]+\]", "[stamp]", text, flags=re.M)
    text = re.sub(r"Kernel time: [0-9.]+ sec", "Kernel time: t sec", text)
    return re.sub(r"(RAM[a-z ]*: )\d+ Gb", r"\1n Gb", text)


@pytest.mark.parametrize("mode,extra", [("count", []), ("minimizers", []),
                                        ("count", ["--kmer", "13", "--min-read", "350"])])
def test_cli_prints_the_jax_cli_lines(kmer_files, capsys, monkeypatch, mode, extra):
    monkeypatch.setattr(compile_cache, "enable", lambda *a, **kw: None)
    reads, cfgs = kmer_files
    argv = ["--reads", reads, "--config", str(cfgs[mode]), "--min-ovlp", "250", "--debug", *extra]
    assert jcli.main(argv) == 0
    want = capsys.readouterr()
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want.out and "useMinimizers:" in got.out
    assert _masked(got.err) == _masked(want.err)
    assert ("Total k-mers" in got.err) == (mode == "count")
    assert ("Selected k-mers" in got.err) == (mode == "minimizers")


def test_cli_streamed_path_prints_the_same_lines(kmer_files, capsys, monkeypatch):
    """Past BATCHED_BASES the CLI streams through count_kmers_batched (the
    bound lowered here so a small file takes that path)."""
    monkeypatch.setattr(compile_cache, "enable", lambda *a, **kw: None)
    reads, cfgs = kmer_files
    argv = ["--reads", reads, "--config", str(cfgs["count"]), "--min-ovlp", "250", "--debug"]
    jcli.main(argv)
    want = capsys.readouterr()
    calls = []
    real = K.count_kmers_batched
    monkeypatch.setattr(cli, "BATCHED_BASES", 1_000)
    monkeypatch.setattr(K, "count_kmers_batched",
                        lambda *a, **kw: calls.append(1) or real(*a, batch_bases=2_000, **kw))
    cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr()
    assert calls and got.out == want.out and _masked(got.err) == _masked(want.err)


def test_entry_points_need_a_gpu_or_device_cpu(kmer_files, monkeypatch):
    reads, cfgs = kmer_files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: cli.main(["--reads", reads, "--config", str(cfgs["count"])]),
               lambda: K.count_kmers(_reads(1, 2, 300, 400), min_read_length=100),
               lambda: K.count_kmers_batched(_reads(1, 2, 300, 400), min_read_length=100)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_load_flye_cfg_parses_values(tmp_path):
    cfg = tmp_path / "x.cfg"
    cfg.write_text("a = 3\nb=2.5 ; c\n# whole line\nname = flye\n\nnoequals\n")
    assert load_flye_cfg(str(cfg)) == {"a": 3, "b": 2.5, "name": "flye"}
