"""The port's FM-index SMEM seeding (genomicsbench_palisade_tpu_torch) against
the JAX package's device engine, builder and CLI and the oracle, on the CPU
at small sizes.

Tolerance: none.  Every value is an integer (intervals, positions, counts,
flags), so the port's torch ops (what the CPU runs; the card is held to
the CPU in tests/test_torch_cuda.py and chip_smoke.py) must equal the JAX
package's results and the oracle's exactly, with the JAX engine run at
both index dtypes (int32 and int64) against the port's int64.
"""

import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu.cli import fmi as jcli
from genomicsbench_palisade_tpu.index import builder as JB
from genomicsbench_palisade_tpu.index import fmi_index as JFI
from genomicsbench_palisade_tpu.ops import fmi as JF
from genomicsbench_palisade_tpu.ops import fmi_pipeline as JP
from genomicsbench_palisade_tpu.ops.oracle import fmi as JO
from genomicsbench_palisade_tpu.parallel.mesh import shard_work_imbalance as j_imbalance
from genomicsbench_palisade_tpu_torch.cli import fmi as cli
from genomicsbench_palisade_tpu_torch.convert import fmi_index_from_numpy
from genomicsbench_palisade_tpu_torch.index import builder as IB
from genomicsbench_palisade_tpu_torch.index import fmi_index as FI
from genomicsbench_palisade_tpu_torch.io.fastq import encode_reads, read_all
from genomicsbench_palisade_tpu_torch.ops import fmi as F
from genomicsbench_palisade_tpu_torch.ops import fmi_pipeline as FP
from genomicsbench_palisade_tpu_torch.ops.oracle import fmi as O

REPO = Path(__file__).resolve().parents[1]
KEYS = ("rid", "m", "n", "k", "l", "s")


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_index(didx, dtype):
    didx.idx_dtype = dtype
    return {k: jnp.asarray(v) for k, v in didx.as_device_arrays().items()}


@pytest.fixture(scope="module")
def setup():
    """tests/test_fmi_jax.py's case: a repetitive genome (a 120-base unit
    five times, then 400 random bases) and 24 reads of 40-150 bases with 3%
    substitutions, N included, so that the reseed phase runs."""
    rng = np.random.default_rng(9)
    unit = "".join(rng.choice(list("ACGT"), 120))
    fwd = (unit * 5) + "".join(rng.choice(list("ACGT"), 400))
    oidx = O.build_index(fwd)
    reads = []
    for _ in range(24):
        ln = int(rng.integers(40, 151))
        st0 = int(rng.integers(0, len(fwd) - ln))
        r = fwd[st0 : st0 + ln]
        r = "".join(ch if rng.random() > 0.03 else rng.choice(list("ACGTN")) for ch in r)
        reads.append(r)
    enc, rl = encode_reads(reads)
    jdidx = JFI.from_oracle_index(JO.build_index(fwd), np.int32)
    return dict(fwd=fwd, oidx=oidx, reads=reads, enc=enc, rl=rl, jdidx=jdidx,
                index=fmi_index_from_numpy(FI.from_oracle_index(oidx), "cpu"))


def _t(a):
    return torch.as_tensor(np.asarray(a)).long()


def test_oracle_copy_equals_jax_oracle(setup):
    fwd, reads = setup["fwd"], setup["reads"]
    a, b = O.build_index(fwd[:700]), JO.build_index(fwd[:700])
    for key in ("count", "bwt", "sa", "cp_count", "one_hot"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    assert (a.ref_seq_len, a.sentinel_index) == (b.ref_seq_len, b.sentinel_index)
    codes = np.random.default_rng(1).integers(0, 4, 3000)
    np.testing.assert_array_equal(O.suffix_array(codes), JO.suffix_array(codes))
    enc = [O.encode_read(r) for r in reads]
    assert all(np.array_equal(e, JO.encode_read(r)) for e, r in zip(enc, reads))
    oidx, jidx = setup["oidx"], JO.build_index(fwd)
    assert O.fmi_pipeline(oidx, enc) == JO.fmi_pipeline(jidx, enc)
    assert O.fmi_pipeline(oidx, enc, min_seed_len=12) == JO.fmi_pipeline(jidx, enc, min_seed_len=12)
    for e in enc[:6]:
        assert (O.bwt_seed_strategy_one_read(oidx, e, 20, 15)
                == JO.bwt_seed_strategy_one_read(jidx, e, 20, 15))


def test_oracle_view_searches_like_the_built_index(setup):
    oidx, enc = setup["oidx"], [O.encode_read(r) for r in setup["reads"]]
    view = O.oracle_view(IB.build_arrays(JB._CODE_TABLE[np.frombuffer(
        setup["fwd"].encode(), np.uint8)], device="cpu"))
    assert view.bwt.size == 0 and view.sa.size == 0
    for pp in range(oidx.ref_seq_len + 1):
        assert [O.occ(view, pp, c) for c in range(4)] == [O.occ(oidx, pp, c) for c in range(4)]
    assert O.fmi_pipeline(view, enc) == O.fmi_pipeline(oidx, enc)


@pytest.mark.parametrize("n_bases", [3000, 4471, 6000])
@pytest.mark.parametrize("sa_compression", [False, True])
def test_build_arrays_equals_jax(n_bases, sa_compression):
    codes = np.random.default_rng(n_bases).integers(0, 4, n_bases).astype(np.uint8)
    got = IB.build_arrays(codes, sa_compression=sa_compression, device="cpu")
    want = JB.build_arrays(codes, sa_compression=sa_compression)
    assert (got.ref_seq_len, got.sentinel_index, got.sa_compression) == (
        want.ref_seq_len, want.sentinel_index, want.sa_compression)
    np.testing.assert_array_equal(got.count, want.count)
    np.testing.assert_array_equal(got.cp_count, want.cp_count)
    hi, lo = FI.split_one_hot(got.cp_occ)
    np.testing.assert_array_equal(hi, want.one_hot_hi)
    np.testing.assert_array_equal(lo, want.one_hot_lo)
    np.testing.assert_array_equal(got.sa_ms_byte, want.sa_ms_byte)
    np.testing.assert_array_equal(got.sa_ls_word, want.sa_ls_word)
    full = np.concatenate([codes, 3 - codes[::-1]])
    np.testing.assert_array_equal(IB.suffix_array(full, "cpu").numpy(), JO.suffix_array(full))


def test_pack_fasta_equals_jax(tmp_path):
    fa = tmp_path / "x.fa"
    fa.write_text(">a x\nACGTNNRYacgt\nAC\n>b\nNNNNGGT\n>c\nTTTT\n")
    got, want = IB.pack_fasta(str(fa)), JB.pack_fasta(str(fa))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == ["a", "b", "c"]
    np.testing.assert_array_equal(got[2], want[2])


def test_suffix_array_edges():
    for text in ([0], [3, 3], [2, 2, 2, 2, 2], [3, 0], [1, 0, 1, 0, 1, 0, 1]):
        np.testing.assert_array_equal(IB.suffix_array(np.array(text), "cpu").numpy(),
                                      JO.suffix_array(np.array(text)))


def test_builder_raises_without_cuda(monkeypatch):
    """The builder is an entry point: with no GPU and no device it raises,
    as every other one does, instead of building on the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codes = np.array([0, 1, 2, 3, 3, 1], np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IB.build_arrays(codes)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IB.suffix_array(codes)
    assert IB.build_arrays(codes, device="cpu").ref_seq_len == 13


def test_occ_all_equals_jax_at_every_position(setup):
    index = setup["index"]
    pp = np.arange(setup["oidx"].ref_seq_len + 1)
    got = F.occ_all(index, _t(pp)).numpy()
    for dtype in (np.int32, np.int64):
        want = np.asarray(JF.occ_all(_jax_index(setup["jdidx"], dtype), jnp.asarray(pp)))
        np.testing.assert_array_equal(got, want)
    assert got[-1].tolist() == [int(setup["oidx"].count[c + 1] - setup["oidx"].count[c])
                                for c in range(4)]


def test_popcount_and_top_mask_equal_numpy():
    rng = np.random.default_rng(2)
    words = np.concatenate([rng.integers(-2**63, 2**63 - 1, 1000, dtype=np.int64),
                            np.array([0, -1, -2**63, 2**63 - 1], np.int64)])
    want = [bin(int(w) & 0xFFFFFFFFFFFFFFFF).count("1") for w in words]
    assert F.popcount64(torch.from_numpy(words)).tolist() == want
    masks = F.top_mask(torch.arange(64)).numpy().view(np.uint64)
    assert masks[0] == 0 and all(int(masks[y]) == ((1 << 64) - 1) ^ ((1 << (64 - y)) - 1)
                                 for y in range(1, 64))


def test_backward_ext_matches_oracle(setup):
    """tests/test_fmi_jax.py:39-58 on the port."""
    oidx, index, fwd = setup["oidx"], setup["index"], setup["fwd"]
    rng = np.random.default_rng(11)
    for _ in range(30):
        plen = int(rng.integers(1, 10))
        start = int(rng.integers(0, len(fwd) - plen))
        codes = [O._CODE[c] for c in fwd[start : start + plen]]
        a0 = codes[-1]
        sm = {"rid": 0, "m": 0, "n": 0, "k": int(oidx.count[a0]), "l": int(oidx.count[3 - a0]),
              "s": int(oidx.count[a0 + 1] - oidx.count[a0])}
        k, l, s = _t([sm["k"]]), _t([sm["l"]]), _t([sm["s"]])
        for a in reversed(codes[:-1]):
            sm = O.backward_ext(oidx, sm, a)
            k, l, s = F.backward_ext(index, k, l, s, _t([a]))
            assert (int(k[0]), int(l[0]), int(s[0])) == (sm["k"], sm["l"], sm["s"])


def _bufs_np(bufs):
    return {k: np.asarray(v).astype(np.int64) for k, v in bufs.items()}


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_all_pos_and_last_equal_jax_and_oracle(setup, dtype):
    oidx, enc, rl, index = setup["oidx"], setup["enc"], setup["rl"], setup["index"]
    jindex = _jax_index(setup["jdidx"], dtype)
    b = len(rl)
    st = {}
    bufs, counts, ovf = F.smems_all_pos_batch(index, _t(enc), _t(rl), _t(np.ones(b)), 19, stats=st)
    jb, jc, jo = JF.smems_all_pos_batch(jindex, jnp.asarray(enc, jnp.int32), jnp.asarray(rl),
                                        jnp.ones(b, jnp.int32), 19)
    got = _bufs_np(bufs)
    assert all(np.array_equal(got[k], v) for k, v in _bufs_np(jb).items())
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jo))
    assert not ovf.any() and st["steps"] > 0 and st["occ_rows"] > 0
    for i, r in enumerate(setup["reads"]):
        want = O.get_smems_all_pos(oidx, O.encode_read(r), 1, 19, 0)
        have = [tuple(int(got[f][i, p]) for f in "mnkls") for p in range(int(counts[i]))]
        assert have == [(w["m"], w["n"], w["k"], w["l"], w["s"]) for w in want], i

    bufs3, counts3, ovf3 = F.bwt_seed_strategy_batch(index, _t(enc), _t(rl), _t(np.full(b, 20)), 20)
    jb3, jc3, jo3 = JF.bwt_seed_strategy_batch(jindex, jnp.asarray(enc, jnp.int32),
                                               jnp.asarray(rl), jnp.full(b, 20, jnp.int32), 20)
    got3 = _bufs_np(bufs3)
    assert all(np.array_equal(got3[k], v) for k, v in _bufs_np(jb3).items())
    np.testing.assert_array_equal(counts3.numpy(), np.asarray(jc3))
    np.testing.assert_array_equal(ovf3.numpy(), np.asarray(jo3))
    for i, r in enumerate(setup["reads"]):
        want = O.bwt_seed_strategy_one_read(oidx, O.encode_read(r), 20, 20)
        have = [tuple(int(got3[f][i, p]) for f in "mnkls") for p in range(int(counts3[i]))]
        assert have == [(w["m"], w["n"], w["k"], w["l"], w["s"]) for w in want], i


def _tuples(out):
    return list(zip(*(out[k].tolist() for k in KEYS)))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_pipeline_equals_jax_and_oracle(setup, dtype):
    oidx, enc, rl, index = setup["oidx"], setup["enc"], setup["rl"], setup["index"]
    jindex = _jax_index(setup["jdidx"], dtype)
    st = {}
    got, n1, n2, n3, ovf = FP.fmi_pipeline_batch(index, enc, rl, stats=st)
    want, w1, w2, w3 = O.fmi_pipeline(oidx, [O.encode_read(r) for r in setup["reads"]])
    assert (n1, n2, n3) == (w1, w2, w3) and n2 > 0 and not ovf
    assert _tuples(got) == [tuple(w[k] for k in KEYS) for w in want]
    jgot, *jn = JP.fmi_pipeline_batch(jindex, enc.astype(np.int32), rl)
    assert [n1, n2, n3, ovf] == jn
    assert all(np.array_equal(got[k], jgot[k]) for k in KEYS)
    assert {"steps1", "steps2", "steps3", "occ_rows", "search_s", "collect_s"} <= set(st)
    # the packed device result, every row and slot
    split = FP.split_len_of(19)
    packed, ovf_r = FP.fmi_pipeline_device(index, _t(enc), _t(rl), 19, 10, 20, split)
    jpacked, jovf_r = JP.fmi_pipeline_device(jindex, jnp.asarray(enc, jnp.int32), jnp.asarray(rl),
                                             19, 10, 20, split)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked).astype(np.int64))
    assert bool(ovf_r) == bool(jovf_r) is False


@pytest.mark.parametrize("m_cap,reseed_cap", [(2, 3), (4, 1)])
def test_overflow_flags_and_truncation_equal_jax(setup, m_cap, reseed_cap):
    enc, rl, index = setup["enc"], setup["rl"], setup["index"]
    jindex = _jax_index(setup["jdidx"], np.int32)
    split = FP.split_len_of(15)
    packed, ovf_r = FP.fmi_pipeline_device(index, _t(enc), _t(rl), 15, 10, 20, split,
                                           m_cap=m_cap, reseed_cap=reseed_cap)
    jpacked, jovf_r = JP.fmi_pipeline_device(jindex, jnp.asarray(enc, jnp.int32), jnp.asarray(rl),
                                             15, 10, 20, split, m_cap=m_cap,
                                             reseed_cap=reseed_cap)
    packed = packed.numpy()
    np.testing.assert_array_equal(packed, np.asarray(jpacked).astype(np.int64))
    assert bool(ovf_r) and bool(jovf_r)
    b = len(rl)
    assert packed[-b:, 2].any() and packed[:b, 2].any() == (m_cap == 2)  # phase 3; phase 1 at 2
    got = FP.fmi_pipeline_batch(index, enc, rl, min_seed_len=15, m_cap=m_cap,
                                reseed_cap=reseed_cap)
    jgot = JP.fmi_pipeline_batch(jindex, enc.astype(np.int32), rl, min_seed_len=15, m_cap=m_cap,
                                 reseed_cap=reseed_cap)
    assert list(got[1:]) == list(jgot[1:]) and got[4]
    assert all(np.array_equal(got[0][k], jgot[0][k]) for k in KEYS)


def test_reseed_slots_write_each_live_slot_once():
    rng = np.random.default_rng(5)
    keep = torch.from_numpy(rng.random(200) < 0.3)
    lane = torch.arange(200) // 8
    for r in (5, 60, 400):
        rid, mid, miv, dest, n = FP.reseed_slots(keep, lane, torch.arange(200), torch.arange(200) + 1, r)
        live = dest[dest < r]
        assert live.unique().numel() == live.numel() == min(int(n), r)
        assert torch.equal(live, torch.arange(min(int(n), r)))
        kept = torch.nonzero(keep)[:, 0][:r]
        assert torch.equal(mid[: kept.numel()], kept) and torch.equal(rid[: kept.numel()], lane[kept])
        assert (rid[kept.numel():] == -1).all() and (miv[kept.numel():] == 1).all()


def test_convert_carries_jax_device_arrays(setup):
    jd = setup["jdidx"]
    for dtype in (np.int32, np.int64):
        jd.idx_dtype = dtype
        got = fmi_index_from_numpy(jd.as_device_arrays(), "cpu")
        assert got["cp_occ"].dtype == torch.int64 and got["cp_occ"].shape[1] == 8
        assert torch.equal(got["cp_occ"], setup["index"]["cp_occ"])
        assert torch.equal(got["count"], setup["index"]["count"])
        assert got["sentinel_index"] == setup["index"]["sentinel_index"]


def test_index_files_interoperate(tmp_path):
    codes = np.random.default_rng(3).integers(0, 4, 2500).astype(np.uint8)
    jidx = JB.build_arrays(codes)
    path = str(tmp_path / "x.bwt.2bit.64")
    JB.write_bwt2bit64(jidx, path)
    got, want = FI.load_bwt2bit64(path, load_sa=True), JFI.load_bwt2bit64(path, load_sa=True)
    np.testing.assert_array_equal(got.cp_count, want.cp_count)
    np.testing.assert_array_equal(FI.split_one_hot(got.cp_occ)[0], want.one_hot_hi)
    np.testing.assert_array_equal(got.sa_ls_word, want.sa_ls_word)
    assert (got.ref_seq_len, got.sentinel_index) == (want.ref_seq_len, want.sentinel_index)
    np.testing.assert_array_equal(got.count, want.count)
    JFI.save_npz(jidx, str(tmp_path / "j.npz"))
    FI.save_npz(got, str(tmp_path / "t.npz"))
    for p in ("j.npz", "t.npz"):
        a, b = FI.load_npz(str(tmp_path / p)), JFI.load_npz(str(tmp_path / p))
        np.testing.assert_array_equal(a.cp_occ, got.cp_occ)
        np.testing.assert_array_equal(b.one_hot_lo, jidx.one_hot_lo)


def test_encode_reads_equals_encode_read(tmp_path):
    seqs = ["ACGTacgtNnRYx", "", "TTTT", "gattaca"]
    enc, rl = encode_reads(seqs)
    assert rl.tolist() == [13, 0, 4, 7] and enc.shape == (4, 13) and enc.dtype == np.int8
    for e, s, n in zip(enc, seqs, rl):
        np.testing.assert_array_equal(e[:n], O.encode_read(s))
        assert (e[n:] == 4).all()
    fq = tmp_path / "r.fq"
    fq.write_text("@a x\nACGN\n+\nIIII\n@b\nGG\n+\nII\n")
    assert read_all(fq) == [("a", "ACGN", "IIII"), ("b", "GG", "II")]
    assert read_all(fq, limit=1) == [("a", "ACGN", "IIII")]


def _cli_inputs(tmp_path, seed=8, n_bases=3000, n_reads=48):
    """A random genome as a FASTA and the npz of its index (the JAX
    builder's), and reads of 60-90 bases, N and lowercase included."""
    rng = np.random.default_rng(seed)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, n_bases)])
    (tmp_path / "g.fa").write_text(">g\n" + genome + "\n")
    JFI.save_npz(JB.build_arrays(JB._CODE_TABLE[np.frombuffer(genome.encode(), np.uint8)]),
                 str(tmp_path / "g.npz"))
    with open(tmp_path / "r.fq", "w") as f:
        for i in range(n_reads):
            n = int(rng.integers(60, 91))
            s = int(rng.integers(0, n_bases - n))
            r = "".join(c if rng.random() > 0.02 else "N" for c in genome[s : s + n])
            r = r.lower() if i % 7 == 0 else r
            f.write(f"@q{i}\n{r}\n+\n{'I' * n}\n")
    return tmp_path / "g.fa", tmp_path / "g.npz", tmp_path / "r.fq"


@pytest.mark.parametrize("index_kind", ["npz", "fasta"])
def test_cli_matches_jax_cli(tmp_path, capsys, monkeypatch, index_kind):
    """Every printed line but Consumed, the dump included, at batch 16 over
    three batches.  The JAX CLI counts the devices it sees as shards of its
    load-imbalance line; the port runs on one device, so the JAX CLI is
    shown one device."""
    fa, npz, fq = _cli_inputs(tmp_path)
    index = str(npz if index_kind == "npz" else fa)
    assert cli.main([index, str(fq), "16", "--print-output", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    monkeypatch.setenv("GENOMICS_TPU_CACHE_DIR", str(tmp_path / "xla"))
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k: jax.devices()[:1])
    assert jcli.main([index, str(fq), "16", "--print-output", "--engine", "tpu"]) == 0
    jout = capsys.readouterr().out
    keep = lambda text: [ln for ln in text.splitlines() if not ln.startswith("Consumed: ")]
    assert keep(out) == keep(jout)
    assert sum(ln.startswith("num_smem1") for ln in keep(out)) == 3
    assert sum(ln.startswith("[") for ln in keep(out)) > 48
    # the search's results through prepare + run equal the CLI's
    prep = cli.prepare(index, str(fq), "cpu")
    buf = io.StringIO()
    cli.print_output(cli.run(prep.index, prep.enc, prep.rl, 16, 19), buf)
    assert buf.getvalue().splitlines() == [ln for ln in keep(out) if ln.startswith("[")
                                           or ln.endswith(":") and ln[:-1].isdigit()]


def test_cli_engine_tpu_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """The JAX CLI's `--engine tpu` command line runs on the port (its
    `device` is an alias) and prints the JAX CLI's lines but Consumed."""
    _fa, npz, fq = _cli_inputs(tmp_path)
    args = [str(npz), str(fq), "16", "18", "--print-output", "--engine"]
    assert cli.main(args + ["tpu", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert cli.main(args + ["device", "--device", "cpu"]) == 0
    alias = capsys.readouterr().out
    monkeypatch.setenv("GENOMICS_TPU_CACHE_DIR", str(tmp_path / "xla"))
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k: jax.devices()[:1])
    assert jcli.main(args + ["tpu"]) == 0
    jout = capsys.readouterr().out
    keep = lambda text: [ln for ln in text.splitlines() if not ln.startswith("Consumed: ")]
    assert keep(out) == keep(jout) == keep(alias)
    assert sum(ln.startswith("num_smem1") for ln in keep(out)) == 3


def test_cli_refuses_host_engine_and_copies_imbalance(tmp_path, capsys):
    fa, npz, fq = _cli_inputs(tmp_path, n_reads=4)
    with pytest.raises(SystemExit):
        cli.main([str(npz), str(fq), "--engine", "host", "--device", "cpu"])
    assert "ROADMAP queue 1 item 14" in capsys.readouterr().err
    for work in ([3, 1, 4, 1, 5], [0, 0], [7]):
        for n in (1, 2, 3):
            assert cli.shard_work_imbalance(work, n) == j_imbalance(work, n)
    assert cli.main([str(npz), str(fq), "2", "18", "--limit", "3", "--repeat", "2",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "numReads = 3," in out and "repeat Consumed: " in out and out.count("\nbatch_id: ") == 2


def test_chip_smoke_fmi_generators(tmp_path, monkeypatch):
    """chip_smoke.py's reference and reads are tools/genome_scale_fmi.py's
    synth_reference and synth_reads (same rng draws), and its FASTQ holds
    those reads."""
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    import genome_scale_fmi

    fa = tmp_path / "ref.fa"
    genome_scale_fmi.synth_reference(fa, 1, seed=5)
    codes = chip_smoke.synth_reference_codes(1, np.random.default_rng(5))
    np.testing.assert_array_equal(codes, JB.pack_fasta(str(fa))[0])
    np.testing.assert_array_equal(codes, IB.pack_fasta(str(fa))[0])
    want = genome_scale_fmi.synth_reads(fa, 40, 151, seed=6)
    enc = chip_smoke.synth_reads(codes, 40, 151, np.random.default_rng(6))
    np.testing.assert_array_equal(enc, want)
    fq = tmp_path / "r.fq"
    chip_smoke.write_fastq(fq, enc)
    got, rl = encode_reads([s for _n, s, _q in read_all(fq)])
    np.testing.assert_array_equal(got, enc)
    assert (rl == 151).all()
