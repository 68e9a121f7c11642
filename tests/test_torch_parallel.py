"""The port's sharded runtime (parallel/) against the JAX package's.

One module-scoped spawn of 4 gloo ranks on the CPU runs the port's nine
sharded paths on the shapes and seeds of tests/test_parallel.py (phmm, bsw,
fmi search, kmer, grm, fmi pipeline, the shard files) and of the JAX dry
run (chain at w 16, poa, the abea fill); each rank keeps what it got, and
the tests hold every rank's result to the JAX `dp` functions on a mesh of
4 of the conftest's 8 virtual devices:
  phmm within 1e-5 log10; bsw, kmer metrics and per-shard stats, fmi
  (k, l, s) and the fmi pipeline's rows after collect exactly; chain
  exactly at w 16 and equal to the port's oracle at w >= w_need; poa's
  packed rows exactly; abea traces and band starts exactly, the last
  values within tests/test_torch_abea.py's 8 ulps; grm within
  tests/test_torch_grm.py's 2e-5 of the float64 oracle.
Also: the shard files each way between the packages, `entry` against the
JAX `entry`, `dryrun_multichip(2)`, `cli.phmm` under 2 ranks (the bytes of
one rank's run), a collective whose peer left and a group init with no
peer (both raise), the plain chain's preset head, the fmi load imbalance.

The module imports no JAX at its top: the spawned ranks import it by name.
"""

from __future__ import annotations

import contextlib
import io
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu_torch.convert import (abea_batch_from_numpy,
                                                      bsw_batch_from_numpy)
from genomicsbench_palisade_tpu_torch.index import builder as PB
from genomicsbench_palisade_tpu_torch.index import fmi_index as PFI
from genomicsbench_palisade_tpu_torch.io.phmm_batch import parse_testfile
from genomicsbench_palisade_tpu_torch.ops import abea as PA
from genomicsbench_palisade_tpu_torch.ops import bsw as PW
from genomicsbench_palisade_tpu_torch.ops import chain as PC
from genomicsbench_palisade_tpu_torch.ops import fmi_pipeline as PFP
from genomicsbench_palisade_tpu_torch.ops import kmer as PK
from genomicsbench_palisade_tpu_torch.ops import phmm as PP
from genomicsbench_palisade_tpu_torch.ops import poa as PPOA
from genomicsbench_palisade_tpu_torch.ops.oracle import chain as PCO
from genomicsbench_palisade_tpu_torch.ops.oracle.abea import get_kmer_rank
from genomicsbench_palisade_tpu_torch.ops.oracle.poa import PoaGraph
from genomicsbench_palisade_tpu_torch.parallel import dp, mesh as M

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
GRM_TOL = 2e-5  # tests/test_torch_grm.py's
ABEA_ULPS = 8  # tests/test_torch_abea.py's last-value tolerance against the JAX scan
POA_PARAMS = (2, -4, -6, -2, -25, -1)
CODE_MAP = {ch: i for i, ch in enumerate("ACGT")}


# ---------------------------------------------------------------- inputs


def phmm_case():
    """tests/test_parallel.py's 16 testcases."""
    rng = np.random.default_rng(0)
    reads, haps, pairs = [], [], []
    for k in range(16):
        rl, hl = int(rng.integers(5, 30)), int(rng.integers(5, 40))
        reads.append({"bases": rng.integers(0, 4, rl), "q": rng.integers(33, 60, rl),
                      "i": rng.integers(33, 60, rl), "d": rng.integers(33, 60, rl),
                      "c": rng.integers(33, 60, rl)})
        haps.append(rng.integers(0, 4, hl))
        pairs.append((k, k))
    return reads, haps, pairs


def bsw_case():
    rng = np.random.default_rng(4)
    pairs = []
    for _ in range(16):
        ql, tl = int(rng.integers(5, 40)), int(rng.integers(5, 60))
        pairs.append((rng.integers(0, 5, ql), rng.integers(0, 5, tl), int(rng.integers(1, 40))))
    return pairs


def fmi_search_case():
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 4000).astype(np.uint8)
    b, l_max = 16, 24
    enc = np.zeros((b, l_max), np.int32)
    lengths = np.zeros(b, np.int32)
    for i in range(b):
        n = int(rng.integers(8, l_max + 1))
        s = int(rng.integers(0, len(genome) - n))
        enc[i, :n] = genome[s : s + n]
        lengths[i] = n
    enc[0, 2] = (enc[0, 2] + 1) % 4  # a mismatch: s reaches 0 mid-walk
    return genome, enc, lengths


def kmer_case():
    rng = np.random.default_rng(9)
    unit = "".join(rng.choice(list("ACGT"), 30))
    reads = [unit * 10 for _ in range(3)] + ["".join(rng.choice(list("ACGT"), 200))
                                             for _ in range(13)]
    return PK.encode_reads_np(reads)


def grm_case():
    rng = np.random.default_rng(12)
    geno = rng.choice([0, 1, 2, 3], size=(64, 24), p=[.5, .3, .15, .05]).astype(np.int8)
    miss = geno == 3
    g64 = np.where(miss, 0.0, geno.astype(np.float64))
    freqs = g64.sum(1) / np.maximum(2.0 * (~miss).sum(1), 1.0)
    var = 2.0 * freqs * (1.0 - freqs)
    ok = var > 2 ** -44
    isd = np.where(ok, 1.0 / np.sqrt(np.where(ok, var, 1.0)), 0.0)
    return geno, (2 * freqs).astype(np.float32), isd.astype(np.float32), ok


def chain_case(n, seed, spread):
    """tests/test_parallel.py's anchors, with query spans 10-29 in y's bits
    32-39 (without them every score is 0 and no anchor has a parent)."""
    rng = np.random.default_rng(seed)
    xs = np.cumsum(rng.integers(1, 40, n)).astype(np.int64) + 1000
    ys = np.maximum(xs + rng.integers(-spread, spread, n), 0)
    return xs, ys | (rng.integers(10, 30, n) << 32)


def fmi_pipeline_case():
    rng = np.random.default_rng(17)
    genome = rng.integers(0, 4, 6000).astype(np.uint8)
    b, l_max = 16, 40
    enc = np.full((b, l_max), 4, np.int32)
    lengths = np.zeros(b, np.int32)
    for i in range(b):
        n = int(rng.integers(24, l_max + 1))
        s = int(rng.integers(0, len(genome) - n))
        seq = genome[s : s + n].astype(np.int32)
        mut = rng.random(n) < 0.05
        seq[mut] = rng.integers(0, 4, int(mut.sum()))
        enc[i, :n] = seq
        lengths[i] = n
    return genome, enc, lengths


def shard_files_case():
    rng = np.random.default_rng(23)
    genome = rng.integers(0, 4, 5000).astype(np.uint8)
    b, l_max = 8, 32
    enc = np.full((b, l_max), 4, np.int32)
    lengths = np.zeros(b, np.int32)
    for i in range(b):
        n = int(rng.integers(20, l_max + 1))
        s = int(rng.integers(0, len(genome) - n))
        enc[i, :n] = genome[s : s + n]
        lengths[i] = n
    return genome, enc, lengths


def poa_case():
    """The JAX dry run's poa step at 4 devices: 8 windows of 24 bases, each
    graph one sequence, aligned against a copy with 10% substitutions."""
    rng = np.random.default_rng(31)
    wb = 2 * WORLD
    bases = ["".join(rng.choice(list("ACGT"), 24)) for _ in range(wb)]
    seqs = []
    for s in bases:
        cs = list(s)
        for p in np.nonzero(rng.random(len(cs)) < 0.1)[0]:
            cs[p] = "ACGT"[rng.integers(0, 4)]
        seqs.append("".join(cs))
    return bases, seqs


def abea_case():
    """The JAX dry run's abea step at 4 devices: 8 reads of 24 bases."""
    rng = np.random.default_rng(33)
    model = {"level_mean": rng.normal(90, 12, 4096).astype(np.float32),
             "level_stdv": (rng.random(4096) + 1).astype(np.float32)}
    model["level_log_stdv"] = np.log(model["level_stdv"]).astype(np.float32)
    seqs, evs = [], []
    for _ in range(2 * WORLD):
        seq = "".join(rng.choice(list("ACGT"), 24))
        raw = []
        for p in range(len(seq) - 5):
            raw.extend(model["level_mean"][get_kmer_rank(seq[p : p + 6])]
                       + rng.normal(0, 0.3, int(rng.integers(1, 3))))
        seqs.append(seq)
        evs.append(np.asarray(raw, np.float32))
    return model, seqs, evs


CHAIN_W16 = dict(n=48 * WORLD, seed=1, spread=200)  # the JAX dry run's call, w 16
CHAIN_FULL = dict(n=1200, seed=21, spread=300)  # tests/test_parallel.py's kind, w >= w_need


def chain_full_w(call) -> int:
    return max(call["w_need"], 16)


# ---------------------------------------------------------------- the ranks


def _rank(rank: int, outdir: str):
    """One of the 4 ranks: every sharded path, the results pickled."""
    torch.set_num_threads(1)
    mesh = M.make_mesh(WORLD, device="cpu")
    cpu = torch.device("cpu")
    res = {}

    reads, haps, pairs = phmm_case()
    rows, n = M.shard_batch(PP.prepare_batch(reads, haps, pairs), mesh)
    res["phmm"] = (dp.phmm_forward_sharded(mesh, rows), n)

    tb, params = bsw_batch_from_numpy(PW.prepare_pairs(bsw_case(), q_pad=64, t_pad=64), cpu)
    res["bsw"] = dp.bsw_batch_sharded(mesh, tb, params).numpy()

    genome, enc, lengths = fmi_search_case()
    res["fmi_search"] = [t.numpy() for t in dp.fmi_backward_search_sharded(
        mesh, PB.build_arrays(genome, device="cpu"), enc, lengths)]

    bases, lens = kmer_case()
    res["kmer"] = dp.count_kmers_sharded(mesh, bases, lens, k=17, return_shard_stats=True)

    sums, counts = dp.grm_sharded(mesh, *grm_case(), block=8)
    res["grm"] = (sums.numpy(), counts.numpy())

    call = PC.prepare_call(*chain_case(**CHAIN_W16), avg_qspan=22.5)
    res["chain_w16"] = dp.chain_dp_halo_sharded(mesh, call, w=16)
    call = PC.prepare_call(*chain_case(**CHAIN_FULL), avg_qspan=22.5)
    res["chain_full"] = dp.chain_dp_halo_sharded(mesh, call, w=chain_full_w(call))

    genome, enc, lengths = fmi_pipeline_case()
    packed, ovf = dp.fmi_pipeline_index_sharded(mesh, PB.build_arrays(genome, device="cpu"),
                                                enc, lengths, min_seed_len=15)
    res["fmi_pipeline"] = PFP.collect(packed.numpy(), bool(ovf), len(lengths))

    # the shard files: this rank loads only its own
    prefix = str(Path(outdir) / "port_idx")
    man = PFI.load_shard_manifest(prefix)
    shard = PFI.load_npz_shard(prefix, rank)
    _genome, enc, lengths = shard_files_case()
    packed, ovf = dp.fmi_pipeline_index_sharded(
        mesh, {"count": man["count"], "sentinel_index": int(man["sentinel_index"])}, enc,
        lengths, min_seed_len=15, shard_rows=(shard["cp_occ"], shard["block_start"]))
    res["fmi_files"] = PFP.collect(packed.numpy(), bool(ovf), len(lengths))

    bases_s, seqs = poa_case()
    graphs = [PoaGraph() for _ in bases_s]
    for g, a, s in zip(graphs, PPOA.align_batch(graphs, bases_s, device=cpu), bases_s):
        g.add_alignment(a, s)
    garrs, seq_arr, seq_len, w_cap, a_cap = PPOA.round_arrays(graphs, seqs)
    garr_stack = {k: np.stack([a[k] for a in garrs]) for k in garrs[0]}
    res["poa"] = dp.poa_align_sharded(mesh, seq_arr, seq_len, garr_stack, POA_PARAMS, w_cap,
                                      a_cap)

    model, aseqs, aevs = abea_case()
    batch, _idx = PA.prepare_batch(aseqs, aevs, model, [1.0] * len(aseqs), [0.0] * len(aseqs))
    res["abea"] = {k: v.numpy() for k, v in dp.abea_fill_sharded(mesh, batch).items()}

    with open(Path(outdir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def rank_dir(tmp_path_factory):
    """The ranks' folder, with the port's shard files of shard_files_case."""
    out = tmp_path_factory.mktemp("ranks")
    genome, _enc, _lengths = shard_files_case()
    PFI.save_npz_sharded(PB.build_arrays(genome, sa_compression=True, device="cpu"),
                         str(out / "port_idx"), WORLD)
    return out


@pytest.fixture(scope="module")
def runs(rank_dir):
    """Every rank's results (a list of 4 dicts)."""
    M.spawn(_rank, WORLD, (str(rank_dir),))
    return [pickle.load(open(rank_dir / f"rank{r}.pkl", "rb")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def mesh4():
    import jax

    from genomicsbench_palisade_tpu.parallel import mesh as JM

    assert len(jax.devices()) >= WORLD, "conftest must force 8 virtual cpu devices"
    return JM.make_mesh(WORLD)


def each_rank(runs, key):
    return [r[key] for r in runs]


# ---------------------------------------------------------------- the nine paths


def test_phmm_sharded_equals_jax(runs, mesh4):
    from genomicsbench_palisade_tpu.ops import phmm as JP
    from genomicsbench_palisade_tpu.parallel import dp as JD, mesh as JM

    reads, haps, pairs = phmm_case()
    sharded, n = JM.shard_batch(JP.prepare_batch(reads, haps, pairs), mesh4)
    want, _raw, want_fb = (np.asarray(a)[:n] for a in JD.phmm_forward_sharded(mesh4, sharded))
    assert 0 < want_fb.sum() < n
    for (log10, _raw, fb), n_got in each_rank(runs, "phmm"):
        assert n_got == n and len(log10) == 16
        # the flagged testcases underflow f32 and go to the f64 pass
        np.testing.assert_array_equal(fb[:n], want_fb)
        np.testing.assert_allclose(log10[:n][~fb[:n]], want[~want_fb], rtol=0, atol=1e-5)


def test_bsw_sharded_equals_jax(runs, mesh4):
    from genomicsbench_palisade_tpu.ops import bsw as JW
    from genomicsbench_palisade_tpu.parallel import dp as JD, mesh as JM

    batch = JW.prepare_pairs(bsw_case(), q_pad=64, t_pad=64)
    sharded, n = JM.shard_batch(batch, mesh4)
    want = JD.bsw_batch_sharded(mesh4, sharded)
    for got in each_rank(runs, "bsw"):
        for row, key in enumerate(PW.OUT_ORDER):
            np.testing.assert_array_equal(got[row], np.asarray(want[key])[:n], err_msg=key)


def test_fmi_search_sharded_equals_jax(runs, mesh4):
    from genomicsbench_palisade_tpu.index.builder import build_arrays
    from genomicsbench_palisade_tpu.parallel import dp as JD

    genome, enc, lengths = fmi_search_case()
    want = JD.fmi_backward_search_sharded(mesh4, build_arrays(genome).as_device_arrays(), enc,
                                          lengths)
    for got in each_rank(runs, "fmi_search"):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert (got[2][1:] > 0).all()  # the true substrings match


def test_kmer_sharded_equals_jax(runs, mesh4):
    from genomicsbench_palisade_tpu.parallel import dp as JD

    bases, lengths = kmer_case()
    metrics, shards = JD.count_kmers_sharded(mesh4, np.asarray(bases, np.int32), lengths, k=17,
                                             return_shard_stats=True)
    whole = PK.count_kmers_device(torch.from_numpy(bases), torch.from_numpy(lengths), 17)
    for got, got_shards in each_rank(runs, "kmer"):
        assert got == {k: int(v) for k, v in metrics.items()} == whole
        np.testing.assert_array_equal(got_shards["occ"], np.asarray(shards["occ"]))
        np.testing.assert_array_equal(got_shards["distinct"], np.asarray(shards["distinct"]))
        assert len(set(got_shards["occ"].tolist())) > 1  # the owners differ


def test_grm_sharded_within_tolerance_of_f64(runs):
    geno, _tf, _isd, _ok = grm_case()
    miss = geno == 3
    g64 = np.where(miss, 0.0, geno.astype(np.float64))
    freqs = g64.sum(1) / np.maximum(2.0 * (~miss).sum(1), 1.0)
    var = 2.0 * freqs * (1.0 - freqs)
    ok = var > 2 ** -44
    z = np.where(miss | ~ok[:, None], 0.0,
                 (g64 - 2 * freqs[:, None]) / np.sqrt(np.where(ok, var, 1.0))[:, None])
    v = np.where(miss | ~ok[:, None], 0.0, 1.0)
    want_counts = v.T @ v
    want = (z.T @ z) / np.maximum(want_counts, 1.0)
    for sums, counts in each_rank(runs, "grm"):
        np.testing.assert_array_equal(counts, want_counts)
        np.testing.assert_allclose(sums / np.maximum(counts, 1.0), want, atol=GRM_TOL,
                                   rtol=GRM_TOL)


def test_chain_halo_sharded_equals_jax_at_w16(runs, mesh4):
    from genomicsbench_palisade_tpu.ops import chain as JC
    from genomicsbench_palisade_tpu.parallel import dp as JD

    xs, ys = chain_case(**CHAIN_W16)
    want = JD.chain_dp_halo_sharded(mesh4, JC.prepare_call(xs, ys, avg_qspan=22.5), w=16)
    single = PC.chain_call(PC.window_clamp(PC.prepare_call(xs, ys, avg_qspan=22.5), 16), "cpu")
    for got in each_rank(runs, "chain_w16"):
        for g, w, s in zip(got, want, single):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, s)


def test_chain_halo_sharded_equals_oracle_past_w_need(runs):
    xs, ys = chain_case(**CHAIN_FULL)
    call = PC.prepare_call(xs, ys, avg_qspan=22.5)
    assert 64 <= chain_full_w(call) <= -(-call["n"] // WORLD)
    want = PCO.chain_dp(PCO.ChainCall(len(xs), 22.5, 5000, 5000, 500, 1, xs.astype(np.uint64),
                                      ys.astype(np.uint64)))
    for sc, par, pk in each_rank(runs, "chain_full"):
        np.testing.assert_array_equal(sc, want["scores"])
        np.testing.assert_array_equal(par, want["parents"])
        np.testing.assert_array_equal(pk, want["peak_scores"])
        assert (par >= 0).sum() > call["n"] // 2


def _jax_collect(handles, b):
    from genomicsbench_palisade_tpu.ops import fmi_pipeline as JFP

    return JFP.fmi_pipeline_collect(handles, b)


def _same_smems(got, want):
    allm, n1, n2, n3, ovf = got
    jm, j1, j2, j3, jovf = want
    assert (n1, n2, n3, ovf) == (j1, j2, j3, jovf)
    assert n1 + n2 + n3 > 0
    for key in jm:
        np.testing.assert_array_equal(allm[key], jm[key], err_msg=key)


def test_fmi_pipeline_sharded_equals_jax(runs, mesh4):
    from genomicsbench_palisade_tpu.index.builder import build_arrays
    from genomicsbench_palisade_tpu.parallel import dp as JD

    genome, enc, lengths = fmi_pipeline_case()
    want = _jax_collect(JD.fmi_pipeline_index_sharded(
        mesh4, build_arrays(genome).as_device_arrays(), enc, lengths, min_seed_len=15),
        len(lengths))
    for got in each_rank(runs, "fmi_pipeline"):
        _same_smems(got, want)


def test_fmi_pipeline_over_port_shard_files_equals_jax(runs, rank_dir, mesh4):
    """Each rank loaded only its own port-written shard file; the JAX
    pipeline runs over its global cp_pack from the same files, read by the
    JAX reader."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from genomicsbench_palisade_tpu.index import fmi_index as JFI
    from genomicsbench_palisade_tpu.index.builder import build_arrays
    from genomicsbench_palisade_tpu.parallel import dp as JD

    genome, enc, lengths = shard_files_case()
    prefix = str(rank_dir / "port_idx")
    cp = np.concatenate([JFI.load_npz_shard(prefix, i)["cp_pack"] for i in range(WORLD)])
    cp = jax.device_put(cp, NamedSharding(mesh4, PartitionSpec("dp", None)))
    index = build_arrays(genome, sa_compression=True).as_device_arrays()
    want = _jax_collect(JD.fmi_pipeline_index_sharded(mesh4, index, enc, lengths,
                                                      min_seed_len=15, cp_pack_global=cp),
                        len(lengths))
    for got in each_rank(runs, "fmi_files"):
        _same_smems(got, want)


def test_poa_sharded_equals_jax(runs, mesh4):
    import jax.numpy as jnp

    from genomicsbench_palisade_tpu.ops import poa as JPOA
    from genomicsbench_palisade_tpu.ops.oracle.poa import PoaGraph as JPoaGraph
    from genomicsbench_palisade_tpu.parallel import dp as JD

    bases, seqs = poa_case()
    graphs = [JPoaGraph() for _ in bases]
    for g, a, s in zip(graphs, JPOA.align_batch(graphs, bases), bases):
        g.add_alignment(a, s)
    # the JAX graphs in rank space by the JAX function, at the port's caps
    port_garrs, seq_arr, seq_len, w_cap, a_cap = PPOA.round_arrays(graphs, seqs)
    n_cap = port_garrs[0]["code"].shape[0]
    garrs = [JPOA.graph_to_arrays(g, n_cap, 16, code_map=CODE_MAP) for g in graphs]
    for pa, ja in zip(port_garrs, garrs):
        for k in ja:
            np.testing.assert_array_equal(pa[k], np.asarray(ja[k]))
    garr_stack = {k: jnp.asarray(np.stack([a[k] for a in garrs])) for k in garrs[0]}
    want = np.asarray(JD.poa_align_sharded(mesh4, jnp.asarray(seq_arr), jnp.asarray(seq_len),
                                           garr_stack, POA_PARAMS, w_cap, a_cap))
    for got in each_rank(runs, "poa"):
        np.testing.assert_array_equal(got, want)


def test_abea_fill_sharded_equals_jax(runs, mesh4):
    import jax.numpy as jnp

    from genomicsbench_palisade_tpu.ops import abea as JA
    from genomicsbench_palisade_tpu.parallel import dp as JD

    model, seqs, evs = abea_case()
    bw = 100
    e_buck = JA._bucket(max(len(e) for e in evs), q=32)
    k_buck = JA._bucket(max(len(s) - 5 for s in seqs), q=32)
    preps = [JA._prep_read(s, e, bw, 6, e_buck, k_buck) for s, e in zip(seqs, evs)]
    nr = len(seqs)
    traces, bes, bks, last = map(np.asarray, JD.abea_fill_sharded(
        mesh4, jnp.asarray(np.stack([p[0] for p in preps])),
        jnp.asarray(np.stack([p[1] for p in preps])),
        jnp.asarray(np.array([len(e) for e in evs], np.int32)),
        jnp.asarray(np.array([len(s) - 5 for s in seqs], np.int32)),
        tuple(jnp.asarray(model[k]) for k in ("level_mean", "level_stdv", "level_log_stdv")),
        jnp.asarray(np.ones(nr, np.float32)), jnp.asarray(np.zeros(nr, np.float32)),
        jnp.asarray(np.stack([p[2] for p in preps])), jnp.asarray(np.stack([p[3] for p in preps])),
        n_bands_pad=e_buck + k_buck + 2, bandwidth=bw))
    batch, _idx = PA.prepare_batch(seqs, evs, model, [1.0] * nr, [0.0] * nr)
    for got in each_rank(runs, "abea"):
        for r in range(nr):
            lo = int(batch["band_off"][r])
            nb = len(evs[r]) + len(seqs[r]) - 5 + 2
            np.testing.assert_array_equal(got["trace"][lo + 2 : lo + nb], traces[r, : nb - 2])
            bll_e = got["bll_e"][lo + 2 : lo + nb]
            np.testing.assert_array_equal(bll_e, bes[r, : nb - 2])
            np.testing.assert_array_equal(np.arange(2, nb) - 2 - bll_e, bks[r, : nb - 2])
            lv, want_lv = got["last_val"][lo + 2 : lo + nb], last[r, : nb - 2]
            fin = np.isfinite(want_lv)
            np.testing.assert_array_equal(np.isfinite(lv), fin)
            ulps = np.abs(lv[fin].view(np.int32).astype(np.int64)
                          - want_lv[fin].view(np.int32).astype(np.int64))
            assert ulps.max() <= ABEA_ULPS, r
        whole = PA.abea_fill(abea_batch_from_numpy(batch, "cpu"))
        for key, val in got.items():
            assert np.array_equal(val, whole[key].numpy()), key


def test_every_rank_returns_the_same(runs):
    ref = pickle.dumps(runs[0])
    assert all(pickle.dumps(r) == ref for r in runs[1:])


# ---------------------------------------------------------------- shard files


def test_shard_files_between_the_packages(tmp_path):
    """Port-written shard files read by the JAX readers and JAX-written ones
    by the port's, bit for bit, SA samples included."""
    from genomicsbench_palisade_tpu.index import fmi_index as JFI
    from genomicsbench_palisade_tpu.index.builder import build_arrays

    genome, _enc, _lengths = shard_files_case()
    jidx = build_arrays(genome, sa_compression=True)
    pidx = PB.build_arrays(genome, sa_compression=True, device="cpu")
    assert len(PFI.save_npz_sharded(pidx, str(tmp_path / "p"), 3)) == 4
    JFI.save_npz_sharded(jidx, str(tmp_path / "j"), 3)
    for a, b in (("p", "j"), ("j", "p")):
        assert (PFI.load_shard_manifest(str(tmp_path / a)).keys()
                == JFI.load_shard_manifest(str(tmp_path / b)).keys())
    for prefix in ("p", "j"):
        back = PFI.load_npz_sharded(str(tmp_path / prefix))
        np.testing.assert_array_equal(back.cp_occ, pidx.cp_occ)
        np.testing.assert_array_equal(back.sa_ms_byte, pidx.sa_ms_byte)
        np.testing.assert_array_equal(back.sa_ls_word, pidx.sa_ls_word)
        assert back.sa_compression and back.ref_seq_len == pidx.ref_seq_len
        assert back.sentinel_index == pidx.sentinel_index
        jback = JFI.load_npz_sharded(str(tmp_path / prefix))
        for key in ("cp_count", "one_hot_hi", "one_hot_lo", "sa_ms_byte", "sa_ls_word"):
            np.testing.assert_array_equal(getattr(jback, key), getattr(jidx, key), err_msg=key)
        for i in range(3):
            got, want = PFI.load_npz_shard(str(tmp_path / prefix), i), JFI.load_npz_shard(
                str(tmp_path / prefix), i)
            assert got["block_start"] == want["block_start"] == i * got["cp_occ"].shape[0]
            assert got["cp_occ"].shape[0] % 8 == 0
            np.testing.assert_array_equal(
                got["cp_occ"], PFI.pack_cp_occ(want["cp_count"], want["one_hot_hi"],
                                               want["one_hot_lo"]))
            assert got["sa_start"] == want["sa_start"]
            np.testing.assert_array_equal(got["sa_ls_word"], want["sa_ls_word"])


# ---------------------------------------------------------------- entry points


def test_entry_equals_jax_entry():
    import __graft_entry__ as JE

    from genomicsbench_palisade_tpu_torch import entry as E

    fn, args = E.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    got = fn(*args)
    jfn, jargs = JE.entry()
    want = np.asarray(jfn(*jargs))
    assert got.dtype == torch.float32 and got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_dryrun_multichip_two_ranks():
    from genomicsbench_palisade_tpu_torch import entry as E

    E.dryrun_multichip(2)


def test_no_gpu_no_device_raises():
    from genomicsbench_palisade_tpu_torch import entry as E

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh()


def test_group_init_with_no_peer_raises():
    """A rank whose coordinator never comes raises when the timeout ends."""
    with pytest.raises(Exception):
        M.init_distributed(f"127.0.0.1:{M.free_port()}", 2, 1, backend="gloo", timeout_s=1)
    assert not torch.distributed.is_initialized()


def _cli_rank(rank: int, testfile: str, outdir: str):
    """cli.phmm on 2 ranks, each rank's stdout in a file; then rank 1
    leaves and rank 0's next collective must raise."""
    from genomicsbench_palisade_tpu_torch.cli import phmm as cli

    torch.set_num_threads(1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["-f", testfile, "--device", "cpu"]) == 0
    Path(outdir, f"out{rank}.txt").write_text(buf.getvalue())
    mesh = M.make_mesh(device="cpu")
    M.barrier(mesh)
    if rank == 1:
        return
    try:
        M.all_reduce_sum(mesh, torch.ones(4))
    except Exception as e:  # the peer has left
        Path(outdir, "raised.txt").write_text(type(e).__name__)


def test_phmm_cli_on_two_ranks_prints_one_ranks_bytes(tmp_path):
    sys.path.insert(0, str(REPO))
    import chip_smoke

    from genomicsbench_palisade_tpu_torch.cli import phmm as cli

    tf = tmp_path / "t.txt"
    chip_smoke.synth_testfile(tf, np.random.default_rng(3), n_batches=2, max_reads=10,
                              max_haps=3, read_len=(100, 151), hap_len=(50, 160))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["-f", str(tf), "--device", "cpu"]) == 0
    M.spawn(_cli_rank, 2, (str(tf), str(tmp_path)), timeout_s=20)
    one, two = buf.getvalue().splitlines(), (tmp_path / "out0.txt").read_text().splitlines()
    assert len(one) > 15 and one[:-1] == two[:-1]
    stats = {}
    for bt in parse_testfile(tf):  # the f64 pass ran on the ranks too
        cli.run_testcases(bt.reads, bt.haps, bt.pairs, "cpu", stats=stats)
    assert stats["fallback"] > 0
    assert two[-1].startswith("PairHMM completed. Kernel runtime:")
    assert (tmp_path / "out1.txt").read_text() == ""
    assert (tmp_path / "raised.txt").exists()


def _env_cli_rank(rank: int, port: int, testfile: str, outdir: str):
    """A torchrun-style rank on a box that shows 2 cards: the environment
    names the group and cli.phmm's own init_distributed joins it (env://);
    `--device cpu` must choose gloo (NCCL takes CUDA tensors only)."""
    import os

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: 2
    from genomicsbench_palisade_tpu_torch.cli import phmm as cli

    torch.set_num_threads(1)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            assert cli.main(["-f", testfile, "--device", "cpu"]) == 0
        Path(outdir, f"env{rank}.txt").write_text(buf.getvalue())
        Path(outdir, f"backend{rank}.txt").write_text(torch.distributed.get_backend())
    finally:
        M.shutdown()


def test_phmm_cli_under_torchrun_env_on_the_cpu_uses_gloo(tmp_path):
    """cli.phmm launched as torchrun launches it, with --device cpu on a
    box with cards: the group is gloo and rank 0 prints one rank's bytes."""
    import torch.multiprocessing as mp

    sys.path.insert(0, str(REPO))
    import chip_smoke

    from genomicsbench_palisade_tpu_torch.cli import phmm as cli

    tf = tmp_path / "t.txt"
    chip_smoke.synth_testfile(tf, np.random.default_rng(4), n_batches=1, max_reads=6,
                              max_haps=3, read_len=(60, 100), hap_len=(50, 120))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["-f", str(tf), "--device", "cpu"]) == 0
    mp.spawn(_env_cli_rank, args=(M.free_port(), str(tf), str(tmp_path)), nprocs=2, join=True)
    assert [(tmp_path / f"backend{r}.txt").read_text() for r in range(2)] == ["gloo", "gloo"]
    one, two = buf.getvalue().splitlines(), (tmp_path / "env0.txt").read_text().splitlines()
    assert len(one) > 3 and one[:-1] == two[:-1]
    assert (tmp_path / "env1.txt").read_text() == ""


@pytest.mark.parametrize("device,local_ranks,cards,want", [
    (None, 2, 2, "nccl"),  # a rank a card
    ("cuda", 2, 2, "nccl"),
    (None, 2, 1, "gloo"),  # more ranks than cards
    ("cuda:0", 2, 2, "gloo"),  # every rank names one card
    ("cuda:0", 1, 1, "nccl"),  # one rank on this host
    ("cpu", 2, 2, "gloo"),
])
def test_backend_for_a_device_the_ranks_name(monkeypatch, device, local_ranks, cards, want):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_ranks))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert M.backend_for(device, world=4) == want


# ---------------------------------------------------------------- chain preset head


@pytest.mark.parametrize("w", [16, 64])
def test_plain_chain_preset_head_equals_the_unsplit_run(w):
    """chain_dp_plain on the tail of a call (from s - w), its first w rows
    preset from the whole call's run, equals the whole run's tail, with
    each anchor's predecessors windowed at w (window_clamp)."""
    xs, ys = chain_case(n=500, seed=5, spread=300)
    call = PC.window_clamp(PC.prepare_call(xs, ys, avg_qspan=22.5), w)
    whole = np.stack(PC.chain_call(call, "cpu"))
    s = 300
    a0 = s - w
    tail = {"x_lo": call["x_lo"][a0:], "qi": call["qi"][a0:], "qspan": call["qspan"][a0:],
            "st_eff": np.maximum(call["st_eff"][a0:] - a0, 0), "n": call["n"] - a0,
            "gap_table": call["gap_table"], "max_dist_x": 5000, "max_dist_y": 5000, "bw": 500}
    from genomicsbench_palisade_tpu_torch.convert import chain_batch_from_numpy

    tb, params = chain_batch_from_numpy([tail], "cpu")
    tb["first"] = torch.tensor([w], dtype=torch.int32)
    out = torch.zeros((3, call["n"] - a0), dtype=torch.int32)
    out[0, :w] = torch.from_numpy(whole[0, a0:s].astype(np.int32))
    out[1, :w] = torch.from_numpy(np.where(whole[1, a0:s] >= a0, whole[1, a0:s] - a0, -1))
    out[2, :w] = torch.from_numpy(whole[2, a0:s].astype(np.int32))
    got = PC.chain_dp(tb, params, out=out).numpy()
    np.testing.assert_array_equal(got[0, w:], whole[0, s:])
    np.testing.assert_array_equal(np.where(got[1, w:] >= 0, got[1, w:] + a0, -1), whole[1, s:])
    np.testing.assert_array_equal(got[2, w:], whole[2, s:])
    with pytest.raises(ValueError, match="preset"):
        PC.chain_dp(tb, params)


# ---------------------------------------------------------------- the fmi CLI


def test_fmi_load_imbalance_counts_devices_as_the_jax_cli():
    """The port's report counts min(devices, batches) shards, as the JAX CLI
    does with its local devices (8 here)."""
    import jax

    from genomicsbench_palisade_tpu.cli import fmi as jcli
    from genomicsbench_palisade_tpu_torch.cli import fmi as cli

    totals = [40, 7, 19, 3, 11]
    ndev = len(jax.local_devices())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.report(totals, 1.5, min(ndev, len(totals)))
    jbuf = io.StringIO()
    with contextlib.redirect_stdout(jbuf):
        jcli._report_metrics(totals, 1.5, sum(totals))
    assert buf.getvalue() == jbuf.getvalue()
    assert "load imbalance = 1.000000" not in buf.getvalue()


def test_multiprocess_bench_reports_every_parity(tmp_path):
    """The port's tools/multiprocess_bench: 2 processes through
    init_distributed, the report as tests/test_multiprocess.py reads the
    JAX tool's."""
    import json
    import subprocess

    out = tmp_path / "multiproc.json"
    res = subprocess.run(
        [sys.executable, "-m", "genomicsbench_palisade_tpu_torch.tools.multiprocess_bench",
         "--procs", "2", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=600, cwd=str(REPO))
    assert res.returncode == 0, res.stdout[-1500:] + res.stderr[-1500:]
    run = json.loads(out.read_text())["runs"][0]
    assert run["ok"] and run["global_devices"] == 2 and run["backend"] == "gloo"
    assert run["phmm_parity"] and run["kmer_parity"] and run["fmi_parity"]
    assert run["fmi_total_smems"] > 0


def test_every_public_name_has_a_port_counterpart():
    """parallel/mesh.py's and parallel/dp.py's public names, the shard file
    functions, the occ route's marker and the driver entry points."""
    import inspect

    import __graft_entry__ as JE

    from genomicsbench_palisade_tpu.parallel import dp as JD, mesh as JM
    from genomicsbench_palisade_tpu_torch import entry as E
    from genomicsbench_palisade_tpu_torch.ops import fmi as PF

    for jmod, pmod in ((JM, M), (JD, dp)):
        names = [n for n, v in vars(jmod).items() if not n.startswith("_")
                 and not inspect.ismodule(v)
                 and getattr(v, "__module__", jmod.__name__) == jmod.__name__]
        assert names and all(hasattr(pmod, n) for n in names), [
            n for n in names if not hasattr(pmod, n)]
    for n in ("save_npz_sharded", "load_shard_manifest", "load_npz_shard", "load_npz_sharded"):
        assert callable(getattr(PFI, n))
    assert hasattr(PF, "ShardAxis")
    for n in ("_example_batch", "entry", "dryrun_multichip"):
        assert callable(getattr(JE, n)) and callable(getattr(E, n))


def test_host_local_slice_and_work_imbalance_equal_jax():
    from genomicsbench_palisade_tpu.parallel import mesh as JM

    assert M.host_local_slice(10) == JM.host_local_slice(10) == slice(0, 10)
    rng = np.random.default_rng(2)
    for n in (1, 3, 4, 8):
        work = rng.integers(0, 100, 13)
        assert M.shard_work_imbalance(work, n) == JM.shard_work_imbalance(work, n)
    x = np.arange(10).reshape(5, 2)
    for m in (1, 3, 5):
        got, want = M.pad_to_multiple(x, m), JM.pad_to_multiple(x, m)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])
