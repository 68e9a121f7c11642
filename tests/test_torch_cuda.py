"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the `cuda` marker and skips without a CUDA card
(the kernels have no CPU mode).  The file imports no JAX, so it runs on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: none.  The PairHMM kernel and its plain version do the same
separate roundings on the same tables, so raw sums must be bit-equal; the
bsw and chain kernels and their plain versions compute in int32, so every
output must be equal; the abea kernels and their plain versions do the
oracle's f32 and f64 roundings, so traces, band positions, last values,
seeds, pairs and emission sums must be equal bit for bit; the occ-gather
kernels XOR integer rows, so their folds must be equal; the fmi pipeline
and the index builder compute in int64, so the card's results must equal
the CPU's exactly; the roofline probes' kernels (bsw_stripped, chain_micro)
compute in int32 that wraps, so every output must be equal; the eventalign
mode's realign runs the same elementwise f32 ops on both devices, so its
TSV must be equal byte for byte; the k-mer counter and the POA aligner
are integer torch ops (no hand-written kernel), so their metrics,
alignments and consensus strings must equal the goldens and the CPU's.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu_torch.cli import abea as cli_abea
from genomicsbench_palisade_tpu_torch.cli import bsw as cli_bsw
from genomicsbench_palisade_tpu_torch.cli import chain as cli_chain
from genomicsbench_palisade_tpu_torch.cli import fmi as cli_fmi
from genomicsbench_palisade_tpu_torch.convert import (abea_batch_from_numpy, bsw_batch_from_numpy,
                                                      chain_batch_from_numpy, fmi_index_from_numpy)
from genomicsbench_palisade_tpu_torch.index import builder as IB
from genomicsbench_palisade_tpu_torch.io import bam as B
from genomicsbench_palisade_tpu_torch.io.chain_dump import ChainCallInput
from genomicsbench_palisade_tpu_torch.io import signal as SIG
from genomicsbench_palisade_tpu_torch.ops import abea as A
from genomicsbench_palisade_tpu_torch.ops import abea_cuda
from genomicsbench_palisade_tpu_torch.ops import bsw as W
from genomicsbench_palisade_tpu_torch.ops import bsw_cuda
from genomicsbench_palisade_tpu_torch.ops import bsw_stripped as BS
from genomicsbench_palisade_tpu_torch.ops import chain as C
from genomicsbench_palisade_tpu_torch.ops import chain_cuda
from genomicsbench_palisade_tpu_torch.ops import chain_micro as CM
from genomicsbench_palisade_tpu_torch.ops import fmi_pipeline as FP
from genomicsbench_palisade_tpu_torch.ops import kmer as KM
from genomicsbench_palisade_tpu_torch.ops import occ_gather as G
from genomicsbench_palisade_tpu_torch.ops import phmm as P
from genomicsbench_palisade_tpu_torch.ops import phmm_cuda
from genomicsbench_palisade_tpu_torch.ops import poa as POA
from genomicsbench_palisade_tpu_torch.ops.events import (detect_events_batch,
                                                         estimate_scalings_mom_batch)
from genomicsbench_palisade_tpu_torch.ops.oracle import abea as AO
from genomicsbench_palisade_tpu_torch.ops.oracle import bsw as WO
from genomicsbench_palisade_tpu_torch.ops.oracle import phmm as O
from genomicsbench_palisade_tpu_torch.ops.oracle import poa as POAO

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the edge-case generators)

DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _cases(seed, n, max_r, max_h):
    """Half the reads are noisy substrings of their hap, half random (with
    N); lengths cover partial and whole lanes' rows."""
    rng = np.random.default_rng(seed)
    reads, haps, pairs = [], [], []
    for k in range(n):
        hl = int(rng.integers(2, max_h + 1))
        rl = int(rng.integers(1, min(max_r, hl + 1)))
        hap = rng.integers(0, 5, hl)
        if k % 2:
            s = int(rng.integers(0, hl - rl + 1))
            bases = hap[s : s + rl].copy()
        else:
            bases = rng.integers(0, 5, rl)
        reads.append({"bases": bases, **{q: rng.integers(0, 127, rl) for q in "qidc"}})
        haps.append(hap)
        pairs.append((k, k))
    return reads, haps, pairs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_kernel_bit_equal_to_plain(cuda, dtype):
    reads, haps, pairs = _cases(7, 1000, max_r=64, max_h=128)
    tb = P.as_device_batch(P.prepare_batch(reads, haps, pairs), cuda)
    kernel = phmm_cuda.KERNELS[dtype]
    before = kernel.launches
    got = P.forward_raw(tb, dtype)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = P.phmm_forward_plain(tb, dtype)
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    assert bool(same.all()), int((~same).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_phmm_edge_cases_kernel_equal_to_plain(cuda, dtype):
    """chip_smoke.phmm_edge_cases, each batch at its r_pad (so on the
    instance the wrapper picks for it, in one tile or more), bit for bit."""
    kernel = phmm_cuda.KERNELS[dtype]
    for reads, haps, pairs, rp, hp in chip_smoke.phmm_edge_cases(np.random.default_rng(0)):
        tb = P.as_device_batch(P.prepare_batch(reads, haps, pairs, r_pad=rp, h_pad=hp), cuda)
        before = kernel.launches
        got = P.forward_raw(tb, dtype)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        want = P.phmm_forward_plain(tb, dtype)
        assert bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all()), (rp, hp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_phmm_global_carry_kernel_equal_to_plain(cuda, dtype):
    """Haps of 4,000-5,000 bases at up to 599 rows: a block's tile carry
    would not fit in shared memory, so the wrapper hands the kernel a global
    one.  The reads are their hap's substrings with 1% substituted, so the
    float results stay finite."""
    rng = np.random.default_rng(11)
    reads, haps, pairs = [], [], []
    for k in range(6):
        hap = rng.integers(0, 4, int(rng.integers(4000, 5001)))
        rl = int(rng.integers(300, 600))
        s = int(rng.integers(0, len(hap) - rl + 1))
        bases = hap[s : s + rl].copy()
        mut = rng.random(rl) < 0.01
        bases[mut] = rng.integers(0, 4, int(mut.sum()))
        reads.append({"bases": bases, "q": rng.integers(6, 41, rl), "i": rng.integers(30, 46, rl),
                      "d": rng.integers(30, 46, rl), "c": np.full(rl, 10)})
        haps.append(hap)
        pairs.append((k, k))
    tb = P.as_device_batch(P.prepare_batch(reads, haps, pairs, r_pad=600, h_pad=5000), cuda)
    kernel = phmm_cuda.KERNELS[dtype]
    assert kernel.scratch_elems(6, 600, 5000) == 3 * 5000 * 6
    assert kernel.scratch_elems(6, 513, 512) == 0
    got = P.forward_raw(tb, dtype)
    want = P.phmm_forward_plain(tb, dtype)
    assert bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())
    assert bool((want > 0).all() & torch.isfinite(want).all())


@pytest.mark.cuda
def test_likelihoods_equal_oracle_on_card(cuda):
    reads, haps, pairs = _cases(8, 24, max_r=40, max_h=60)
    got = P.phmm_likelihoods(P.prepare_batch(reads, haps, pairs), cuda)
    want = [O.compute_likelihood(reads[r]["bases"], haps[h], reads[r]["q"], reads[r]["i"],
                                 reads[r]["d"], reads[r]["c"]) for r, h in pairs]
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_wrapper_checks_inputs(cuda):
    reads, haps, pairs = _cases(9, 4, max_r=10, max_h=20)
    tb = P.as_device_batch(P.prepare_batch(reads, haps, pairs), cuda)
    kernel = phmm_cuda.phmm_forward_f32
    tabs = P.device_tables(torch.float32, cuda)
    hp = tb["hap"].shape[1]
    bad = dict(tb, q=tb["q"].to(torch.int32))
    with pytest.raises(ValueError, match="dtype"):
        kernel(bad, tabs, P.device_init_y(torch.float32, cuda, hp))
    with pytest.raises(ValueError, match="shape"):
        kernel(tb, tabs, P.device_init_y(torch.float32, cuda, hp + 1))
    with pytest.raises(ValueError, match="dtype"):
        kernel(tb, P.device_tables(torch.float64, cuda), P.device_init_y(torch.float32, cuda, hp))
    empty = {k: v[:0] for k, v in tb.items()}
    assert kernel(empty, tabs, P.device_init_y(torch.float32, cuda, hp)).numel() == 0


def _bsw_pairs(seed, n, max_q=150, max_t=256):
    """Related pairs (the query a mutated head of its target), random pairs
    with ambiguous bases, empty queries or targets, h0 from -20 to 99."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(n):
        tl = int(rng.integers(0, max_t + 1))
        ql = int(rng.integers(0, max_q + 1))
        if k % 3:
            base = rng.integers(0, 4, max(tl, ql))
            t = base[:tl]
            q = np.where(rng.random(ql) < 0.08, rng.integers(0, 4, ql), base[:ql])
        else:
            t = rng.integers(0, 5, tl)
            q = rng.integers(0, 5, ql)
        pairs.append((q, t, int(rng.integers(-20, 100))))
    return pairs


@pytest.mark.cuda
@pytest.mark.parametrize("params", [WO.DEFAULT_PARAMS,
                                    WO.BswParams(o_del=5, e_del=2, o_ins=5, e_ins=2, match=2,
                                                 mismatch=3)], ids=["default", "m2x3o5e2"])
def test_bsw_kernel_equal_to_plain(cuda, params):
    pairs = _bsw_pairs(10, 3000)
    tb, ptuple = bsw_batch_from_numpy(W.prepare_pairs(pairs), cuda, params)
    before = bsw_cuda.bsw_extend.launches
    got = W.bsw_extend(tb, ptuple)
    torch.cuda.synchronize()
    assert bsw_cuda.bsw_extend.launches == before + 1
    assert torch.equal(got, W.bsw_extend_plain(tb, ptuple))


@pytest.mark.cuda
def test_bsw_results_equal_oracle_on_card(cuda):
    pairs = _bsw_pairs(11, 200)
    got = cli_bsw.score_pairs(pairs, device=cuda)
    for i, (q, t, h0) in enumerate(pairs):
        want = WO.scalar_banded_swa(q, t, h0)
        assert {k: int(got[k][i]) for k in W.OUT_ORDER} == want, i


@pytest.mark.cuda
def test_bsw_wrapper_checks_inputs(cuda):
    tb, ptuple = bsw_batch_from_numpy(W.prepare_pairs(_bsw_pairs(12, 4)), cuda)
    kernel = bsw_cuda.bsw_extend
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel({k: v.cpu() for k, v in tb.items()}, ptuple)
    with pytest.raises(ValueError, match="dtype"):
        kernel(dict(tb, q_off=tb["q_off"].to(torch.int32)), ptuple)
    with pytest.raises(ValueError, match="dtype"):
        kernel(dict(tb, codes=tb["codes"].to(torch.int32)), ptuple)
    with pytest.raises(ValueError, match="shape"):
        kernel(dict(tb, h0=tb["h0"][:2]), ptuple)
    with pytest.raises(ValueError, match="params"):
        kernel(tb, ptuple[:9])
    with pytest.raises(ValueError, match="q_max"):
        kernel(tb, ptuple, q_max=-1)
    assert kernel.launches == before
    empty = {k: v if k == "codes" else v[:0] for k, v in tb.items()}
    assert kernel(empty, ptuple).shape == (6, 0)
    # no longer refused: e_ins < 0 and q_max past the register instances
    neg = ptuple[:3] + (-1,) + ptuple[4:]
    assert torch.equal(kernel(tb, neg), W.bsw_extend_plain(tb, neg))
    assert torch.equal(kernel(tb, ptuple, q_max=513), W.bsw_extend_plain(tb, ptuple))
    assert kernel.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("params", [WO.DEFAULT_PARAMS,
                                    WO.BswParams(o_del=5, e_del=2, o_ins=5, e_ins=2, match=2,
                                                 mismatch=3)], ids=["default", "m2x3o5e2"])
def test_bsw_edge_pairs_kernel_equal_to_plain(cuda, params):
    """chip_smoke.bsw_edge_pairs (lane and bucket edges, breaks, ties, h0
    around o_ins + e_ins): the whole batch on the widest instance and on
    the one the longest query picks, and each query edge's pairs on the
    instance its edge picks."""
    pairs = chip_smoke.bsw_edge_pairs(np.random.default_rng(3), params.o_ins, params.e_ins)
    tb, ptuple = bsw_batch_from_numpy(W.prepare_pairs(pairs), cuda, params)
    want = W.bsw_extend_plain(tb, ptuple)
    assert torch.equal(W.bsw_extend(tb, ptuple), want)
    assert torch.equal(W.bsw_extend(tb, ptuple, q_max=512), want)
    q_len = tb["q_len"].cpu().numpy()
    edges = np.searchsorted(np.asarray(cli_bsw.EDGES), q_len)
    for e in np.unique(edges):
        idx = torch.from_numpy(np.flatnonzero(edges == e)).to(cuda)
        sub = {k: v if k == "codes" else v[idx] for k, v in tb.items()}
        got = W.bsw_extend(sub, ptuple, q_max=cli_bsw.EDGES[e])
        assert torch.equal(got, want[:, idx]), cli_bsw.EDGES[e]


@pytest.mark.cuda
@pytest.mark.parametrize("params", [WO.DEFAULT_PARAMS, WO.BswParams(w=600),
                                    WO.BswParams(e_ins=-1)], ids=["default", "w600", "e_ins-1"])
def test_bsw_long_queries_kernel_equal_to_plain(cuda, params):
    """64 pairs of 513-4,096 bases on the long-query kernel (rows in shared
    memory), and 4 of 28,672-28,800 bases with targets of up to 1,500 (rows
    in the global scratch)."""
    rng = np.random.default_rng(14)
    for pairs in (chip_smoke.bsw_long_pairs(rng, 64, 513, 4096),
                  chip_smoke.bsw_long_pairs(rng, 4, 28_672, 28_800, t_hi=1500)):
        tb, ptuple = bsw_batch_from_numpy(W.prepare_pairs(pairs, params), cuda, params)
        before = bsw_cuda.bsw_extend.launches
        got = W.bsw_extend(tb, ptuple)
        torch.cuda.synchronize()
        assert bsw_cuda.bsw_extend.launches == before + 1
        assert torch.equal(got, W.bsw_extend_plain(tb, ptuple))


@pytest.mark.cuda
def test_bsw_long_query_tie_across_a_chunk_edge(cuda):
    """o_ins + e_ins = 0 ties H(i, i) and H(i, i + 1); the best row, 511,
    ties across the long-query kernel's first chunk edge (qle 513)."""
    params = WO.BswParams(o_ins=-1, e_ins=1)
    q = np.random.default_rng(7).integers(0, 4, 600).astype(np.int8)
    tb, ptuple = bsw_batch_from_numpy(W.prepare_pairs([(q, q[:512], 30)], params), cuda, params)
    got = W.bsw_extend(tb, ptuple)
    assert torch.equal(got, W.bsw_extend_plain(tb, ptuple)) and int(got[1, 0]) == 513


@pytest.mark.cuda
@pytest.mark.parametrize("e_ins", [-1, -3])
def test_bsw_negative_extension_edge_pairs_kernel_equal_to_plain(cuda, e_ins):
    """chip_smoke.bsw_edge_pairs at e_ins < 0: through cli.bsw's buckets
    (each on its edge's instance, the e_ins < 0 variant), whole on the
    widest instance and on the long-query kernel."""
    params = WO.BswParams(e_ins=e_ins)
    pairs = chip_smoke.bsw_edge_pairs(np.random.default_rng(6), params.o_ins, e_ins)
    tb, ptuple = bsw_batch_from_numpy(W.prepare_pairs(pairs, params), cuda, params)
    want = W.bsw_extend_plain(tb, ptuple)
    got = cli_bsw.score_pairs(pairs, params, device=cuda)
    assert torch.equal(torch.from_numpy(np.stack([got[k] for k in W.OUT_ORDER])).to(cuda), want)
    assert torch.equal(W.bsw_extend(tb, ptuple, q_max=512), want)
    assert torch.equal(W.bsw_extend(tb, ptuple, q_max=2048), want)


@pytest.mark.cuda
def test_bsw_goldens_on_card(cuda, fixtures_dir):
    cases = json.load(open(fixtures_dir / "bsw_golden.json"))
    pairs = [(np.array(c["query"], np.int8), np.array(c["target"], np.int8), c["h0"])
             for c in cases]
    got = cli_bsw.score_pairs(pairs, device=cuda)
    bad = [i for i, c in enumerate(cases) if {k: int(got[k][i]) for k in W.OUT_ORDER} != c["out"]]
    assert len(cases) == 300 and not bad, bad


def _chain_preps(seed, n_calls, max_n):
    """Sorted anchors with query spans 8-29 in y, x gaps of 0-59 with rare
    jumps past max_dist_x, an empty call, a dense call that takes the
    max_skip break, and the exact-quarter avg_qspans 25.0 and 50.0."""
    rng = np.random.default_rng(seed)
    preps = []
    for k in range(n_calls):
        n = 0 if k == 3 else int(rng.integers(1, max_n))
        dense = k % 5 == 0
        gaps = rng.integers(0, 4 if dense else 60, n)
        gaps[rng.random(n) < 0.002] += 6000
        x = np.cumsum(gaps).astype(np.int64) + 100
        qpos = np.maximum(x + rng.integers(-30 if dense else -300, 30 if dense else 300, n), 0)
        y = (rng.integers(8, 30, n).astype(np.uint64) << np.uint64(32)) | qpos.astype(np.uint64)
        aq = (25.0, 50.0, float(rng.uniform(10, 40)))[k % 3]
        preps.append(C.prepare_call(x.astype(np.uint64), y, aq))
    return preps


@pytest.mark.cuda
def test_chain_kernel_equal_to_plain(cuda):
    tb, params = chain_batch_from_numpy(_chain_preps(13, 48, 3000), cuda)
    before = chain_cuda.chain_dp.launches
    got = C.chain_dp(tb, params)
    torch.cuda.synchronize()
    assert chain_cuda.chain_dp.launches == before + 1
    assert torch.equal(got, C.chain_dp_plain(tb, params))
    # a second launch reuses nothing of the first (targets start at 0 again)
    assert torch.equal(C.chain_dp(tb, params), got)


@pytest.mark.cuda
def test_chain_edge_calls_kernel_equal_to_plain(cuda):
    """chip_smoke.chain_edge_calls: windows of 1-250 predecessors and of
    MAX_ITER, breaks at every offset of a step, in-step marks, ties."""
    preps = [C.prepare_call(x, y, q) for x, y, q in
             chip_smoke.chain_edge_calls(np.random.default_rng(0))]
    tb, params = chain_batch_from_numpy(preps, cuda)
    got = C.chain_dp(tb, params)
    assert torch.equal(got, C.chain_dp_plain(tb, params))


@pytest.mark.cuda
def test_chain_goldens_on_card(cuda, fixtures_dir):
    calls = json.load(open(fixtures_dir / "chain_golden.json"))
    inputs = [ChainCallInput(c["n"], c["avg_qspan"], c["max_dist_x"], c["max_dist_y"], c["bw"],
                             c["n_segs"], np.array([int(v) for v in c["x"]], np.uint64),
                             np.array([int(v) for v in c["y"]], np.uint64)) for c in calls]
    got = cli_chain.run_calls(inputs, device=cuda)
    for c, (sc, par, _) in zip(calls, got):
        np.testing.assert_array_equal(sc, c["scores"])
        np.testing.assert_array_equal(par, c["parents"])
    g = np.load(fixtures_dir / "chain_big_golden.npz")
    cases = range(int(g["n_cases"]))
    preps = [C.prepare_call(g[f"x{ci}"], g[f"y{ci}"], float(g[f"qspan{ci}"])) for ci in cases]
    for ci, (sc, par, _) in zip(cases, C.chain_calls(preps, cuda)):
        np.testing.assert_array_equal(sc, g[f"scores{ci}"], err_msg=f"case {ci}")
        np.testing.assert_array_equal(par, g[f"parents{ci}"], err_msg=f"case {ci}")


@pytest.mark.cuda
def test_chain_wrapper_checks_inputs(cuda):
    tb, params = chain_batch_from_numpy(_chain_preps(14, 4, 50), cuda)
    kernel = chain_cuda.chain_dp
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel({k: v.cpu() for k, v in tb.items()}, params)
    with pytest.raises(ValueError, match="dtype"):
        kernel(dict(tb, off=tb["off"].to(torch.int32)), params)
    with pytest.raises(ValueError, match="dtype"):
        kernel(dict(tb, x_lo=tb["x_lo"].to(torch.int64)), params)
    with pytest.raises(ValueError, match="shape"):
        kernel(dict(tb, qi=tb["qi"][:-1]), params)
    with pytest.raises(ValueError, match="shape"):
        kernel(tb, (5000, 5000, 400))  # the gap tables hold bw + 1 = 501 entries
    with pytest.raises(ValueError, match="params"):
        kernel(tb, params[:2])
    assert kernel.launches == before
    empty = {k: v[:0] for k, v in tb.items()}
    assert kernel(empty, params).shape == (3, 0)


def _abea_reads(seed, n, max_len):
    """Reads of 7 to max_len bases whose events follow a synthetic model,
    scaled 0.8-1.2 and shifted -4..4, 1-3 events a k-mer; every fifth read
    gets N(0, 25) noise (QC drops), one read has a single event."""
    rng = np.random.default_rng(seed)
    model = {"level_mean": rng.normal(90, 12, 4096).astype(np.float32),
             "level_stdv": (rng.random(4096) * 2 + 1).astype(np.float32)}
    model["level_log_stdv"] = np.log(model["level_stdv"]).astype(np.float32)
    seqs, evs, scales, shifts = [], [], [], []
    for t in range(n):
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(7, max_len))))
        ranks = A.kmer_ranks(seq, 6, len(seq) - 5)
        sc, sh = np.float32(rng.uniform(0.8, 1.2)), np.float32(rng.uniform(-4, 4))
        reps = rng.integers(1, 4, len(ranks))
        ev = (sc * np.repeat(model["level_mean"][ranks], reps) + sh
              + rng.normal(0, 0.5, reps.sum()) * np.repeat(model["level_stdv"][ranks], reps))
        if t % 5 == 4:
            ev = ev + rng.normal(0, 25, len(ev))
        if t == 7:
            ev = ev[:1]
        seqs.append(seq)
        evs.append(ev.astype(np.float32))
        scales.append(float(sc))
        shifts.append(float(sh))
    return seqs, evs, model, scales, shifts


@pytest.mark.cuda
def test_abea_kernels_equal_to_plain(cuda):
    seqs, evs, model, scales, shifts = _abea_reads(15, 60, 700)
    batch_np, idx = A.prepare_batch(seqs, evs, model, scales, shifts)
    tb = abea_batch_from_numpy(batch_np, cuda)
    fill_before, walk_before = abea_cuda.abea_fill.launches, abea_cuda.abea_walk.launches
    fill = A.abea_fill(tb)
    walk = A.abea_walk(tb, fill)
    torch.cuda.synchronize()
    assert abea_cuda.abea_fill.launches == fill_before + 1
    assert abea_cuda.abea_walk.launches == walk_before + 1
    want_fill = A.abea_fill_plain(tb)
    for k, v in want_fill.items():
        assert torch.equal(fill[k], v), k
    for k, v in A.abea_walk_plain(tb, fill).items():
        assert torch.equal(walk[k], v), k
    got = A.decode(batch_np["band_off"], {k: v.cpu().numpy() for k, v in walk.items()})
    for r, i in enumerate(idx[:12]):
        assert got[r] == AO.align(seqs[i], evs[i], model, scales[i], shifts[i]), i
    assert any(got) and not all(got)


@pytest.mark.cuda
def test_abea_edge_reads_kernels_equal_to_plain(cuda):
    """chip_smoke.abea_edge_reads (the warp fill's lanes and band ends, the
    walk's windows) and its first batch blocked (chip_smoke.abea_blocked:
    seed 0, clamped offsets): every output of both kernels bit for bit."""
    model, batches = chip_smoke.abea_edge_reads(np.random.default_rng(0))
    flat = [A.prepare_batch(seqs, evs, model, scales, shifts)[0]
            for seqs, evs, scales, shifts in batches]
    for batch_np in flat + [chip_smoke.abea_blocked(flat[0])]:
        tb = abea_batch_from_numpy(batch_np, cuda)
        before = (abea_cuda.abea_fill.launches, abea_cuda.abea_walk.launches)
        fill = A.abea_fill(tb)
        walk = A.abea_walk(tb, fill)
        torch.cuda.synchronize()
        assert (abea_cuda.abea_fill.launches, abea_cuda.abea_walk.launches) == (
            before[0] + 1, before[1] + 1)
        for k, v in A.abea_fill_plain(tb).items():
            assert torch.equal(fill[k], v), k
        for k, v in A.abea_walk_plain(tb, fill).items():
            assert torch.equal(walk[k], v), k


@pytest.mark.cuda
def test_abea_goldens_on_card(cuda, fixtures_dir, tmp_path):
    sys.path.insert(0, str(Path(__file__).parent))
    from generate_fixtures import _pore_levels

    path = tmp_path / "pore.tsv"
    with open(path, "w") as f:
        f.write("kmer\tlevel_mean\tlevel_stdv\n")
        for km, mean in _pore_levels().items():
            f.write(f"{km}\t{mean:.2f}\t1.50\n")
    model = SIG.load_pore_model(str(path))
    cases = json.load(open(fixtures_dir / "abea_golden.json"))["cases"]
    events = detect_events_batch([np.array([float(x) for x in c["signal"]], np.float32)
                                  for c in cases])
    shifts, scales = estimate_scalings_mom_batch([c["seq"] for c in cases], model, events)
    got = A.align_events_batch([c["seq"] for c in cases], [e["mean"] for e in events], model,
                               [float(v) for v in scales], [float(v) for v in shifts],
                               device=cuda)
    for c, ev, g in zip(cases, events, got):
        assert ev["start"].astype(np.int64).tolist() == [e[0] for e in c["events"]]
        assert g == [tuple(p) for p in c["pairs"]]
    assert [float(v) for v in scales] == [float(np.float32(float.fromhex(c["scale"])))
                                          for c in cases]


@pytest.mark.cuda
def test_eventalign_goldens_on_card_equal_cpu(cuda, fixtures_dir, tmp_path):
    """The eventalign mode's batch (abea kernels, the realign's CUDA graphs)
    gives the 25 goldens' TSV rows on the card, and the same text as the
    CPU's plain path on the first five cases."""
    chip_smoke.write_pore_model(tmp_path / "pore.tsv")
    model = SIG.load_pore_model(str(tmp_path / "pore.tsv"))

    class Port:
        bam, cli_abea = B, cli_abea

    def run(device, cases=None):
        counts = dict.fromkeys(cli_abea.COUNTS, 0)
        entries, contigs, want = chip_smoke.golden_eventalign_entries(Port, counts)
        if cases is not None:
            keep = [e for e in entries if e[3].ref_id < cases]
            entries, contigs = keep, contigs[:cases]
            want = want[: len(keep)]
        text = cli_abea.eventalign_batch(entries, contigs, model, cli_abea.EventalignOptions(),
                                         counts, device)[0]
        return text, [t for w in want for t in w.get("tsv", [])]

    text, want = run(cuda)
    assert text.splitlines() == want
    assert run(cuda, 5)[0] == run("cpu", 5)[0]


@pytest.mark.cuda
def test_abea_wrappers_check_inputs(cuda):
    seqs, evs, model, scales, shifts = _abea_reads(16, 6, 80)
    tb = abea_batch_from_numpy(A.prepare_batch(seqs, evs, model, scales, shifts)[0], cuda)
    fill_k, walk_k = abea_cuda.abea_fill, abea_cuda.abea_walk
    before = (fill_k.launches, walk_k.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fill_k({k: v.cpu() for k, v in tb.items()})
    with pytest.raises(ValueError, match="dtype"):
        fill_k(dict(tb, lp=tb["lp"].float()))
    with pytest.raises(ValueError, match="dtype"):
        fill_k(dict(tb, band_off=tb["band_off"].int()))
    with pytest.raises(ValueError, match="shape"):
        fill_k(dict(tb, stdv=tb["stdv"][:-1]))
    with pytest.raises(ValueError, match="contiguous"):
        fill_k(dict(tb, lp=tb["lp"].t().contiguous().t()))
    fill = fill_k(tb)
    with pytest.raises(ValueError, match="shape"):
        walk_k(tb, dict(fill, trace=fill["trace"][:-1]))
    with pytest.raises(ValueError, match="dtype"):
        walk_k(tb, dict(fill, seed=fill["seed"].long()))
    with pytest.raises(ValueError, match="CUDA"):
        walk_k({k: v.cpu() for k, v in tb.items()}, fill)
    with pytest.raises(ValueError, match="16-byte"):
        walk_k(tb, dict(fill, bll_e=torch.empty(fill["bll_e"].numel() + 1, dtype=torch.int32,
                                                device=cuda)[1:]))
    assert (fill_k.launches, walk_k.launches) == (before[0] + 1, before[1])
    empty = A.prepare_batch([], [], model, [], [])[0]
    te = abea_batch_from_numpy(empty, cuda)
    out = fill_k(te)
    assert out["trace"].shape == (0, 100) and out["seed"].shape == (0,)
    assert walk_k(te, out)["pairs"].shape == (0, 2)
    assert cli_abea.run_reads(cli_abea.PreparedReads(0, [], [], [], [], []), model,
                              device=cuda) == []


def _gather_inputs(seed, rows, n, dev):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, (rows, 8), dtype=np.int64)).to(dev)
    idx = torch.from_numpy(rng.integers(0, rows, n).astype(np.int32)).to(dev)
    return table, idx


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 511, 4096, 100_003])
def test_occ_gather_kernels_equal_to_plain(cuda, n):
    table, idx = _gather_inputs(n, 8 * 4097, n, cuda)
    want = G.occ_gather_row_plain(table, idx)
    for r in G.ROWS_IN_FLIGHT:
        assert torch.equal(G.occ_gather_row(table, idx, r), want)
    assert torch.equal(G.occ_gather_tile(table, idx), G.occ_gather_tile_plain(table, idx))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_occ_gather_every_sweep_layout_equal_to_plain(cuda):
    """Every depth tools/gather_lanes.py can build, on 100,003 indices that
    include rows 0 and rows - 1."""
    from genomicsbench_palisade_tpu_torch.tools import build_all, gather_lanes
    table, idx = _gather_inputs(5, 8 * 4097, 100_003, cuda)
    idx[0], idx[-1] = 0, table.shape[0] - 1
    want_row, want_tile = G.occ_gather_row_plain(table, idx), G.occ_gather_tile_plain(table, idx)
    sets = [dict.fromkeys(G.LAYOUTS, d) for d in gather_lanes.DEPTHS]
    rows = [G.OccGatherRowKernel(lay) for lay in sets]
    tiles = [G.OccGatherTileKernel(lay) for lay in sets]
    build_all(rows)
    for row_k, tile_k in zip(rows, tiles):
        for r in G.ROWS_IN_FLIGHT:
            assert torch.equal(row_k(table, idx, r), want_row), (row_k.defines, r)
        assert torch.equal(tile_k(table, idx), want_tile), tile_k.defines
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_occ_gather_wrappers_check_inputs(cuda):
    table, idx = _gather_inputs(1, 8 * 64, 100, cuda)
    row_k, tile_k = G.occ_gather_row_cuda, G.occ_gather_tile_cuda
    before = (row_k.launches, tile_k.launches)
    with pytest.raises(ValueError, match="CUDA"):
        row_k(table.cpu(), idx.cpu())
    with pytest.raises(ValueError, match="dtype"):
        row_k(table, idx.long())
    with pytest.raises(ValueError, match="shape"):
        row_k(table[:, :4].contiguous(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        row_k(table, idx[::2])
    with pytest.raises(ValueError, match="multiple of 8"):
        tile_k(table[:-1], idx % 63)
    with pytest.raises(RuntimeError, match="launch failed"):
        row_k(table, idx, 4)
    assert (row_k.launches, tile_k.launches) == before
    padded = G.pad_to_tiles(table[:-3])
    assert padded.shape == table.shape and torch.equal(padded[-3:], torch.zeros_like(table[:3]))
    assert torch.equal(tile_k(padded, idx % 509), G.occ_gather_tile_plain(padded, idx % 509))


def _fmi_case(seed, n_bases=3000, n_reads=40, read_len=100):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n_bases).astype(np.uint8)
    starts = rng.integers(0, n_bases - read_len, n_reads)
    enc = np.stack([codes[s : s + read_len] for s in starts]).astype(np.int8)
    enc[rng.random(enc.shape) < 0.02] = 4
    rl = rng.integers(read_len // 2, read_len + 1, n_reads).astype(np.int32)
    return codes, enc, rl


@pytest.mark.cuda
def test_fmi_builder_and_pipeline_on_card_equal_cpu(cuda):
    codes, enc, rl = _fmi_case(3)
    didx = IB.build_arrays(codes, sa_compression=True, device=cuda)
    cpu = IB.build_arrays(codes, sa_compression=True, device="cpu")
    assert didx.sentinel_index == cpu.sentinel_index
    for key in ("count", "cp_occ", "sa_ms_byte", "sa_ls_word"):
        np.testing.assert_array_equal(getattr(didx, key), getattr(cpu, key))
    st = {}
    got = FP.fmi_pipeline_batch(fmi_index_from_numpy(didx, cuda), enc, rl, min_seed_len=15,
                                stats=st)
    want = FP.fmi_pipeline_batch(fmi_index_from_numpy(cpu, "cpu"), enc, rl, min_seed_len=15)
    assert got[1:] == want[1:] and sum(got[1:4]) > 40
    for key in want[0]:
        np.testing.assert_array_equal(got[0][key], want[0][key])
    assert st["occ_rows"] > 0 and st["steps1"] > 0


@pytest.mark.cuda
def test_fmi_cli_on_card(cuda, tmp_path, capsys):
    # reads shorter than the slot buffers: the traces are padded before compaction
    codes, enc, rl = _fmi_case(4, n_reads=20, read_len=40)
    fa, fq = tmp_path / "ref.fa", tmp_path / "r.fq"
    fa.write_text(">r\n" + "".join("ACGT"[c] for c in codes) + "\n")
    with open(fq, "w") as f:
        for i, (e, n) in enumerate(zip(enc, rl)):
            f.write(f"@q{i}\n{''.join('ACGTN'[c] for c in e[:n])}\n+\n{'I' * n}\n")
    assert cli_fmi.main([str(fa), str(fq), "8", "--print-output"]) == 0
    out = capsys.readouterr().out
    assert cli_fmi.main([str(fa), str(fq), "8", "--print-output", "--device", "cpu"]) == 0
    cpu_out = capsys.readouterr().out
    keep = lambda text: [ln for ln in text.splitlines() if not ln.startswith("Consumed")]
    assert keep(out) == keep(cpu_out) and "totalSmems = " in out


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["zero", "seeded", "int32_max", "h_max_e_small"])
@pytest.mark.parametrize("ql", [45, 7, 15, 128, 263, 512, 527, 1031])
def test_bsw_stripped_kernel_equal_to_plain(cuda, start, ql):
    """The whole final H and E, from starts that wrap and starts that do
    not, at queries that are not a multiple of 8 (qe_pad 48, with padding
    slots), at the kernel's instance edges (qe_pad 8, 16, 136, 264, 520),
    past them on the long-column kernel (qe_pad 528 and 1032), and a batch
    that leaves lanes idle.  Each query is its target's head
    with 8% substituted, as in the probe, so that a nonzero start's main
    diagonal keeps scoring."""
    rng = np.random.default_rng(21 + ql)
    # eight query rows forget a seeded start within ~30 target rows (E falls
    # by e_del a row, and the diagonal leaves them after 8): keep it short
    qe, b = BS.qe_pad_of(ql), 300
    tp = 70 if qe > 8 else 16
    t = rng.integers(0, 4, (tp, b))
    q = np.full((qe, b), BS.PAD_CODE)
    n = min(ql, tp)
    q[:n] = np.where(rng.random((n, b)) < 0.08, rng.integers(0, 4, (n, b)), t[:n])
    big = 2**31 - 1
    h, e = {"zero": (np.zeros((qe, b)), np.zeros((qe, b))),
            "seeded": (rng.integers(0, 61, (qe, b)), rng.integers(0, 31, (qe, b))),
            "int32_max": (np.full((qe, b), big), np.full((qe, b), big)),
            "h_max_e_small": (rng.integers(big - 40, big, (qe, b), endpoint=True),
                              rng.integers(0, 30, (qe, b)))}[start]
    args = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(cuda) for a in (q, t, h, e)]
    before = BS.bsw_stripped_cuda.launches
    got = BS.bsw_stripped(*args)
    torch.cuda.synchronize()
    assert BS.bsw_stripped_cuda.launches == before + 1
    assert torch.equal(got, BS.bsw_stripped_plain(*args))
    assert got.shape == (2, qe, b) and (start == "zero") == (not got.any())


@pytest.mark.cuda
def test_bsw_stripped_wrapper_checks_inputs(cuda):
    z = torch.zeros((16, 64), dtype=torch.int32, device=cuda)
    kernel = BS.bsw_stripped_cuda
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel(z.cpu(), z.cpu(), z.cpu(), z.cpu())
    with pytest.raises(ValueError, match="dtype"):
        kernel(z.long(), z, z, z)
    with pytest.raises(ValueError, match="shape"):
        kernel(z, z[:, :32], z, z)
    with pytest.raises(ValueError, match="shape"):
        kernel(z, z, z[:8], z)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(z, z, z, torch.zeros((64, 16), dtype=torch.int32, device=cuda).T)
    with pytest.raises(ValueError, match="6 ints"):
        kernel(z, z, z, z, (6, 1, 6, 1))
    big = torch.zeros((528, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        kernel(big.cpu(), z.cpu(), big.cpu(), big.cpu())
    assert kernel.launches == before
    assert torch.equal(kernel(big, z, big, big), BS.bsw_stripped_plain(big, z, big, big))
    assert kernel.launches == before + 1
    assert kernel(z[:, :0], z[:, :0], z[:, :0], z[:, :0]).shape == (2, 16, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("w,bw,wrap", [(64, 500, False), (13, 500, True), (5, 100_000, True),
                                       (700, 500, False), (1, 500, True), (32, 500, False),
                                       (33, 500, True), (129, 500, True), (700, 500, True)])
def test_chain_micro_kernel_equal_to_plain(cuda, w, bw, wrap):
    """Phantom predecessors, windows of 1 to 700 anchors (one register
    bank, its edge, two banks, and past them into the shared ring), slopes
    whose products wrap, and a bw whose log term passes 8, on 67 calls."""
    rng = np.random.default_rng(w)
    b, n = 67, 1500
    steps = rng.integers(1, 40, (b, n))
    if wrap:
        steps = steps + (rng.random((b, n)) < 0.1) * rng.integers(20_000, 2_000_000, (b, n))
    x = np.cumsum(steps, axis=1).astype(np.int64).astype(np.uint32).view(np.int32)
    qi = np.cumsum(rng.integers(1, 30, (b, n)), axis=1).astype(np.int32)
    qspan = rng.integers(10, 30, (b, n)).astype(np.int32)
    m_fp = (rng.integers(0, 2**31, b) if wrap else np.full(b, 157286)).astype(np.int32)
    gap0 = rng.integers(0, 10, b).astype(np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (x, qi, qspan, m_fp, gap0)]
    before = CM.chain_micro_cuda.launches
    got = CM.chain_micro(*args, w, bw)
    torch.cuda.synchronize()
    assert CM.chain_micro_cuda.launches == before + 1
    assert torch.equal(got, CM.chain_micro_plain(*args, w, bw))
    assert int(got.max()) > 30


@pytest.mark.cuda
def test_chain_micro_wrapper_checks_inputs(cuda):
    z = torch.zeros((4, 96), dtype=torch.int32, device=cuda)
    zc = torch.zeros(4, dtype=torch.int32, device=cuda)
    kernel = CM.chain_micro_cuda
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel(z.cpu(), z.cpu(), z.cpu(), zc.cpu(), zc.cpu(), 64, 500)
    with pytest.raises(ValueError, match="dtype"):
        kernel(z, z.long(), z, zc, zc, 64, 500)
    with pytest.raises(ValueError, match="shape"):
        kernel(z, z, z[:, :32], zc, zc, 64, 500)
    with pytest.raises(ValueError, match="shape"):
        kernel(z, z, z, zc[:2], zc, 64, 500)
    with pytest.raises(ValueError, match="w"):
        kernel(z, z, z, zc, zc, 0, 500)
    assert kernel.launches == before
    assert kernel(z[:, :0], z[:, :0], z[:, :0], zc, zc, 64, 500).shape == (4, 0)
    # a window whose ring passes 48 KB of shared memory (12 bytes an entry)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(np.cumsum(rng.integers(1, 3, (2, 5000)), axis=1).astype(np.int32)).to(cuda)
    zc2 = torch.zeros(2, dtype=torch.int32, device=cuda)
    got = kernel(x, x, torch.full_like(x, 15), zc2, zc2, 4200, 500)
    assert torch.equal(got, CM.chain_micro_plain(x, x, torch.full_like(x, 15), zc2, zc2, 4200, 500))


@pytest.mark.cuda
def test_kmer_goldens_on_card_and_card_equal_cpu(cuda, fixtures_dir):
    """The 25 kmer goldens through both counters on the card; k = 31 and
    32 (bit 63 reached) on coverage reads, card against CPU."""
    for case in json.load(open(fixtures_dir / "kmer_golden.json"))["cases"]:
        args = dict(k=case["k"], min_read_length=case["min_read_length"], device=cuda)
        for got in (KM.count_kmers(case["reads"], **args),
                    KM.count_kmers_batched(case["reads"], batch_bases=600, cap=1 << 13, **args)):
            assert (got["total_kmers"], got["hash_size"]) == (case["total_kmers"],
                                                              case["hash_size"])
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 4000)
    reads = ["".join("ACGT"[c] for c in genome[s : s + 900])
             for s in rng.integers(0, 3100, 64)]
    for k in (31, 32):
        args = dict(k=k, min_read_length=500, batch_bases=9_000, cap=1 << 16)
        want = KM.count_kmers_batched(reads, device="cpu", **args)
        assert KM.count_kmers_batched(reads, device=cuda, **args) == want
        assert KM.count_kmers(reads, k=k, min_read_length=500, device=cuda) == want


@pytest.mark.cuda
def test_poa_goldens_on_card(cuda, fixtures_dir):
    """The 48 poa goldens (nw) through msa_consensus_batch on the card
    (the row step and the walk blocks as CUDA graphs), and the 10 sw/ov
    cases' alignments exactly."""
    cases = json.load(open(fixtures_dir / "poa_golden.json"))["cases"]
    batches = [seqs for case in cases for seqs in case["batches"]]
    assert POA.msa_consensus_batch(batches, device=cuda) == [w for case in cases
                                                              for w in case["consensus"]]
    golden = json.load(open(fixtures_dir / "poa_swov_golden.json"))["cases"]
    for atype in ("sw", "ov"):
        graphs = [POAO.PoaGraph() for _ in golden]
        for k in range(max(len(c["seqs"]) for c in golden)):
            idxs = [ci for ci, c in enumerate(golden) if k < len(c["seqs"])]
            alns = POA.align_batch([graphs[ci] for ci in idxs],
                                   [golden[ci]["seqs"][k] for ci in idxs], align_type=atype,
                                   device=cuda)
            for ci, aln in zip(idxs, alns):
                assert [list(p) for p in aln] == golden[ci][atype]["alignments"][k]
                graphs[ci].add_alignment(aln, golden[ci]["seqs"][k])
        assert [g.generate_consensus() for g in graphs] == [c[atype]["consensus"]
                                                            for c in golden]
