"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the `cuda` marker and skips without a CUDA card
(the kernels have no CPU mode).  The file imports no JAX, so it runs on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: none.  The PairHMM kernel and its plain version do the same
separate roundings on the same tables, so raw sums must be bit-equal; the
bsw and chain kernels and their plain versions compute in int32, so every
output must be equal.
"""

import json

import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu_torch.cli import bsw as cli_bsw
from genomicsbench_palisade_tpu_torch.cli import chain as cli_chain
from genomicsbench_palisade_tpu_torch.convert import bsw_batch_from_numpy, chain_batch_from_numpy
from genomicsbench_palisade_tpu_torch.io.chain_dump import ChainCallInput
from genomicsbench_palisade_tpu_torch.ops import bsw as W
from genomicsbench_palisade_tpu_torch.ops import bsw_cuda
from genomicsbench_palisade_tpu_torch.ops import chain as C
from genomicsbench_palisade_tpu_torch.ops import chain_cuda
from genomicsbench_palisade_tpu_torch.ops import phmm as P
from genomicsbench_palisade_tpu_torch.ops import phmm_cuda
from genomicsbench_palisade_tpu_torch.ops.oracle import bsw as WO
from genomicsbench_palisade_tpu_torch.ops.oracle import phmm as O

DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _cases(seed, n, max_r, max_h):
    """Half the reads are noisy substrings of their hap, half random (with
    N); lengths cover partial and whole 8-row stripes."""
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
    assert kernel.launches == before
    empty = {k: v if k == "codes" else v[:0] for k, v in tb.items()}
    assert kernel(empty, ptuple).shape == (6, 0)


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
