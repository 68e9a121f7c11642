"""The port's PairHMM (genomicsbench_palisade_tpu_torch) against the JAX
package and the GKL oracle, on the CPU at small sizes.

Contract: the port's raw f32 sums are bit-equal to the oracle's f32 path
(ops/oracle/phmm.py compute_full_prob) and its raw f64 sums to the JAX
package's f64 sweep (ops/phmm_f64.phmm_forward_f64).  Against the JAX scan
and the interpret-mode Pallas kernel the bound is 1e-5 in log10, the bound
the JAX package holds its own scan to (tests/test_phmm_jax.py): XLA on the
CPU contracts a*b+c into an FMA and lowers x/3.0 as x*(1/3), so the JAX
scan is itself not bit-exact to the oracle (a few hundred f32 ulp at most
on these sizes).
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genomicsbench_palisade_tpu.ops import phmm as JP
from genomicsbench_palisade_tpu.ops import phmm_f64 as JF64
from genomicsbench_palisade_tpu.ops import phmm_pallas as JPP
from genomicsbench_palisade_tpu.ops.oracle import phmm as JO
from genomicsbench_palisade_tpu_torch.ops import phmm as P
from genomicsbench_palisade_tpu_torch.ops import phmm_f64 as F64
from genomicsbench_palisade_tpu_torch.ops.oracle import phmm as O

LOG10_TOL = 1e-5


def _cases(seed, n, max_r=40, max_h=60, from_hap=False, qlo=6, qhi=60):
    """Random testcases; with from_hap, reads are noisy substrings of their
    hap (the high-likelihood regime of bench.py)."""
    rng = np.random.default_rng(seed)
    reads, haps, pairs = [], [], []
    for k in range(n):
        hl = int(rng.integers(4, max_h))
        rl = int(rng.integers(3, min(max_r, hl)))
        hap = rng.integers(0, 5 if not from_hap else 4, hl)
        if from_hap:
            s = int(rng.integers(0, hl - rl + 1))
            bases = hap[s : s + rl].copy()
            noise = rng.random(rl) < 0.05
            bases[noise] = rng.integers(0, 4, int(noise.sum()))
        else:
            bases = rng.integers(0, 5, rl)
        reads.append({"bases": bases, "q": rng.integers(qlo, qhi, rl),
                      "i": rng.integers(25, qhi, rl), "d": rng.integers(25, qhi, rl),
                      "c": rng.integers(qlo, qhi, rl)})
        haps.append(hap)
        pairs.append((k, k))
    return reads, haps, pairs


CASE_SETS = {
    "random": dict(seed=0, n=24),
    "from_hap": dict(seed=1, n=24, from_hap=True),
    "wide_quals": dict(seed=2, n=16, qlo=0, qhi=127),
}


def _oracle_raw(reads, haps, pairs, dtype):
    return np.array([JO.compute_full_prob(reads[r]["bases"], haps[h], reads[r]["q"],
                                          reads[r]["i"], reads[r]["d"], reads[r]["c"], dtype)
                     for r, h in pairs], dtype=dtype)


def test_tables_equal_jax_tables():
    ph2pr, m2m, log10_ic, ic = JP._tables_f32()
    t32 = P.tables(np.float32)
    np.testing.assert_array_equal(t32["ph2pr"], ph2pr)
    np.testing.assert_array_equal(t32["m2m"], m2m)
    assert t32["ph2pr"].dtype == np.float32 and t32["m2m"].dtype == np.float32
    assert float(t32["log10_initial_constant"]) == log10_ic
    assert float(t32["initial_constant"]) == ic
    np.testing.assert_array_equal(t32["one_m_ph2pr"], np.float32(1.0) - ph2pr)
    np.testing.assert_array_equal(t32["ph2pr_div3"], ph2pr / np.float32(3.0))

    ctx = JO.get_ctx(np.float64)
    t64 = P.tables(np.float64)
    for k in ("ph2pr", "m2m"):
        np.testing.assert_array_equal(t64[k], getattr(ctx, k))
        assert t64[k].dtype == np.float64
    assert t64["initial_constant"] == ctx.initial_constant
    assert t64["log10_initial_constant"] == ctx.log10_initial_constant
    np.testing.assert_array_equal(t64["one_m_ph2pr"], 1.0 - ctx.ph2pr)
    np.testing.assert_array_equal(t64["ph2pr_div3"], ctx.ph2pr / 3.0)
    # init_y = INITIAL_CONSTANT / haplen, divided as the oracle divides
    iy = P.init_y_table(np.float32, 64)
    assert iy[0] == 0 and all(iy[h] == np.float32(ic) / np.float32(h) for h in range(1, 65))


@pytest.mark.parametrize("name", sorted(CASE_SETS))
def test_plain_f32_bit_equal_to_oracle(name):
    reads, haps, pairs = _cases(**CASE_SETS[name])
    batch = P.prepare_batch(reads, haps, pairs)
    got = P.phmm_forward_plain(batch, torch.float32, "cpu").numpy()
    want = _oracle_raw(reads, haps, pairs, np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CASE_SETS))
def test_plain_f64_bit_equal_to_jax_f64(name):
    reads, haps, pairs = _cases(**CASE_SETS[name])
    batch = P.prepare_batch(reads, haps, pairs, r_pad=48, h_pad=64)
    got = P.phmm_forward_plain(batch, torch.float64, "cpu").numpy()
    jb = JP.prepare_batch(reads, haps, pairs, r_pad=48, h_pad=64, transposed=False)
    np.testing.assert_array_equal(got, JF64.phmm_forward_f64(jb))
    np.testing.assert_array_equal(got[:4], _oracle_raw(reads, haps, pairs[:4], np.float64))


def _fallback_case():
    """tests/test_phmm_jax.py's fallback case: float underflows, double
    stays finite (~1e-100)."""
    rl, hl = 100, 100
    bases = np.full(rl, 1, dtype=np.int64)
    bases[:18] = 0
    reads = [{"bases": bases, "q": np.full(rl, 60), "i": np.full(rl, 60),
              "d": np.full(rl, 60), "c": np.full(rl, 60)}]
    return reads, [np.full(hl, 1, dtype=np.int64)], [(0, 0)]


def test_fallback_log10_matches_jax_and_oracle():
    reads, haps, pairs = _fallback_case()
    r = reads[0]
    rng = np.random.default_rng(3)
    more_r, more_h, _ = _cases(seed=3, n=5)
    reads += more_r
    haps += more_h
    pairs += [(k + 1, k + 1) for k in range(5)]
    batch = P.prepare_batch(reads, haps, pairs)
    _, raw, fallback = P.phmm_forward(batch, "cpu")
    assert bool(fallback[0]) and raw[0] < 1e-28
    mask = fallback.copy()
    mask[rng.integers(1, len(pairs))] = True
    got, idx = F64.phmm_fallback_log10(batch, mask, "cpu")
    jb = JP.prepare_batch(reads, haps, pairs)
    want, jidx = JF64.phmm_fallback_log10({k: np.asarray(v) for k, v in jb.items()}, mask)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(got, want)
    oracle_v = O.compute_likelihood(r["bases"], haps[0], r["q"], r["i"], r["d"], r["c"])
    assert got[0] == oracle_v and np.isfinite(got[0]) and got[0] < -50
    assert P.phmm_likelihoods(batch, "cpu")[0] == oracle_v


def test_port_vs_jax_scan():
    reads, haps, pairs = [], [], []
    for name in sorted(CASE_SETS):
        r, h, p = _cases(**CASE_SETS[name])
        off = len(reads)
        reads += r
        haps += h
        pairs += [(a + off, b + off) for a, b in p]
    batch = P.prepare_batch(reads, haps, pairs)
    log10, _, fallback = P.phmm_forward(batch, "cpu")
    jb = JP.prepare_batch(reads, haps, pairs)
    jlog10, _, jfallback = map(np.asarray, JP.phmm_forward(jb))
    np.testing.assert_array_equal(fallback, jfallback)
    ok = ~fallback
    assert ok.sum() > 10
    np.testing.assert_allclose(log10[ok], jlog10[ok], rtol=0, atol=LOG10_TOL)
    # through the f64 fallback too
    got = P.phmm_likelihoods(batch, "cpu")
    want = JP.phmm_likelihoods(jb, reads, haps, pairs)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOG10_TOL)


def test_port_vs_pallas_interpret():
    """128 testcases (one lane tile) through the Pallas kernel in interpret
    mode, as tests/test_phmm_pallas.py runs it."""
    reads, haps, pairs = _cases(seed=4, n=128, max_r=60, max_h=100, from_hap=True, qlo=20)
    r2, h2, _ = _cases(seed=5, n=64, max_r=60, max_h=100)
    reads[:64], haps[:64] = r2, h2
    batch = P.prepare_batch(reads, haps, pairs, r_pad=64, h_pad=128)
    log10, _, fallback = P.phmm_forward(batch, "cpu")
    jb = JP.prepare_batch(reads, haps, pairs, r_pad=64, h_pad=128)
    jb = {k: jax.device_put(np.asarray(v)) for k, v in jb.items()}
    with pltpu.force_tpu_interpret_mode():
        plog10, _, pfallback = map(np.asarray, JPP.phmm_forward_pallas(jb))
    np.testing.assert_array_equal(fallback, pfallback)
    ok = ~fallback
    assert ok.sum() > 32
    np.testing.assert_allclose(log10[ok], plog10[ok], rtol=0, atol=LOG10_TOL)


def test_gkl_goldens(fixtures_dir):
    cases = json.load(open(fixtures_dir / "phmm_golden.json"))
    reads, haps, pairs = [], [], []
    for k, case in enumerate(cases):
        reads.append({"bases": O.encode_bases(case["rs"]),
                      **{key: np.array([ord(c) for c in case[key]]) for key in "qidc"}})
        haps.append(O.encode_bases(case["hap"]))
        pairs.append((k, k))
    assert len(cases) == 40
    got = P.phmm_likelihoods(P.prepare_batch(reads, haps, pairs), "cpu")
    want = np.array([c["log10"] for c in cases])
    np.testing.assert_allclose(got, want, rtol=0, atol=LOG10_TOL)


def test_likelihoods_equal_port_oracle():
    """Float-first with double fallback, exactly the oracle's numbers."""
    reads, haps, pairs = _cases(seed=6, n=16, max_r=30, max_h=50)
    got = P.phmm_likelihoods(P.prepare_batch(reads, haps, pairs), "cpu")
    want = [O.compute_likelihood(reads[r]["bases"], haps[h], reads[r]["q"], reads[r]["i"],
                                 reads[r]["d"], reads[r]["c"]) for r, h in pairs]
    np.testing.assert_array_equal(got, want)
