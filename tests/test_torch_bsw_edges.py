"""The port's banded Smith-Waterman on pairs aimed at the lane layout of
csrc/bsw_extend.cu (`chip_smoke.bsw_edge_pairs`: every bucket edge and the
query lengths around lane boundaries, bands wider than 32 entries, the
m == 0 and z-drop breaks, ties in the row max, ambiguous codes, h0 at and
around o_ins + e_ins), on the CPU.

The plain version (what the CPU runs) is held to the port's oracle, the
JAX scan and the JAX package's Pallas kernel in interpret mode (as
tests/test_bsw_pallas.py runs it); the same pairs hold the kernel to the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py phase
5).  The kernel's two algebraic steps are transcribed in Python int32
arithmetic and held to the oracle's sequential loops: the first row's
closed form, and the F chain as a scan of composed maps across lanes.

Tolerance: none.  Every value is int32.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genomicsbench_palisade_tpu.ops import bsw as JW
from genomicsbench_palisade_tpu.ops import bsw_pallas as JWP
from genomicsbench_palisade_tpu.ops.oracle import bsw as JO
from genomicsbench_palisade_tpu_torch.convert import bsw_batch_from_numpy
from genomicsbench_palisade_tpu_torch.ops import bsw as W
from genomicsbench_palisade_tpu_torch.ops.oracle import bsw as O

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the edge-case generators)

KEYS = W.OUT_ORDER
INT32_MAX = (1 << 31) - 1
PARAMS = {"default": O.DEFAULT_PARAMS,
          "m2x3o5e2": O.BswParams(o_del=5, e_del=2, o_ins=5, e_ins=2, match=2, mismatch=3)}


@pytest.fixture(autouse=True)
def one_thread():
    """The plain version steps a target row at a time over [B, 513] rows:
    one torch thread is far faster at that width than the default pool."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pairs(name, seed=0):
    p = PARAMS[name]
    return chip_smoke.bsw_edge_pairs(np.random.default_rng(seed), p.o_ins, p.e_ins)


def _plain(pairs, params):
    tb, ptuple = bsw_batch_from_numpy(W.prepare_pairs(pairs, params), "cpu", params)
    out = W.bsw_extend(tb, ptuple)
    return {k: out[r].numpy() for r, k in enumerate(KEYS)}


def test_edge_pairs_cover_the_layout():
    pairs = _pairs("default")
    qlens = sorted({len(q) for q, _, _ in pairs})
    assert qlens == sorted(chip_smoke.BSW_EDGE_QLENS)
    assert {1, 31, 32, 33, 63, 512} <= set(qlens)
    oe = O.DEFAULT_PARAMS.o_ins + O.DEFAULT_PARAMS.e_ins
    assert {oe - 1, oe, oe + 1, oe + 2, -1, 0} <= {h for _, _, h in pairs}
    assert any((q >= 4).any() for q, _, _ in pairs) and max(len(t) for _, t, _ in pairs) <= 512
    got = _plain(pairs, O.DEFAULT_PARAMS)
    # breaks before the last row and scores that stay at h0 both occur
    assert (got["tle"] < np.array([len(t) for _, t, _ in pairs])).any()
    assert (got["score"] == np.array([h for _, _, h in pairs])).any()


@pytest.mark.parametrize("name", list(PARAMS))
def test_edge_plain_equals_oracle(name):
    params = PARAMS[name]
    pairs = _pairs(name)
    got = _plain(pairs, params)
    for i, (q, t, h0) in enumerate(pairs):
        assert {k: int(got[k][i]) for k in KEYS} == O.scalar_banded_swa(q, t, h0, params), i


@pytest.mark.parametrize("name", list(PARAMS))
def test_edge_plain_equals_jax_scan(name):
    params = PARAMS[name]
    pairs = _pairs(name, seed=1)
    got = _plain(pairs, params)
    jt = JW._params_tuple(JO.BswParams(**params.__dict__))
    want = JW.bsw_batch(JW.prepare_pairs(pairs), jt)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_edge_plain_equals_interpret_pallas():
    """The pairs of query length <= 65 (the three narrowest edges, one
    entry a lane at the warp's width), from four seeds: 128 pairs, one
    tile of the Pallas kernel's lanes."""
    params = PARAMS["default"]
    pairs = [p for seed in (2, 3, 4, 5) for p in _pairs("default", seed) if len(p[0]) <= 65]
    pairs = pairs[: JWP.LANE_TILE]
    got = _plain(pairs, params)
    jbatch = JW.prepare_pairs(pairs, q_pad=72, t_pad=max(len(t) for _, t, _ in pairs))
    with pltpu.force_tpu_interpret_mode():
        want = JWP.bsw_batch_pallas(jbatch, JW._params_tuple(JO.BswParams(**params.__dict__)))
    for k in KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def _decay_loop(h0, qlen, o_ins, e_ins):
    """The oracle's first row (bandedSWA.cpp:158-162): eh[1..qlen]."""
    oe = o_ins + e_ins
    row = [0] * (qlen + 1)
    row[0] = h0
    if qlen >= 1:
        row[1] = h0 - oe if h0 > oe else 0
    j = 2
    while j <= qlen and row[j - 1] > e_ins:
        row[j] = row[j - 1] - e_ins
        j += 1
    return row


def _closed_form(h0, qlen, o_ins, e_ins):
    """The kernel's first row: max(h0 - oe_ins - (j-1)*e_ins, 0) in 64 bits."""
    oe = o_ins + e_ins
    return [h0] + [max(h0 - oe - (j - 1) * e_ins, 0) for j in range(1, qlen + 1)]


@pytest.mark.parametrize("o_ins,e_ins", [(6, 1), (5, 2), (0, 0), (7, 1 << 28)],
                         ids=["default", "o5e2", "zero", "e_large"])
def test_first_row_closed_form_equals_decay_loop(o_ins, e_ins):
    oe = o_ins + e_ins
    h0s = list(range(-3, 10)) + [oe + k * e_ins + d for k in range(12) for d in (-2, -1, 0, 1)]
    h0s += [INT32_MAX, INT32_MAX - 5, -(1 << 31), 1 << 30]
    for qlen in (0, 1, 2, 33, 200):
        for h0 in h0s:
            assert _closed_form(h0, qlen, o_ins, e_ins) == _decay_loop(h0, qlen, o_ins, e_ins), (h0, qlen)
    if e_ins >= 1 << 20:  # the plain version's int32 (j-1)*e_ins would wrap
        return
    # the plain version's first row is the same closed form, in int32
    h0 = torch.tensor([h for h in h0s if abs(h) < 1 << 20], dtype=torch.int32)
    qlen = torch.full_like(h0, 33)
    row = W.first_row(h0, qlen, 34, (6, 1, o_ins, e_ins))
    for b, h in enumerate(h0.tolist()):
        assert row[b].tolist() == _decay_loop(h, 33, o_ins, e_ins), h


def _add_sat(a, b):
    return INT32_MAX if a > INT32_MAX - b else a + b


def _f_by_map_scan(c, beg, end, e_ins, lanes, k):
    """F over one row as csrc/bsw_extend.cu computes it: each lane folds
    its band cells' maps x -> max(x - e_ins, c_j) into one (a, b), a
    Hillis-Steele scan composes the lanes' maps, and each lane replays its
    cells from the b of the maps before it.  Every intermediate must stay
    inside int32, which the assertions check."""
    fa, fb = [0] * lanes, [0] * lanes
    for r in range(lanes):
        for j in range(r * k, r * k + k):
            if beg <= j < end:
                fb[r] = max(fb[r] - e_ins, c[j])
                fa[r] = _add_sat(fa[r], e_ins)
    d = 1
    while d < lanes:
        pa, pb = fa[:], fb[:]
        for r in range(d, lanes):
            diff = pb[r - d] - fa[r]
            assert -INT32_MAX <= diff <= INT32_MAX
            fb[r] = max(diff, fb[r])
            fa[r] = _add_sat(pa[r - d], fa[r])
        d *= 2
    f_out = [None] * (lanes * k)
    for r in range(lanes):
        f = fb[r - 1] if r else 0
        for j in range(r * k, r * k + k):
            if beg <= j < end:
                f_out[j] = f
                f = max(f - e_ins, c[j])
    return f_out


@pytest.mark.parametrize("lanes,k", [(8, 4), (32, 1), (32, 4), (32, 16)])
def test_f_chain_map_scan_equals_sequential(lanes, k):
    rng = np.random.default_rng(lanes * 100 + k)
    width = lanes * k
    for e_ins in (0, 1, 2, 1 << 20, 1 << 30, INT32_MAX):
        for _ in range(12):
            beg = int(rng.integers(0, width))
            end = int(rng.integers(beg, width + 1))
            top = int(rng.choice([50, 1 << 20, INT32_MAX]))
            c = [int(v) for v in rng.integers(0, top, width, endpoint=True)]
            c = [v if rng.random() > 0.3 else 0 for v in c]
            want, f = [None] * width, 0
            for j in range(beg, end):  # the oracle's chain: F(beg) = 0
                want[j] = f
                f = max(f - e_ins, c[j])
            assert _f_by_map_scan(c, beg, end, e_ins, lanes, k) == want, (e_ins, beg, end)
