"""The port's banded Smith-Waterman on the inputs that its register kernels
refused before: queries past 512 bases and negative gap extension
(e_ins < 0), and the stripped probe past qe_pad 520, on the CPU.

The plain version (what the CPU runs; the card's kernels are held to it in
tests/test_torch_cuda.py, chip_smoke.py phases 5 and 13 and the warp
emulation) is held to the JAX scan, bit for bit.  At e_ins < 0 both part
from the C reference's loop (the oracle): their F is the prefix maximum
max(0, max_{j'<j}(c_j' + j'*e_ins) - (j-1)*e_ins), with no term for the
chain's zero start (which grows when e_ins < 0), and their first row is
max(h0 - oe_ins - (j-1)*e_ins, 0) written while the unclamped entry before
it is > e_ins, where the oracle's decay starts from max(h0 - oe_ins, 0).
`_oracle_closed_forms` is the oracle's loop with those two forms put in:
the plain version equals it, which shows that nothing else differs, and the
goldens count the pairs where the two semantics give other outputs.

Tolerance: none.  Every value is int32.
"""

import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from genomicsbench_palisade_tpu.ops import bsw as JW
from genomicsbench_palisade_tpu.ops.oracle import bsw as JO
from genomicsbench_palisade_tpu_torch.convert import bsw_batch_from_numpy
from genomicsbench_palisade_tpu_torch.ops import bsw as W
from genomicsbench_palisade_tpu_torch.ops import bsw_cuda
from genomicsbench_palisade_tpu_torch.ops import bsw_stripped as S
from genomicsbench_palisade_tpu_torch.ops.oracle import bsw as O

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
import bsw_roofline as J  # noqa: E402  the JAX tool (tools/ is not a package)
import chip_smoke  # noqa: E402  (the pair generators)

KEYS = W.OUT_ORDER


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _plain(pairs, params):
    tb, ptuple = bsw_batch_from_numpy(W.prepare_pairs(pairs, params), "cpu", params)
    out = W.bsw_extend(tb, ptuple)
    return {k: out[r].numpy() for r, k in enumerate(KEYS)}


def _jax(pairs, params):
    out = JW.bsw_batch(JW.prepare_pairs(pairs), JW._params_tuple(JO.BswParams(**params.__dict__)))
    return {k: np.asarray(out[k]) for k in KEYS}


def _assert_equal(got, want):
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("ql,w", [(513, 100), (700, 600), (1000, 100), (1024, 600)])
def test_long_query_plain_equals_jax_scan(ql, w):
    """Queries of `ql` bases, the head of targets of up to 2,048 bases with
    8% substituted; w 600 gives bands of 1,201 entries, across chunk edges
    of the long-query kernel."""
    params = O.BswParams(w=w)
    pairs = chip_smoke.bsw_long_pairs(np.random.default_rng(ql), 3, ql, ql, t_hi=2048)
    got = _plain(pairs, params)
    _assert_equal(got, _jax(pairs, params))
    assert (got["score"] > np.array([h for _, _, h in pairs])).all()
    assert (got["qle"] > 512).any()  # the best cell lies past the register instances


def test_tie_across_a_chunk_edge_plain_equals_jax_scan_and_oracle():
    """o_ins + e_ins = 0: F carries a row's M forward, so H(i, i) and
    H(i, i + 1) tie; the best row, 511, ties across the long-query
    kernel's first chunk edge, and the later entry wins (qle 513)."""
    params = O.BswParams(o_ins=-1, e_ins=1)
    q = np.random.default_rng(7).integers(0, 4, 600).astype(np.int8)
    pairs = [(q, q[:512], 30)]
    got = _plain(pairs, params)
    _assert_equal(got, _jax(pairs, params))
    assert {k: int(got[k][0]) for k in KEYS} == O.scalar_banded_swa(q, q[:512], 30, params)
    assert int(got["qle"][0]) == 513


@pytest.mark.parametrize("e_ins", [-1, -3])
def test_negative_extension_plain_equals_jax_scan(e_ins):
    """The edge pairs of chip_smoke.bsw_edge_pairs (queries of 1-512 bases at
    every lane and bucket edge, breaks, ties, h0 around o_ins + e_ins) and
    seeded pairs of 32-512 bases, at e_ins -1 and -3."""
    params = O.BswParams(e_ins=e_ins)
    rng = np.random.default_rng(-e_ins)
    pairs = chip_smoke.bsw_edge_pairs(rng, params.o_ins, e_ins)
    pairs += chip_smoke.bsw_long_pairs(rng, 12, 32, 512)
    got = _plain(pairs, params)
    _assert_equal(got, _jax(pairs, params))
    assert len({int(v) for v in got["score"]}) > 10


def _oracle_closed_forms(query, target, h0, p):
    """ops/oracle/bsw.py's loop with the JAX scan's first row and F (see the
    module's note), in Python ints."""
    qlen, tlen = len(query), len(target)
    mat = O.fill_scmat(p.match, p.mismatch, p.ambig)
    oe_del, oe_ins = p.o_del + p.e_del, p.o_ins + p.e_ins
    qp = mat[:, np.asarray(query, np.int64)]
    eh_h = [0] * (qlen + 2)
    eh_e = [0] * (qlen + 2)
    eh_h[0] = h0
    for j in range(1, qlen + 1):
        if j == 1 or h0 - oe_ins - (j - 2) * p.e_ins > p.e_ins:
            eh_h[j] = max(h0 - oe_ins - (j - 1) * p.e_ins, 0)
    w = W.band_width(torch.tensor([qlen], dtype=torch.int32), W._params_tuple(p)).item()
    max_score, max_i, max_j, max_ie, gscore, max_off = h0, -1, -1, -1, -1, 0
    beg, end = 0, qlen
    for i in range(tlen):
        q = qp[target[i]]
        beg, end = max(beg, i - w), min(end, i + w + 1, qlen)
        h1 = max(h0 - (p.o_del + p.e_del * (i + 1)), 0) if beg == 0 else 0
        m, mj, gmax = 0, -1, None  # gmax: max of c_j' + j'*e_ins so far
        for j in range(beg, end):
            big_m, e = eh_h[j], eh_e[j]
            eh_h[j] = h1
            big_m = big_m + int(q[j]) if big_m else 0
            f = 0 if gmax is None else max(gmax - (j - 1) * p.e_ins, 0)
            h = max(big_m, e, f)
            h1 = h
            if m <= h:
                m, mj = h, j
            eh_e[j] = max(e - p.e_del, max(big_m - oe_del, 0))
            c = max(big_m - oe_ins, 0) + j * p.e_ins
            gmax = c if gmax is None else max(gmax, c)
        eh_h[end], eh_e[end] = h1, 0
        if end == qlen and gscore <= h1:
            max_ie, gscore = i, h1
        if m == 0:
            break
        if m > max_score:
            max_score, max_i, max_j, max_off = m, i, mj, max(max_off, abs(mj - i))
        elif p.zdrop > 0:
            if i - max_i > mj - max_j:
                if max_score - m - ((i - max_i) - (mj - max_j)) * p.e_del > p.zdrop:
                    break
            elif max_score - m - ((mj - max_j) - (i - max_i)) * p.e_ins > p.zdrop:
                break
        j = beg
        while j < end and eh_h[j] == 0 and eh_e[j] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and eh_h[j] == 0 and eh_e[j] == 0:
            j -= 1
        end = j + 2 if j + 2 < qlen else qlen
    return {"score": max_score, "qle": max_j + 1, "tle": max_i + 1, "gtle": max_ie + 1,
            "gscore": gscore, "max_off": max_off}


# goldens whose outputs differ between the oracle and the JAX scan at e_ins
# (this test's count)
GOLDEN_ORACLE_DIFFERS = {-1: 9, -3: 24}


@pytest.mark.parametrize("e_ins", [-1, -3])
def test_negative_extension_goldens(e_ins, fixtures_dir):
    """The 300 reference goldens' pairs (tests/fixtures/bsw_golden.json) run
    with e_ins -1 and -3: the plain version equals the JAX scan and the
    oracle's loop with the scan's closed forms, every output of every pair;
    the oracle proper differs on GOLDEN_ORACLE_DIFFERS of them.  At e_ins 1
    the closed forms are the oracle's own."""
    cases = json.load(open(fixtures_dir / "bsw_golden.json"))
    pairs = [(np.array(c["query"], np.int8), np.array(c["target"], np.int8), c["h0"])
             for c in cases]
    params = O.BswParams(e_ins=e_ins)
    got = _plain(pairs, params)
    _assert_equal(got, _jax(pairs, params))
    rows = [{k: int(got[k][i]) for k in KEYS} for i in range(len(pairs))]
    assert rows == [_oracle_closed_forms(q, t, h, params) for q, t, h in pairs]
    differs = sum(r != O.scalar_banded_swa(q, t, h, params) for r, (q, t, h) in zip(rows, pairs))
    assert differs == GOLDEN_ORACLE_DIFFERS[e_ins]
    assert [_oracle_closed_forms(q, t, h, O.DEFAULT_PARAMS) for q, t, h in pairs[:40]] == \
        [c["out"] for c in cases[:40]]


def test_wrapper_takes_long_queries_and_negative_extension():
    """No query length and no e_ins is refused before the device check: a
    CPU tensor raises "CUDA" before any launch.  Rows of a query past
    28,671 bases leave a block's shared memory for the scratch."""
    pairs = chip_smoke.bsw_long_pairs(np.random.default_rng(0), 2, 600, 700)
    params = O.BswParams(e_ins=-2)
    tb, ptuple = bsw_batch_from_numpy(W.prepare_pairs(pairs, params), "cpu", params)
    kernel = bsw_cuda.bsw_extend
    before = kernel.launches
    for q_max in (None, 700, 30_000):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(tb, ptuple, q_max=q_max)
    assert kernel.launches == before
    assert bsw_cuda.long_stride(512) == 1024 and bsw_cuda.long_stride(1023) == 1024
    assert bsw_cuda.long_stride(1024) == 1536
    assert not bsw_cuda.long_in_scratch(28_671) and bsw_cuda.long_in_scratch(28_672)
    assert W.bsw_extend(tb, ptuple).shape == (6, 2)


def _stripped_full(params, q_ref, t_ref, h0_ref, e0_ref, out_ref, h_ref, e_ref):
    """tools/bsw_roofline.py's `_stripped_kernel` with its H/E scratch made
    outputs, started from h0/e0: the whole final H and E."""
    h_ref[:] = h0_ref[:]
    e_ref[:] = e0_ref[:]
    J._stripped_kernel(params, q_ref, t_ref, out_ref, h_ref, e_ref)


@pytest.mark.parametrize("qe_pad", [528, 1032])
def test_stripped_plain_equals_the_jax_recurrence_past_520(qe_pad):
    """Past the widest register instance: the JAX tool's recurrence (its
    Pallas kernel's body, interpret mode) from a seeded start (H 0-60, E
    0-30) over 6 target rows, every row of the final H and E."""
    rng = np.random.default_rng(qe_pad)
    q = rng.integers(0, 4, (qe_pad, J.LANE_TILE)).astype(np.int32)
    q[qe_pad - 5:] = S.PAD_CODE
    t = rng.integers(0, 4, (6, J.LANE_TILE)).astype(np.int32)
    h0 = rng.integers(0, 61, q.shape).astype(np.int32)
    e0 = rng.integers(0, 31, q.shape).astype(np.int32)
    spec = pl.BlockSpec(memory_space=pltpu.VMEM)
    col = jax.ShapeDtypeStruct(q.shape, jnp.int32)
    call = pl.pallas_call(functools.partial(_stripped_full, S.PARAMS),
                          in_specs=[spec] * 4, out_specs=[spec] * 3,
                          out_shape=[jax.ShapeDtypeStruct((8, J.LANE_TILE), jnp.int32), col, col],
                          interpret=pltpu.InterpretParams())
    _, want_h, want_e = call(*(jnp.asarray(a) for a in (q, t, h0, e0)))
    got = S.bsw_stripped(*(torch.from_numpy(a) for a in (q, t, h0, e0)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_e))
    assert (got[0, 512:] != torch.from_numpy(h0[512:])).any()
