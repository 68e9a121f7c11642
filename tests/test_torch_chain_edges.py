"""The port's anchor chaining on calls aimed at the steps of 32 predecessors
of csrc/chain_dp.cu (`chip_smoke.chain_edge_calls`: windows of 1, 31, 32,
33, 200 and 250 predecessors and of MAX_ITER, max_skip breaks at every
offset of a step, marks that a step's lanes make for its own later lanes,
ties, n_skip decrements at 0), on the CPU.

A transcription of the reference's loop (`_walk`) records where each of
those hazards occurs, so the first test proves the calls reach them.  The
plain version (what the CPU runs) is held to the port's oracle, the JAX
scan and the JAX package's Pallas kernel in interpret mode (as
tests/test_torch_chain.py runs them); the same calls hold the kernel to
the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 7).

Tolerance: none.  Every value is int32.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genomicsbench_palisade_tpu.ops import chain as JC
from genomicsbench_palisade_tpu_torch.convert import chain_batch_from_numpy
from genomicsbench_palisade_tpu_torch.ops import chain as C
from genomicsbench_palisade_tpu_torch.ops.oracle import chain as O

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the edge-case generators)

OUTS = ("scores", "parents", "peak_scores")


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _calls():
    return chip_smoke.chain_edge_calls(np.random.default_rng(0))


def _s32(v):
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _walk(p, bw=500, max_dist=5000):
    """The reference's loop (host_kernel.cpp:405-472) over a prepare_call
    dict: (scores, parents, events), where events counts the visits at
    offset t = i-1-j that the kernel's steps of 32 treat apart."""
    n = p["n"]
    x = [int(v) for v in p["x_lo"].view(np.uint32)]
    q = [int(v) for v in p["qi"]]
    span = [int(v) for v in p["qspan"]]
    gap = [int(v) for v in p["gap_table"]]
    scores, parents = [0] * n, [-1] * n
    ev = {"break_offsets": [], "in_step_skips": 0, "ties": 0, "floor_improvements": 0,
          "windows": set()}
    for i in range(n):
        st = int(p["st_eff"][i])
        ev["windows"].add(i - st)
        max_f, max_j, n_skip, marked = span[i], -1, 0, {}
        for j in range(i - 1, st - 1, -1):
            t = i - 1 - j
            dr, dq = _s32(x[i] - x[j]), _s32(q[i] - q[j])
            if dr == 0 or dq <= 0 or dq > max_dist:
                continue
            dd = abs(dr - dq)
            if dd > bw:
                continue
            sc = min(dq, dr, span[i]) - gap[dd] + scores[j]
            if sc > max_f:
                ev["floor_improvements"] += n_skip == 0
                max_f, max_j, n_skip = sc, j, max(n_skip - 1, 0)
            else:
                ev["ties"] += sc == max_f
                if j in marked:  # targets[j] == i
                    ev["in_step_skips"] += marked[j] // 32 == t // 32
                    n_skip += 1
                    if n_skip > O.MAX_SKIP:
                        ev["break_offsets"].append(t)
                        break
            if parents[j] >= 0:
                marked.setdefault(parents[j], t)
        scores[i], parents[i] = max_f, max_j
    return scores, parents, ev


def test_edge_calls_reach_every_hazard():
    calls = _calls()
    preps = [C.prepare_call(x, y, q) for x, y, q in calls]
    breaks, windows = [], set()
    totals = {"in_step_skips": 0, "ties": 0, "floor_improvements": 0}
    for (x, y, q), p in zip(calls[:-1], preps[:-1]):
        scores, parents, ev = _walk(p)
        want = O.chain_dp(O.ChainCall(len(x), q, 5000, 5000, 500, 1, x, y))
        assert scores == want["scores"].tolist() and parents == want["parents"].tolist()
        breaks += ev["break_offsets"]
        windows |= ev["windows"]
        for k in totals:
            totals[k] += ev[k]
    assert set(chip_smoke.CHAIN_EDGE_WINDOWS) <= windows
    assert set(np.array(breaks) % 32) == set(range(32))  # every lane of a step
    assert max(breaks) >= 64  # a break past the first two steps
    assert all(v > 0 for v in totals.values()), totals
    # the last call: windows of MAX_ITER, some walked to their end
    far = preps[-1]
    assert far["w_need"] == C.MAX_ITER
    batch, params = chain_batch_from_numpy([far], "cpu")
    stats = {}
    C.chain_dp_plain(batch, params, stats=stats)
    assert stats["predecessors"] > 1000 * far["n"] and 0 < stats["breaks"] < far["n"]


def test_edge_plain_equals_oracle():
    calls = _calls()[:-1]  # the oracle would take minutes on the MAX_ITER call
    preps = [C.prepare_call(x, y, q) for x, y, q in calls]
    got = C.chain_calls(preps, "cpu")
    for b, (x, y, q) in enumerate(calls):
        want = O.chain_dp(O.ChainCall(len(x), q, 5000, 5000, 500, 1, x, y))
        for r, k in enumerate(OUTS):
            np.testing.assert_array_equal(got[b][r], want[k], err_msg=f"call {b} {k}")


@pytest.mark.parametrize("part", ["windows_dense", "max_iter"])
def test_edge_plain_equals_jax_scan(part):
    calls = _calls()
    calls = calls[:-1] if part == "windows_dense" else calls[-1:]
    preps = [C.prepare_call(x, y, q) for x, y, q in calls]
    jpreps = [JC.prepare_call(x, y, q) for x, y, q in calls]
    got = C.chain_calls(preps, "cpu")
    w = C.window_size(max(p["w_need"] for p in jpreps))
    n_pad = max(p["n"] for p in jpreps)
    for b, p in enumerate(jpreps):
        want = JC.chain_call(p, w=w, n_pad=n_pad, engine="scan")
        for r in range(3):
            np.testing.assert_array_equal(got[b][r], np.asarray(want[r]), err_msg=f"call {b} {OUTS[r]}")


def test_edge_plain_equals_interpret_pallas(monkeypatch):
    """The calls with windows of 1-33 predecessors, through the JAX
    package's packed Pallas path in interpret mode (as
    tests/test_torch_chain.py runs it)."""
    calls = [c for c in _calls() if len(c[0]) <= 93]
    assert len(calls) == 8
    jpreps = [JC.prepare_call(x, y, q) for x, y, q in calls]
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        want = JC.chain_calls_packed(jpreps, lane_tile=2, force_kernel=True, nc=128)
    got = C.chain_calls([C.prepare_call(x, y, q) for x, y, q in calls], "cpu")
    for g, w in zip(got, want):
        for r in range(3):
            np.testing.assert_array_equal(g[r], w[r])
