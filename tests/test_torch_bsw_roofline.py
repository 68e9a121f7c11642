"""The port's bsw roofline probe (ops/bsw_stripped.py,
tools/bsw_roofline.py) against the JAX tool's workload and its Pallas
probe `_stripped` run in interpret mode, on the CPU.

The Pallas probe never initialises its H/E scratch, so interpret mode's
`uninitialized_memory` decides its start: "zero" is the port's zero start,
and the default "nan" fills int32 scratch with INT32_MAX, from which the
probe's int32 arithmetic wraps.  The plain version (what the CPU runs; the
card's kernel is held to it in tests/test_torch_cuda.py and chip_smoke.py)
must equal the probe's H[:8] from both starts.

Tolerance: none (int32).
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genomicsbench_palisade_tpu.ops import bsw as JW
from genomicsbench_palisade_tpu_torch.ops import bsw as W
from genomicsbench_palisade_tpu_torch.ops import bsw_cuda
from genomicsbench_palisade_tpu_torch.ops import bsw_stripped as S
from genomicsbench_palisade_tpu_torch import tools
from genomicsbench_palisade_tpu_torch.tools import bsw_idle_timing as I
from genomicsbench_palisade_tpu_torch.tools import bsw_roofline as T

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import bsw_roofline as J  # noqa: E402  the JAX tool (tools/ is not a package)

INT32_MAX = 2**31 - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _jax_tool_arrays(b, ql, tl):
    """tools/bsw_roofline.py:main's draws, line for line."""
    rng = np.random.default_rng(5)
    tgt = rng.integers(0, 4, (b, tl), np.int32)
    qry = tgt[:, :ql].copy()
    mut = rng.random((b, ql)) < 0.08
    qry[mut] = rng.integers(0, 4, int(mut.sum()))
    pairs = [(qry[i], tgt[i], 30) for i in range(b)]
    qe_pad = -(-(ql + 1) // 8) * 8
    q_dev = np.pad(qry.T, ((0, qe_pad - ql), (0, 0)), constant_values=5).astype(np.int32)
    return pairs, q_dev, tgt.T.astype(np.int32)


@pytest.mark.parametrize("b,ql,tl", [(8192, 128, 256), (128, 24, 40)])
def test_make_workload_is_the_tools_data(b, ql, tl):
    pairs, q_codes, target = T.make_workload(b, ql, tl)
    jpairs, jq, jt = _jax_tool_arrays(b, ql, tl)
    np.testing.assert_array_equal(q_codes, jq)
    np.testing.assert_array_equal(target, jt)
    assert q_codes.shape == (S.qe_pad_of(ql), b) and q_codes.dtype == np.int32
    assert all(h == jh == T.H0 for (_q, _t_, h), (_jq, _jt, jh) in zip(pairs, jpairs))
    want = JW.prepare_pairs(jpairs, q_pad=ql, t_pad=tl)
    got = W.prepare_pairs(pairs, q_pad=ql, t_pad=tl)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def _case(ql, tl, b=128, seed=1):
    rng = np.random.default_rng(seed + ql)
    tgt = rng.integers(0, 4, (b, tl), np.int32)
    qry = tgt[:, :ql].copy()
    mut = rng.random((b, ql)) < 0.08
    qry[mut] = rng.integers(0, 4, int(mut.sum()))
    qe = S.qe_pad_of(ql)
    q = np.pad(qry.T, ((0, qe - ql), (0, 0)), constant_values=S.PAD_CODE).astype(np.int32)
    return q, tgt.T.astype(np.int32).copy()


@pytest.mark.parametrize("ql,tl", [(16, 32), (24, 40)])
@pytest.mark.parametrize("memory,start", [("zero", 0), ("nan", INT32_MAX)])
def test_plain_equals_interpret_pallas(ql, tl, memory, start):
    q, t = _case(ql, tl)
    with pltpu.force_tpu_interpret_mode(pltpu.InterpretParams(uninitialized_memory=memory)):
        want = np.asarray(J._stripped(jnp.asarray(q), jnp.asarray(t), S.PARAMS))
    init = torch.full(q.shape, start, dtype=torch.int32)
    got = S.bsw_stripped(_t(q), _t(t), init, init.clone())
    assert got.shape == (2, q.shape[0], q.shape[1]) and got.dtype == torch.int32
    np.testing.assert_array_equal(got[0, :8].numpy(), want)
    if start:  # the wrapped start reaches the output: values near INT32_MAX and zeros
        assert want.max() > INT32_MAX - 64 and (want == 0).any()


def _loop(q, t, h, e, params, form):
    """One pair at a time, one cell at a time, in Python ints wrapped to
    int32: `prefix` is the kernel's form (F from the running maximum of
    max(c_k + k*e_ins, NEG)), `running` the form r = max(r - e_ins, c),
    F = max(r, 0)."""
    o_del, e_del, o_ins, e_ins, match, mismatch = params
    wrap = lambda v: (v + 2**31) % 2**32 - 2**31
    h, e = h.astype(np.int64), e.astype(np.int64)
    for b in range(q.shape[1]):
        for i in range(t.shape[0]):
            prev, gmax, r = 0, S.NEG, None
            for j in range(q.shape[0]):
                hj, ej = int(h[j, b]), int(e[j, b])
                m = wrap(hj + (match if q[j, b] == t[i, b] else -mismatch)) if hj else 0
                c = max(wrap(m - o_ins - e_ins), 0)
                if form == "prefix":
                    f = max(wrap(gmax - (j - 1) * e_ins), 0)
                    gmax = max(gmax, max(wrap(c + j * e_ins), S.NEG))
                else:
                    f = 0 if r is None else max(r, 0)
                    r = c if r is None else max(wrap(r - e_ins), c)
                e[j, b] = max(wrap(ej - e_del), max(wrap(m - o_del - e_del), 0))
                h[j, b], prev = prev, max(m, ej, f)
    return np.stack([h, e]).astype(np.int32)


def _start(kind, shape, rng):
    if kind == "seeded":  # chip_smoke.py's nonzero start
        return rng.integers(0, 61, shape), rng.integers(0, 31, shape)
    if kind == "int32_max":
        return np.full(shape, INT32_MAX), np.full(shape, INT32_MAX)
    # H near INT32_MAX, E small: c + j*e_ins wraps and the NEG clamp drops it
    return rng.integers(INT32_MAX - 40, INT32_MAX, shape, endpoint=True), rng.integers(0, 30, shape)


@pytest.mark.parametrize("kind", ["seeded", "int32_max", "h_max_e_small"])
def test_plain_equals_the_kernels_scalar_loop(kind):
    """The plain version (cummax) equals a cell-by-cell loop of the CUDA
    kernel's form from every start.  The shorter running-F form agrees
    while nothing wraps, and not from a start where c + j*e_ins wraps:
    that is why the kernel carries the prefix maximum."""
    q, t = _case(16, 24, b=6, seed=7)
    rng = np.random.default_rng(11)
    h, e = _start(kind, q.shape, rng)
    got = S.bsw_stripped(_t(q), _t(t), _t(h), _t(e)).numpy()
    np.testing.assert_array_equal(got, _loop(q, t, h, e, S.PARAMS, "prefix"))
    assert got[0].any()
    running = _loop(q, t, h, e, S.PARAMS, "running")
    assert np.array_equal(got, running) == (kind != "h_max_e_small")


def test_wrapper_refuses_cpu_tensors_and_dispatches_to_plain():
    q, t = _case(16, 24, b=4)
    z = torch.zeros(q.shape, dtype=torch.int32)
    before = S.bsw_stripped_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        S.bsw_stripped_cuda(_t(q), _t(t), z, z)
    assert S.bsw_stripped_cuda.launches == before
    assert torch.equal(S.bsw_stripped(_t(q), _t(t), z, z), S.bsw_stripped_plain(_t(q), _t(t), z, z))
    with pytest.raises(ValueError, match="6 ints"):
        S.bsw_stripped(_t(q), _t(t), z, z, (6, 1, 6, 1, 1))
    assert S.KERNELS == (S.bsw_stripped_cuda,) and S.bsw_stripped_cuda.name == "bsw_stripped"


def test_wrapper_refuses_qe_pad_above_the_kernels_limit():
    """The limit is gone: past the widest register instance (qe_pad 520,
    qe_pad_of(512)) the long-column kernel takes any qe_pad, so the wrapper
    refuses a column only for what it refuses at every qe_pad: a CPU tensor
    raises "CUDA" before any launch; the plain version takes them."""
    assert S.MAX_REGISTER_QE_PAD == S.qe_pad_of(512) == 520
    t = torch.zeros((24, 4), dtype=torch.int32)
    before = S.bsw_stripped_cuda.launches
    for qe in (520, 528, 4104):
        col = torch.zeros((qe, 4), dtype=torch.int32)
        with pytest.raises(ValueError, match="CUDA"):
            S.bsw_stripped_cuda(col, t, col, col)
        assert S.bsw_stripped(col, t, col, col).shape == (2, qe, 4)
    assert S.bsw_stripped_cuda.launches == before
    assert S.layout(528) == (1024, 32, 16) and S.layout(1032) == (1536, 32, 16)


def test_tool_runs_on_the_cpu_when_told(capsys, monkeypatch):
    assert T.main(["--device", "cpu", "--pairs", "128", "--qlen", "16", "--tlen", "32",
                   "--reps", "1", "--chain", "1"]) == 0
    out = json.loads(capsys.readouterr().out)
    keys = {"tool", "pairs", "qlen", "tlen", "prod_ms", "strip_ms", "prod_gcups",
            "strip_gcups", "overhead_vs_recurrence"}
    assert set(out) == keys | {"device"}
    assert (out["tool"], out["pairs"], out["qlen"], out["tlen"], out["device"]) == (
        "bsw_roofline", 128, 16, 32, "cpu")
    assert out["prod_ms"] > 0 and out["strip_ms"] > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main([])


def test_idle_timing_tool_runs_on_the_cpu_when_told(capsys, monkeypatch):
    assert I.main(["--device", "cpu", "--pairs", "128", "--qlen", "16", "--tlen", "32",
                   "--gaps", "2", "--gap-s", "0.01"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert (out["tool"], out["pairs"], out["gaps"], out["device"]) == (
        "bsw_idle_timing", 128, 2, "cpu")
    names = [s["stage"] for s in out["stages"]]
    assert names == ["tool_run_1", "host_work_0", "chained_0", "single_0", "host_work_1",
                     "chained_1", "single_1", "tool_run_2"]
    chained = [s for s in out["stages"] if s["stage"].startswith("chained")]
    assert [s["warm"] for s in chained] == ["one", "fixed"]
    for s in chained:
        assert len(s["prod_ms"]) == I.REPS and len(s["strip_ms"]) == I.REPS
        assert min(s["prod_ms"] + s["strip_ms"]) > 0
    assert all(len(s["strip_ms"]) == I.SINGLES for s in out["stages"]
               if s["stage"].startswith("single"))
    assert all(s["clock"]["samples"] == 0 for s in out["stages"])
    assert out["stages"][0]["tool"]["tool"] == "bsw_roofline"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        I.main([])


def test_sm_clock_summary_and_warm_up_on_the_cpu():
    clock = tools.SmClock(enabled=False)
    with clock:
        assert clock.rows == []
    assert clock.summary() == {"samples": 0, "sm_mhz": "not sampled", "power_w": "not sampled"}
    clock.rows = [(1.0, 1980.0, 300.0), (2.0, 345.0, 70.0), (3.0, 1755.0, 650.0)]
    assert clock.summary() == {"samples": 3, "sm_mhz": [345.0, 1755.0, 1980.0],
                               "power_w": [70.0, 300.0, 650.0]}
    assert clock.summary(1.5, 2.5) == {"samples": 1, "sm_mhz": [345.0] * 3,
                                       "power_w": [70.0] * 3}
    calls = []
    assert tools.warm_up(lambda: calls.append(1) or len(calls), torch.device("cpu")) == 1
    assert calls == [1]


@pytest.mark.parametrize("qe_pad, want", [(1, (8, 8, 1)), (8, (8, 8, 1)), (9, (16, 8, 2)),
                                          (48, (64, 8, 8)), (136, (136, 8, 17)),
                                          (137, (264, 16, 17)), (520, (520, 32, 17))])
def test_layout_is_the_instance_qe_pad_picks(qe_pad, want):
    """(edge, lanes, rows a lane) from the wrapper's table: the first edge at
    or above qe_pad, K = ceil(edge / lanes); every instance keeps K <= 17.
    bsw_extend's, likewise, from its table."""
    assert S.layout(qe_pad) == want
    edge, lanes, k = want
    assert lanes * k >= edge and k <= 17
    assert bsw_cuda.layout(128) == (128, 32, 4) and bsw_cuda.layout(33) == (64, 8, 8)
