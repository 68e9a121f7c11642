"""The port's chain roofline probe (ops/chain_micro.py,
tools/chain_roofline.py) against the JAX tool's workload and its Pallas
probe `micro_batch` run in interpret mode, on the CPU.

The Pallas probe pads x and q with w zero rows and zeroes the first
chunk's scores, so the first anchors see phantom predecessors at (0, 0)
with score 0; its chunks of nc anchors carry the last w scores across.
The plain version (what the CPU runs; the card's kernel is held to it in
tests/test_torch_cuda.py and chip_smoke.py) keeps the phantoms, does not
chunk, and must equal the probe at every nc.

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

from genomicsbench_palisade_tpu_torch.ops import chain as C
from genomicsbench_palisade_tpu_torch.ops import chain_micro as M
from genomicsbench_palisade_tpu_torch.tools import chain_roofline as T

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import chain_roofline as J  # noqa: E402  the JAX tool (tools/ is not a package)


def _jax_tool_arrays(b, n_pad):
    """tools/chain_roofline.py:main's draws, line for line."""
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.integers(1, 40, (b, n_pad)), axis=1).astype(np.int32)
    qi = np.cumsum(rng.integers(1, 30, (b, n_pad)), axis=1).astype(np.int32)
    qspan = np.full((b, n_pad), 15, np.int32)
    m_fp = np.full(b, 157286, np.int32)
    gap0 = np.zeros(b, np.int32)
    return {"x": x, "qi": qi, "qspan": qspan, "m_fp": m_fp, "gap0": gap0}


@pytest.mark.parametrize("b,n_pad", [(128, 4096), (128, 256)])
def test_make_workload_is_the_tools_arrays(b, n_pad):
    got, want = T.make_workload(b, n_pad), _jax_tool_arrays(b, n_pad)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == np.int32


def _micro(wl, w, bw, nc):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(J.micro_batch(*(jnp.asarray(wl[k]) for k in
                                          ("x", "qi", "qspan", "m_fp", "gap0")),
                                        w, wl["x"].shape[1], nc, bw))


def _plain(wl, w, bw):
    return M.chain_micro(*(torch.from_numpy(wl[k]) for k in ("x", "qi", "qspan", "m_fp", "gap0")),
                         w, bw).numpy()


@pytest.mark.parametrize("nc", [128, 256])
def test_plain_equals_interpret_pallas_at_any_chunk(nc):
    wl = T.make_workload(128, 256)
    got = _plain(wl, 64, 500)
    np.testing.assert_array_equal(got, _micro(wl, 64, 500, nc))
    # the phantom predecessors score: anchor 1 chains to anchor 0 or a phantom
    assert got.min() == 15 and got.max() > 1000 and (got[:, 1:4] > 15).any()


def test_plain_equals_interpret_pallas_where_dd_times_m_wraps():
    """Anchors far apart: dd * m wraps int32 (dd > 13,653 at m 157,286) for
    pairs that are not eligible, and none of it reaches the output."""
    rng = np.random.default_rng(3)
    wl = T.make_workload(128, 256, seed=3)
    jumps = (rng.random((128, 256)) < 0.1) * rng.integers(20_000, 200_000, (128, 256))
    wl["x"] = (wl["x"] + np.cumsum(jumps, axis=1)).astype(np.int32)
    x = wl["x"].astype(np.int64)
    dd_max = max(np.abs(np.diff(x, axis=1)).max(), 0)
    assert dd_max * T.M_FP > 2**31
    got = _plain(wl, 64, 500)
    np.testing.assert_array_equal(got, _micro(wl, 64, 500, 128))
    assert got.max() > 15


def test_plain_gap_terms_against_a_scalar_loop():
    """A few anchors, a small window and bw below the spacing's spread, so
    that the log term, the slope and the eligibility tests all vary; a
    Python loop of the kernel's form (ilog as min(floor(log2 dd), n_log))."""
    rng = np.random.default_rng(9)
    b, n, w, bw = 3, 40, 7, 37
    x = np.cumsum(rng.integers(0, 30, (b, n)), axis=1).astype(np.int32)
    qi = np.cumsum(rng.integers(-3, 30, (b, n)), axis=1).astype(np.int32)
    qspan = rng.integers(10, 30, (b, n)).astype(np.int32)
    m_fp = rng.integers(0, 400_000, b).astype(np.int32)
    gap0 = rng.integers(0, 5, b).astype(np.int32)
    wrap = lambda v: (v + 2**31) % 2**32 - 2**31
    n_log = M.n_log_of(bw)
    want = np.zeros((b, n), np.int64)
    for c in range(b):
        for i in range(n):
            best = M.NEG
            for j in range(i - w, i):
                xj, qj, sj = (int(x[c, j]), int(qi[c, j]), int(want[c, j])) if j >= 0 else (0, 0, 0)
                dr, dq = wrap(int(x[c, i]) - xj), wrap(int(qi[c, i]) - qj)
                dd = abs(dr - dq)
                if dr == 0 or dq <= 0 or dq > 5000 or dd > bw:
                    continue
                ilog = min(dd.bit_length() - 1, n_log) if dd >= 2 else 0
                gap = int(gap0[c]) + ((dd * int(m_fp[c])) % 2**32 >> 20) + (ilog >> 1)
                best = max(best, min(dq, dr, int(qspan[c, i])) - gap + sj)
            want[c, i] = max(best, int(qspan[c, i]))
    got = M.chain_micro(*(torch.from_numpy(a) for a in (x, qi, qspan, m_fp, gap0)), w, bw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert M.n_log_of(500) == 8 and M.n_log_of(1) == 1 and M.n_log_of(2) == 1


def test_prod_batch_starts_each_window_w_back():
    """The prod side's flat batch: the tool's anchors, span 15, each window
    starting w anchors back, the float64 gap table of avg_qspan 15."""
    wl = T.make_workload(3, 200)
    batch, params = T.prod_batch(wl, 64, 500, "cpu")
    assert params == (5000, 5000, 500)
    np.testing.assert_array_equal(batch["x_lo"].numpy(), wl["x"].ravel())
    np.testing.assert_array_equal(batch["qi"].numpy(), wl["qi"].ravel())
    assert (batch["qspan"] == 15).all() and batch["n"].tolist() == [200] * 3
    st = batch["st_eff"].view(3, 200).numpy()
    assert (st == np.maximum(np.arange(200) - 64, 0)).all()
    table = C.prepare_call(np.arange(2, dtype=np.uint64), np.zeros(2, np.uint64), 15.0)["gap_table"]
    assert (batch["gap_table"].numpy() == table).all()
    # at most the w anchors before each; the reference's max_skip break ends
    # some windows early, which the micro side does not have
    stats = {}
    C.chain_dp_plain(batch, params, stats)
    assert 0 < stats["predecessors"] < 3 * sum(min(i, 64) for i in range(200))
    assert stats["breaks"] > 0


def test_wrapper_refuses_cpu_tensors_and_dispatches_to_plain():
    wl = T.make_workload(4, 96)
    args = [torch.from_numpy(wl[k]) for k in ("x", "qi", "qspan", "m_fp", "gap0")]
    before = M.chain_micro_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        M.chain_micro_cuda(*args, 64, 500)
    assert M.chain_micro_cuda.launches == before
    assert torch.equal(M.chain_micro(*args, 16, 500), M.chain_micro_plain(*args, 16, 500))
    with pytest.raises(ValueError, match="w"):
        M.chain_micro(*args, 0, 500)
    assert M.KERNELS == (M.chain_micro_cuda,) and M.chain_micro_cuda.name == "chain_micro"


def test_tool_runs_on_the_cpu_when_told(capsys, monkeypatch):
    assert T.main(["--device", "cpu", "--calls", "8", "--n-pad", "96", "--iters", "1",
                   "--reps", "1"]) == 0
    out = json.loads(capsys.readouterr().out)
    keys = {"shape", "micro_s", "prod_s", "micro_manchors_per_s", "prod_manchors_per_s",
            "prod_over_bound"}
    assert set(out) == keys | {"device"}
    assert out["shape"] == "8x96 w=64" and out["device"] == "cpu"
    assert out["micro_s"] > 0 and out["prod_s"] > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main([])
