"""The port's occ-gather probes (ops/occ_gather.py, tools/occ_gather_experiment.py)
against numpy, the JAX tool's XLA gather and its Pallas probes run in
interpret mode, on the CPU.

Tolerance: none.  The folds are XORs of integer words, so the plain
versions (what the CPU runs; the card's kernels are held to them in
tests/test_torch_cuda.py and chip_smoke.py) must equal the others bit for
bit.  The JAX tool's u32 [rows, 16] table and the port's int64 [rows, 8]
table are the same bytes.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genomicsbench_palisade_tpu_torch.ops import occ_gather as G
from genomicsbench_palisade_tpu_torch.tools import occ_gather_experiment as T

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import occ_gather_experiment as J  # noqa: E402  the JAX tool (tools/ is not a package)

ROWS, N = 4096, 1024  # interpret-mode Pallas takes ~4 s a variant at this size


@pytest.fixture(scope="module")
def workload():
    table, idx = T.make_workload(ROWS, N, 3)
    return table, idx, table.view(np.uint32).reshape(ROWS, 16)


def test_make_workload_is_the_tools_table(workload):
    table, idx, u32 = workload
    rng = np.random.default_rng(3)
    want = rng.integers(0, 2**32, (ROWS, 16), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(u32, want)
    np.testing.assert_array_equal(idx, rng.integers(0, ROWS, N).astype(np.int32))
    assert table.dtype == np.int64 and table.shape == (ROWS, 8)


@pytest.mark.parametrize("row_bytes", [32, 64, 128])
def test_plain_row_fold_equals_numpy_and_xla_gather(workload, row_bytes):
    _table, idx, u32 = workload
    words = {32: u32[:, :8], 64: u32, 128: np.concatenate([u32, u32], axis=1)}[row_bytes]
    table = torch.from_numpy(np.ascontiguousarray(words).view(np.int64))
    got = G.occ_gather_row_plain(table, torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.bitwise_xor.reduce(table.numpy()[idx], axis=0))
    xla = np.asarray(J.xla_gather_xor(jnp.asarray(words), jnp.asarray(idx)))
    np.testing.assert_array_equal(got.view(np.uint32), xla)


@pytest.mark.parametrize("nslots", [2, 8])
def test_row_equals_interpret_pallas_dma_gather(workload, nslots):
    table, idx, u32 = workload
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(J.dma_gather_xor(jnp.asarray(u32.reshape(ROWS // 8, 128)),
                                           jnp.asarray(idx), nslots))
    got = G.occ_gather_row(torch.from_numpy(table), torch.from_numpy(idx), nslots).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want[0, :16])
    assert (want[0, 16:] == 0).all()


def test_tile_equals_interpret_pallas_bw_gather(workload):
    table, idx, u32 = workload
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(J.dma_bw_xor(jnp.asarray(u32.reshape(ROWS // 8, 128)),
                                       jnp.asarray(idx), 32, 8))
    got = G.occ_gather_tile(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want[0])


@pytest.mark.parametrize("n", [0, 1, 7, 1000, 4097])
def test_every_index_is_folded(n):
    """Counts that are not a multiple of the Pallas probe's 512-index grid
    step (which dropped the rest) against numpy."""
    rng = np.random.default_rng(n)
    table = rng.integers(-2**63, 2**63 - 1, (8 * 37, 8), dtype=np.int64)
    idx = rng.integers(0, len(table), n).astype(np.int32)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    np.testing.assert_array_equal(G.occ_gather_row(t, i).numpy(),
                                  np.bitwise_xor.reduce(table[idx], axis=0) if n else np.zeros(8))
    tiles = table.reshape(-1, 64)
    np.testing.assert_array_equal(G.occ_gather_tile(t, i).numpy(),
                                  np.bitwise_xor.reduce(tiles[idx >> 3], axis=0) if n
                                  else np.zeros(64))


def test_wrappers_refuse_cpu_tensors_and_dispatch_to_plain(workload):
    table, idx, _ = workload
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    before = [k.launches for k in G.KERNELS]
    for kern, args in ((G.occ_gather_row_cuda, (t, i, 8)), (G.occ_gather_tile_cuda, (t, i))):
        with pytest.raises(ValueError, match="CUDA"):
            kern(*args)
    assert torch.equal(G.occ_gather_row(t, i, 2), G.occ_gather_row_plain(t, i))
    assert torch.equal(G.occ_gather_tile(t, i), G.occ_gather_tile_plain(t, i))
    assert [k.launches for k in G.KERNELS] == before
    with pytest.raises(ValueError, match="rows_in_flight"):
        G.occ_gather_row(t, i, 4)
    padded = G.pad_to_tiles(t[:-5])
    assert padded.shape == t.shape and not padded[-5:].any()
    assert G.pad_to_tiles(t) is t


def test_tool_runs_on_the_cpu_when_told(workload, capsys, monkeypatch):
    table, idx, _ = workload
    out = T.run(table, idx, "cpu", iters=1)
    names = ("xla_gather", "xla_gather32", "xla_gather128", "cuda_row2", "cuda_row8", "cuda_tile8")
    assert all(out[f"{n}_correct"] for n in names)
    assert set(out) == {"tool", "rows", "row_bytes", "device"} | {
        f"{n}_{k}" for n in names for k in ("ms", "mb_s", "mrows_s", "correct")}
    assert out["rows"] == N and out["device"] == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main([])
