"""The device code of the port's warp kernels, csrc/bsw_extend.cu and
csrc/chain_dp.cu, compiled with g++ and run on the CPU under a warp
emulation (tests/cuda_emulation/: a warp's 32 lanes as fibers on one
thread, every shuffle, vote and reduction a point where all 32 post and
then read), against the plain versions.

The card is the only place the kernels run for real (tests/test_torch_cuda.py,
chip_smoke.py); this holds their lane logic (the F chain's map scan, the
row max's ballots, the band shrink, the max_skip walk, the mark bitmap, the
register banks) to the plain versions on every CPU run.  The build uses
-fsanitize=undefined, so a signed overflow aborts the run.

Tolerance: none.  Every value is int32.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu_torch.cli.bsw import EDGES
from genomicsbench_palisade_tpu_torch.convert import bsw_batch_from_numpy, chain_batch_from_numpy
from genomicsbench_palisade_tpu_torch.ops import bsw as W
from genomicsbench_palisade_tpu_torch.ops import chain as C
from genomicsbench_palisade_tpu_torch.ops.oracle import bsw as WO

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the edge-case generators)

CSRC = REPO / "genomicsbench_palisade_tpu_torch" / "csrc"
EMU = Path(__file__).resolve().parent / "cuda_emulation"
MARK = "}  // namespace\n"


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """{"bsw", "chain"}: the emulated kernels' executables."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp("emulated")
    exes = {}
    for name, src, defines in (("bsw", "bsw_extend.cu", ["-DBSW"]), ("chain", "chain_dp.cu", [])):
        text = (CSRC / src).read_text()
        part = out / f"{name}_device.inc"
        part.write_text(text[: text.index(MARK) + len(MARK)])
        exe = out / f"run_{name}"
        cmd = [gxx, "-std=c++20", "-O1", "-fsanitize=undefined", "-fno-sanitize-recover=undefined",
               f"-I{EMU}", f'-DKERNEL_PART="{part}"', *defines, "-o", str(exe),
               str(EMU / "run_kernels.cpp"), "-pthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-3000:]
        exes[name] = exe
    return exes


def _run(exe, tmp_path, arrays, n_out):
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    with open(src, "wb") as f:
        for a in arrays:
            f.write(np.ascontiguousarray(a).tobytes())
    proc = subprocess.run([str(exe), str(src), str(dst)], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return torch.from_numpy(np.fromfile(dst, np.int32).reshape(n_out, -1))


def _bsw(exe, tmp_path, tb, ptuple, q_max):
    head = np.array([tb["h0"].numel(), tb["codes"].numel(), q_max, *ptuple], np.int64)
    keys = ("codes", "q_off", "q_len", "t_off", "t_len", "h0")
    return _run(exe, tmp_path, [head, *(tb[k].numpy() for k in keys)], 6)


@pytest.mark.parametrize("name,params", [
    ("default", WO.DEFAULT_PARAMS),
    ("m2x3o5e2", WO.BswParams(o_del=5, e_del=2, o_ins=5, e_ins=2, match=2, mismatch=3))])
def test_bsw_emulated_equals_plain_on_edge_pairs(emulated, tmp_path, name, params):
    """chip_smoke.bsw_edge_pairs, each query edge's pairs on its edge's
    instance (8 lanes a pair up to edge 64, 32 above), as cli/bsw.py
    launches them."""
    pairs = chip_smoke.bsw_edge_pairs(np.random.default_rng(4), params.o_ins, params.e_ins)
    tb, ptuple = bsw_batch_from_numpy(W.prepare_pairs(pairs), "cpu", params)
    want = W.bsw_extend_plain(tb, ptuple)
    edges = np.searchsorted(np.asarray(EDGES), tb["q_len"].numpy())
    for e in np.unique(edges):
        idx = torch.from_numpy(np.flatnonzero(edges == e))
        sub = {k: v if k == "codes" else v[idx] for k, v in tb.items()}
        got = _bsw(emulated["bsw"], tmp_path, sub, ptuple, EDGES[e])
        assert torch.equal(got, want[:, idx]), EDGES[e]


def test_bsw_emulated_goldens(emulated, tmp_path, fixtures_dir):
    cases = json.load(open(fixtures_dir / "bsw_golden.json"))
    pairs = [(np.array(c["query"]), np.array(c["target"]), c["h0"]) for c in cases]
    tb, ptuple = bsw_batch_from_numpy(W.prepare_pairs(pairs), "cpu")
    got = _bsw(emulated["bsw"], tmp_path, tb, ptuple, int(tb["q_len"].max()))
    bad = [i for i, c in enumerate(cases)
           if {k: int(got[r, i]) for r, k in enumerate(W.OUT_ORDER)} != c["out"]]
    assert len(cases) == 300 and not bad, bad


def test_chain_emulated_equals_plain_on_edge_calls(emulated, tmp_path):
    """chip_smoke.chain_edge_calls but its MAX_ITER call (its windows of
    5,000 would take minutes at a barrier a primitive): windows of 1-250
    predecessors, dense calls that break at every offset of a step."""
    preps = [C.prepare_call(x, y, q) for x, y, q in
             chip_smoke.chain_edge_calls(np.random.default_rng(0))[:-1]]
    tb, params = chain_batch_from_numpy(preps, "cpu")
    order = torch.argsort(tb["n"], descending=True, stable=True).to(torch.int32)
    head = np.array([tb["x_lo"].numel(), tb["n"].numel(), *params], np.int64)
    keys = ("x_lo", "qi", "qspan", "st_eff", "off", "n", "gap_table")
    got = _run(emulated["chain"], tmp_path, [head, *(tb[k].numpy() for k in keys), order.numpy()], 3)
    stats = {}
    assert torch.equal(got, C.chain_dp_plain(tb, params, stats=stats))
    assert stats["breaks"] > 0
