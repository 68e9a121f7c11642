"""The device code of the port's warp kernels, csrc/bsw_extend.cu,
csrc/chain_dp.cu, csrc/phmm_forward.cu, csrc/abea_fill.cu,
csrc/abea_walk.cu, csrc/bsw_stripped.cu, csrc/chain_micro.cu and
csrc/occ_gather.cu, compiled with g++ and run on the CPU under a warp
emulation (tests/cuda_emulation/: a warp's 32 lanes as fibers on one
thread, every shuffle, vote and reduction a point where all 32 post and
then read; cp.async copies made at their wait, the latest the card may
make them),
against the plain versions.

The card is the only place the kernels run for real (tests/test_torch_cuda.py,
chip_smoke.py); this holds their lane logic (the F chain's map scan, the
row max's ballots, the band shrink, the max_skip walk, the mark bitmap, the
register banks, PairHMM's wavefront, virtual rows and tile carry, the abea
fill's band on shuffles and early emissions, the abea walk's shared-memory
windows, the stripped recurrence's max-scan and roll, the micro chain's
register and shared rings, bsw's long-query chunks and e_ins < 0
variant, the stripped long-column chunks, the gathers' quads of lanes and
tile steps) to the plain versions on every CPU run.  The build uses
-fsanitize=undefined, so a signed overflow aborts the run.

Tolerance: none.  bsw and chain compute in int32.  PairHMM and abea round
every multiply and add on its own in float or double, on the card
(-fmad=false) and here (-ffp-contract=off, SSE arithmetic), in the order of
the plain version and the oracle, so raw sums, traces, band positions, last
values, seeds, pairs and emission sums must be bit-equal.
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
from genomicsbench_palisade_tpu_torch.convert import (INT8_KEYS, INT32_KEYS, TABLE_KEYS,
                                                      abea_batch_from_numpy, bsw_batch_from_numpy,
                                                      chain_batch_from_numpy)
from genomicsbench_palisade_tpu_torch.io import signal as SIG
from genomicsbench_palisade_tpu_torch.ops import abea as A
from genomicsbench_palisade_tpu_torch.ops import abea_cuda
from genomicsbench_palisade_tpu_torch.ops import bsw as W
from genomicsbench_palisade_tpu_torch.ops import bsw_cuda
from genomicsbench_palisade_tpu_torch.ops import bsw_stripped as BS
from genomicsbench_palisade_tpu_torch.ops import events as EV
from genomicsbench_palisade_tpu_torch.ops import chain as C
from genomicsbench_palisade_tpu_torch.ops import chain_micro as CM
from genomicsbench_palisade_tpu_torch.ops import occ_gather as G
from genomicsbench_palisade_tpu_torch.ops import phmm as P
from genomicsbench_palisade_tpu_torch.ops.oracle import bsw as WO
from genomicsbench_palisade_tpu_torch.ops.oracle import phmm as PO

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
    """{"bsw", "chain", "phmm", "abea_fill", "abea_walk", "bsw_stripped",
    "chain_micro", "occ_gather"}: the emulated kernels' executables."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp("emulated")
    exes, procs = {}, []

    def lanes(kernel):  # the lanes or banks the wrapper builds the source with
        return [f"-D{k}={v}" for k, v in kernel.defines]

    for name, src, defines in (("bsw", "bsw_extend.cu", ["-DBSW", *lanes(bsw_cuda.bsw_extend)]),
                               ("chain", "chain_dp.cu", []),
                               ("phmm", "phmm_forward.cu", ["-DPHMM", "-ffp-contract=off"]),
                               ("abea_fill", "abea_fill.cu", ["-DABEA_FILL", "-ffp-contract=off"]),
                               ("abea_walk", "abea_walk.cu", ["-DABEA_WALK", "-ffp-contract=off"]),
                               ("bsw_stripped", "bsw_stripped.cu",
                                ["-DBSW_STRIPPED", *lanes(BS.bsw_stripped_cuda)]),
                               ("chain_micro", "chain_micro.cu",
                                ["-DCHAIN_MICRO", *lanes(CM.chain_micro_cuda)]),
                               ("occ_gather", "occ_gather.cu", ["-DOCC_GATHER"])):
        text = (CSRC / src).read_text()
        part = out / f"{name}_device.inc"
        part.write_text(text[: text.index(MARK) + len(MARK)])
        exe = out / f"run_{name}"
        cmd = [gxx, "-std=c++20", "-O1", "-fsanitize=undefined", "-fno-sanitize-recover=undefined",
               f"-I{EMU}", f'-DKERNEL_PART="{part}"', *defines, "-o", str(exe),
               str(EMU / "run_kernels.cpp"), "-pthread"]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
        exes[name] = exe
    for proc in procs:  # the builds run side by side
        _, err = proc.communicate()
        assert proc.returncode == 0, err[-3000:]
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


def _bsw(exe, tmp_path, tb, ptuple, q_max, scratch_warps=0):
    head = np.array([tb["h0"].numel(), tb["codes"].numel(), q_max, scratch_warps, *ptuple],
                    np.int64)
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


@pytest.mark.parametrize("name,params,scratch_warps", [
    ("default", WO.DEFAULT_PARAMS, 0),
    ("w600", WO.BswParams(w=600), 0),
    ("default_scratch", WO.DEFAULT_PARAMS, 3),
    ("e_ins_-1_scratch", WO.BswParams(e_ins=-1), 3)])
def test_bsw_emulated_long_queries(emulated, tmp_path, name, params, scratch_warps):
    """The long-query kernel on 12 pairs of 513-1,024 bases (targets of 1-2
    query lengths): its rows in shared memory, or in a scratch of 3 warps'
    regions that the grid strides over (scratch_warps 3); w 600 gives bands
    of 1,201 entries across chunk edges."""
    pairs = chip_smoke.bsw_long_pairs(np.random.default_rng(12), 12, 513, 1024)
    tb, ptuple = bsw_batch_from_numpy(W.prepare_pairs(pairs, params), "cpu", params)
    want = W.bsw_extend_plain(tb, ptuple)
    got = _bsw(emulated["bsw"], tmp_path, tb, ptuple, int(tb["q_len"].max()), scratch_warps)
    assert torch.equal(got, want)
    assert (want[1] > 512).any()  # best cells past the first chunk


def test_bsw_emulated_long_query_tie_across_a_chunk_edge(emulated, tmp_path):
    """o_ins + e_ins = 0 makes F carry a row's M forward, so H(i, i) and
    H(i, i + 1) tie: a target of 512 bases, the head of its 600-base query,
    scores best on row 511, where the tie spans the long-query kernel's
    first chunk edge and the later entry (qle 513) must win."""
    params = WO.BswParams(o_ins=-1, e_ins=1)
    q = np.random.default_rng(7).integers(0, 4, 600).astype(np.int8)
    tb, ptuple = bsw_batch_from_numpy(W.prepare_pairs([(q, q[:512], 30)], params), "cpu", params)
    want = W.bsw_extend_plain(tb, ptuple)
    assert want[:3, 0].tolist() == [30 + 512, 513, 512]
    assert torch.equal(_bsw(emulated["bsw"], tmp_path, tb, ptuple, 600), want)


@pytest.mark.parametrize("e_ins", [-1, -3])
def test_bsw_emulated_negative_extension_on_edge_pairs(emulated, tmp_path, e_ins):
    """chip_smoke.bsw_edge_pairs at e_ins -1 and -3: each query edge's pairs
    on its edge's instance (the e_ins < 0 variant), and all of them on the
    long-query kernel (q_max 600)."""
    params = WO.BswParams(e_ins=e_ins)
    pairs = chip_smoke.bsw_edge_pairs(np.random.default_rng(5), params.o_ins, e_ins)
    tb, ptuple = bsw_batch_from_numpy(W.prepare_pairs(pairs, params), "cpu", params)
    want = W.bsw_extend_plain(tb, ptuple)
    edges = np.searchsorted(np.asarray(EDGES), tb["q_len"].numpy())
    for e in np.unique(edges):
        idx = torch.from_numpy(np.flatnonzero(edges == e))
        sub = {k: v if k == "codes" else v[idx] for k, v in tb.items()}
        got = _bsw(emulated["bsw"], tmp_path, sub, ptuple, EDGES[e])
        assert torch.equal(got, want[:, idx]), EDGES[e]
    assert torch.equal(_bsw(emulated["bsw"], tmp_path, tb, ptuple, 600), want)


OCC_ROWS = 4096


def _occ(exe, tmp_path, tile, depth, grid, table, idx):
    head = np.array([tile, depth, grid, len(idx), OCC_ROWS], np.int64)
    return _run(exe, tmp_path, [head, table, idx], 1).view(torch.int64)[0]


def _occ_layouts():
    """(kernel, depth) of every depth the wrapper's table or the sweep
    (tools/gather_lanes.py) can build."""
    from genomicsbench_palisade_tpu_torch.tools import gather_lanes as GL
    depths = set(GL.DEPTHS) | set(G.LAYOUTS.values())
    return [(kernel, d) for kernel in ("row", "tile") for d in sorted(depths)]


@pytest.mark.parametrize("kernel,depth", _occ_layouts())
def test_occ_gather_emulated_equals_plain(emulated, tmp_path, kernel, depth):
    """csrc/occ_gather.cu at a depth on a table of 4,096 random rows, with n
    = 1, 1,000 and 2,053 indices (a multiple of no step or block) that start
    with rows 4,095 and 0, on grids of 1 and 3 blocks of 8 warps."""
    rng = np.random.default_rng(depth + 10 * (kernel == "tile"))
    table = rng.integers(-(2**63), 2**63 - 1, (OCC_ROWS, 8), dtype=np.int64, endpoint=True)
    plain = G.occ_gather_tile_plain if kernel == "tile" else G.occ_gather_row_plain
    for n in (1, 1000, 2053):
        idx = rng.integers(1, OCC_ROWS - 1, n).astype(np.int32)
        idx[:2] = (OCC_ROWS - 1, 0)[:n]  # both ends of the table; the last index stays random
        want = plain(torch.from_numpy(table), torch.from_numpy(idx))
        for grid in (1, 3):
            got = _occ(emulated["occ_gather"], tmp_path, kernel == "tile", depth, grid, table, idx)
            assert torch.equal(got, want), (n, grid)


@pytest.mark.parametrize("tile", [0, 1])
def test_occ_gather_emulated_traps_an_index_outside_the_table(emulated, tmp_path, tile):
    table = np.zeros((OCC_ROWS, 8), np.int64)
    idx = np.array([5, OCC_ROWS, 7], np.int32)
    head = np.array([tile, 2, 1, len(idx), OCC_ROWS], np.int64)
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    src.write_bytes(b"".join(a.tobytes() for a in (head, table, idx)))
    proc = subprocess.run([str(emulated["occ_gather"]), str(src), str(dst)], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode != 0 and "__trap" in proc.stderr


def test_chain_emulated_equals_plain_on_edge_calls(emulated, tmp_path):
    """chip_smoke.chain_edge_calls but its MAX_ITER call (its windows of
    5,000 would take minutes at a barrier a primitive): windows of 1-250
    predecessors, dense calls that break at every offset of a step."""
    preps = [C.prepare_call(x, y, q) for x, y, q in
             chip_smoke.chain_edge_calls(np.random.default_rng(0))[:-1]]
    tb, params = chain_batch_from_numpy(preps, "cpu")
    order = torch.argsort(tb["n"], descending=True, stable=True).to(torch.int32)
    head = np.array([tb["x_lo"].numel(), tb["n"].numel(), *params, 0], np.int64)
    keys = ("x_lo", "qi", "qspan", "st_eff", "off", "n", "gap_table")
    got = _run(emulated["chain"], tmp_path, [head, *(tb[k].numpy() for k in keys), order.numpy()], 3)
    stats = {}
    assert torch.equal(got, C.chain_dp_plain(tb, params, stats=stats))
    assert stats["breaks"] > 0


@pytest.mark.parametrize("first", [1, 40, 200])
def test_chain_emulated_preset_head_equals_plain(emulated, tmp_path, first):
    """The `first` entry (a call past a preset head, the sharded runtime's
    halo): each edge call's rows [0, first) preset, the rest computed after
    them, against the plain version with the same preset.  The preset is
    the call's own run with scores raised by 0-40 and the peaks with them,
    as a halo computed with more predecessors would differ, so the rows
    after it differ from the call's own run.  first 1 and 40 preload the
    register banks partly, 200 all three (96 predecessors)."""
    preps = [C.prepare_call(x, y, q) for x, y, q in
             chip_smoke.chain_edge_calls(np.random.default_rng(0))[:-1]]
    tb, params = chain_batch_from_numpy(preps, "cpu")
    whole = C.chain_dp_plain(tb, params)
    tb["first"] = torch.clamp(tb["n"], max=first).to(torch.int32)
    order = torch.argsort(tb["n"], descending=True, stable=True).to(torch.int32)
    lift = torch.from_numpy(np.random.default_rng(first).integers(0, 41, whole.shape[1]))
    preset = torch.full_like(whole, -777)
    for o, n in zip(tb["off"].tolist(), tb["first"].tolist()):
        sl = slice(o, o + n)
        preset[0, sl] = whole[0, sl] + lift[sl].int()
        preset[1, sl] = whole[1, sl]
        preset[2, sl] = torch.maximum(whole[2, sl], preset[0, sl])
    head = np.array([tb["x_lo"].numel(), tb["n"].numel(), *params, 1], np.int64)
    keys = ("x_lo", "qi", "qspan", "st_eff", "off", "n", "gap_table")
    got = _run(emulated["chain"], tmp_path, [head, *(tb[k].numpy() for k in keys), order.numpy(),
                                             tb["first"].numpy(), preset.numpy()], 3)
    want = C.chain_dp_plain(tb, params, out=preset.clone())
    assert torch.equal(got, want)
    head_rows = torch.cat([torch.arange(o, o + n) for o, n in
                           zip(tb["off"].tolist(), tb["first"].tolist())])
    assert torch.equal(want[:, head_rows], preset[:, head_rows])
    assert not torch.equal(want, whole)


PHMM_DTYPES = {"f32": (torch.float32, np.float32), "f64": (torch.float64, np.float64)}


def _phmm(exe, tmp_path, tb, dtype, global_carry=False):
    """Raw M+X sums [B] of the emulated kernel, on the instance the wrapper
    picks for the batch's r_pad; `global_carry` hands it a global carry
    buffer instead of its shared one."""
    np_dtype = PHMM_DTYPES["f64" if dtype == torch.float64 else "f32"][1]
    b, rp = tb["rs_row"].shape
    hp = tb["hap"].shape[1]
    tabs = P.tables(np_dtype)
    head = np.array([int(dtype == torch.float64), b, rp, hp, int(global_carry),
                     tabs["ph2pr"].size, tabs["m2m"].size], np.int64)
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    with open(src, "wb") as f:
        f.write(head.tobytes())
        for k in INT8_KEYS + INT32_KEYS:
            f.write(np.ascontiguousarray(tb[k].numpy()).tobytes())
        f.write(P.init_y_table(np_dtype, hp).tobytes())
        for k in TABLE_KEYS:
            f.write(np.ascontiguousarray(tabs[k], dtype=np_dtype).tobytes())
    proc = subprocess.run([str(exe), str(src), str(dst)], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return torch.from_numpy(np.fromfile(dst, np_dtype))


def _bit_equal(got, want):
    return bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_phmm_emulated_equals_plain_on_edge_cases(emulated, tmp_path, dtype):
    """chip_smoke.phmm_edge_cases, each batch at its r_pad (the CLI's four
    row buckets and 640), and the batches of 512 rows and more (those that
    take more than one tile on some instance) again with the carry in
    global memory."""
    dt = PHMM_DTYPES[dtype][0]
    for reads, haps, pairs, rp, hp in chip_smoke.phmm_edge_cases(np.random.default_rng(0)):
        tb = P.as_device_batch(P.prepare_batch(reads, haps, pairs, r_pad=rp, h_pad=hp), "cpu")
        want = P.phmm_forward_plain(tb, dt)
        assert _bit_equal(_phmm(emulated["phmm"], tmp_path, tb, dt), want), (rp, hp)
        if rp >= 512:
            assert _bit_equal(_phmm(emulated["phmm"], tmp_path, tb, dt, True), want), (rp, hp)


@pytest.mark.parametrize("rp", [64, 128, 256, 512, 700])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_phmm_emulated_equals_plain_seeded(emulated, tmp_path, rp, dtype):
    """A seeded batch on each row edge's instance (rp 700: more than one
    tile on every instance): reads of 1 to rp-1 bases, half noisy
    substrings of their hap, haps of up to 320 bases with N, quals 0-126."""
    rng = np.random.default_rng(rp)
    reads, haps, pairs = [], [], []
    for k in range(21):
        rl = int(rng.integers(1, rp))
        hl = int(rng.integers(1, 321))
        hap = rng.integers(0, 5, hl)
        if k % 2 and rl <= hl:
            s = int(rng.integers(0, hl - rl + 1))
            bases = hap[s : s + rl].copy()
        else:
            bases = rng.integers(0, 5, rl)
        reads.append({"bases": bases, **{q: rng.integers(0, 127, rl) for q in "qidc"}})
        haps.append(hap)
        pairs.append((k, k))
    tb = P.as_device_batch(P.prepare_batch(reads, haps, pairs, r_pad=rp, h_pad=320), "cpu")
    dt = PHMM_DTYPES[dtype][0]
    assert _bit_equal(_phmm(emulated["phmm"], tmp_path, tb, dt), P.phmm_forward_plain(tb, dt))


def test_phmm_emulated_goldens_equal_oracle(emulated, tmp_path, fixtures_dir):
    """The 40 GKL goldens: both instances' raw sums exactly the port's
    oracle's (compute_full_prob in float and in double)."""
    cases = json.load(open(fixtures_dir / "phmm_golden.json"))
    reads, haps, pairs = [], [], []
    for k, case in enumerate(cases):
        reads.append({"bases": PO.encode_bases(case["rs"]),
                      **{key: np.array([ord(c) for c in case[key]]) for key in "qidc"}})
        haps.append(PO.encode_bases(case["hap"]))
        pairs.append((k, k))
    assert len(cases) == 40
    tb = P.as_device_batch(P.prepare_batch(reads, haps, pairs), "cpu")
    for dt, np_dtype in PHMM_DTYPES.values():
        want = np.array([PO.compute_full_prob(r["bases"], h, r["q"], r["i"], r["d"], r["c"],
                                              np_dtype) for r, h in zip(reads, haps)])
        got = _phmm(emulated["phmm"], tmp_path, tb, dt).numpy()
        np.testing.assert_array_equal(got, want.astype(np_dtype))


ABEA_KEYS = ("ev", "gm", "stdv", "lstdv", "ev_off", "k_off", "band_off", "ne", "nk", "lp")


def _abea_run(exe, tmp_path, tb, fill=None):
    """The emulated fill (fill None) or walk of a flat CPU batch, a warp a
    read in the wrappers' order: the kernel's outputs as tensors."""
    b, rows = tb["ne"].numel(), A.n_rows(tb)
    arrays = [np.array([b, tb["ev"].numel(), tb["gm"].numel(), rows], np.int64)]
    if fill is not None:
        arrays += [fill[k].numpy() for k in ("trace", "bll_e", "seed")]
    arrays += [tb[k].numpy() for k in ABEA_KEYS] + [abea_cuda._order(tb).numpy()]
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    with open(src, "wb") as f:
        for a in arrays:
            f.write(np.ascontiguousarray(a).tobytes())
    proc = subprocess.run([str(exe), str(src), str(dst)], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    raw = dst.read_bytes()
    if fill is None:
        layout = (("trace", np.uint8, (rows, 100)), ("bll_e", np.int32, (rows,)),
                  ("last_val", np.float32, (rows,)), ("seed", np.int32, (b,)))
    else:
        layout = (("pairs", np.int32, (rows, 2)), ("n", np.int32, (b,)),
                  ("max_gap", np.int32, (b,)), ("sum_em", np.float64, (b,)))
    out, at = {}, 0
    for key, dtype, shape in layout:
        size = int(np.prod(shape)) * np.dtype(dtype).itemsize
        out[key] = torch.from_numpy(np.frombuffer(raw[at : at + size], dtype).reshape(shape).copy())
        at += size
    assert at == len(raw)
    return out


def _abea_check(emulated, tmp_path, batch_np):
    """Both emulated kernels against the plain versions on one batch, bit
    for bit; the walk from the plain fill.  Returns the plain walk."""
    tb = abea_batch_from_numpy(batch_np, "cpu")
    want_fill = A.abea_fill_plain(tb)
    got_fill = _abea_run(emulated["abea_fill"], tmp_path, tb)
    for k, v in want_fill.items():
        assert torch.equal(got_fill[k], v), k
    want_walk = A.abea_walk_plain(tb, want_fill)
    got_walk = _abea_run(emulated["abea_walk"], tmp_path, tb, want_fill)
    for k, v in want_walk.items():
        assert torch.equal(got_walk[k], v), k
    return want_walk


def test_abea_emulated_equal_plain_on_edge_reads(emulated, tmp_path):
    """chip_smoke.abea_edge_reads: ne or nk of 1, reads shorter than the
    band, stay- and skip-heavy reads, ties, sums that round, a read of 13
    windows, a batch of one read; and the first batch blocked
    (chip_smoke.abea_blocked: every cell -inf, seed 0, clamped offsets)."""
    model, batches = chip_smoke.abea_edge_reads(np.random.default_rng(0))
    for seqs, evs, scales, shifts in batches:
        batch_np, idx = A.prepare_batch(seqs, evs, model, scales, shifts)
        assert len(idx) == len(seqs)
        _abea_check(emulated, tmp_path, batch_np)
    _abea_check(emulated, tmp_path, chip_smoke.abea_blocked(
        A.prepare_batch(*batches[0][:2], model, *batches[0][2:])[0]))


def test_abea_emulated_equal_plain_on_golden_reads(emulated, tmp_path):
    """Reads of 1-2 kb by the golden recipe (chip_smoke.golden_reads, the
    abea-512 cell's recipe): events and scalings by the port's host prep,
    with the golden pore model."""
    tsv = tmp_path / "pore.tsv"
    chip_smoke.write_pore_model(tsv)
    model = SIG.load_pore_model(str(tsv))
    reads = list(chip_smoke.golden_reads([1000, 1400, 2000], np.random.default_rng(3)))
    events = EV.detect_events_batch([sig for _, sig in reads])
    seqs = [seq for seq, _ in reads]
    shifts, scales = EV.estimate_scalings_mom_batch(seqs, model, events)
    batch_np, _ = A.prepare_batch(seqs, [e["mean"] for e in events], model,
                                  [float(v) for v in scales], [float(v) for v in shifts])
    walk = _abea_check(emulated, tmp_path, batch_np)
    assert all(A.decode(batch_np["band_off"], {k: v.numpy() for k, v in walk.items()}))



@pytest.mark.parametrize("qe_pad", [8, 16, 32, 64, 136, 264, 520, 528, 1032])
def test_bsw_stripped_emulated_equals_plain(emulated, tmp_path, qe_pad):
    """Each instance of csrc/bsw_stripped.cu at its qe_pad edge (every slot
    of its lanes a query row, or the slots past qe_pad padding), and the
    long-column kernel past 520 (two chunks and a row past them, three
    chunks with the last part padding), 21 target
    rows (not a multiple of the group), on chip_smoke.strip_edge_batch: its
    four starts side by side (zero, seeded, INT32_MAX, H near INT32_MAX
    with E small), three pairs each, so that a warp of pairs is left part
    empty."""
    n = 3
    arrays = chip_smoke.strip_edge_batch(np.random.default_rng(qe_pad), qe_pad, 21, n)
    q, t, h, e = arrays
    head = np.array([qe_pad, t.shape[0], q.shape[1], *BS.PARAMS], np.int64)
    got = _run(emulated["bsw_stripped"], tmp_path, [head, q, h, e, t], 2).reshape(2, qe_pad, -1)
    assert torch.equal(got, BS.bsw_stripped_plain(*(torch.from_numpy(a) for a in arrays)))
    assert not got[:, :, :n].any() and got[:, :, n:].any()


@pytest.mark.parametrize("w", [1, 31, 32, 33, 64, 100, 129, 256, 257, 700])
def test_chain_micro_emulated_equals_plain(emulated, tmp_path, w):
    """csrc/chain_micro.cu at windows inside one register bank, at its edge,
    across banks, at the edge of the default eight (256) and past them into
    the shared ring (257: one slot there; 700), on more anchors than the
    window (phantom predecessors first): chip_smoke.micro_edge_calls, two
    calls of the probe's kind and two whose slope products wrap."""
    b, n = 4, max(w + 150, 200)
    calls = chip_smoke.micro_edge_calls(np.random.default_rng(w), b, n)
    head = np.array([b, n, w, CM.MAX_DIST, 500], np.int64)
    got = _run(emulated["chain_micro"], tmp_path, [head, *calls], b)
    assert torch.equal(got, CM.chain_micro_plain(*(torch.from_numpy(a) for a in calls), w, 500))
    assert int(got.max()) > 30
