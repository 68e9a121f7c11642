"""The port's anchor chaining (genomicsbench_palisade_tpu_torch) against the
JAX package's scan, its interpret-mode Pallas kernel (plain and lane-packed),
the oracle, the reference-binary goldens and the JAX CLI, on the CPU at
small sizes.

Tolerance: none.  Every value is int32, so the port's plain version (what
the CPU runs; the card's kernel is held to it in tests/test_torch_cuda.py
and chip_smoke.py) must equal the others in scores, parents and peaks.
The plain version takes one vectorized step per anchor index over small
windows; every test here pins torch to one thread, which is several times
faster at these widths than its default pool and keeps parallel test
workers from oversubscribing the cores.
"""

import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genomicsbench_palisade_tpu.cli import chain as jcli
from genomicsbench_palisade_tpu.io import chain_dump as JIO
from genomicsbench_palisade_tpu.ops import chain as JC
from genomicsbench_palisade_tpu.ops import chain_pallas as JCP
from genomicsbench_palisade_tpu.ops.oracle import chain as JO
from genomicsbench_palisade_tpu_torch.cli import chain as cli
from genomicsbench_palisade_tpu_torch.convert import chain_arrays, chain_batch_from_numpy
from genomicsbench_palisade_tpu_torch.io import chain_dump as CIO
from genomicsbench_palisade_tpu_torch.ops import chain as C
from genomicsbench_palisade_tpu_torch.ops.oracle import chain as O

REPO = Path(__file__).resolve().parents[1]
OUTS = ("scores", "parents", "peak_scores")


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pack_y(qpos, span):
    return (np.asarray(span, np.uint64) << np.uint64(32)) | np.asarray(qpos, np.uint64)


def _mixed(rng):
    """Mixed sizes with an empty call (tests/test_chain_jax.py:91-113)."""
    out = []
    for n, q in ((0, 20.0), (37, 20.0), (200, 18.7), (64, 31.9), (150, 19.87)):
        xs = np.cumsum(rng.integers(1, 50, n)).astype(np.int64)
        ys = np.maximum(xs + rng.integers(-300, 300, n), 0)
        out.append((xs.astype(np.uint64), ys.astype(np.uint64), q))
    return out


def _dense_break(rng):
    """Dense anchors that take the max_skip break on most anchors
    (tests/test_chain_jax.py:24-41)."""
    n = 600
    pos = np.cumsum(rng.integers(0, 4, n)).astype(np.uint64)
    qpos = (pos.astype(np.int64) + rng.integers(-30, 30, n)).clip(0).astype(np.uint64)
    span = rng.integers(10, 20, n).astype(np.uint64)
    return [(pos, _pack_y(qpos, span), float(span.mean()))]


def _tiny(rng):
    """One and two anchors, and dr == 0 (tests/test_chain_jax.py:44-59)."""
    cases = [([100], [50]), ([100, 150], [50, 100]), ([100, 100], [50, 60])]
    return [(np.array(xs, np.uint64), _pack_y(ys, [15] * len(ys)), 20.0) for xs, ys in cases]


def _escapes(rng):
    """In-call x jumps past u16 and qi jumps past i16 both ways
    (tests/test_chain_packed.py:79-103)."""
    out = []
    for n in (96, 150):
        steps = rng.integers(1, 40, n).astype(np.int64)
        steps[rng.random(n) < 0.05] = 70_000
        xs = np.cumsum(steps) + 1_000
        dy = rng.integers(-200, 200, n).astype(np.int64)
        dy[rng.random(n) < 0.05] = 60_000
        dy[rng.random(n) < 0.05] = -50_000
        ys = np.maximum(xs + dy, 0)
        out.append((np.sort(xs).astype(np.uint64), ys.astype(np.uint64), 19.87))
    return out


def _quarters(rng):
    """avg_qspan 25.0 and 50.0: the gap tables with no fixed-point slope,
    which the JAX package had to send to its scan."""
    out = []
    for q in (25.0, 50.0, 20.1):
        xs = np.cumsum(rng.integers(1, 40, 200)).astype(np.int64) + 500
        ys = np.maximum(xs + rng.integers(-200, 200, 200), 0)
        out.append((xs.astype(np.uint64), ys.astype(np.uint64), q))
    return out


CASES = {"mixed": _mixed, "dense_break": _dense_break, "tiny": _tiny,
         "escapes": _escapes, "quarters": _quarters}


def _raw(name, seed=0):
    return CASES[name](np.random.default_rng(seed))


def _flat_out(out, arrays, i):
    lo, nn = int(arrays["off"][i]), int(arrays["n"][i])
    return [out[r, lo : lo + nn].numpy() for r in range(3)]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_equals_jax_scan(name):
    raw = _raw(name)
    preps = [C.prepare_call(x, y, q) for x, y, q in raw]
    jpreps = [JC.prepare_call(x, y, q) for x, y, q in raw]
    got = [C.chain_call(p, "cpu") for p in preps]
    live = [i for i, p in enumerate(jpreps) if p["n"]]
    w = C.window_size(max(jpreps[i]["w_need"] for i in live))
    n_pad = max(jpreps[i]["n"] for i in live)
    for i, p in enumerate(jpreps):
        want = JC.chain_call(p, w=w, n_pad=n_pad, engine="scan") if p["n"] else JC.chain_call(p)
        for r in range(3):
            np.testing.assert_array_equal(got[i][r], np.asarray(want[r]), err_msg=f"call {i} {OUTS[r]}")
        assert got[i][1].dtype == np.int64

    def stack(k):
        return jnp.asarray(np.stack([np.pad(np.asarray(jpreps[i][k]).view(np.int32),
                                            (0, n_pad - jpreps[i]["n"])) for i in live]))

    sc, par, pk = JC.chain_dp_device_batch(
        stack("x_lo"), stack("qi"), stack("qspan"), stack("st_eff"),
        jnp.asarray(np.stack([jpreps[i]["gap_table"] for i in live])),
        jnp.asarray(np.array([jpreps[i]["n"] for i in live], np.int32)),
        w, n_pad, 5000, 5000, 500)
    for b, i in enumerate(live):
        nn = jpreps[i]["n"]
        for r, arr in enumerate((sc, par, pk)):
            np.testing.assert_array_equal(got[i][r], np.asarray(arr)[b, :nn])


def test_prepare_call_matches_jax():
    for x, y, q in _raw("mixed") + _raw("escapes") + _raw("quarters"):
        got, want = C.prepare_call(x, y, q), JC.prepare_call(x, y, q)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert [C.window_size(v) for v in (0, 1, 16, 17, 267, 512, 513)] == [16, 16, 16, 32, 512, 512, 1024]
    x, y, q = _raw("mixed")[1]
    with pytest.raises(ValueError, match="sorted"):
        C.prepare_call(x[::-1], y, q)
    with pytest.raises(ValueError, match="n_segs"):
        C.prepare_call(x, y, q, n_segs=2)


def test_plain_equals_interpret_pallas_multichunk():
    """The ring-carry Pallas kernel in interpret mode, with chunks of 128
    anchors so that a call crosses the carry hand-off."""
    rng = np.random.default_rng(3)
    preps = []
    for n, q in ((250, 22.5), (180, 19.5)):
        # gaps of 40-79 keep the window (max_dist_x 5000) within w anchors
        x = (np.cumsum(rng.integers(40, 80, n)) + 1000).astype(np.uint64)
        y = (x.astype(np.int64) + rng.integers(-200, 200, n)).astype(np.uint64)
        preps.append(JC.prepare_call(x, y, q))
    n_pad, w, nc = 256, 128, 128
    assert max(p["w_need"] for p in preps) <= w

    def padded(k):
        a = np.stack([np.pad(np.asarray(p[k]).view(np.int32), (0, n_pad - p["n"])) for p in preps])
        return jnp.asarray(np.pad(a, ((0, JCP.LANE_TILE - len(preps)), (0, 0))))

    steps, gap0, ok = JCP.gap_fixed_point(np.stack([p["gap_table"] for p in preps]), 500)
    assert bool(ok.all())

    def lanes(a):
        return jnp.asarray(np.pad(a, (0, JCP.LANE_TILE - len(preps))))

    with pltpu.force_tpu_interpret_mode():
        sc, par, pk = JCP.chain_dp_pallas_batch(
            padded("x_lo"), padded("qi"), padded("qspan"), padded("st_eff"), lanes(steps),
            lanes(gap0), lanes(np.array([p["n"] for p in preps], np.int32)), w, n_pad,
            5000, 5000, 500, nc=nc)
    batch, params = chain_batch_from_numpy(preps, "cpu")
    out = C.chain_dp(batch, params)
    arrays, _ = chain_arrays(preps)
    for b in range(len(preps)):
        for r, arr in enumerate((sc, par, pk)):
            np.testing.assert_array_equal(_flat_out(out, arrays, b)[r],
                                          np.asarray(arr)[b, : preps[b]["n"]])


def test_plain_equals_interpret_pallas_packed(monkeypatch):
    """chain_calls_packed: several calls to a lane, per-anchor slopes; the
    exact-quarter call goes to the JAX scan there and to the same path as
    every other call here."""
    rng = np.random.default_rng(12)
    raw = []
    for n, q in zip((40, 170, 90, 120, 55), (20.1, 18.7, 25.0, 23.3, 31.9)):
        xs = np.cumsum(rng.integers(1, 40, n)).astype(np.int64) + 500
        ys = np.maximum(xs + rng.integers(-200, 200, n), 0)
        raw.append((xs, ys, q))
    jpreps = [JC.prepare_call(x, y, q) for x, y, q in raw]
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        want = JC.chain_calls_packed(jpreps, lane_tile=2, force_kernel=True, nc=256)
    assert JC.LAST_ROUTE == {"pallas": 4, "scan": 1}, JC.LAST_ROUTE
    got = C.chain_calls([C.prepare_call(x, y, q) for x, y, q in raw], "cpu")
    for g, w in zip(got, want):
        for r in range(3):
            np.testing.assert_array_equal(g[r], w[r])


def _golden_inputs(calls):
    return [CIO.ChainCallInput(c["n"], c["avg_qspan"], c["max_dist_x"], c["max_dist_y"], c["bw"],
                               c["n_segs"], np.array([int(v) for v in c["x"]], np.uint64),
                               np.array([int(v) for v in c["y"]], np.uint64)) for c in calls]


def test_goldens_25_of_25(fixtures_dir):
    calls = json.load(open(fixtures_dir / "chain_golden.json"))
    got = cli.run_calls(_golden_inputs(calls), device="cpu")
    bad = [i for i, (c, g) in enumerate(zip(calls, got))
           if not (np.array_equal(g[0], c["scores"]) and np.array_equal(g[1], c["parents"]))]
    assert len(calls) == 25 and not bad, bad


def test_big_goldens_up_to_16384(fixtures_dir):
    """chain_big_golden.npz cases of at most 16,384 anchors (3 of 6) as one
    batch; the 30,000-87,000-anchor cases run on the card in chip_smoke.py."""
    g = np.load(fixtures_dir / "chain_big_golden.npz")
    cases = [ci for ci in range(int(g["n_cases"])) if len(g[f"x{ci}"]) <= 16384]
    assert len(cases) == 3
    preps = [C.prepare_call(g[f"x{ci}"], g[f"y{ci}"], float(g[f"qspan{ci}"])) for ci in cases]
    for ci, (sc, par, _pk) in zip(cases, C.chain_calls(preps, "cpu")):
        np.testing.assert_array_equal(sc, g[f"scores{ci}"], err_msg=f"case {ci} scores")
        np.testing.assert_array_equal(par, g[f"parents{ci}"], err_msg=f"case {ci} parents")


def _oracle_calls(rng):
    """Sorted and unsorted anchors, two segments (seg in y's bits 48-55)."""
    out = []
    for k, n in enumerate((1, 2, 60, 180, 240)):
        x = np.cumsum(rng.integers(0, 60, n)).astype(np.uint64) + np.uint64(100)
        qpos = np.maximum(x.astype(np.int64) + rng.integers(-150, 150, n), 0)
        y = _pack_y(qpos, rng.integers(8, 30, n))
        if k % 2:
            seg = (rng.random(n) < 0.3).astype(np.uint64)
            y = y | (seg << np.uint64(O.MM_SEED_SEG_SHIFT))
        if k == 3:
            x = x[rng.permutation(n)]
        out.append(O.ChainCall(n, float(rng.uniform(10, 40)), 5000, 800, 500, 1 + k % 2, x, y))
    return out


@pytest.mark.parametrize("is_cdna", [False, True], ids=["dna", "cdna"])
def test_oracle_equals_jax_oracle(is_cdna):
    assert (O.MAX_ITER, O.MAX_SKIP, O.GAP_SCALE) == (JO.MAX_ITER, JO.MAX_SKIP, JO.GAP_SCALE)
    assert [O.ilog2_32(v) for v in (0, 1, 2, 3, 1 << 20)] == [JO.ilog2_32(v) for v in (0, 1, 2, 3, 1 << 20)]
    for call in _oracle_calls(np.random.default_rng(4)):
        got = O.chain_dp(call, is_cdna=is_cdna)
        want = JO.chain_dp(JO.ChainCall(**call.__dict__), is_cdna=is_cdna)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_plain_equals_oracle_and_counts_visits():
    """Scores, parents and peaks equal the port's oracle; the plain
    version's visit and break counts (the bound's work) equal a
    loop-by-loop count of the reference's scan."""
    raw = _raw("dense_break", 5) + _raw("mixed", 6) + _raw("escapes", 7)
    preps = [C.prepare_call(x, y, q) for x, y, q in raw if len(x)]
    batch, params = chain_batch_from_numpy(preps, "cpu")
    stats = {}
    out = C.chain_dp_plain(batch, params, stats=stats)
    arrays, _ = chain_arrays(preps)
    visits, eligible, breaks, per_call = 0, 0, 0, []
    for b, (x, y, q) in enumerate(r for r in raw if len(r[0])):
        want = O.chain_dp(O.ChainCall(len(x), q, 5000, 5000, 500, 1, x, y))
        for r, k in enumerate(OUTS):
            np.testing.assert_array_equal(_flat_out(out, arrays, b)[r], want[k], err_msg=k)
        # the reference's loop, counting what it visits
        p, sc, par = preps[b], want["scores"], want["parents"]
        targets = np.zeros(p["n"], np.int64)
        mine = 0
        for i in range(p["n"]):
            max_f, n_skip = int(p["qspan"][i]), 0
            for j in range(i - 1, int(p["st_eff"][i]) - 1, -1):
                mine += 1
                dr = int(p["x_lo"][i]) - int(p["x_lo"][j])
                dq = int(p["qi"][i]) - int(p["qi"][j])
                dd = abs(dr - dq)
                if dr == 0 or dq <= 0 or dq > 5000 or dd > 500:
                    continue
                eligible += 1
                s = min(dq, dr, int(p["qspan"][i])) - int(p["gap_table"][dd]) + int(sc[j])
                if s > max_f:
                    max_f, n_skip = s, max(n_skip - 1, 0)
                elif targets[j] == i:
                    n_skip += 1
                    if n_skip > C.MAX_SKIP:
                        breaks += 1
                        break
                if par[j] >= 0:
                    targets[par[j]] = i
        visits += mine
        per_call.append(mine)
    assert stats == {"predecessors": visits, "eligible": eligible, "breaks": breaks,
                     "predecessors_max_call": max(per_call)}
    assert 0 < eligible < visits
    assert breaks > 0


def _write_dump(path, calls):
    with open(path, "w") as f:
        for c in calls:
            f.write(f"{c.n} {c.avg_qspan:.6f} {c.max_dist_x} {c.max_dist_y} {c.bw} {c.n_segs}\n")
            f.write("".join(f"{a} {b}\n" for a, b in zip(c.x.tolist(), c.y.tolist())))
            f.write("EOR\n")


def _dump_calls(rng):
    """Sorted single-segment calls, an empty one, one above 256 anchors
    (print_return's vectorized branch), an n_segs = 2 and an unsorted one."""
    calls = []
    for n in (30, 0, 300, 120):
        xs = np.cumsum(rng.integers(1, 50, n)).astype(np.int64)
        ys = np.maximum(xs + rng.integers(-300, 300, n), 0)
        calls.append(O.ChainCall(n, float(rng.uniform(10, 40)), 5000, 5000, 500, 1,
                                 xs.astype(np.uint64), ys.astype(np.uint64)))
    return calls + _oracle_calls(rng)[3:]


def test_parse_and_print_return_match_jax(tmp_path):
    path = tmp_path / "calls.txt"
    _write_dump(path, _dump_calls(np.random.default_rng(8)))
    got, want = CIO.parse_chain_dump(path), JIO.parse_chain_dump(str(path))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert (g.n, g.avg_qspan, g.max_dist_x, g.max_dist_y, g.bw, g.n_segs) == (
            w.n, w.avg_qspan, w.max_dist_x, w.max_dist_y, w.bw, w.n_segs)
        assert g.x.dtype == g.y.dtype == np.uint64
        np.testing.assert_array_equal(g.x, w.x)
        np.testing.assert_array_equal(g.y, w.y)
    with open(path) as f:
        assert [c.n for c in CIO.parse_chain_dump(f)] == [c.n for c in got]
    rng = np.random.default_rng(9)
    for n in (0, 5, 256, 257, 1000):
        sc = rng.integers(-50, 5000, n).astype(np.int32)
        par = rng.integers(-1, max(n, 1), n).astype(np.int64)
        a, b = io.StringIO(), io.StringIO()
        CIO.print_return(a, sc, par)
        JIO.print_return(b, sc, par)
        assert a.getvalue() == b.getvalue(), n


def test_cli_output_matches_jax_cli(tmp_path, capsys, monkeypatch):
    path = tmp_path / "calls.txt"
    _write_dump(path, _dump_calls(np.random.default_rng(10)))
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    assert cli.main(["-i", str(path), "-o", str(ours), "--device", "cpu", "-t", "4"]) == 0
    assert capsys.readouterr().err.startswith("Time in kernel: ")
    monkeypatch.setenv("GENOMICS_TPU_CACHE_DIR", str(tmp_path / "xla"))
    assert jcli.main(["-i", str(path), "-o", str(theirs)]) == 0
    assert capsys.readouterr().err.startswith("Time in kernel: ")
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.read_text().count("EOR\n") == 6


def test_run_calls_routes_and_keeps(tmp_path):
    """n_segs != 1 and unsorted calls run the oracle on the host; empty ones
    short-circuit; the rest go to the device in one launch per parameter
    group, whose tensors and outputs `keep` holds."""
    rng = np.random.default_rng(11)
    calls = [CIO.ChainCallInput(c.n, c.avg_qspan, c.max_dist_x, c.max_dist_y, c.bw,
                                c.n_segs, c.x, c.y) for c in _dump_calls(rng)]
    stats, keep = {}, []
    got = cli.run_calls(calls, device="cpu", stats=stats, keep=keep)
    for c, g in zip(calls, got):
        want = O.chain_dp(O.ChainCall(c.n, c.avg_qspan, c.max_dist_x, c.max_dist_y, c.bw,
                                      c.n_segs, c.x, c.y))
        for r, k in enumerate(OUTS):
            np.testing.assert_array_equal(g[r], want[k], err_msg=k)
    assert got[1][0].shape == (0,)
    # the last call is sorted with n_segs = 1 and max_dist_y = 800: a second group
    assert [kb["params"] for kb in keep] == [(5000, 5000, 500), (5000, 800, 500)]
    assert [kb["batch"]["n"].tolist() for kb in keep] == [[30, 300, 120], [240]]
    for kb in keep:
        assert torch.equal(kb["out"], C.chain_dp_plain(kb["batch"], kb["params"]))
    assert set(stats) == {"prep_s", "pack_s", "h2d_s", "kernel_s", "d2h_s"}
    assert cli.run_calls([], device="cpu") == []


def test_convert_carries_jax_prepare_call():
    raw = _raw("mixed", 12)[1:] + _raw("quarters", 13)
    jpreps = [JC.prepare_call(x, y, q) for x, y, q in raw]
    batch, params = chain_batch_from_numpy(jpreps, "cpu")
    own, own_params = chain_batch_from_numpy([C.prepare_call(x, y, q) for x, y, q in raw], "cpu")
    assert params == own_params == (5000, 5000, 500)
    assert {k: v.dtype for k, v in batch.items()} == {
        "x_lo": torch.int32, "qi": torch.int32, "qspan": torch.int32, "st_eff": torch.int32,
        "off": torch.int64, "n": torch.int32, "gap_table": torch.int32}
    assert all(torch.equal(batch[k], own[k]) for k in own)
    assert batch["off"].tolist() == np.cumsum([0] + [p["n"] for p in jpreps[:-1]]).tolist()
    assert batch["gap_table"].shape == (len(jpreps), 501)
    out = C.chain_dp(batch, params)
    for b, p in enumerate(jpreps):
        want = JC.chain_call(p, w=64, n_pad=200, engine="scan")
        lo = int(batch["off"][b])
        for r in range(3):
            np.testing.assert_array_equal(out[r, lo : lo + p["n"]].numpy(), np.asarray(want[r]))
    with pytest.raises(ValueError, match="max_dist_x"):
        chain_batch_from_numpy([jpreps[0], dict(jpreps[1], bw=200)], "cpu")


def test_chip_smoke_dump_matches_tools_generator(tmp_path, monkeypatch):
    """chip_smoke.py writes the chain dataset of tools/chain_scale_bench.py
    byte for byte (same rng draws)."""
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    monkeypatch.syspath_prepend(str(REPO))
    import chain_scale_bench
    import chip_smoke

    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    assert chip_smoke.write_dump(a, np.random.default_rng(5), 2) == chain_scale_bench.write_dump(
        b, np.random.default_rng(5), 2)
    assert a.read_bytes() == b.read_bytes()
    calls = CIO.parse_chain_dump(a)
    assert max(c.n for c in calls) == chip_smoke.CHAIN_MAX_N == chain_scale_bench.MAX_N


def test_chip_smoke_dump_with_spans_scores_and_breaks(tmp_path, monkeypatch):
    """With query spans, chip_smoke.py's chain dataset keeps the generator's
    anchors (x, and y's query positions) and gains spans 10-29 in y's bits
    32-39; its calls then score, chain and reach the max_skip break."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    assert chip_smoke.write_dump(a, np.random.default_rng(5), 2) == chip_smoke.write_dump(
        b, np.random.default_rng(5), 2, spans_rng=np.random.default_rng(0))
    plain, spanned = CIO.parse_chain_dump(a), CIO.parse_chain_dump(b)
    for p, s in zip(plain, spanned):
        np.testing.assert_array_equal(p.x, s.x)
        np.testing.assert_array_equal(p.y, s.y & np.uint64(0xFFFFFFFF))
        spans = s.y >> np.uint64(32)
        assert spans.min() >= chip_smoke.CHAIN_SPANS[0] and spans.max() < chip_smoke.CHAIN_SPANS[1]
    c = max(spanned, key=lambda c: c.n)
    preps = [C.prepare_call(c.x[:1500], c.y[:1500], c.avg_qspan)]
    batch, params = chain_batch_from_numpy(preps, "cpu")
    stats = {}
    out = C.chain_dp_plain(batch, params, stats=stats)
    want = O.chain_dp(O.ChainCall(1500, c.avg_qspan, 5000, 5000, 500, 1, c.x[:1500], c.y[:1500]))
    for r, k in enumerate(OUTS):
        np.testing.assert_array_equal(out[r].numpy(), want[k], err_msg=k)
    assert (out[0] > 0).all() and (out[1] >= 0).any() and stats["breaks"] > 0
