"""The port's banded Smith-Waterman (genomicsbench_palisade_tpu_torch) against
the JAX package, its interpret-mode Pallas kernel, the oracle and the
reference-binary goldens, on the CPU at small sizes.

Tolerance: none.  Every value is int32, so the port's plain version (what
the CPU runs; the card's kernel is held to it in tests/test_torch_cuda.py
and chip_smoke.py) must equal the JAX scan, the Pallas kernel under
`pltpu.force_tpu_interpret_mode()` and the oracle in every output.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genomicsbench_palisade_tpu.cli import bsw as jcli
from genomicsbench_palisade_tpu.io import pairs as JIO
from genomicsbench_palisade_tpu.ops import bsw as JW
from genomicsbench_palisade_tpu.ops import bsw_pallas as JWP
from genomicsbench_palisade_tpu.ops.oracle import bsw as JO
from genomicsbench_palisade_tpu_torch.cli import bsw as cli
from genomicsbench_palisade_tpu_torch.convert import bsw_batch_from_numpy
from genomicsbench_palisade_tpu_torch.io import pairs as PIO
from genomicsbench_palisade_tpu_torch.ops import bsw as W
from genomicsbench_palisade_tpu_torch.ops.oracle import bsw as O

REPO = Path(__file__).resolve().parents[1]
KEYS = W.OUT_ORDER
# the reference CLI's -m 2 -x 3 -o 5 -e 2
PARAMS = {"default": O.DEFAULT_PARAMS,
          "m2x3o5e2": O.BswParams(o_del=5, e_del=2, o_ins=5, e_ins=2, match=2, mismatch=3)}


def _jax_params(p):
    return JO.BswParams(**p.__dict__)


def _mixed_pairs(seed, n, ql_max=60, tl_max=90):
    """Related pairs (a mutated head of the target), random pairs with
    ambiguous bases (code 4), long-indel pairs; h0 from -10 to 79, so
    negative, zero and small (<= oe_ins) seeds all occur."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(n):
        ql = int(rng.integers(1, ql_max + 1))
        tl = int(rng.integers(1, tl_max + 1))
        mode = k % 3
        if mode == 0:
            base = rng.integers(0, 4, max(tl, ql))
            t = base[:tl]
            q = np.where(rng.random(ql) < 0.1, rng.integers(0, 5, ql), base[:ql])
        elif mode == 1:
            t = rng.integers(0, 5, tl)
            q = rng.integers(0, 5, ql)
        else:
            base = rng.integers(0, 4, tl + ql + 20)
            t = base[:tl]
            q = np.concatenate([base[15 : 15 + ql // 2], rng.integers(0, 4, ql - ql // 2)])
        pairs.append((q.astype(np.int8), t.astype(np.int8), int(rng.integers(-10, 80))))
    return pairs


def _plain(pairs, params=O.DEFAULT_PARAMS, **pad):
    tb, ptuple = bsw_batch_from_numpy(W.prepare_pairs(pairs, params, **pad), "cpu", params)
    out = W.bsw_extend(tb, ptuple)
    return {k: out[r].numpy() for r, k in enumerate(KEYS)}


def _soa(pairs):
    n = len(pairs)
    q_len = np.array([len(q) for q, _, _ in pairs], np.int32)
    t_len = np.array([len(t) for _, t, _ in pairs], np.int32)
    codes = np.concatenate([np.asarray(a, np.int8) for q, t, _ in pairs for a in (q, t)])
    sizes = np.empty(2 * n, np.int64)
    sizes[0::2] = q_len
    sizes[1::2] = t_len
    offs = np.concatenate(([0], np.cumsum(sizes[:-1])))
    return {"codes": codes, "q_off": offs[0::2], "q_len": q_len, "t_off": offs[1::2],
            "t_len": t_len, "h0": np.array([h for _, _, h in pairs], np.int32)}


def _write_pairs_file(path, pairs, terminated=True, extra_fields=True):
    rows = []
    for q, t, h0 in pairs:
        head = f"{h0} {len(t)} {len(q)}" if extra_fields else f"{h0}"
        rows.append(f"{head}\n{''.join(map(str, t))}\n{''.join(map(str, q))}")
    path.write_text("\n".join(rows) + ("\n" if terminated else ""))


@pytest.mark.parametrize("name", list(PARAMS))
def test_plain_equals_jax_scan_and_interpret_pallas(name):
    params = PARAMS[name]
    pairs = _mixed_pairs(0, 128)
    got = _plain(pairs, params, q_pad=64, t_pad=96)
    jbatch = JW.prepare_pairs(pairs, q_pad=64, t_pad=96)
    jt = JW._params_tuple(_jax_params(params))
    scan = JW.bsw_batch(jbatch, jt)
    with pltpu.force_tpu_interpret_mode():
        pallas = JWP.bsw_batch_pallas(jbatch, jt)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(scan[k]), err_msg=f"scan {k}")
        np.testing.assert_array_equal(got[k], np.asarray(pallas[k]), err_msg=f"pallas {k}")


def test_goldens_300_of_300(fixtures_dir):
    cases = json.load(open(fixtures_dir / "bsw_golden.json"))
    pairs = [(np.array(c["query"]), np.array(c["target"]), c["h0"]) for c in cases]
    got = _plain(pairs)
    bad = [i for i, c in enumerate(cases) if {k: int(got[k][i]) for k in KEYS} != c["out"]]
    assert len(cases) == 300 and not bad, bad


@pytest.mark.parametrize("name", list(PARAMS))
def test_plain_equals_oracle(name):
    params = PARAMS[name]
    pairs = _mixed_pairs(1, 96, ql_max=130, tl_max=200)
    pairs += [(np.zeros(0, np.int8), np.array([0, 1], np.int8), 5),  # empty query
              (np.array([0, 1], np.int8), np.zeros(0, np.int8), 5),  # empty target
              (np.array([4, 4, 4], np.int8), np.array([4, 4], np.int8), 10)]  # all ambiguous
    got = _plain(pairs, params)
    for i, (q, t, h0) in enumerate(pairs):
        assert {k: int(got[k][i]) for k in KEYS} == O.scalar_banded_swa(q, t, h0, params), i


@pytest.mark.parametrize("name", list(PARAMS))
def test_oracle_equals_jax_oracle(name):
    params = PARAMS[name]
    assert np.array_equal(O.fill_scmat(params.match, params.mismatch, params.ambig),
                          JO.fill_scmat(params.match, params.mismatch, params.ambig))
    for q, t, h0 in _mixed_pairs(2, 60, ql_max=120, tl_max=160):
        assert O.scalar_banded_swa(q, t, h0, params) == JO.scalar_banded_swa(
            q, t, h0, _jax_params(params))


def test_band_width_matches_oracle_clamp():
    """w = min(w0, max_ins, max_del) with the reference's truncating double
    division, including negative numerators (short queries, large gap open)."""
    for p in (O.DEFAULT_PARAMS, O.BswParams(o_del=7, e_del=3, o_ins=9, e_ins=2, w=40),
              O.BswParams(o_del=20, e_del=3, o_ins=25, e_ins=7, match=2, end_bonus=0)):
        qlen = np.arange(0, 600)
        want = []
        for ql in qlen:
            max_ins = max(int((ql * p.match + p.end_bonus - p.o_ins) / p.e_ins + 1.0), 1)
            max_del = max(int((ql * p.match + p.end_bonus - p.o_del) / p.e_del + 1.0), 1)
            want.append(min(p.w, max_ins, max_del))
        got = W.band_width(torch.from_numpy(qlen.astype(np.int32)), W._params_tuple(p))
        assert got.dtype == torch.int32 and got.tolist() == want


@pytest.mark.parametrize("terminated", [True, False], ids=["terminated", "unterminated"])
def test_parse_pairs_soa_matches_jax(tmp_path, terminated):
    pairs = _mixed_pairs(3, 40)
    pairs[5] = (pairs[5][0], pairs[5][1], -7)
    pf = tmp_path / "pairs.txt"
    _write_pairs_file(pf, pairs, terminated=terminated, extra_fields=not terminated)
    got = PIO.parse_pairs_soa(pf)
    want = JIO.parse_pairs_soa(str(pf))
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["q_off"].dtype == np.int64 and got["t_off"].dtype == np.int64
    assert got["h0"].dtype == np.int32 and got["h0"][5] == -7
    with open(pf, "rb") as f:  # a file object parses the same
        again = PIO.parse_pairs_soa(f)
    assert all(np.array_equal(again[k], got[k]) for k in got)
    plain = PIO.parse_pairs_soa(pf, use_native=False)  # the numpy parse
    assert all(np.array_equal(plain[k], got[k]) and plain[k].dtype == got[k].dtype for k in got)
    lists = PIO.parse_pairs(pf)
    jlists = JIO.parse_pairs(str(pf))
    assert len(lists) == len(jlists) == len(pairs)
    for (q, t, h), (jq, jt, jh) in zip(lists, jlists):
        assert h == jh and np.array_equal(q, jq) and np.array_equal(t, jt)
    assert len(PIO.parse_pairs_soa(pf, max_pairs=7)["h0"]) == 7


def test_score_pairs_soa_matches_jax_cli():
    """The 96 mixed pairs of tests/test_pairsio_native.py (every third with
    ambiguous bases, h0 from -5), through both CLIs' scoring."""
    rng = np.random.default_rng(7)
    pairs = []
    for i in range(96):
        tl = int(rng.integers(12, 60))
        ql = int(rng.integers(8, min(tl, 40)))
        hi = 5 if i % 3 == 0 else 4
        t = rng.integers(0, hi, tl)
        q = rng.integers(0, hi, ql)
        pairs.append((q.astype(np.int8), t.astype(np.int8), int(rng.integers(-5, 60))))
    soa = _soa(pairs)
    stats, keep = {}, []
    got = cli.score_pairs_soa(soa, device="cpu", dev_batch=16, stats=stats, keep=keep)
    with pltpu.force_tpu_interpret_mode():
        want = jcli.score_pairs_soa(soa)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # launches of at most 16 pairs, one bucket each, in bucket order
    assert sum(kb["out"].shape[1] for kb in keep) == 96
    assert all(kb["out"].shape[1] <= 16 for kb in keep)
    assert set(stats) == {"bucket_s", "h2d_s", "kernel_s", "d2h_s"}
    listed = cli.score_pairs(pairs, device="cpu")
    assert all(np.array_equal(listed[k], got[k]) for k in KEYS)


def test_score_pairs_soa_rejects_long_pairs():
    pairs = [(np.zeros(513, np.int8), np.zeros(10, np.int8), 5)]
    with pytest.raises(ValueError, match="exceeds the largest bucket 512"):
        cli.score_pairs_soa(_soa(pairs), device="cpu")
    empty = {k: v[:0] for k, v in _soa(pairs).items()}
    assert all(v.shape == (0,) for v in cli.score_pairs_soa(empty, device="cpu").values())


@pytest.mark.parametrize("flags", [[], ["-m", "2", "-x", "3", "-o", "5", "-e", "2"]],
                         ids=["default", "m2x3o5e2"])
def test_cli_print_output_matches_jax_cli(tmp_path, capsys, flags):
    pairs = _mixed_pairs(4, 50)
    pf = tmp_path / "pairs.txt"
    _write_pairs_file(pf, pairs)
    assert cli.main(["-pairs", str(pf), "--print-output", "--device", "cpu", *flags]) == 0
    got = capsys.readouterr().out.splitlines()
    with pltpu.force_tpu_interpret_mode():
        assert jcli.main(["-pairs", str(pf), "--print-output", *flags]) == 0
    want = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 50 + 4
    for g, w in zip(got, want):  # timings differ; every other line is equal
        if g.startswith(("Read time = ", "Overall SW cycles")):
            assert w.split("=")[0] == g.split("=")[0]
        else:
            assert g == w
    assert got[1] == "Total Pairs read: 50" and got[-1] == "Total Pairs processed: 50"


def test_convert_carries_jax_prepare_pairs():
    pairs = _mixed_pairs(5, 40)
    params = PARAMS["m2x3o5e2"]
    jbatch = JW.prepare_pairs(pairs, q_pad=64, t_pad=96)
    tb, ptuple = bsw_batch_from_numpy(jbatch, "cpu", _jax_params(params))
    assert ptuple == W._params_tuple(params) == JW._params_tuple(_jax_params(params))
    assert {k: v.dtype for k, v in tb.items()} == {
        "codes": torch.int8, "q_off": torch.int64, "q_len": torch.int32,
        "t_off": torch.int64, "t_len": torch.int32, "h0": torch.int32}
    for b, (q, t, h0) in enumerate(pairs):
        qo, to = int(tb["q_off"][b]), int(tb["t_off"][b])
        assert np.array_equal(tb["codes"][qo : qo + len(q)].numpy(), q)
        assert np.array_equal(tb["codes"][to : to + len(t)].numpy(), t)
    out = W.bsw_extend(tb, ptuple)
    want = JW.bsw_batch(jbatch, JW._params_tuple(_jax_params(params)))
    for r, k in enumerate(KEYS):
        np.testing.assert_array_equal(out[r].numpy(), np.asarray(want[k]), err_msg=k)
    # the plain version's chunking does not change its outputs
    stats = {}
    assert torch.equal(W.bsw_extend_plain(tb, ptuple, chunk=7, stats=stats), out)
    assert stats["cells"] > 0


def test_chip_smoke_pair_file_matches_tools_generator(tmp_path, monkeypatch):
    """chip_smoke.py writes bsw_large with the port tool's write_pairs: the
    file of tools/bsw_scale_bench.py byte for byte (same rng draws), with
    the records laid out in bulk."""
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    import bsw_scale_bench

    from genomicsbench_palisade_tpu_torch.tools.bsw_scale_bench import write_pairs

    for n, chunk in ((2500, 1000), (700, 8192)):
        a, b = tmp_path / "a.txt", tmp_path / "b.txt"
        write_pairs(a, n, np.random.default_rng(9), chunk=chunk)
        bsw_scale_bench.write_pairs(b, n, np.random.default_rng(9), chunk=chunk)
        assert a.read_bytes() == b.read_bytes()
    soa = PIO.parse_pairs_soa(a)
    assert len(soa["h0"]) == 700 and soa["q_len"].min() >= 96 and soa["t_len"].max() <= 256
