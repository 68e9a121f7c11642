"""The port's POA (ops/poa.py, cli/poa.py) on the CPU, against the JAX
package, the port's oracle and the reference goldens.

The aligner's alignments must equal the JAX package's `align_batch` for
nw, sw and ov, on graphs that take the JAX ring path (every predecessor at
most 32 ranks back) and graphs that do not, and its raw output must equal
both JAX paths' (`_batched_align` with and without the ring).  Graphs are
the port's oracle `PoaGraph`s, which both packages' aligners read.
Tolerance 0: every output is an integer or a string.
"""

import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu.cli import poa as jcli
from genomicsbench_palisade_tpu.ops import poa as JP
from genomicsbench_palisade_tpu.utils import compile_cache
from genomicsbench_palisade_tpu_torch.cli import poa as cli
from genomicsbench_palisade_tpu_torch.convert import poa_batch_from_numpy
from genomicsbench_palisade_tpu_torch.ops import poa as P
from genomicsbench_palisade_tpu_torch.ops.oracle import poa as PO

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
CPU = "cpu"
PARAMS = (2, -4, -6, -2, -25, -1)  # the driver's (msa_spoa_omp.cpp:264-270, combined)
ACGT = {ch: i for i, ch in enumerate("ACGT")}


def _mutate(rng, truth, sub=0.06, indel=0.03, alphabet="ACGT"):
    out = []
    for ch in truth:
        u = rng.random()
        if u < indel:
            continue
        out.append(ch if u > sub + indel else rng.choice(list(alphabet)))
        if u > 1 - indel:
            out.append(rng.choice(list(alphabet)))
    return "".join(out)


def _windows(seed, n=6, rounds=4, lo=40, hi=90, alphabet="ACGT"):
    """Noisy copies of a truth a window; the last copies of some windows
    start or end with extra bases, or lack some, so walks run along row 0
    and column 0."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n):
        truth = "".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi))))
        seqs = [_mutate(rng, truth, alphabet=alphabet) for _ in range(rounds)]
        if w % 3 == 1:
            seqs[-1] = "".join(rng.choice(list("ACGT"), 7)) + seqs[-1][5:]
        elif w % 3 == 2:
            seqs[-1] = seqs[-1][9:] + "".join(rng.choice(list("ACGT"), 6))
        out.append(seqs)
    return out


def _long_deletion(seed, n=80):
    """A window whose second sequence skips 45 bases of the first: an edge
    more than RING_D (32) ranks back, so the JAX package takes its
    full-matrix path."""
    rng = np.random.default_rng(seed)
    truth = "".join(rng.choice(list("ACGT"), n))
    return [truth, truth[:15] + truth[60:], _mutate(rng, truth), _mutate(rng, truth)]


def _grow(graph, seq, atype="nw", params=PARAMS):
    graph.add_alignment(PO.convex_align(seq, graph, PO.PoaParams(*params), atype), seq)


def _max_back(graph):
    """The largest rank distance from a node back to a predecessor."""
    a = P.graph_to_arrays(graph, len(graph.nodes), 16)
    n = len(graph.nodes)
    if not n:
        return 0
    pr = a["preds"][:n]
    ok = (np.arange(pr.shape[1])[None, :] < a["npreds"][:n, None]) & (pr >= 1)
    return int((np.arange(1, n + 1)[:, None] - pr)[ok].max()) if ok.any() else 0


def test_graph_to_arrays_equals_jax():
    wins = _windows(3, n=4, rounds=3, alphabet="ACGTN")
    for seqs in wins:
        g = PO.PoaGraph()
        for s in seqs:
            _grow(g, s)
            for code_map in (None, ACGT):
                got = P.graph_to_arrays(g, 256, 16, code_map)
                want = JP.graph_to_arrays(g, 256, 16, code_map)
                assert got.keys() == want.keys()
                for k in got:
                    np.testing.assert_array_equal(got[k], want[k])
        assert P.graph_to_arrays(g, len(g.nodes) - 1, 16) is None
        deg = int(P.graph_to_arrays(g, 256, 16)["npreds"].max())
        assert P.graph_to_arrays(g, 256, deg - 1) is None
        assert JP.graph_to_arrays(g, 256, deg - 1) is None


def _lockstep(wins, atype, n_cap=128, w_cap=128, p_cap=16, params=PARAMS, jax_too=True,
              first=0):
    """Round k aligns sequence k of every window through the port and the
    JAX package (fixed caps: one JAX compile a path) and grows the graphs
    with the port's alignments; the first `first` sequences are added by
    the oracle's nw.  Returns the graphs and every round's alignments."""
    graphs = [PO.PoaGraph() for _ in wins]
    for g, w in zip(graphs, wins):
        for s in w[:first]:
            _grow(g, s)
    rounds = []
    for k in range(first, len(wins[0])):
        seqs = [w[k] for w in wins]
        got = P.align_batch(graphs, seqs, params, n_cap=n_cap, p_cap=p_cap, w_cap=w_cap,
                            align_type=atype, device=CPU)
        if jax_too:
            want = JP.align_batch(graphs, seqs, params, n_cap=n_cap, p_cap=p_cap, w_cap=w_cap,
                                  align_type=atype)
            assert got == want, (atype, k)
        for g, s, a in zip(graphs, seqs, got):
            g.add_alignment(a, s)
        rounds.append(got)
    return graphs, rounds


@pytest.mark.parametrize("atype", ["nw", "sw", "ov"])
def test_align_batch_equals_jax_on_ring_path(atype):
    wins = _windows(11)
    graphs, rounds = _lockstep(wins, atype)
    assert max(_max_back(g) for g in graphs) <= JP.RING_D
    last = rounds[-1]
    if atype == "nw":  # walks that end along row 0 and along column 0
        assert any(a[0][0] == -1 for a in last) and any(a[0][1] == -1 for a in last)


@pytest.mark.parametrize("atype", ["nw", "sw", "ov"])
def test_align_batch_equals_jax_off_ring_path(atype):
    """A graph with a predecessor more than 32 ranks back sends the JAX
    package's whole batch down its full-matrix path; windows with an
    extended alphabet (codes 9) ride along."""
    wins = _windows(12, n=3, alphabet="ACGTNRY") + [_long_deletion(5)]
    graphs, _ = _lockstep(wins, atype, first=2)
    assert _max_back(graphs[-1]) > JP.RING_D


def _device_batch(seed, atype, rounds=3):
    """A round's batch as the aligners take it (graph arrays stacked)."""
    wins = _windows(seed, n=5, rounds=rounds + 1)
    graphs = [PO.PoaGraph() for _ in wins]
    for k in range(rounds):
        for g, w in zip(graphs, wins):
            _grow(g, w[k], atype)
    garrs = [P.graph_to_arrays(g, 128, 16, ACGT) for g in graphs]
    seq_arr = np.zeros((len(wins), 127), np.int32)
    seq_len = np.zeros(len(wins), np.int32)
    for i, w in enumerate(wins):
        seq_arr[i, : len(w[rounds])] = [ACGT[ch] for ch in w[rounds]]
        seq_len[i] = len(w[rounds])
    return garrs, seq_arr, seq_len


@pytest.mark.parametrize("atype", ["nw", "sw", "ov"])
def test_aligner_output_equals_both_jax_paths(atype):
    """poa_align_device's raw (ranks, columns, count), -2 fill included,
    equals the JAX vmapped aligner with the ring (ring_d 32) and without;
    with all 16 predecessor slots and with the batch's widest in-degree."""
    garrs, seq_arr, seq_len = _device_batch(21, atype)
    a_cap = 128 + 128 + 4
    stack = {k: jnp.asarray(np.stack([a[k] for a in garrs])) for k in garrs[0]}
    wants = [np.asarray(JP._batched_align(PARAMS, 128, a_cap, atype, ring)(
        jnp.asarray(seq_arr), jnp.asarray(seq_len), stack)) for ring in (JP.RING_D, 0)]
    np.testing.assert_array_equal(wants[0], wants[1])
    deg = max(int(a["npreds"].max()) for a in garrs)
    assert deg > 1
    for p_slots in (None, deg):
        batch = poa_batch_from_numpy(garrs, seq_arr, seq_len, CPU, p_slots)
        ai, aj, cnt = P.poa_align_device(batch, PARAMS, 128, a_cap, atype)
        np.testing.assert_array_equal(np.concatenate([ai, aj, cnt[:, None]], 1), wants[0])


def test_overflow_and_empty_graph_go_to_the_oracle():
    """A node over p_cap predecessors and an empty graph: the oracle's
    convex_align, as in the JAX package.  With other scores the port hands
    the oracle those scores (the JAX package hands it its defaults)."""
    wins = _windows(31, n=4, rounds=4)
    graphs = [PO.PoaGraph() for _ in wins]
    for g, w, n in zip(graphs, wins, (1, 3, 3, 0)):
        for s in w[:n]:
            _grow(g, s)
    degs = [int(P.graph_to_arrays(g, 256, 16)["npreds"].max()) for g in graphs[:3]]
    p_cap = 1
    assert degs[0] == p_cap < min(degs[1:])  # one window on the device, two overflow
    seqs = [w[3] for w in wins]
    got = P.align_batch(graphs, seqs, PARAMS, p_cap=p_cap, device=CPU)
    assert got == JP.align_batch(graphs, seqs, PARAMS, p_cap=p_cap)
    other = (3, -5, -4, -1, -20, -2)
    got = P.align_batch(graphs, seqs, other, p_cap=p_cap, device=CPU)
    for g, s, a, d in zip(graphs, seqs, got, degs + [0]):
        if d > p_cap or not g.nodes:
            assert a == PO.convex_align(s, g, PO.PoaParams(*other))


def test_fixpoint_reruns_with_more_passes(monkeypatch):
    """One E/Q pass a row leaves rows unconverged: the round is filled again
    with twice the passes, and the alignments are the same."""
    wins = _windows(41, n=4, rounds=3)
    _, want = _lockstep(wins, "nw", jax_too=False)
    monkeypatch.setattr(P, "FIX_PASSES", 1)
    stats = {}
    graphs = [PO.PoaGraph() for _ in wins]
    for k in range(3):
        seqs = [w[k] for w in wins]
        got = P.align_batch(graphs, seqs, n_cap=128, w_cap=128, device=CPU, stats=stats)
        assert got == want[k]
        for g, s, a in zip(graphs, seqs, got):
            g.add_alignment(a, s)
    assert stats["reruns"] >= 1 and stats["passes"] == 2


def test_poa_goldens_nw():
    """The 48 windows of tests/fixtures/poa_golden.json (the reference's
    spoa through the driver's batch flow) in one lockstep batch."""
    cases = json.loads((FIXTURES / "poa_golden.json").read_text())["cases"]
    batches = [seqs for case in cases for seqs in case["batches"]]
    wants = [w for case in cases for w in case["consensus"]]
    assert len(batches) == 48
    timings, stats = {}, {}
    assert P.msa_consensus_batch(batches, timings=timings, device=CPU, stats=stats) == wants
    assert set(timings) == {"align", "add", "consensus"}
    assert stats["rounds"] == max(len(b) for b in batches)


@pytest.mark.parametrize("atype", ["sw", "ov"])
def test_poa_swov_goldens(atype):
    """The 10 cases of tests/fixtures/poa_swov_golden.json: every
    alignment and the consensus exactly, the cases in lockstep."""
    golden = json.loads((FIXTURES / "poa_swov_golden.json").read_text())["cases"]
    graphs = [PO.PoaGraph() for _ in golden]
    for k in range(max(len(c["seqs"]) for c in golden)):
        idxs = [ci for ci, c in enumerate(golden) if k < len(c["seqs"])]
        alns = P.align_batch([graphs[ci] for ci in idxs], [golden[ci]["seqs"][k] for ci in idxs],
                             align_type=atype, device=CPU)
        for ci, aln in zip(idxs, alns):
            assert [list(p) for p in aln] == golden[ci][atype]["alignments"][k], (ci, k)
            graphs[ci].add_alignment(aln, golden[ci]["seqs"][k])
    for g, case in zip(graphs, golden):
        assert g.generate_consensus() == case[atype]["consensus"]


def test_msa_consensus_batch_equals_oracle():
    wins = _windows(51, n=5, rounds=5)
    assert P.msa_consensus_batch(wins, device=CPU) == [PO.msa_consensus(w) for w in wins]


@pytest.fixture
def poa_file(tmp_path):
    path = tmp_path / "windows.fa"
    lines = []
    for w, seqs in enumerate(_windows(61, n=3, rounds=4)):
        for i, s in enumerate(seqs):
            lines += [f">{0 if i == 0 else 1}_{w}_{i}", s]
    path.write_text("\n".join(lines) + "\n\n")
    return path


def _runtime_masked(text):
    return re.sub(r"Runtime: [0-9.]+ sec", "Runtime: t sec", text)


@pytest.mark.parametrize("flags", [["--engine", "device"], ["--oracle"],
                                   ["-m", "3", "-x", "5", "-o", "3,20", "-e", "1,2",
                                    "--engine", "device"]])
def test_cli_prints_the_jax_cli_stdout(poa_file, capsys, monkeypatch, flags):
    monkeypatch.setattr(compile_cache, "enable", lambda *a, **kw: None)
    assert jcli.main(["-s", str(poa_file), *flags]) == 0
    want = capsys.readouterr()
    port_flags = [f for f in flags if f not in ("--engine", "device")]
    assert cli.main(["-s", str(poa_file), *port_flags, "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert _runtime_masked(got.out) == _runtime_masked(want.out)
    assert got.out.startswith("Number of batches: 3\n")
    assert re.fullmatch(r"Runtime: [0-9.]+, GraphCreate: 0.00, Align: [0-9.]+, AddSeqGraph: "
                        r"[0-9.]+, Consensus [0-9.]+ [0-9.]+ [0-9.]+\n", got.err)
    assert cli.read_batches(str(poa_file)) == jcli.read_batches(str(poa_file))


def test_cli_refuses_engine_host(poa_file, capsys, monkeypatch):
    """`--engine host` is no longer refused (the test keeps the name it had
    while the port lacked the engine): it runs the native engine on the
    host, with no device, and prints what `--engine device` prints, and the
    reference's stderr line."""
    assert cli.main(["-s", str(poa_file), "--engine", "device", "--device", "cpu"]) == 0
    want = capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["-s", str(poa_file), "--engine", "host"]) == 0
    got = capsys.readouterr()
    assert _runtime_masked(got.out) == _runtime_masked(want.out)
    assert got.out.count("consensus_seq: ") == 3
    assert re.fullmatch(r"Runtime: [0-9.]+, GraphCreate: 0.00, Align: [0-9.]+, AddSeqGraph: "
                        r"[0-9.]+, Consensus [0-9.]+ [0-9.]+ [0-9.]+\n", got.err)


def test_entry_points_need_a_gpu_or_device_cpu(poa_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wins = _windows(71, n=2, rounds=2)
    for fn in (lambda: cli.main(["-s", str(poa_file)]),
               lambda: P.msa_consensus_batch(wins),
               lambda: P.align_batch([PO.PoaGraph()], [wins[0][0]])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
