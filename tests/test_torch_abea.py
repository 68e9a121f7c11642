"""The port's adaptive banded event alignment (genomicsbench_palisade_tpu_torch)
against the JAX package's scan, its host traceback, both oracles, the
reference-binary goldens and the JAX CLI, on the CPU at small sizes.

Tolerance: none.  The fill's trace and bll_e are integers; its last-k-mer
values are f32 made by the same roundings (the port adds the double
penalties in real doubles, the JAX scan through compensated f32 sums that
reproduce the same single rounding), so they must be equal bit for bit;
pairs, event tables and scalings must equal the oracles'.  Every test pins
torch to one thread, which keeps parallel test workers from
oversubscribing the cores.
"""

import functools
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu.cli import abea as jcli
from genomicsbench_palisade_tpu.io import signal as JSIG
from genomicsbench_palisade_tpu.ops import abea as JA
from genomicsbench_palisade_tpu.ops.oracle import abea as JAO
from genomicsbench_palisade_tpu.ops.oracle import events as JEO
from genomicsbench_palisade_tpu_torch.cli import abea as cli
from genomicsbench_palisade_tpu_torch.convert import abea_batch_from_numpy, abea_model_from_numpy
from genomicsbench_palisade_tpu_torch.io import signal as SIG
from genomicsbench_palisade_tpu_torch.io.fastq import read_sequences
from genomicsbench_palisade_tpu_torch.ops import abea as A
from genomicsbench_palisade_tpu_torch.ops import events as EV
from genomicsbench_palisade_tpu_torch.ops.oracle import abea as AO
from genomicsbench_palisade_tpu_torch.ops.oracle import events as EO

REPO = Path(__file__).resolve().parents[1]
K = AO.KMER_SIZE


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def model():
    """tests/test_abea.py's synthetic model."""
    rng = np.random.default_rng(0)
    m = {"level_mean": rng.normal(90, 12, 4096).astype(np.float32),
         "level_stdv": (rng.random(4096).astype(np.float32) * 2 + 1)}
    m["level_log_stdv"] = np.log(m["level_stdv"]).astype(np.float32)
    return m


def _synth(rng, model, seq, scale=1.0, shift=0.0, epk=1.8):
    """tests/test_abea.py:_synth, with the events scaled and shifted."""
    means = []
    for i in range(len(seq) - K + 1):
        r = AO.get_kmer_rank(seq[i : i + K])
        for _ in range(max(1, int(rng.poisson(epk - 1)) + 1)):
            means.append(scale * model["level_mean"][r] + shift
                         + rng.normal(0, model["level_stdv"][r] * 0.5))
    return np.array(means, dtype=np.float32)


def _reads(seed, model, lengths, noisy=()):
    """Reads of the given lengths with scales 0.8-1.2 and shifts -4..4 (f32
    values); the reads in `noisy` get N(0, 25) more noise (QC drops)."""
    rng = np.random.default_rng(seed)
    seqs, evs, scales, shifts = [], [], [], []
    for t, n in enumerate(lengths):
        seq = "".join(rng.choice(list("ACGT"), n))
        sc = float(np.float32(rng.uniform(0.8, 1.2)))
        sh = float(np.float32(rng.uniform(-4, 4)))
        ev = _synth(rng, model, seq, sc, sh)
        if t in noisy:
            ev = (ev + rng.normal(0, 25, len(ev))).astype(np.float32)
        seqs.append(seq)
        evs.append(ev)
        scales.append(sc)
        shifts.append(sh)
    return seqs, evs, scales, shifts


def _port_batch(seqs, evs, model, scales, shifts):
    batch_np, idx = A.prepare_batch(seqs, evs, model, scales, shifts)
    return batch_np, idx, abea_batch_from_numpy(batch_np, "cpu")


def _jax_fill(seq, ev, model, scale, shift):
    """JAX abea_fill_bands (the scan) of one read: its bands 2.. nb-1."""
    e_buck, k_buck = JA._bucket(len(ev)), JA._bucket(len(seq) - K + 1)
    ev_pad, ranks_pad, lp_consts, trim_vals, _ = JA._prep_read(seq, ev, 100, K, e_buck, k_buck)
    fill = jax.jit(functools.partial(JA.abea_fill_bands, n_bands_pad=e_buck + k_buck + 2))
    tr, bes, _, lv = fill(ev_pad, ranks_pad, len(ev), len(seq) - K + 1,
                          model["level_mean"], model["level_stdv"], model["level_log_stdv"],
                          np.float32(scale), np.float32(shift), lp_consts, trim_vals)
    nb = len(ev) + len(seq) - K + 3
    return np.asarray(tr)[: nb - 2], np.asarray(bes)[: nb - 2], np.asarray(lv)[: nb - 2]


def _oracle_fill(seq, ev, model, scale, shift):
    """The oracle's fill (ops/oracle/abea.py fill_bands) as the port lays it
    out: trace, bll_e and the last k-mer's value of every band."""
    bands, trace, bll_e = AO.fill_bands(seq, ev, model, scale, shift)
    bi = np.arange(len(bll_e))
    off = bll_e - (bi - (len(seq) - K + 1) - 1)  # the cell of event bi - nk - 1
    ok = (off >= 0) & (off < 100)
    return trace, bll_e, np.where(ok, bands[bi, np.clip(off, 0, 99)], -np.inf).astype(np.float32)


@pytest.mark.parametrize("seed", [21, 22])
def test_fill_equals_oracle_and_jax_scan(model, seed):
    """Per band: the moves, bll_e and the last k-mer's value, against the
    oracle's fill, exactly, and the moves and bll_e against the JAX scan,
    exactly, read by read (scales 0.8-1.2, shifts -4..4, a QC-drop read).

    The JAX scan's last values are not the oracle's: on the CPU, XLA fuses
    its gm = scale*mean + shift into an FMA, and its compensated f32 sums
    round a few more cells otherwise (a JAX-side fault, ROADMAP queue 3).
    Where the two differ the oracle decides, and it sides with the port, so
    against the JAX scan the last values are held within 8 ulps."""
    seqs, evs, scales, shifts = _reads(seed, model, [40, 97, 150, 61], noisy=(2,))
    batch_np, idx, batch = _port_batch(seqs, evs, model, scales, shifts)
    fill = A.abea_fill_plain(batch)
    assert idx == [0, 1, 2, 3]
    for r in idx:
        lo, nb = int(batch_np["band_off"][r]), len(evs[r]) + len(seqs[r]) - K + 3
        got = {k: fill[k][lo : lo + nb].numpy() for k in ("trace", "bll_e", "last_val")}
        for key, want in zip(("trace", "bll_e", "last_val"),
                             _oracle_fill(seqs[r], evs[r], model, scales[r], shifts[r])):
            assert np.array_equal(got[key], want), f"{key} of read {r} differs from the oracle"
        tr, bes, lv = _jax_fill(seqs[r], evs[r], model, scales[r], shifts[r])
        assert np.array_equal(got["trace"][2:], tr), f"trace of read {r}"
        assert np.array_equal(got["bll_e"][2:], bes), f"bll_e of read {r}"
        fin = np.isfinite(lv)
        assert np.array_equal(np.isfinite(got["last_val"][2:]), fin), f"last_val of read {r}"
        ulps = np.abs(got["last_val"][2:][fin].view(np.int32).astype(np.int64)
                      - lv[fin].view(np.int32).astype(np.int64))
        assert ulps.max() <= 8, f"last_val of read {r}: {ulps.max()} ulps from the JAX scan"
        # the seed: the first event maximising (float)(last + (ne - ei) * lp_trim)
        ne, nk = len(evs[r]), len(seqs[r]) - K + 1
        ei = np.arange(ne)
        s_ei = (got["last_val"][ei + nk + 1].astype(np.float64)
                + (ne - ei) * np.log(0.01)).astype(np.float32)
        assert fill["seed"][r].item() == int(np.argmax(s_ei)), f"seed of read {r}"


def test_walk_and_decode_equal_jax_traceback(model):
    """The port's walk and decode on its fill, against the JAX package's
    numpy traceback (`_traceback_batch(use_native=False)`) on the same
    fill, pair for pair, QC drops included."""
    seqs, evs, scales, shifts = _reads(23, model, [45, 120, 80, 66], noisy=(1,))
    batch_np, idx, batch = _port_batch(seqs, evs, model, scales, shifts)
    fill = A.abea_fill_plain(batch)
    walk = A.abea_walk_plain(batch, fill)
    got = A.decode(batch_np["band_off"], {k: v.numpy() for k, v in walk.items()})
    g = lambda r, key: fill[key][int(batch_np["band_off"][r]) + 2 :  # noqa: E731
                                 int(batch_np["band_off"][r]) + len(evs[r]) + len(seqs[r]) - K + 3
                                 ].numpy()
    want = JA._traceback_batch(
        seqs, evs, model, scales, shifts, [g(r, "trace") for r in idx],
        [g(r, "bll_e") for r in idx], [g(r, "last_val").astype(np.float64) for r in idx],
        [A.kmer_ranks(s, K, len(s) - K + 1) for s in seqs], 100, K, use_native=False)
    assert got == want
    assert want[1] == [] and all(want[r] for r in (0, 2, 3))
    # a kept read's walk: its pairs, from (last k-mer, seed)
    for r in (0, 2, 3):
        assert walk["n"][r].item() == len(want[r])
        assert want[r][-1] == (len(seqs[r]) - K, fill["seed"][r].item())


def test_align_events_batch_equals_jax_and_oracles(model):
    """A mixed batch (a QC drop, a read with no event, one shorter than a
    k-mer) through the port on the CPU, the JAX package's scan path, the
    port's oracle and the JAX package's oracle."""
    seqs, evs, scales, shifts = _reads(24, model, [30, 140, 75, 210, 52], noisy=(3,))
    seqs += ["ACGTA", "ACGTACGTAC"]
    evs += [np.array([90.0, 91.0], np.float32), np.zeros(0, np.float32)]
    scales += [1.0, 1.0]
    shifts += [0.0, 0.0]
    got = A.align_events_batch(seqs, evs, model, scales, shifts, device="cpu")
    jax_got = JA.align_events_batch(seqs, evs, model, scales, shifts, use_native=False)
    want = [AO.align(s, e, model, sc, sh) for s, e, sc, sh in zip(seqs[:5], evs, scales, shifts)]
    jwant = [JAO.align(s, e, model, sc, sh) for s, e, sc, sh in zip(seqs[:5], evs, scales, shifts)]
    assert got == jax_got == want + [[], []]
    assert want == jwant
    assert want[3] == [] and all(want[r] for r in (0, 1, 2, 4))
    assert A.align_events(seqs[1], evs[1], model, scales[1], shifts[1], device="cpu") == want[1]


def test_plain_walk_clamps_an_offset_outside_the_band(model):
    """A read whose last k-mer column is -inf in every band (no event
    reaches it) walks from event 0 through cells outside the band; the
    offset is clamped as the JAX walk clamps it, and QC drops the read."""
    rng = np.random.default_rng(25)
    seq = "".join(rng.choice(list("ACGT"), 300))
    ev = _synth(rng, model, seq)[:20]  # ~20 events for ~295 k-mers: far past the band
    got = A.align_events_batch([seq], [ev], model, [1.0], [0.0], device="cpu")
    assert got == JA.align_events_batch([seq], [ev], model, [1.0], [0.0],
                                        use_native=False) == [[]]


@pytest.fixture(scope="module")
def golden(fixtures_dir):
    return json.loads((fixtures_dir / "abea_golden.json").read_text())["cases"]


@pytest.fixture(scope="module")
def golden_model(tmp_path_factory):
    import sys

    sys.path.insert(0, str(REPO / "tests"))
    from generate_fixtures import _pore_levels

    path = tmp_path_factory.mktemp("abea") / "pore.tsv"
    with open(path, "w") as f:
        f.write("kmer\tlevel_mean\tlevel_stdv\n")
        for km, mean in _pore_levels().items():
            f.write(f"{km}\t{mean:.2f}\t1.50\n")
    return path


def test_goldens_25_of_25(golden, golden_model):
    """The 25 reference-binary cases (tools/golden/abea_harness.cpp):
    events, scale, shift and pairs, through the port's batch host prep and
    its batch alignment on the CPU."""
    model = SIG.load_pore_model(str(golden_model))
    sigs = [np.array([float(x) for x in c["signal"]], np.float32) for c in golden]
    events = EV.detect_events_batch(sigs)
    shifts, scales = EV.estimate_scalings_mom_batch([c["seq"] for c in golden], model, events)
    for c, ev, sh, sc in zip(golden, events, shifts, scales):
        assert ev["start"].astype(np.int64).tolist() == [e[0] for e in c["events"]]
        assert np.array_equal(ev["mean"], np.array([float.fromhex(e[2]) for e in c["events"]],
                                                   np.float32))
        assert sc == np.float32(float.fromhex(c["scale"]))
        assert sh == np.float32(float.fromhex(c["shift"]))
    got = A.align_events_batch([c["seq"] for c in golden], [e["mean"] for e in events], model,
                               [float(v) for v in scales], [float(v) for v in shifts],
                               device="cpu")
    assert [[tuple(p) for p in c["pairs"]] for c in golden] == got
    assert sum(1 for g in got if g) >= 15 and any(not g for g in got)


def _signals(seed, lengths):
    """Raw signals like the golden recipe (tests/generate_fixtures.py:390-426):
    per k-mer 3-13 samples at its level plus N(0, 0.8), or N(0, 6) for 20%."""
    rng = np.random.default_rng(seed)
    levels = rng.uniform(60, 140, 4096)
    out = []
    for n in lengths:
        codes = rng.integers(0, 4, n + K - 1)
        ranks = np.zeros(n, np.int64)
        for j in range(K):
            ranks = (ranks << 2) | codes[j : j + n]
        dwell = rng.integers(3, 14, n)
        noise = np.where(rng.random(n) < 0.8, 0.8, 6.0)
        lv = np.repeat(levels[ranks], dwell) + rng.normal(0, 1, dwell.sum()) * np.repeat(noise, dwell)
        out.append(lv.astype(np.float32))
    return out


def test_detect_events_batch_equals_oracles(monkeypatch):
    """The batch detector and the batch MoM against the port's per-read
    oracle and the JAX package's numpy path, on signals of mixed lengths
    (empty, shorter than both windows, and up to ~3,000 samples), with every
    read in lockstep, every read on the per-read loop, and as the cost
    model splits them."""
    sigs = _signals(26, [300, 40, 0, 120, 7]) + [np.zeros(0, np.float32),
                                                np.full(5, 100.0, np.float32)]
    wants = [(EO.detect_events(s), JEO.detect_events(s, use_native=False)) for s in sigs]
    n_sorted = np.sort([len(s) for s in sigs])[::-1]
    # per read: every read with a sample (the two empty ones need no step)
    for step_cost, k in ((0.0, 0), (1e9, 5), (EV.STEP_COST, None)):
        monkeypatch.setattr(EV, "STEP_COST", step_cost)
        if k is not None:
            assert EV.lockstep_split(n_sorted) == k
        got = EV.detect_events_batch(sigs, use_native=False)
        assert len(got) == len(sigs)
        for g, (want, jwant) in zip(got, wants):
            assert g.dtype == want.dtype == jwant.dtype
            for key in ("start", "length", "mean", "stdv"):
                np.testing.assert_array_equal(g[key], want[key], err_msg=key)
                np.testing.assert_array_equal(g[key], jwant[key], err_msg=key)
    assert EV.detect_events_batch([]) == []
    assert sum(len(g) for g in got) > 200
    rng = np.random.default_rng(27)
    seqs = ["".join(rng.choice(list("ACGT"), len(g) + int(rng.integers(6, 40))))
            for g in got[:2] + got[3:4]]
    m = {"level_mean": rng.uniform(60, 140, 4096).astype(np.float32)}
    shifts, scales = EV.estimate_scalings_mom_batch(seqs, m, got[:2] + got[3:4], use_native=False)
    for seq, ev, sh, sc in zip(seqs, got[:2] + got[3:4], shifts, scales):
        assert (sh, sc) == EO.estimate_scalings_using_mom(seq, m, ev) \
            == JEO.estimate_scalings_using_mom(seq, m, ev)
        assert sh.dtype == sc.dtype == np.float32


def test_create_events_equals_oracle_on_unsorted_peaks():
    """Peaks arrive unsorted when the long detector fires behind the short
    one; both create_events use them in that order (negative lengths)."""
    rng = np.random.default_rng(28)
    raw = rng.normal(100, 5, 200).astype(np.float32)
    sums, sumsqs = EO.compute_sum_sumsq(raw)
    for peaks in ([50, 20, 120], [0, 30, 30, 250, 199], []):
        got = EV.create_events(peaks, sums, sumsqs, len(raw))
        with np.errstate(all="ignore"):
            want = EO.create_events(peaks, sums, sumsqs, len(raw))
        for key in ("start", "length", "mean", "stdv"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _cli_inputs(tmp_path, seed=30):
    """Several reads with signals by the golden recipe, one read with no
    signal and one whose signal is noise (QC drop); a model TSV like
    tests/test_cli_drivers.py's."""
    rng = np.random.default_rng(seed)
    level_mean = rng.normal(90, 12, 4096).astype(np.float32)
    level_stdv = (rng.random(4096) * 2 + 1).astype(np.float32)
    lines = ["#synthetic\tmodel", "kmer\tlevel_mean\tlevel_stdv\tsd_mean\tsd_stdv"]
    for r in range(4096):
        kmer = "".join("ACGT"[(r >> (2 * (K - 1 - j))) & 3] for j in range(K))
        lines.append(f"{kmer}\t{level_mean[r]:.5f}\t{level_stdv[r]:.5f}\t0\t0")
    model_tsv = tmp_path / "model.tsv"
    model_tsv.write_text("\n".join(lines) + "\n")
    model = SIG.load_pore_model(str(model_tsv))
    reads, signals = [], {}
    for i, n in enumerate([150, 90, 200, 60, 120]):
        seq = "".join(rng.choice(list("ACGT"), n))
        ranks = A.kmer_ranks(seq, K, n - K + 1)
        dwell = rng.integers(3, 14, len(ranks))
        raw = np.repeat(model["level_mean"][ranks], dwell) + rng.normal(0, 0.8, dwell.sum())
        if i == 3:
            raw = rng.normal(90, 20, dwell.sum())
        reads.append((f"read{i}", seq))
        if i != 1:
            signals[f"read{i}"] = raw.astype(np.float32)
    fa = tmp_path / "reads.fasta"
    fa.write_text("".join(f">{n} comment\n{s[:70]}\n{s[70:]}\n" for n, s in reads))
    npz = tmp_path / "signals.npz"
    np.savez(npz, **signals)
    return fa, npz, model_tsv


def test_cli_matches_jax_cli(tmp_path, capsys, monkeypatch):
    fa, npz, model_tsv = _cli_inputs(tmp_path)
    ours, theirs = tmp_path / "ours.tsv", tmp_path / "theirs.tsv"
    args = ["--reads", str(fa), "--raw", str(npz), "--model", str(model_tsv)]
    assert cli.main(args + ["-o", str(ours), "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    monkeypatch.setenv("GENOMICS_TPU_CACHE_DIR", str(tmp_path / "xla"))
    assert jcli.main(args + ["-o", str(theirs)]) == 0
    jerr = capsys.readouterr().err
    assert ours.read_bytes() == theirs.read_bytes()
    rows = ours.read_text().splitlines()
    assert rows[0] == cli.HEADER.rstrip("\n") and len(rows) > 300
    assert {r.split("\t")[0] for r in rows[1:]} == {"read0", "read2", "read4"}
    summary = [ln for ln in err.splitlines() if ln.startswith("[eventalign]")]
    assert summary == [ln for ln in jerr.splitlines() if ln.startswith("[eventalign]")]
    assert summary == [f"[eventalign] 4 reads, {len(rows) - 1} aligned event-kmer pairs"]
    assert "WARNING: no raw signal for read read1, skipped" in err
    assert err.splitlines()[-1].startswith("Kernel time: ")
    # stdout, and -b without -g refused, as by the JAX CLI (the eventalign
    # mode needs the genome)
    assert cli.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out.encode() == ours.read_bytes()
    with pytest.raises(SystemExit):
        cli.main(args + ["--device", "cpu", "-b", "x.bam"])
    assert "-b requires -g" in capsys.readouterr().err


def test_cli_batches_by_reads_and_bases(tmp_path, capsys):
    """f5c's batches: a batch ends at -K reads or once its bases reach -B;
    the output bytes and the summary line do not depend on the batching."""
    recs = [(f"r{i}", "A" * n, None) for i, n in enumerate([100, 50, 300, 10, 10, 10])]
    sizes = lambda k, b: [[r[0] for r in bt] for bt in cli.batches(iter(recs), k, b)]
    assert sizes(512, 10**9) == [["r0", "r1", "r2", "r3", "r4", "r5"]]
    assert sizes(2, 10**9) == [["r0", "r1"], ["r2", "r3"], ["r4", "r5"]]
    assert sizes(512, 150) == [["r0", "r1"], ["r2"], ["r3", "r4", "r5"]]
    assert list(cli.batches(iter([]), 4, 100)) == []
    assert [cli.parse_bases(v) for v in ("2.0M", "3.7M", "500k", "1234", "1G")] == [
        2_000_000, 3_700_000, 500_000, 1234, 1_000_000_000]
    fa, npz, model_tsv = _cli_inputs(tmp_path, seed=35)
    args = ["--reads", str(fa), "--raw", str(npz), "--model", str(model_tsv), "--device", "cpu"]
    outs = []
    for extra in ([], ["-K", "2"], ["-B", "200"], ["-K", "1", "-B", "1K"]):
        assert cli.main(args + extra) == 0
        cap = capsys.readouterr()
        outs.append((cap.out, [ln for ln in cap.err.splitlines() if ln.startswith("[eventalign]")]))
    assert all(o == outs[0] for o in outs) and outs[0][1][0].startswith("[eventalign] 4 reads, ")
    for bad in (["-K", "0"], ["-B", "0"], ["-B", "lots"]):
        with pytest.raises(SystemExit):
            cli.main(args + bad)
    assert "-K and -B must be positive" in capsys.readouterr().err


def test_prepare_and_run_reads_keep_the_batch(tmp_path):
    """prepare_reads/run_reads split the CLI's work; `keep` holds the
    tensors of the batch, the fill and the walk, which equal the plain
    versions; `stats` holds every phase."""
    fa, npz, model_tsv = _cli_inputs(tmp_path, seed=31)
    model = SIG.load_pore_model(str(model_tsv))
    stats, keep = {}, {}
    prep = cli.prepare_reads(read_sequences(str(fa)), SIG.load_signals_npz(str(npz)), model,
                             stats=stats)
    assert prep.n_reads == 4 and prep.names == ["read0", "read2", "read3", "read4"]
    res = cli.run_reads(prep, model, device="cpu", stats=stats, keep=keep)
    assert set(stats) == {"events_s", "mom_s", "pack_s", "h2d_s", "fill_s", "walk_s", "d2h_s",
                          "decode_s"}
    fill = A.abea_fill_plain(keep["batch"])
    assert all(torch.equal(fill[k], keep["fill"][k]) for k in fill)
    walk = A.abea_walk_plain(keep["batch"], fill)
    assert all(torch.equal(walk[k], keep["walk"][k]) for k in walk)
    for seq, ev, sc, sh, got in zip(prep.seqs, prep.events, prep.scales, prep.shifts, res):
        assert got == AO.align(seq, ev["mean"], model, sc, sh)
    assert res[2] == [] and all(res[r] for r in (0, 1, 3))
    buf = io.StringIO()
    assert cli.emit(prep, res, model, buf) == sum(len(r) for r in res)
    assert cli.run_reads(cli.prepare_reads([], {}, model), model, device="cpu") == []


def test_convert_carries_jax_model_and_batch(tmp_path, model):
    fa, npz, model_tsv = _cli_inputs(tmp_path, seed=32)
    jm = JSIG.load_pore_model(str(model_tsv))
    m = abea_model_from_numpy(jm)
    own = SIG.load_pore_model(str(model_tsv))
    assert set(m) == set(own) and all(np.array_equal(m[k], own[k]) for k in own)
    assert all(v.dtype == np.float32 and v.flags.c_contiguous for v in m.values())
    with pytest.raises(ValueError, match="shape"):
        abea_model_from_numpy({k: v[:10] for k, v in jm.items()})
    with pytest.raises(ValueError, match="shape"):  # the batch prep reads the model through it
        A.prepare_batch(["ACGTACGTAC"], [np.ones(4, np.float32)],
                        {k: v[:10] for k, v in jm.items()}, [1.0], [0.0])
    seqs, evs, scales, shifts = _reads(33, model, [50, 70])
    batch_np, idx, batch = _port_batch(seqs, evs, abea_model_from_numpy(model), scales, shifts)
    assert {k: v.dtype for k, v in batch.items()} == {
        "ev": torch.float32, "gm": torch.float32, "stdv": torch.float32,
        "lstdv": torch.float32, "ev_off": torch.int64, "k_off": torch.int64,
        "band_off": torch.int64, "ne": torch.int32, "nk": torch.int32, "lp": torch.float64}
    assert batch["lp"].shape == (2, 4) and A.n_rows(batch) == sum(
        len(e) + len(s) - K + 3 for s, e in zip(seqs, evs))
    for r in range(2):
        assert batch["lp"][r].tolist() == list(JA.lp_consts_f64(len(evs[r]), len(seqs[r]) - K + 1))
        kr = A.kmer_ranks(seqs[r], K, len(seqs[r]) - K + 1)
        assert np.array_equal(kr, JA._kmer_ranks(seqs[r], K, len(seqs[r]) - K + 1))
        lo = int(batch_np["k_off"][r])
        want_gm = np.float32(scales[r]) * model["level_mean"][kr] + np.float32(shifts[r])
        assert np.array_equal(batch["gm"][lo : lo + len(kr)].numpy(), want_gm)


def test_chip_smoke_abea_generator_aligns(tmp_path, monkeypatch):
    """chip_smoke.py's abea-512 generator, cut to 4 short reads, writes a
    FASTA and signals that the port's CLI aligns; its bench reads are
    tools/abea_scale_bench.py's synth_read (same rng draws)."""
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    monkeypatch.syspath_prepend(str(REPO))
    import abea_scale_bench
    import chip_smoke

    fa, npz, model_tsv = tmp_path / "r.fa", tmp_path / "s.npz", tmp_path / "m.tsv"
    lengths = np.array([300, 420, 510, 640])
    samples = chip_smoke.write_abea_dataset(fa, npz, model_tsv, lengths, np.random.default_rng(0))
    sig = SIG.load_signals_npz(str(npz))
    assert sum(len(v) for v in sig.values()) == samples
    model = SIG.load_pore_model(str(model_tsv))
    prep = cli.prepare_reads(read_sequences(str(fa)), sig, model)
    res = cli.run_reads(prep, model, device="cpu")
    assert prep.n_reads == 4 and sum(1 for r in res if r) >= 3
    assert res[0] == AO.align(prep.seqs[0], prep.events[0]["mean"], model, prep.scales[0],
                              prep.shifts[0])
    a = np.random.default_rng(17)
    b = np.random.default_rng(17)
    ma, mb = chip_smoke.synth_model(a), abea_scale_bench.synth_model(b)
    assert all(np.array_equal(ma[k], mb[k]) for k in ma)
    for n in (500, 1200):
        sa, ea = chip_smoke.synth_read(a, ma, n)
        sb, eb = abea_scale_bench.synth_read(b, mb, n)
        assert sa == sb and np.array_equal(ea, eb)


def test_peaks_batch_equals_oracle_detector_on_random_tracks(monkeypatch):
    """The lockstep detector against the oracle's, read by read, on random
    t-statistic tracks dense in peaks and in short-over-long resets, reads
    of unequal lengths (the lockstep's masks and skew), with the tracks
    laid out in one chunk of steps and in chunks of 64 (reads leave the
    lockstep inside and between chunks)."""
    rng = np.random.default_rng(29)
    n = np.sort(rng.integers(0, 400, 40))[::-1].copy()
    n[:2] = 400
    t1 = [(rng.random(v) * 3).astype(np.float32) for v in n]
    t2 = [(rng.random(v) * 12).astype(np.float32) for v in n]
    want = [EO.short_long_peak_detector(a, b) for a, b in zip(t1, t2)]
    assert sum(len(w) for w in want) > 1000
    for chunk in (EV.LOCKSTEP_CHUNK, 64):
        monkeypatch.setattr(EV, "LOCKSTEP_CHUNK", chunk)
        got = EV.peaks_batch(t1, t2)
        assert [g.tolist() for g in got] == want, chunk
    assert EV.peaks_batch([], []) == []


def test_detect_events_batch_gives_long_reads_to_the_per_read_loop():
    """The cost model keeps f5c's evenly spread batch in lockstep, gives the
    long-read workload's 17 reads to the per-read loop, and splits a batch
    of one long and 100 short reads; that split batch equals the oracle."""
    samples_a_base = 8.5  # the signal recipe's 3-13 samples a k-mer
    even = np.linspace(1000, 13450, 512)[::-1] * samples_a_base
    assert EV.lockstep_split(even) == 0
    long17 = np.sort(np.r_[np.linspace(10_000, 50_000, 16), 100_000])[::-1] * samples_a_base
    assert EV.lockstep_split(long17) == 17
    assert EV.lockstep_split([]) == 0
    sigs = _signals(34, [90] * 50 + [600] + [90] * 50)
    n_sorted = np.sort([len(s) for s in sigs])[::-1]
    assert 1 <= EV.lockstep_split(n_sorted) < 10  # the long read and a few more
    for s, g in zip(sigs, EV.detect_events_batch(sigs, use_native=False)):
        want = EO.detect_events(s)
        for key in ("start", "length", "mean", "stdv"):
            np.testing.assert_array_equal(g[key], want[key], err_msg=key)
