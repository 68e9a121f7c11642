"""The port's abea fill and walk on reads aimed at the layouts of
csrc/abea_fill.cu (a warp a read, 4 band cells a lane, the band's ends by
shuffles, emissions a band early) and csrc/abea_walk.cu (windows of band
rows in shared memory), `chip_smoke.abea_edge_reads`: ne or nk of 1, reads
shorter than the band, stay- and skip-heavy reads, a skip run past
MAX_GAP, an all -inf last column (`chip_smoke.abea_blocked`: seed 0,
clamped offsets), the both-ends -inf parity rule, exact D/U/L and
seed-score ties, emission sums that round, D moves across window edges, a
read of many windows, batches of one read and of many, on the CPU.

The plain versions (what the CPU runs) are held to the port's oracle and to
the JAX package's scan (`abea_fill_bands`) and host traceback; the same
reads hold the kernels to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 9) and under the CPU warp
emulation (tests/test_torch_kernel_emulation.py).

Tolerance: none, except the JAX scan's last values.  Traces, band
positions, seeds and pairs are integers; last values and emission sums are
the oracle's f32 and f64 roundings, bit for bit.  The JAX scan's last
values land a few ulps off the oracle's (XLA fuses an FMA; ROADMAP queue
3), so against it only traces and band positions are compared.
"""

import functools
import math
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu.ops import abea as JA
from genomicsbench_palisade_tpu_torch.convert import abea_batch_from_numpy
from genomicsbench_palisade_tpu_torch.ops import abea as A
from genomicsbench_palisade_tpu_torch.ops.oracle import abea as AO

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the edge-case generators)

K = AO.KMER_SIZE
# the walk kernel's window of band rows
WINDOW = int(re.search(r"constexpr int kRows = (\d+);",
                       (REPO / "genomicsbench_palisade_tpu_torch" / "csrc" / "abea_walk.cu")
                       .read_text()).group(1))


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def edge():
    """Per batch of the edge reads: its reads, flat batch, plain fill and
    plain walk (numpy)."""
    torch.set_num_threads(1)
    model, batches = chip_smoke.abea_edge_reads(np.random.default_rng(0))
    out = []
    for seqs, evs, scales, shifts in batches:
        batch_np, idx = A.prepare_batch(seqs, evs, model, scales, shifts)
        assert idx == list(range(len(seqs)))
        tb = abea_batch_from_numpy(batch_np, "cpu")
        fill = A.abea_fill_plain(tb)
        walk = A.abea_walk_plain(tb, fill)
        out.append({"reads": list(zip(seqs, evs, scales, shifts)), "batch": batch_np,
                    "fill": {k: v.numpy() for k, v in fill.items()},
                    "walk": {k: v.numpy() for k, v in walk.items()}})
    return model, out


@pytest.fixture(scope="module")
def oracle(edge):
    """Per batch, per read: the oracle's fill (bands, trace, bll_e)."""
    model, batches = edge
    return [[AO.fill_bands(s, e, model, sc, sh) for s, e, sc, sh in b["reads"]] for b in batches]


def _rows(b, r, key):
    """Read r's rows of a fill output."""
    lo = int(b["batch"]["band_off"][r])
    nb = int(b["batch"]["ne"][r]) + int(b["batch"]["nk"][r]) + 2
    return b["fill"][key][lo : lo + nb]


def _pairs(b, r):
    lo, n = int(b["batch"]["band_off"][r]), int(b["walk"]["n"][r])
    return b["walk"]["pairs"][lo : lo + n].astype(np.int64)


def _seed_scores(b, r):
    """(float)(last + (ne - ei) * lp_trim) of every event ei."""
    ne, nk = int(b["batch"]["ne"][r]), int(b["batch"]["nk"][r])
    ei = np.arange(ne)
    last = _rows(b, r, "last_val")[ei + nk + 1].astype(np.float64)
    return (last + (ne - ei) * b["batch"]["lp"][r, 3]).astype(np.float32)


def _emissions(model, read, pairs):
    """The oracle's f32 emission of each pair, in walk order."""
    seq, ev, sc, sh = read
    ranks = A.kmer_ranks(seq, K, len(seq) - K + 1)[pairs[:, 0]]
    return [float(AO.log_prob_match(model["level_mean"][rk], model["level_stdv"][rk],
                                    model["level_log_stdv"][rk], ev[e], sc, sh))
            for rk, e in zip(ranks, pairs[:, 1])]


def _score_ties(model, read, fill):
    """Cells of the oracle's fill where two of its finite candidate scores
    are equal and win: D = U, or L = the larger of D and U."""
    seq, ev, sc, sh = read
    bands, _, bll_e = fill
    ne, nk = len(ev), len(seq) - K + 1
    ranks = A.kmer_ranks(seq, K, nk)
    lp_skip, lp_stay, lp_step, _ = A.lp_consts_f64(ne, nk)
    bll_k = np.arange(len(bll_e)) - 2 - bll_e
    ties = 0
    for bi in range(2, len(bll_e)):
        for o in range(100):
            ei, ki = bll_e[bi] - o, bll_k[bi] + o
            if not (0 <= ei < ne and 0 <= ki < nk):
                continue
            at = lambda band, off: bands[band, off] if 0 <= off < 100 else -np.inf  # noqa: E731
            up = at(bi - 1, bll_e[bi - 1] - (ei - 1))
            left = at(bi - 1, ki - 1 - bll_k[bi - 1])
            diag = at(bi - 2, ki - 1 - bll_k[bi - 2])
            em = np.float64(AO.log_prob_match(model["level_mean"][ranks[ki]],
                                              model["level_stdv"][ranks[ki]],
                                              model["level_log_stdv"][ranks[ki]], ev[ei], sc, sh))
            d = np.float32(np.float64(diag) + lp_step + em)
            u = np.float32(np.float64(up) + lp_stay + em)
            lft = np.float32(np.float64(left) + lp_skip)
            best = max(d, u)
            ties += bool(np.isfinite(best) and (d == u or lft == best))
    return ties


def test_edge_reads_cover_the_cases(edge, oracle):
    model, batches = edge
    b = batches[0]
    ne, nk = b["batch"]["ne"].astype(np.int64), b["batch"]["nk"].astype(np.int64)
    assert len(batches) == 2 and len(batches[1]["reads"]) == 1 and len(ne) > 1
    assert (nk == 1).any() and (ne == 1).any() and ((ne == 1) & (nk > 1)).any()
    assert (ne + nk + 2 < 100).any()  # shorter than the band
    assert (ne >= 4 * nk).any() and (nk >= 2.5 * ne).any()  # stay- and skip-heavy
    assert (b["walk"]["max_gap"] > A.MAX_GAP).any()
    # the parity rule well past the start (both ends of the band before -inf)
    parity = sum(int(np.isneginf(bands[bi - 1, 0]) and np.isneginf(bands[bi - 1, 99]))
                 for bands, _, bll_e in oracle[0] for bi in range(60, len(bll_e)))
    assert parity > 100
    # ties: cell scores (the homopolymer and the repeat), seed scores
    assert _score_ties(model, b["reads"][9], oracle[0][9]) > 0
    assert _score_ties(model, b["reads"][10], oracle[0][10]) > 0
    seed_ties = [r for r in range(len(ne)) if np.isfinite(s := _seed_scores(b, r)).any()
                 and (s == s.max()).sum() > 1]
    assert len(seed_ties) >= 3
    # an emission sum that rounds: its walk order decides its bits
    em = _emissions(model, b["reads"][21], _pairs(b, 21))
    assert math.fsum(em) != b["walk"]["sum_em"][21]
    # D moves out of a window, and a read of many windows
    crossings = 0
    for r in range(len(ne)):
        p = _pairs(b, r)
        g = b["batch"]["band_off"][r] + p[:-1, 0] + p[:-1, 1] + 2
        d = (p[:-1, 0] - p[1:, 0] == 1) & (p[:-1, 1] - p[1:, 1] == 1)
        crossings += int((d & (g % WINDOW < 2)).sum())
    assert crossings > 0
    assert (ne + nk + 2).max() > 10 * WINDOW


def test_edge_fill_equals_oracle(edge, oracle):
    """Per read: the moves, bll_e and the last k-mer's value against the
    oracle's fill, and the seed: the first event of the largest score."""
    _, batches = edge
    for b, fills in zip(batches, oracle):
        for r, (bands, trace, bll_e) in enumerate(fills):
            nk = int(b["batch"]["nk"][r])
            bi = np.arange(len(bll_e))
            off = bll_e - (bi - nk - 1)
            ok = (off >= 0) & (off < 100)
            last = np.where(ok, bands[bi, np.clip(off, 0, 99)], -np.inf).astype(np.float32)
            assert np.array_equal(_rows(b, r, "trace"), trace), r
            assert np.array_equal(_rows(b, r, "bll_e"), bll_e), r
            assert np.array_equal(_rows(b, r, "last_val"), last), r
            s = _seed_scores(b, r)
            want = int(np.argmax(s)) if np.isfinite(s).any() else 0
            assert b["fill"]["seed"][r] == want, r


def test_edge_walk_equals_oracle(edge):
    """Per read: the decoded pairs (QC drops included) against the
    oracle's `align`; the emission sum against the oracle's emissions of
    the walk's pairs added in walk order; max_gap against the longest run
    of k-mer moves between the pairs (the move that ends the walk may add
    one)."""
    model, batches = edge
    for b in batches:
        got = A.decode(b["batch"]["band_off"], b["walk"])
        for r, read in enumerate(b["reads"]):
            assert got[r] == AO.align(*read[:2], model, *read[2:]), r
            p = _pairs(b, r)
            total = 0.0
            for x in _emissions(model, read, p):
                total += x
            assert total == b["walk"]["sum_em"][r], r
            moves_l = (p[:-1, 0] - p[1:, 0] == 1) & (p[:-1, 1] == p[1:, 1])
            runs = np.diff(np.flatnonzero(np.r_[True, ~moves_l, True])) - 1
            assert 0 <= b["walk"]["max_gap"][r] - runs.max() <= 1, r
    assert any(got) and not all(A.decode(batches[0]["batch"]["band_off"], batches[0]["walk"]))


def _jax_fill(seq, ev, model, scale, shift):
    """JAX abea_fill_bands (the scan) of one read: trace and bll_e of its
    bands 2 .. nb-1."""
    e_buck, k_buck = JA._bucket(len(ev)), JA._bucket(len(seq) - K + 1)
    ev_pad, ranks_pad, lp_consts, trim_vals, _ = JA._prep_read(seq, ev, 100, K, e_buck, k_buck)
    fill = jax.jit(functools.partial(JA.abea_fill_bands, n_bands_pad=e_buck + k_buck + 2))
    tr, bes, _, _ = fill(ev_pad, ranks_pad, len(ev), len(seq) - K + 1,
                         model["level_mean"], model["level_stdv"], model["level_log_stdv"],
                         np.float32(scale), np.float32(shift), lp_consts, trim_vals)
    nb = len(ev) + len(seq) - K + 3
    return np.asarray(tr)[: nb - 2], np.asarray(bes)[: nb - 2]


def test_edge_fill_equals_jax_scan(edge):
    """Traces and band positions against the JAX package's scan, read by
    read (its last values are a few ulps off the oracle's: not compared)."""
    model, batches = edge
    for b in batches:
        for r, read in enumerate(b["reads"]):
            tr, bes = _jax_fill(*read[:2], model, *read[2:])
            assert np.array_equal(_rows(b, r, "trace")[2:], tr), r
            assert np.array_equal(_rows(b, r, "bll_e")[2:], bes), r


def test_edge_walk_equals_jax_traceback(edge):
    """The decoded pairs against the JAX package's numpy traceback on the
    same fill, QC drops included."""
    model, batches = edge
    for b in batches:
        seqs, evs, scales, shifts = (list(v) for v in zip(*b["reads"]))
        rows = [lambda key, r=r: _rows(b, r, key)[2:] for r in range(len(seqs))]
        want = JA._traceback_batch(
            seqs, evs, model, scales, shifts, [g("trace") for g in rows],
            [g("bll_e") for g in rows], [g("last_val").astype(np.float64) for g in rows],
            [A.kmer_ranks(s, K, len(s) - K + 1) for s in seqs], 100, K, use_native=False)
        assert A.decode(b["batch"]["band_off"], b["walk"]) == want


def test_blocked_batch_seeds_at_zero_and_clamps(edge):
    """chip_smoke.abea_blocked: every cell but the origin -inf, so every
    read's seed is 0 and its walk clamps offsets outside the band; the
    plain versions against the oracle's walk rules on that fill (the oracle
    makes its own penalties, so it cannot fill such a batch)."""
    _, batches = edge
    blocked = chip_smoke.abea_blocked(batches[0]["batch"])
    tb = abea_batch_from_numpy(blocked, "cpu")
    fill = {k: v.numpy() for k, v in A.abea_fill_plain(tb).items()}
    walk = {k: v.numpy() for k, v in A.abea_walk_plain(tb, {k: torch.from_numpy(v) for k, v
                                                           in fill.items()}).items()}
    b = {"batch": blocked, "fill": fill, "walk": walk}
    assert not np.isfinite(fill["last_val"]).any() and not fill["seed"].any()
    assert (fill["trace"] == AO.FROM_L).sum() > 10_000  # -inf ties go to L
    for r in range(len(blocked["ne"])):
        assert not np.isfinite(_seed_scores(b, r)).any()
        p = _pairs(b, r)
        off = _rows(b, r, "bll_e")[p[:, 1] + p[:, 0] + 2] - p[:, 1]
        # from (nk - 1, 0): one step unless nk = 1 (the last row is the seed's)
        assert (p[0] == [blocked["nk"][r] - 1, 0]).all()
        if blocked["nk"][r] > 100:
            assert ((off < 0) | (off > 99)).any(), r
