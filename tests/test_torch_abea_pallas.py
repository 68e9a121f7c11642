"""The port's abea fill and walk against the JAX package's TPU kernels run in
interpret mode on the CPU (abea_fill_bands_pallas, abea_walk_pallas), on two
short reads.  A file of its own, so that `--dist loadfile` gives this slow
interpret-mode run a worker of its own.

Tolerance: none for the integers (every move, the band move, the seed, the
walk's moves and count).  The last k-mer values, which the TPU kernel adds
through compensated f32 sums, are held within 8 ulps: tests/test_torch_abea.py
holds the port's to the oracle exactly and finds the JAX package's rounding
off it (ROADMAP queue 3).
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genomicsbench_palisade_tpu.ops import abea as JA
from genomicsbench_palisade_tpu.ops import abea_pallas as JAP
from genomicsbench_palisade_tpu_torch.convert import abea_batch_from_numpy
from genomicsbench_palisade_tpu_torch.ops import abea as A
from genomicsbench_palisade_tpu_torch.ops.oracle import abea as AO

K = AO.KMER_SIZE


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reads(model, rng, lengths):
    """tests/test_abea.py:_synth reads: ~1.8 events a k-mer."""
    seqs, evs = [], []
    for n in lengths:
        seq = "".join(rng.choice(list("ACGT"), n))
        means = []
        for i in range(n - K + 1):
            r = AO.get_kmer_rank(seq[i : i + K])
            for _ in range(max(1, int(rng.poisson(0.8)) + 1)):
                means.append(model["level_mean"][r] + rng.normal(0, model["level_stdv"][r] * 0.5))
        seqs.append(seq)
        evs.append(np.array(means, np.float32))
    return seqs, evs


def _pallas_inputs(seqs, evs, model):
    """abea_fill_bands_pallas's inputs, as align_events_batch_pallas builds
    them (tests/test_abea.py:226-264)."""
    e_buck = JA._bucket(max(len(e) for e in evs))
    k_buck = JA._bucket(max(len(s) - K + 1 for s in seqs))
    n_bands = e_buck + k_buck + 2
    tbl_len = JAP._round_up(max(e_buck, k_buck) + 2 * JAP.ALN_BANDWIDTH, JAP.LANES)
    lm, ls, lls = (model[k].astype(np.float32)
                   for k in ("level_mean", "level_stdv", "level_log_stdv"))
    rows = {"ev": [], "gm": [], "stdv": [], "lstdv": [], "lp": []}
    trim_tbl = None
    for s, e in zip(seqs, evs):
        ev_pad, ranks_pad, lp_consts, trim_vals, _ = JA._prep_read(
            s, e, JAP.ALN_BANDWIDTH, K, e_buck, k_buck)
        if trim_tbl is None:
            trim_tbl = np.zeros(JAP._round_up(len(trim_vals), JAP.LANES), np.float32)
            trim_tbl[: len(trim_vals)] = trim_vals
        for key, a in (("ev", ev_pad), ("gm", lm[ranks_pad]), ("stdv", ls[ranks_pad]),
                       ("lstdv", lls[ranks_pad])):
            row = np.zeros(tbl_len, np.float32)
            row[: len(a)] = a
            rows[key].append(row)
        rows["lp"].append(lp_consts)
    ne = np.array([len(e) for e in evs], np.int32)
    nk = np.array([len(s) - K + 1 for s in seqs], np.int32)
    return ((np.stack(rows["ev"]), np.stack(rows["gm"]), np.stack(rows["stdv"]),
             np.stack(rows["lstdv"]), ne, nk, np.stack(rows["lp"]), trim_tbl),
            n_bands, tbl_len)


def test_plain_fill_and_walk_equal_interpret_pallas():
    rng = np.random.default_rng(40)
    model = {"level_mean": rng.normal(90, 12, 4096).astype(np.float32),
             "level_stdv": (rng.random(4096) * 2 + 1).astype(np.float32)}
    model["level_log_stdv"] = np.log(model["level_stdv"]).astype(np.float32)
    seqs, evs = _reads(model, rng, [80, 57])
    args, n_bands, tbl_len = _pallas_inputs(seqs, evs, model)
    with pltpu.force_tpu_interpret_mode():
        packed = np.asarray(JAP.abea_fill_bands_pallas(*args, n_bands=n_bands, tbl_len=tbl_len))
        words = np.asarray(JAP.abea_walk_pallas(packed, args[4], args[5], n_bands=n_bands))
    cells = JAP.unpack_trace_rows(packed)

    batch_np, idx = A.prepare_batch(seqs, evs, model, [1.0, 1.0], [0.0, 0.0])
    batch = abea_batch_from_numpy(batch_np, "cpu")
    fill = A.abea_fill_plain(batch)
    walk = A.abea_walk_plain(batch, fill)
    for r in idx:
        lo, nb = int(batch_np["band_off"][r]), len(evs[r]) + len(seqs[r]) - K + 3
        tr, bll_e = fill["trace"][lo : lo + nb].numpy(), fill["bll_e"][lo : lo + nb].numpy()
        # cells 0-99: the moves; cell 100: the band move (right: bll_e stays)
        assert np.array_equal(cells[r, : nb - 2, :100], tr[2:]), f"moves of read {r}"
        assert np.array_equal(cells[r, : nb - 2, 100], (bll_e[2:] == bll_e[1:-1]).astype(np.uint8))
        # cells 104-119: the last k-mer's f32 value, 2 bits a cell
        bits = np.zeros(nb - 2, np.uint32)
        for t in range(16):
            bits |= cells[r, : nb - 2, JAP.LV_LANE0 + t].astype(np.uint32) << np.uint32(2 * t)
        got_lv, lv = fill["last_val"][lo + 2 : lo + nb].numpy(), bits.view(np.float32)
        fin = np.isfinite(lv)
        assert np.array_equal(np.isfinite(got_lv), fin) and fin.sum() > 20
        ulps = np.abs(got_lv[fin].view(np.int32).astype(np.int64) - lv[fin].view(np.int32))
        assert ulps.max() <= 8, f"last_val of read {r}: {ulps.max()} ulps"

        # the walk: count and seed in the meta rows, then 2-bit moves, 16 a word
        cnt, seed = int(words[r, -1]), int(words[r, -2])
        assert (cnt, seed) == (walk["n"][r].item(), fill["seed"][r].item())
        moves = (words[r, np.arange(cnt) >> 4].astype(np.uint32)
                 >> (2 * (np.arange(cnt) & 15)).astype(np.uint32)) & 3
        ck, ce, replay = len(seqs[r]) - K, seed, []
        for m in moves.tolist():
            replay.append((ck, ce))
            ck, ce = ck - (m != AO.FROM_U), ce - (m != AO.FROM_L)
        assert min(ck, ce) == -1
        assert replay == [tuple(p) for p in walk["pairs"][lo : lo + cnt].tolist()]
        assert cnt > 40
