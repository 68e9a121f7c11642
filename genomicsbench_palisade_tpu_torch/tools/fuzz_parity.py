"""Randomized parity sweep: every engine of the port against its oracle.

    python -m genomicsbench_palisade_tpu_torch.tools.fuzz_parity [--seconds 300]
        [--seed 0] [--device cpu]

Counterpart of tools/fuzz_parity.py, with its 14 suites and generators.
The JAX tool forces the CPU; this one runs on the entry's device, so on the
card the device suites send random shapes through the hand-written
kernels, and on the CPU (`--device cpu`) through their plain versions:
  bsw -> bsw_extend (ql and tl from 1), chain -> chain_dp, phmm-pallas ->
  phmm_forward_f32 (high-likelihood subsequence pairs: the data that exposed
  the padded-row inf/NaN poisoning of the Pallas kernel), abea-tb and
  abea-fill -> abea_fill and abea_walk, phmm-f64 -> phmm_forward_f64,
  kmer-engines -> the device counter (one-shot and streamed), poa-native
  and poa-align-engine -> the device aligner.
The native suites (minimizers, dbg, poa-native, ctc-beam, fmi,
pileup-region, and the host engines beside the device paths) run the
port's `io.native` engines.  The port builds native/ on every host, so a
missing library raises: no suite passes without comparing.

Rounds of every suite run until `--seconds` pass; the first round always
runs whole, so every suite compares at least once.  Prints one
`FAIL <suite>: ...` line a failure and `OK   <suite>: <n> rounds` a suite;
returns 1 on any failure.
"""

from __future__ import annotations

import argparse
import pathlib
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from .. import default_device
from ..convert import bsw_batch_from_numpy
from ..index.builder import build_arrays
from ..io import bam as B
from ..io import native as N
from ..models import bonito as BM
from ..ops import abea as A
from ..ops import bsw as W
from ..ops import chain as C
from ..ops import dbg as DBG
from ..ops import kmer as K
from ..ops import phmm as P
from ..ops import poa as POA
from ..ops.oracle import abea as AO
from ..ops.oracle import bsw as WO
from ..ops.oracle import chain as CO
from ..ops.oracle import fmi as FO
from ..ops.oracle import kmer as KO
from ..ops.oracle import phmm as PHO
from ..ops.oracle import poa as PO
from ..ops.phmm_f64 import phmm_forward_f64_native
from ..ops.pileup import calculate_pileup, calculate_pileup_region

PHMM_ORACLE_PAIRS = 4  # pairs of a phmm-pallas round held to the Python oracle too


def fuzz_bsw(rng, dev):
    pairs = []
    for _ in range(8):
        ql, tl = int(rng.integers(1, 90)), int(rng.integers(1, 150))
        pairs.append((rng.integers(0, 5, ql), rng.integers(0, 5, tl),
                      int(rng.integers(0, 120))))
    batch, params = bsw_batch_from_numpy(W.prepare_pairs(pairs, q_pad=128, t_pad=192), dev)
    got = W.bsw_extend(batch, params).cpu().numpy()
    for i, (q, t, h0) in enumerate(pairs):
        want = WO.scalar_banded_swa(q, t, h0)
        for row, key in enumerate(W.OUT_ORDER):
            assert got[row, i] == want[key], (key, i, int(got[row, i]), want[key])


def fuzz_chain(rng, dev):
    n = int(rng.integers(2, 300))
    xs = np.cumsum(rng.integers(1, 60, n)).astype(np.int64) + 500
    ys = np.maximum(xs + rng.integers(-400, 400, n), 0).astype(np.int64)
    q = float(rng.uniform(3, 45))
    call = CO.ChainCall(n=n, avg_qspan=q, max_dist_x=5000, max_dist_y=5000,
                        bw=500, n_segs=1, x=xs.astype(np.uint64),
                        y=ys.astype(np.uint64))
    want = CO.chain_dp(call)
    prep = C.prepare_call(xs.astype(np.uint64), ys.astype(np.uint64), q)
    scores, parents, peaks = C.chain_call(prep, dev)
    np.testing.assert_array_equal(scores, want["scores"])
    np.testing.assert_array_equal(parents, want["parents"])
    np.testing.assert_array_equal(peaks, want["peak_scores"])


def fuzz_fmi(rng, dev):
    genome = rng.integers(0, 4, int(rng.integers(200, 3000))).astype(np.uint8)
    didx = build_arrays(genome, device=dev)
    oidx = FO.build_index("".join("ACGT"[c] for c in genome))
    b, rl = 6, int(rng.integers(25, 80))
    enc = np.full((b, rl), 4, np.int8)
    for i in range(b):
        s = int(rng.integers(0, len(genome) - rl))
        r = genome[s : s + rl].astype(np.int8)
        mut = rng.random(rl) < 0.05
        r[mut] = rng.integers(0, 5, int(mut.sum()))
        enc[i] = r
    _allm, n1, n2, n3 = N.fmi_search_native(didx, enc, np.full(b, rl, np.int32))
    split_len = int(19 * 1.5 + 0.499)
    want_n1 = want_n2 = want_n3 = 0
    for i in range(b):
        er = enc[i].astype(np.int64)
        m1 = FO.get_smems_all_pos(oidx, er, 1, 19)
        want_n1 += len(m1)
        for m in m1:  # reseed in emit order (fmi.cpp phase 2)
            if (m["n"] + 1 - m["m"]) >= split_len and m["s"] <= 10:
                mid = (m["n"] + 1 + m["m"]) >> 1
                want_n2 += len(FO.get_smems_one_pos(oidx, er, mid, m["s"] + 1, 19)[0])
        want_n3 += len(FO.bwt_seed_strategy_one_read(oidx, er, 20, 20))
    assert (n1, n2, n3) == (want_n1, want_n2, want_n3), (
        (n1, n2, n3), (want_n1, want_n2, want_n3))


def fuzz_minimizers(rng, dev):
    reads = [rng.integers(0, 4, int(rng.integers(18, 300))).astype(np.uint8)
             for _ in range(int(rng.integers(1, 5)))]
    k = int(rng.choice([7, 15, 17]))
    w = int(rng.choice([1, 3, 5, 8]))
    got = N.minimizer_counts_native(reads, k, w, 0)
    want = Counter()
    for codes in reads:
        if len(codes) - k <= 0:
            continue
        for _p, fwd in KO.yield_minimizers(codes, k, w):
            rc = KO.revcomp_code(fwd, k)
            want[min(fwd, rc)] += 1
    assert got == dict(want)


def fuzz_dbg(rng, dev):
    ln = int(rng.integers(100, 400))
    ref = "".join(rng.choice(list("ACGTN"), p=[.24, .24, .24, .24, .04], size=ln))
    reads = []
    for _ in range(int(rng.integers(1, 15))):
        s = int(rng.integers(0, max(ln - 50, 1)))
        seq = list(ref[s : s + 50].replace("N", "A"))
        for pos in np.nonzero(rng.random(len(seq)) < 0.06)[0]:
            seq[pos] = "ACGTN"[rng.integers(0, 5)]
        reads.append(("".join(seq), rng.integers(5, 41, len(seq)).astype(np.uint8),
                      0x200 if rng.random() < 0.1 else 0))
    g, bubbles = DBG.assemble_window(ref, 1, reads, kmer_size=15, min_qual=20, min_reads=2)
    nat = N.dbg_window_native(ref, 1, reads, 15, 20, 2)
    assert nat == (len(g.nodes), [DBG.path_sequence(p, 15) for p in bubbles])


def fuzz_poa_native(rng, dev):
    """The native graph (align, add, consensus) against the oracle's graph
    grown by the device aligner."""
    base = "".join(rng.choice(list("ACGT"), int(rng.integers(25, 90))))
    seqs = []
    for _ in range(int(rng.integers(2, 6))):
        s = []
        for ch in base:
            u = rng.random()
            if u < 0.05:
                continue
            s.append(ch if u > 0.13 else "ACGT"[rng.integers(0, 4)])
            if u > 0.95:
                s.append("ACGT"[rng.integers(0, 4)])
        seqs.append("".join(s) or "A")
    gn, gp = POA.NativePoaGraph(), PO.PoaGraph()
    for s in seqs:
        an = gn.align(s)
        ap = POA.align_batch([gp], [s], device=dev)[0]
        assert an == ap
        gn.add_alignment(an, s)
        gp.add_alignment(ap, s)
    assert gn.n_nodes() == len(gp.nodes)
    assert gn.generate_consensus() == gp.generate_consensus()


def fuzz_ctc(rng, dev):
    t = int(rng.integers(2, 50))
    logits = rng.normal(0, float(rng.uniform(0.5, 3.0)), (t, 5))
    lp = np.log(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    nat = N.ctc_beam_native(lp, 5, 1e-3)
    py = BM.beam_search_decode(lp, use_native=False)
    assert "".join(BM.DEFAULT_ALPHABET[c] for c in nat) == py


def _random_model(rng):
    model = {"level_mean": rng.normal(90, 12, 4096).astype(np.float32),
             "level_stdv": (rng.random(4096) * 2 + 1).astype(np.float32)}
    model["level_log_stdv"] = np.log(model["level_stdv"]).astype(np.float32)
    return model


def fuzz_abea_tb(rng, dev):
    """The fill and walk (kernels on the card) with their decode, the host
    walk of the same fill (native/abea_tb.cpp) and the oracle."""
    k = 6
    model = _random_model(rng)
    seqs, evs = [], []
    for _ in range(3):
        seq = "".join(rng.choice(list("ACGT"), int(rng.integers(40, 110))))
        raw = []
        for p in range(len(seq) - k + 1):
            r = AO.get_kmer_rank(seq[p : p + k])
            raw.extend(model["level_mean"][r] + rng.normal(0, 0.5, int(rng.integers(1, 3))))
        seqs.append(seq)
        evs.append(np.array(raw, np.float32))
    ones, zeros = [1.0] * 3, [0.0] * 3
    keep = {}
    dev_pairs = A.align_events_batch(seqs, evs, model, ones, zeros, dev, keep=keep)
    host_pairs = A.traceback_host(seqs, evs, model, ones, zeros, keep["fill"])
    want = [AO.align(s, e, model, 1.0, 0.0) for s, e in zip(seqs, evs)]
    assert dev_pairs == host_pairs == [list(map(tuple, w)) for w in want]


def fuzz_phmm_pallas(rng, dev):
    """The f32 forward pass at r_pad 64, h_pad 128 on HIGH-LIKELIHOOD
    subsequence pairs, the data class that exposed the padded-row inf/NaN
    poisoning (multiply- vs where-gated result accumulation) of the Pallas
    kernel; random-vs-random pairs never trigger it.  Every raw sum equals
    the plain version's on the host, and PHMM_ORACLE_PAIRS of them the
    GKL oracle's (ops.oracle.phmm), bit for bit."""
    reads, haps, pairs = [], [], []
    for i in range(128):
        rl = int(rng.integers(8, 60))
        hl = int(rng.integers(rl + 2, 96))
        hap = rng.integers(0, 4, hl)
        start = int(rng.integers(0, hl - rl))
        read = hap[start : start + rl].copy()
        noise = rng.random(rl) < 0.05
        read[noise] = rng.integers(0, 4, int(noise.sum()))
        reads.append({"bases": read,
                      "q": rng.integers(20, 62, rl),
                      "i": rng.integers(20, 62, rl),
                      "d": rng.integers(20, 62, rl),
                      "c": rng.integers(20, 62, rl)})
        haps.append(hap)
        pairs.append((i, i))
    batch = P.prepare_batch(reads, haps, pairs, r_pad=64, h_pad=128)
    got = P.forward_raw(P.as_device_batch(batch, dev), torch.float32).cpu().numpy()
    plain = P.forward_raw(P.as_device_batch(batch, "cpu"), torch.float32).numpy()
    assert np.array_equal(got, plain, equal_nan=True), np.nonzero(
        got.view(np.int32) != plain.view(np.int32))[0][:8]
    assert np.isfinite(got).all()
    for i in rng.choice(len(reads), PHMM_ORACLE_PAIRS, replace=False).tolist():
        r = reads[i]
        want = PHO.compute_full_prob(r["bases"], haps[i], r["q"], r["i"], r["d"], r["c"])
        assert got[i].tobytes() == np.float32(want).tobytes(), (i, got[i], want)


def fuzz_kmer_engines(rng, dev):
    """count_kmers (one-shot device) vs count_kmers_batched (streamed
    accumulator) vs count_kmers_host (native hash) vs the oracle: random
    coverage reads with errors, random batch sizes crossing kmer runs."""
    genome = rng.integers(0, 5, int(rng.integers(8_000, 30_000))).astype(np.uint8)
    genome = np.where(genome >= 4, 3, genome).astype(np.uint8)
    reads = []
    for _ in range(int(rng.integers(4, 24))):
        ln = int(rng.integers(5_100, 6_500))
        if ln >= len(genome):
            ln = len(genome) - 1
        s = int(rng.integers(0, len(genome) - ln))
        r = genome[s : s + ln].copy()
        mut = rng.random(ln) < 0.01
        r[mut] = rng.integers(0, 4, int(mut.sum()))
        reads.append(r)
    want = K.count_kmers(reads, device=dev)
    got_b = K.count_kmers_batched(reads, batch_bases=int(rng.integers(8_000, 40_000)),
                                  cap=1 << 18, device=dev)
    assert got_b == want, (got_b, want)
    got_h = K.count_kmers_host(reads)
    assert got_h == want, (got_h, want)
    oracle = KO.count_kmers(["".join("ACGT"[c] for c in r.tolist()) for r in reads])
    assert (want["total_kmers"], want["hash_size"], want["occurrences"]) == (
        oracle["total_kmers"], oracle["hash_size"], sum(oracle["counter"].values()))


def fuzz_poa_align_engine(rng, dev):
    """The native convex align engine (poaalign.cpp) and the device aligner
    against the oracle's convex_align, all three alignment types."""
    base = "".join(rng.choice(list("ACGT"), int(rng.integers(20, 120))))
    g, gn = PO.PoaGraph(), POA.NativePoaGraph()
    for _ in range(int(rng.integers(2, 5))):
        s = "".join(ch for ch in base if rng.random() > 0.08) or "A"
        at = ("nw", "sw", "ov")[int(rng.integers(3))]
        a_or = PO.convex_align(s, g, align_type=at)
        assert gn.align(s, align_type=at) == a_or
        assert POA.align_batch([g], [s], align_type=at, device=dev)[0] == a_or
        grow = a_or if at == "nw" else PO.convex_align(s, g)
        g.add_alignment(grow, s)
        gn.add_alignment(grow, s)


def fuzz_abea_fill(rng, dev):
    """The native banded fill (abeafill.cpp) and the device fill and walk
    against the oracle, QC drops included."""
    model = _random_model(rng)
    seq = "".join(rng.choice(list("ACGT"), int(rng.integers(40, 300))))
    ev = []
    for i in range(len(seq) - 5):
        r = AO.get_kmer_rank(seq[i:i + 6])
        lv = model["level_mean"][r]
        noise = 0.5 if rng.random() < 0.8 else 20.0
        ev.extend(lv + rng.normal(0, noise, int(rng.integers(1, 4))))
    ev = np.asarray(ev, np.float32)
    sc = float(rng.uniform(0.85, 1.15))
    sh = float(rng.uniform(-3, 3))
    want = AO.align(seq, ev, model, sc, sh)
    assert A.align_events_batch_native([seq], [ev], model, [sc], [sh])[0] == want
    assert A.align_events_batch([seq], [ev], model, [sc], [sh], dev)[0] == want


def fuzz_phmm_f64(rng, dev):
    """The double pass (the f64 kernel on the card) against the native
    double pass on the host, bit for bit."""
    reads, haps, pairs = [], [], []
    for k in range(8):
        rl = int(rng.integers(4, 100))
        reads.append({"bases": rng.integers(0, 5, rl),
                      "q": rng.integers(6, 60, rl),
                      "i": rng.integers(20, 50, rl),
                      "d": rng.integers(20, 50, rl),
                      "c": rng.integers(5, 30, rl)})
        haps.append(rng.integers(0, 5, int(rng.integers(5, 250))))
        pairs.append((k, k))
    batch = P.prepare_batch(reads, haps, pairs)
    got = P.forward_raw(P.as_device_batch(batch, dev), torch.float64).cpu().numpy()
    np.testing.assert_array_equal(got, phmm_forward_f64_native(batch))


def fuzz_pileup_region(rng, dev):
    """Fused native region pileup vs the record-object path (native and
    numpy events) on a synthetic indexed BAM (random cigars incl. I/D/S,
    both strands)."""
    ref_len = int(rng.integers(300, 2000))
    idx16 = {c: i for i, c in enumerate(B.SEQ_NT16_STR)}
    genome = "".join(rng.choice(list("ACGT"), ref_len))
    rows = []
    n = int(rng.integers(5, 40))
    positions = np.sort(rng.integers(0, max(1, ref_len - 80), n))
    for i, p in enumerate(positions):
        L = int(rng.integers(20, 70))
        seq = list(genome[p:p + L])
        cig = [("M", len(seq))]
        u = rng.random()
        if u < 0.3 and len(seq) > 12:
            at = int(rng.integers(4, len(seq) - 4))
            ins = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 5))))
            seq = seq[:at] + list(ins) + seq[at:]
            cig = [("M", at), ("I", len(ins)), ("M", len(seq) - at - len(ins))]
        elif u < 0.5 and len(seq) > 14:
            x = int(rng.integers(4, len(seq) // 2))
            d = int(rng.integers(1, 5))
            seq = seq[:x] + seq[x + d:]
            cig = [("M", x), ("D", d), ("M", len(seq) - x)]
        elif u < 0.65 and len(seq) > 10:
            sc = int(rng.integers(1, 5))
            cig = [("S", sc), ("M", len(seq) - sc)]
        rows.append(B.BamRecord(
            name=f"r{i}", flag=16 if rng.random() < 0.5 else 0, ref_id=0,
            pos=int(p), mapq=int(rng.integers(0, 60)),
            cigar=cig,
            seq_nt16=np.array([idx16[c] for c in seq], np.uint8),
            qual=rng.integers(1, 40, len(seq)).astype(np.uint8), tags={}))
    with tempfile.TemporaryDirectory() as td:
        bam = pathlib.Path(td) / "f.bam"
        B.write_bam(str(bam), [("tig1", ref_len)], rows)
        B.build_bai(str(bam))
        index = B.read_bai(str(bam) + ".bai")
        beg = int(rng.integers(0, ref_len // 2))
        end = int(rng.integers(beg + 50, ref_len + 1))
        _refs, recs = B.read_bam_region(str(bam), "tig1", beg, end, index=index)
        got = calculate_pileup_region(str(bam), "tig1", beg, end, index=index)
        for native_events in (True, False):
            want = calculate_pileup(recs, 0, beg, end, native_events=native_events)
            for key in ("major", "minor", "matrix"):
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


SUITES = [
    ("bsw", fuzz_bsw), ("chain", fuzz_chain), ("fmi", fuzz_fmi),
    ("minimizers", fuzz_minimizers), ("dbg", fuzz_dbg),
    ("poa-native", fuzz_poa_native), ("ctc-beam", fuzz_ctc),
    ("abea-tb", fuzz_abea_tb), ("phmm-pallas", fuzz_phmm_pallas),
    ("kmer-engines", fuzz_kmer_engines),
    ("poa-align-engine", fuzz_poa_align_engine),
    ("abea-fill", fuzz_abea_fill), ("phmm-f64", fuzz_phmm_f64),
    ("pileup-region", fuzz_pileup_region),
]


def run(seconds: float, seed: int, device):
    """Rounds of the suites until `seconds` have passed (the first round
    whole).  Returns ({suite: rounds passed}, [failure lines])."""
    rng = np.random.default_rng(seed)
    counts = {name: 0 for name, _ in SUITES}
    failures = []
    deadline = time.time() + seconds
    first = True
    while first or time.time() < deadline:
        for name, fn in SUITES:
            try:
                fn(rng, device)
                counts[name] += 1
            except Exception as e:  # noqa: BLE001 -- report and continue
                failures.append(f"FAIL {name}: {type(e).__name__}: {str(e)[:200]}")
                print(failures[-1], flush=True)
            if not first and time.time() >= deadline:
                break
        first = False
    return counts, failures


def main(argv=None):
    ap = argparse.ArgumentParser(prog="fuzz_parity")
    ap.add_argument("--seconds", type=float, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default: the kernels on the card) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    counts, failures = run(args.seconds, args.seed, default_device(args.device))
    for name, c in counts.items():
        print(f"OK   {name}: {c} rounds")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
