"""Per-kernel throughput suite on one card.

    python -m genomicsbench_palisade_tpu_torch.tools.bench_all [--device cpu]

Counterpart of tools/bench_all.py: one JSON line a bench, with the JAX
tool's keys, shapes and seeds (default_rng 0, 1, 2, 3, 4 and 41, 9, 12, 6,
7, 5):
  phmm   GCUPS: `csrc/phmm_forward.cu` (f32) on 2048 x (250x302), r_pad 256,
         h_pad 320
  bsw    pairs/s and GCUPS: `csrc/bsw_extend.cu` on 8192 x (128x256)
  chain  anchors/s: `csrc/chain_dp.cu` on 128 calls of 4096 anchors,
         windows 64 back; `mixed_batch_ok`: calls of avg_qspan 18.5, 25.0,
         31.25 and 22.0 through `ops.chain.chain_calls` equal the oracle
  kmer   Mbases/s: the device counter on 512 reads of 5,500 bases (k 17)
  fmi    reads/s: the device pipeline on 512 reads of 101 bp over a 5 Mbp
         index; the native host engine on the same (`host_reads_per_s`)
         and on a 64 Mbp index (`host_genome_reads_per_s`)
  poa    seqs/s: 32 windows of 6 x 200 bases on the device, and on the
         native host engine (`host_seqs_per_s`; the same consensus)
  abea   reads/s: 64 reads of 500 bases through the fill and walk kernels,
         and the native host engine (`host_reads_per_s`; the same pairs)
  pileup Mbases/s: host counting, 2,000 x 300 bp over a 60 kb region
  dbg    Mb-ref/s: the native window engine, 24 windows of 1,500 bases
  grm    TFLOP/s: `ops.grm.grm_device` (IEEE f32) on 32,768 x 2,048, block
         8,192
Each bench takes its shape as keyword arguments (the JAX values by
default).  Timing follows the JAX tool's protocol, "chain ITERS
executions, fetch one output", best of 3; on a card the calls are
bracketed by synchronisations.  The 64 Mbp index is cached, uncompressed,
under build/ beside the package (`bench_fmi_idx64.npz`; building it takes
seconds on the card, and compressing it tens of seconds).  A bench that
raises prints the JAX tool's `{"kernel": ..., "error": ...}` line; the
tool then returns 1 (the JAX tool returns 0).  `bench` (tools/bench.py)
runs all but phmm after its flagship measurement.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import default_device
from ..convert import bsw_batch_from_numpy, chain_arrays, fmi_index_from_numpy, \
    kmer_batch_from_numpy
from ..index import builder as IB
from ..index import fmi_index as FI
from ..io.bam import BamRecord
from ..io.native import dbg_window_native, fmi_search_native
from ..ops import bsw as W
from ..ops import chain as C
from ..ops import fmi_pipeline as FP
from ..ops import grm as G
from ..ops import kmer as K
from ..ops import phmm as P
from ..ops.abea import align_events_batch
from ..ops.oracle import chain as CO
from ..ops.oracle.abea import get_kmer_rank
from ..ops.pileup import calculate_pileup
from ..ops.poa import msa_consensus_batch, msa_consensus_host
from .abea_scale_bench import synth_model
from .grm_sweep import genotypes

CACHE_DIR = Path(__file__).resolve().parents[2] / "build"


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(fn, fetch, device, iters=10, repeats=3):
    """Best over `repeats` of the mean seconds of `iters` calls in a row,
    one output fetched at the end, after one warm call (fetched)."""
    fetch(fn())
    best = math.inf
    for _ in range(repeats):
        sync(device)
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn()
        fetch(out)
        sync(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def _timeit_host(fn, iters=1, repeats=3):
    """(the best over `repeats` of the mean seconds of `iters` calls, the
    last result) for a call whose result is on the host when it returns."""
    fn()
    best, out = math.inf, None
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best, out


# ---------------------------------------------------------------- phmm


def phmm_cases(rng, b, rl, hl):
    """b testcases: a random hap of hl bases, its first rl as the read,
    quals 36-59 (reads, haps, pairs)."""
    reads, haps, pairs = [], [], []
    for i in range(b):
        hap = rng.integers(0, 4, hl)
        reads.append({"bases": hap[:rl].copy(), "q": rng.integers(36, 60, rl),
                      "i": rng.integers(36, 60, rl), "d": rng.integers(36, 60, rl),
                      "c": rng.integers(36, 60, rl)})
        haps.append(hap)
        pairs.append((i, i))
    return reads, haps, pairs


def bench_phmm(b=2048, rl=250, hl=302, r_pad=256, h_pad=320, device=None):
    device = default_device(device)
    batch = P.prepare_batch(*phmm_cases(np.random.default_rng(0), b, rl, hl),
                            r_pad=r_pad, h_pad=h_pad)
    tb = P.as_device_batch(batch, device)
    dt = _timeit(lambda: P.forward_raw(tb, torch.float32), lambda o: o[:1].cpu(), device)
    return {"kernel": "phmm", "value": round(b * rl * hl / dt / 1e9, 3), "unit": "GCUPS",
            "batch": b}


# ---------------------------------------------------------------- bsw


def bsw_pairs(rng, b, ql, tl):
    """b pairs: a random target of tl bases, the query its first ql with 8%
    mutations, h0 20-59."""
    pairs = []
    for _ in range(b):
        t = rng.integers(0, 4, tl)
        q = t[:ql].copy()
        mut = rng.random(ql) < 0.08
        q[mut] = rng.integers(0, 4, int(mut.sum()))
        pairs.append((q, t, int(rng.integers(20, 60))))
    return pairs


def bench_bsw(b=8192, ql=128, tl=256, device=None):
    device = default_device(device)
    pairs = bsw_pairs(np.random.default_rng(1), b, ql, tl)
    tb, params = bsw_batch_from_numpy(W.prepare_pairs(pairs, q_pad=ql, t_pad=tl), device)
    dt = _timeit(lambda: W.bsw_extend(tb, params, q_max=ql), lambda o: o[0, :1].cpu(), device)
    return {"kernel": "bsw", "value": round(b / dt, 1), "unit": "pairs/s",
            "gcups": round(b * ql * tl / dt / 1e9, 3), "batch": b}


# ---------------------------------------------------------------- chain


def slope_feasible(gap_table, bw: int, shift: int = 20) -> bool:
    """Whether the gap table has the TPU kernel's exact fixed-point form,
    gap_table[dd] = gap_table[0] + (dd * m >> shift) + (ilog2(dd) >> 1) for
    one integer m < 2^22 (the `ok` of the JAX package's
    ops/chain_pallas.gap_fixed_point).  The port's kernel reads the table
    and needs no slope; the bench keeps the JAX draws, which skip such
    tables."""
    dd = np.arange(bw + 1, dtype=np.int64)
    ilog = np.zeros(bw + 1, np.int64)
    ilog[1:] = np.floor(np.log2(dd[1:])).astype(np.int64)
    table = np.asarray(gap_table, np.int64)
    lin = table - table[0] - (ilog >> 1)
    if lin[0] != 0 or np.any(np.diff(lin) < 0):
        return False
    d = dd[1:]
    lo = int(np.max(-(-(lin[1:] << shift) // d)))
    hi = int(np.min((((lin[1:] + 1) << shift) - 1) // d))
    m = max(lo, 0)
    return bool(lo <= hi and m < (1 << 22) and np.all((dd * m) >> shift == lin))


def chain_anchors(rng, n):
    """x steps of 1-39, y within 200 of x (int64)."""
    xs = np.cumsum(rng.integers(1, 40, n)).astype(np.int64)
    return xs, np.maximum(xs + rng.integers(-200, 200, n), 0)


def chain_bench_calls(rng, n, n_calls):
    """n_calls prepare_call dicts of n anchors, avg_qspan 14-40, the draws
    whose gap table has no fixed-point slope skipped (as the JAX bench
    skips them)."""
    calls = []
    while len(calls) < n_calls:
        xs, ys = chain_anchors(rng, n)
        c = C.prepare_call(xs, ys, avg_qspan=float(rng.uniform(14, 40)))
        if slope_feasible(c["gap_table"], c["bw"]):
            calls.append(c)
    return calls


def bench_chain(n=4096, n_calls=128, w=64, nm=256, device=None):
    device = default_device(device)
    rng = np.random.default_rng(2)
    calls = chain_bench_calls(rng, n, n_calls)
    arrays, params = chain_arrays([C.window_clamp(c, w) for c in calls])
    batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    dt = _timeit(lambda: C.chain_dp(batch, params), lambda o: o[0, :1].cpu(), device)
    res = {"kernel": "chain", "value": round(n * n_calls / dt, 1), "unit": "anchors/s",
           "n": n, "calls": n_calls}
    # the production route on a mixed batch: avg_qspan 25.0 and 31.25 have
    # no fixed-point slope (the TPU route splits them off); the port's kernel
    # takes every table, and the whole windows must equal the oracle
    mixed = [(*chain_anchors(rng, nm), q) for q in (18.5, 25.0, 31.25, 22.0)]
    got = C.chain_calls([C.prepare_call(xs, ys, avg_qspan=q) for xs, ys, q in mixed], device)
    ok = True
    for (xs, ys, q), out in zip(mixed, got):
        want = CO.chain_dp(CO.ChainCall(n=nm, avg_qspan=q, max_dist_x=5000, max_dist_y=5000,
                                        bw=500, n_segs=1, x=xs.astype(np.uint64),
                                        y=ys.astype(np.uint64)))
        ok &= all(np.array_equal(g, want[k])
                  for g, k in zip(out, ("scores", "parents", "peak_scores")))
    res["mixed_batch_ok"] = bool(ok)
    return res


# ---------------------------------------------------------------- kmer


def kmer_reads(rng, n_reads, read_len):
    return ["".join(rng.choice(list("ACGT"), read_len)) for _ in range(n_reads)]


def bench_kmer(n_reads=512, read_len=5500, device=None):
    device = default_device(device)
    bases, lengths = K.encode_reads_np(kmer_reads(np.random.default_rng(3), n_reads, read_len))
    tb, tl = kmer_batch_from_numpy(bases, lengths, device)
    dt = _timeit(lambda: K.count_kmers_device(tb, tl), lambda o: o["total_kmers"], device)
    return {"kernel": "kmer", "value": round(int(lengths.sum()) / dt / 1e6, 2),
            "unit": "Mbases/s", "reads": n_reads}


# ---------------------------------------------------------------- fmi


def fmi_reads(rng, genome, b, rl):
    """b reads of rl bases from the genome with 2% substitutions, int32."""
    enc = np.zeros((b, rl), np.int32)
    for i in range(b):
        s = int(rng.integers(0, len(genome) - rl))
        read = genome[s : s + rl].astype(np.int32)
        mut = rng.random(rl) < 0.02
        read[mut] = rng.integers(0, 4, int(mut.sum()))
        enc[i] = read
    return enc


def bench_fmi(genome_bp=5_000_000, b=512, rl=101, genome_mbp=64, genome_reads=2048,
              genome_rl=151, cache_dir=None, device=None):
    device = default_device(device)
    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, genome_bp).astype(np.uint8)
    didx = IB.build_arrays(genome, device=device)
    index = fmi_index_from_numpy(didx, device)
    enc = fmi_reads(rng, genome, b, rl)
    rlens = np.full(b, rl, np.int32)
    dt = _timeit(lambda: FP.fmi_pipeline_batch(index, enc, rlens), lambda o: o[1], device,
                 iters=3)
    res = {"kernel": "fmi", "value": round(b / dt, 1), "unit": "reads/s", "batch": b,
           "engine": "device"}
    enc8 = enc.astype(np.int8)
    dt_h, _ = _timeit_host(lambda: fmi_search_native(didx, enc8, rlens), iters=3)
    res["host_reads_per_s"] = round(b / dt_h, 1)
    res["host_genome_reads_per_s"] = _bench_fmi_genome_scale(
        genome_mbp, genome_reads, genome_rl, cache_dir, device)
    return res


def genome_scale_reads(mbp, b, rl):
    """The genome-scale bench's reference, `mbp` Mbp of uniform codes
    (default_rng(41)), and its b reads of rl bases with 1% substitutions
    (int8 [b, rl])."""
    rng = np.random.default_rng(41)
    n = mbp * 1_000_000
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    starts = rng.integers(0, n - rl, b)
    enc = np.stack([codes[s : s + rl] for s in starts]).astype(np.int8)
    sub = rng.random(enc.shape) < 0.01
    enc[sub] = rng.integers(0, 4, int(sub.sum()), dtype=np.int8)
    return codes, enc


def _bench_fmi_genome_scale(mbp=64, b=2048, rl=151, cache_dir=None, device=None):
    """The host engine's reads/s on an index of `mbp` Mbp (64: a 64 MB
    cp_occ, past the last-level cache, where the interleaved search of
    native/fmsearch.cpp runs), built on first use and cached uncompressed in
    `cache_dir` (build/ by default)."""
    cache = Path(cache_dir or CACHE_DIR) / f"bench_fmi_idx{mbp}.npz"
    codes, enc = genome_scale_reads(mbp, b, rl)
    if not cache.exists():
        cache.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        idx = IB.build_arrays(codes, sa_compression=True, device=device)
        t1 = time.perf_counter()
        tmp = cache.with_name(f"{cache.stem}.{os.getpid()}.npz")
        IB.save_npz_full(idx, str(tmp), compress=False)
        os.replace(tmp, cache)
        print(json.dumps({"note": "fmi genome-scale index built+cached", "mbp": mbp,
                          "build_s": round(t1 - t0, 1),
                          "write_s": round(time.perf_counter() - t1, 1)}),
              file=sys.stderr, flush=True)
    didx = FI.load_npz(str(cache))
    rlens = np.full(b, rl, np.int32)
    dt, _ = _timeit_host(lambda: fmi_search_native(didx, enc, rlens), iters=3)
    return round(b / dt, 1)


# ---------------------------------------------------------------- pileup, dbg


def pileup_records(rng, n_reads, read_len, span):
    return [BamRecord(f"r{i}", 0, 0, int(rng.integers(0, span)), 60, [("M", read_len)],
                      rng.integers(1, 16, read_len).astype(np.uint8),
                      rng.integers(10, 40, read_len).astype(np.uint8), {})
            for i in range(n_reads)]


def bench_pileup(n_reads=2000, read_len=300, span=50000, region=60000):
    recs = pileup_records(np.random.default_rng(9), n_reads, read_len, span)
    dt, out = _timeit_host(lambda: calculate_pileup(recs, 0, 0, region))
    if out["n_cols"] <= 0:
        raise AssertionError("pileup counted no column")
    return {"kernel": "pileup", "value": round(n_reads * read_len / dt / 1e6, 2),
            "unit": "Mbases/s", "reads": n_reads, "len": read_len}


def dbg_windows(rng, n_win, w_len, n_reads, r_len):
    """n_win random windows of w_len bases, each with n_reads reads of r_len
    bases from it (1% substitutions, quality 35)."""
    wins = []
    for _ in range(n_win):
        ref = "".join(rng.choice(list("ACGT"), w_len))
        reads = []
        for _ in range(n_reads):
            s = int(rng.integers(0, w_len - r_len))
            seq = list(ref[s : s + r_len])
            for pos in np.nonzero(rng.random(r_len) < 0.01)[0]:
                seq[pos] = "ACGT"[rng.integers(0, 4)]
            reads.append(("".join(seq), np.full(r_len, 35, np.uint8), 0))
        wins.append((ref, reads))
    return wins


def bench_dbg(n_win=24, w_len=1500, n_reads=60, r_len=80):
    """Platypus window assembly (native/dbg.cpp): the colored DBG and its
    bubble paths a window."""
    wins = dbg_windows(np.random.default_rng(12), n_win, w_len, n_reads, r_len)

    def run():
        return sum(len(dbg_window_native(ref, 0, reads, 15, 20, 2)[1]) for ref, reads in wins)

    dt, _ = _timeit_host(run)
    return {"kernel": "dbg", "value": round(n_win * w_len / dt / 1e6, 3), "unit": "Mb-ref/s",
            "windows": n_win, "reads_per_window": n_reads}


# ---------------------------------------------------------------- poa, abea, grm


def poa_windows(rng, w_n, s_n, length):
    """w_n windows: a random sequence, s_n copies with 5% substitutions."""
    batches = []
    for _ in range(w_n):
        base = "".join(rng.choice(list("ACGT"), length))
        seqs = []
        for _ in range(s_n):
            s = list(base)
            for pos in np.nonzero(rng.random(length) < 0.05)[0]:
                s[pos] = "ACGT"[rng.integers(0, 4)]
            seqs.append("".join(s))
        batches.append(seqs)
    return batches


def bench_poa(w_n=32, s_n=6, length=200, device=None):
    device = default_device(device)
    batches = poa_windows(np.random.default_rng(6), w_n, s_n, length)
    dt, out = _timeit_host(lambda: msa_consensus_batch(batches, device=device))
    if not all(out):
        raise AssertionError("empty consensus")
    dt_h, out_h = _timeit_host(lambda: msa_consensus_host(batches))
    if out_h != out:
        raise AssertionError("the host engine's consensus differs from the device's")
    return {"kernel": "poa", "value": round(w_n * s_n / dt, 1), "unit": "seqs/s",
            "windows": w_n, "seqs": s_n, "len": length,
            "host_seqs_per_s": round(w_n * s_n / dt_h, 1)}


def abea_reads(rng, model, b, seq_len, k=6):
    """b random reads and their event means: 1-2 events a k-mer at the
    model's level plus N(0, 0.4)."""
    seqs, evs = [], []
    for _ in range(b):
        seq = "".join(rng.choice(list("ACGT"), seq_len))
        raw = []
        for p in range(len(seq) - k + 1):
            r = get_kmer_rank(seq[p : p + k])
            raw.extend(model["level_mean"][r] + rng.normal(0, 0.4, int(rng.integers(1, 3))))
        seqs.append(seq)
        evs.append(np.array(raw, np.float32))
    return seqs, evs


def bench_abea(b=64, seq_len=500, device=None):
    device = default_device(device)
    rng = np.random.default_rng(7)
    model = synth_model(rng)
    seqs, evs = abea_reads(rng, model, b, seq_len)
    ones, zeros = [1.0] * b, [0.0] * b

    def run(native):
        return align_events_batch(seqs, evs, model, ones, zeros, device=device,
                                  use_native=native)

    dt, res = _timeit_host(lambda: run(False), iters=3)
    if not all(res):
        raise AssertionError("QC-dropped synthetic reads")
    dt_h, res_h = _timeit_host(lambda: run(True), iters=3)
    if res_h != res:
        raise AssertionError("the host engine's pairs differ from the kernels'")
    return {"kernel": "abea", "value": round(b / dt, 1), "unit": "reads/s", "b": b,
            "seq_len": seq_len, "host_reads_per_s": round(b / dt_h, 1)}


def bench_grm(m=32768, n=2048, block=8192, device=None):
    """The blocked products alone, on device-resident inputs (the host's
    float64 allele frequencies, as plink2's)."""
    device = default_device(device)
    geno = genotypes(m, n)
    miss = geno == 3
    g64 = np.where(miss, 0.0, geno.astype(np.float64))
    freqs = g64.sum(1) / np.maximum(2.0 * (~miss).sum(1), 1.0)
    var = 2.0 * freqs * (1.0 - freqs)
    ok = var > G.K_SMALL_EPSILON
    isd = np.where(ok, 1.0 / np.sqrt(np.where(ok, var, 1.0)), 0.0)
    args = (torch.from_numpy(geno).to(device),
            torch.from_numpy((2 * freqs).astype(np.float32)).to(device),
            torch.from_numpy(isd.astype(np.float32)).to(device), torch.from_numpy(ok).to(device))
    dt = _timeit(lambda: G.grm_device(*args, block=block), lambda o: o[0][:1, :1].cpu(), device)
    return {"kernel": "grm", "value": round(2 * m * n * n * 2 / dt / 1e12, 3),
            "unit": "TFLOP/s", "m": m, "n": n}


BENCHES = (bench_phmm, bench_bsw, bench_chain, bench_kmer, bench_fmi, bench_poa, bench_abea,
           bench_pileup, bench_dbg, bench_grm)
HOST_BENCHES = (bench_pileup, bench_dbg)


def on_device(benches, device) -> list:
    """The benches as calls of no argument, each but the host ones on
    `device`."""
    return [fn if fn in HOST_BENCHES else functools.partial(fn, device=device)
            for fn in benches]


def run_benches(calls) -> tuple:
    """Each call of no argument, its line printed as it ends; a bench that
    raises gives the JAX tool's error line.  Returns (the lines, whether
    none raised)."""
    results, ok = [], True
    for fn in calls:
        try:
            r = fn()
        except Exception as e:  # record the failure, keep going
            r = {"kernel": getattr(fn, "func", fn).__name__, "error": repr(e)[:200]}
            ok = False
        results.append(r)
        print(json.dumps(r), flush=True)
    return results, ok


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_all")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions; hours at these shapes)")
    args = ap.parse_args(argv)
    _, ok = run_benches(on_device(BENCHES, default_device(args.device)))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
