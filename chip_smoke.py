#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's PairHMM, bsw, chain and abea paths on one GPU
and hold their kernels to their plain PyTorch versions.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero and prints no result):
  1. environment: Python, torch, CUDA, nvcc and the card (nvidia-smi);
  2. build csrc/phmm_forward.cu, csrc/bsw_extend.cu, csrc/chain_dp.cu,
     csrc/abea_fill.cu and csrc/abea_walk.cu with nvcc, one process per
     source, started together (timed; ptxas register and spill lines);
  3. the f32 PairHMM kernel against the plain version on the card, bit for
     bit, at bench.py's shapes 8192x(250x302) and 4096x(250x473), with
     kernel and plain times (CUDA events), GCUPS and the bound;
  4. the PairHMM main path: `cli.phmm.run_testcases` over a testfile written
     from --seed in the shape of the reference benchmark's dataset (550
     batches of <=110 reads x <=37 haps), launch counts reset just before
     and read just after; phase split, end-to-end GCUPS (parse plus the
     median of three runs), fallback fraction; the run once more under
     torch.profiler for the device's busy share and time by kind; the CLI's
     printed lines against the pooled results; then every raw output of the
     counted run, f32 and f64, bucket by bucket, against the plain version
     on the same device tensors, the kernels timed on the main path's
     largest buckets, and 16 seeded testcases against the port's oracle
     (exactly);
  5. the bsw kernel against its plain version on the card, bit for bit, at
     tools/bench_all.py's shape 8192x(128x256) (8% mutations, h0 20-59),
     with kernel and plain times, GCUPS and the bound;
  6. the bsw main path at the reference's bsw_large size: 10,606,460 pairs
     written with the generator of tools/bsw_scale_bench.py (rng seed 9;
     queries 96-151, targets 192-256), `io.pairs.parse_pairs_soa`, then
     `cli.bsw.score_pairs_soa` on the card, launch counts reset just before
     and read just after; phase split, the median of three runs, end-to-end
     pairs/s and GCUPS (parse plus the median run); the run once more under
     torch.profiler; a launch-size sweep on the file's first 1,000,000
     pairs; the CLI's --print-output lines for the file's first pairs
     against the pooled results; every output of the counted run against
     the plain version on the same device tensors (consecutive launches of
     a bucket taken together; tolerance 0: integers), which also counts the
     band cells for the bound; the kernel timed on the main path's largest
     launch; 512 seeded pairs against the port's oracle (exactly);
  7. the chain kernel against its plain version on the card, bit for bit,
     on 128 calls of 4096 anchors made by the generator of
     tools/chain_scale_bench.py (rng seed 0, avg_qspan 10-40), and on the
     same anchors with query spans 10-29 (--seed) written into y (the
     generator's y has none, so every score there is 0 and no call reaches
     the max_skip break); kernel and plain times, anchors/s, the
     predecessors visited and the bound;
  8. the chain main path at the reference dataset's size: 1001 calls,
     12,030,789 anchors, up to 87,271 a call, written with the generator of
     tools/chain_scale_bench.py (rng seed 5) with query spans 10-29 (--seed)
     written into y, so that the calls score, mark and break;
     `io.chain_dump.parse_chain_dump`,
     then `cli.chain.run_calls` on the card, launch counts reset just before
     and read just after; phase split, the median of three runs, end-to-end
     anchors/s (parse plus the median run); the run once more under
     torch.profiler; the CLI's output file for the dump's first 50 calls
     against print_return of the pooled results; every output of the
     counted run against the plain version on the same device tensors
     (tolerance 0: integers), which also counts the predecessors for the
     bound; the kernel timed on the main path's launch; the 25 + 6
     reference goldens through `run_calls` on the card; up to 8 calls of
     the dump with n <= 1500 against the port's oracle (exactly);
  9. the abea kernels (fill and walk) against their plain versions on the
     card, bit for bit, on 128 reads of 1-4 kb made by the generator of
     tools/abea_scale_bench.py (synth_read, rng seed 17), with kernel and
     plain times, band cells/s and the bounds; then the kernels alone on
     that tool's long-read workload (16 reads of 10-50 kb and one of 100
     kb, seed 17), which must all align; and the host's event detection
     on raw signals of those lengths (golden recipe, seed 17);
 10. the abea main path, cell abea-512: one f5c batch of 512 reads of
     1,000-13,450 bases (3,698,945 bases, the reference's `-B 3.7M`), raw
     signals by the golden recipe of tests/generate_fixtures.py (seeded
     from --seed) written to an npz and a FASTA; load, `cli.abea.
     prepare_reads` (events and scalings on the host) and three runs of
     `cli.abea.run_reads`, launch counts reset just before and read just
     after; phase split, events/s end to end (load + prep + the median
     run), the TSV emit timed apart; the run once more under
     torch.profiler; the CLI's output for the first 20 reads against the
     TSV of the pooled pairs; every output of the counted run against the
     plain versions on the same device tensors; the 25 abea goldens on the
     card; the batch's 8 shortest reads against the port's oracle;
 11. a `kernels` JSON line, the card's name and power limit, and the last
     line {"ok": true, "device": {...}}.
Every measurement is printed as it is taken.  Needs one CUDA card; without
one it exits 1.  The bsw dataset (~3.8 GB), the chain dump (~236 MB) and
the abea signals (~118 MB) are written under build/ beside this script and
deleted at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
DEVICE = "cuda"
PROFILE_ATTEMPTS = 3  # traces of one run, when a trace shows no device event
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): f32 and f64 outside
# the tensor cores count an FMA as two operations; the kernel does none.
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
# int32: 64 INT32 units per SM (Hopper architecture white paper) x 132 SMs
# x 1.98 GHz, the boost clock at which the data sheet's 67 TFLOP/s f32 is
# 128 FP32 units per SM x 2
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
OPS_PER_CELL = 12  # 8 multiplies + 4 adds (csrc/phmm_forward.cu)
# int32 operations per band cell of ksw_extend (csrc/bsw_extend.cu): score
# 6 (two ambiguity tests, or, equality, two selects), M 3 (test, add,
# select), H 2 (max, max), running max and argmax 3 (compare, two selects),
# E 4 and F 4 (subtract, max, subtract, max)
BSW_OPS_PER_CELL = 22
SOURCE = "genomicsbench_palisade_tpu_torch/csrc/phmm_forward.cu"
REPLACES = "genomicsbench_palisade_tpu/ops/phmm_pallas.py:38"
BSW_SOURCE = "genomicsbench_palisade_tpu_torch/csrc/bsw_extend.cu"
BSW_REPLACES = "genomicsbench_palisade_tpu/ops/bsw_pallas.py:35"
BSW_PAIRS = 10_606_460  # the reference's bsw_large (scripts/bsw_large:8)
BSW_SEED = 9  # tools/bsw_scale_bench.py's generator seed
BSW_CLI_PAIRS = 4096  # pairs of the file's head run through the CLI
BSW_ORACLE_PAIRS = 512
BSW_PLAIN_GROUP = 1 << 18  # pairs per call of the plain version in the whole-run check
BSW_SWEEP_PAIRS = 1_000_000
BSW_SWEEP_BATCHES = (4096, 16384, 65536, 262144)
CHAIN_SOURCE = "genomicsbench_palisade_tpu_torch/csrc/chain_dp.cu"
CHAIN_REPLACES = "genomicsbench_palisade_tpu/ops/chain_pallas.py:55"
CHAIN_CALLS = 1001  # the reference's dataset (benchmarks/chain/src/main.cpp:100-101)
CHAIN_MAX_N = 87_271  # its largest call (tools/chain_scale_bench.py:38)
CHAIN_SEED = 5  # tools/chain_scale_bench.py's generator seed
CHAIN_BENCH = (128, 4096)  # calls x anchors of the kernel-alone cell
CHAIN_CLI_CALLS = 50
CHAIN_ORACLE_CALLS = 8
CHAIN_ORACLE_MAX_N = 1500
CHAIN_SPANS = (10, 30)  # query spans written into y: 10-29, minimap2's k-mer sizes
# int32 operations of csrc/chain_dp.cu: 5 per visited predecessor (loop test
# and step, dr, dq, the dr == 0 test) and 16 more per one that passes the
# skip tests (four tests, |dr - dq| 2, two mins, gap subtract, score add,
# compare with max_f, three for the update or the skip count and break
# test, the parent test)
CHAIN_OPS_PER_VISIT = 5
CHAIN_OPS_PER_ELIGIBLE = 16
ABEA_FILL_SOURCE = "genomicsbench_palisade_tpu_torch/csrc/abea_fill.cu"
ABEA_FILL_REPLACES = "genomicsbench_palisade_tpu/ops/abea_pallas.py:40"
ABEA_WALK_SOURCE = "genomicsbench_palisade_tpu_torch/csrc/abea_walk.cu"
ABEA_WALK_REPLACES = "genomicsbench_palisade_tpu/ops/abea_pallas.py:479"
ABEA_SEED = 17  # tools/abea_scale_bench.py's generator seed
ABEA_BENCH = (128, 1000, 4000)  # reads, shortest, longest of the kernel-alone cell
ABEA_LONG = (16, 10_000, 50_000, 100_000)  # abea_scale_bench's reads and its --add-100k read
ABEA_READS = 512  # the f5c CLI's -K default (genomicsbench_palisade_tpu/cli/abea.py:220)
ABEA_LENS = (1000, 13450)  # 3,698,945 bases: -B 3.7M of the reference's GPU run
ABEA_MAX_BASES = "3.7M"  # -B of the reference's GPU run (scripts/run-gpu.sh:32)
ABEA_CLI_READS = 20
ABEA_ORACLE_READS = 8
# operations of csrc/abea_fill.cu a valid cell: f32 6 for the emission
# (two subtractions, the division, two multiplications, the addition) and 4
# compares; f64 4 conversions in, 5 additions, 3 conversions out
ABEA_FILL_F32_OPS = 10
ABEA_FILL_F64_OPS = 12
# csrc/abea_walk.cu a step: the emission's 6 f32; one conversion and one addition in f64
ABEA_WALK_F32_OPS = 6
ABEA_WALK_F64_OPS = 2


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------- data


def synth_bench_cases(rng, b, rl, hl):
    """bench.py:_synth_phmm_batch: reads are noisy (5%) substrings of their
    hap, quals 36-59."""
    reads, haps, pairs = [], [], []
    for i in range(b):
        hap = rng.integers(0, 4, hl)
        start = rng.integers(0, hl - rl)
        read = hap[start : start + rl].copy()
        noise = rng.random(rl) < 0.05
        read[noise] = rng.integers(0, 4, int(noise.sum()))
        reads.append({"bases": read, "q": rng.integers(36, 60, rl),
                      "i": rng.integers(36, 60, rl), "d": rng.integers(36, 60, rl),
                      "c": rng.integers(36, 60, rl)})
        haps.append(hap)
        pairs.append((i, i))
    return reads, haps, pairs


def qual33(arr) -> str:
    return "".join(chr(int(v) + 33) for v in arr)


N_BATCHES = 550  # the reference benchmark's dataset


def synth_testfile(path, rng, n_batches=N_BATCHES, max_reads=110, max_haps=37,
                   read_len=(10, 151), hap_len=(50, 473)):
    """The reference benchmark's dataset shape (the generator of
    tools/phmm_scale_bench.py): reads 10-151 bp, haps 50-473 bp, 60% of
    reads sampled from a hap with 3% mutations, q 6-40, i/d 30-45, c 10."""
    with open(path, "w") as f:
        for _ in range(n_batches):
            nr = int(rng.integers(1, max_reads + 1))
            nh = int(rng.integers(1, max_haps + 1))
            f.write(f"{nr} {nh}\n")
            haps = ["".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(
                hap_len[0], hap_len[1] + 1)))) for _ in range(nh)]
            for _ in range(nr):
                rl = int(rng.integers(read_len[0], read_len[1] + 1))
                if rng.random() < 0.6 and len(haps[0]) > rl:
                    hp = haps[int(rng.integers(nh))]
                    if len(hp) > rl:
                        s = int(rng.integers(0, len(hp) - rl))
                        bases = list(hp[s : s + rl])
                        for p in np.nonzero(rng.random(rl) < 0.03)[0]:
                            bases[p] = "ACGT"[int(rng.integers(4))]
                        bases = "".join(bases)
                    else:
                        bases = hp
                        rl = len(bases)
                else:
                    bases = "".join("ACGT"[c] for c in rng.integers(0, 4, rl))
                f.write(f"{bases} {qual33(rng.integers(6, 41, rl))} "
                        f"{qual33(rng.integers(30, 46, rl))} "
                        f"{qual33(rng.integers(30, 46, rl))} {qual33(np.full(rl, 10))}\n")
            for hp in haps:
                f.write(hp + "\n")


def write_pairs(path, n_pairs, rng, chunk=8192):
    """The bsw pair file of tools/bsw_scale_bench.py:write_pairs, byte for
    byte from the same rng: chunks of pairs that share (ql, tl), queries
    96-151 copied from their target's head with 8% mutations, targets
    192-256, h0 1-79; each chunk's records are laid out in one uint8
    matrix (a 1-digit h0 drops its first column) instead of per record."""
    with open(path, "wb") as f:
        done = 0
        while done < n_pairs:
            m = min(chunk, n_pairs - done)
            ql = int(rng.integers(96, 152))
            tl = int(rng.integers(192, 257))
            tgt = rng.integers(0, 4, (m, tl), dtype=np.uint8)
            qry = tgt[:, :ql].copy()
            mut = rng.random((m, ql)) < 0.08
            qry[mut] = rng.integers(0, 4, int(mut.sum()), dtype=np.uint8)
            h0 = rng.integers(1, 80, m)
            head = np.frombuffer(b" %d %d\n" % (tl, ql), np.uint8)
            rec = np.empty((m, 2 + len(head) + tl + 1 + ql + 1), np.uint8)
            rec[:, 0] = 48 + h0 // 10
            rec[:, 1] = 48 + h0 % 10
            c = 2 + len(head)
            rec[:, 2:c] = head
            rec[:, c : c + tl] = tgt + 48
            rec[:, c + tl] = 10
            rec[:, c + tl + 1 : c + tl + 1 + ql] = qry + 48
            rec[:, -1] = 10
            keep = np.ones(rec.shape, bool)
            keep[:, 0] = h0 >= 10
            f.write(rec[keep].tobytes())
            done += m


def synth_call(rng, n):
    """tools/chain_scale_bench.py:synth_call: x non-decreasing with gaps of
    1-39 and a rare jump of 5,000-20,000, y within 400 of x (so y holds no
    query span)."""
    gaps = rng.integers(1, 40, n)
    jumps = rng.random(n) < 0.002
    gaps[jumps] += rng.integers(5_000, 20_000, int(jumps.sum()))
    x = np.cumsum(gaps.astype(np.int64)) + 10_000
    y = np.maximum(x + rng.integers(-400, 400, n), 0)
    return x.astype(np.uint64), y.astype(np.uint64)


def with_spans(y, spans_rng):
    """y with query spans drawn from CHAIN_SPANS in bits 32-39, where
    minimap2 keeps them (the generator's y has none)."""
    return y | (spans_rng.integers(*CHAIN_SPANS, len(y)).astype(np.uint64) << np.uint64(32))


def write_dump(path, rng, n_calls, spans_rng=None):
    """The chain dataset of tools/chain_scale_bench.py:write_dump, byte for
    byte from the same rng when `spans_rng` is None: log-uniform call sizes
    from 63 anchors, one call of exactly CHAIN_MAX_N.  With `spans_rng` the
    same anchors get query spans in y.  Returns the number of anchors."""
    sizes = np.round(10 ** rng.uniform(1.8, np.log10(CHAIN_MAX_N), n_calls)).astype(np.int64)
    sizes[rng.integers(0, n_calls)] = CHAIN_MAX_N
    with open(path, "w") as f:
        for n in sizes:
            x, y = synth_call(rng, int(n))
            if spans_rng is not None:
                y = with_spans(y, spans_rng)
            aq = float(rng.uniform(10, 40))
            f.write(f"{n} {aq:.6f} 5000 5000 500 1\n")
            f.write("\n".join(f"{a} {b}" for a, b in zip(x, y)))
            f.write("\nEOR\n")
    return int(sizes.sum())


def synth_bsw_bench_pairs(rng, b=8192, ql=128, tl=256):
    """tools/bench_all.py:bench_bsw's batch: queries are the head of their
    target with 8% mutations, h0 20-59."""
    pairs = []
    for _ in range(b):
        t = rng.integers(0, 4, tl)
        q = t[:ql].copy()
        mut = rng.random(ql) < 0.08
        q[mut] = rng.integers(0, 4, int(mut.sum()))
        pairs.append((q, t, int(rng.integers(20, 60))))
    return pairs


def synth_model(rng):
    """tools/abea_scale_bench.py:synth_model: levels N(90, 12), stdv 1-3."""
    model = {"level_mean": rng.normal(90, 12, 4096).astype(np.float32),
             "level_stdv": (rng.random(4096) * 2 + 1).astype(np.float32)}
    model["level_log_stdv"] = np.log(model["level_stdv"]).astype(np.float32)
    return model


def synth_read(rng, model, length):
    """tools/abea_scale_bench.py:synth_read: a random read and its event
    means, 1-2 events a k-mer at the model's level plus N(0, 0.4)."""
    codes = rng.integers(0, 4, length)
    seq = "".join("ACGT"[c] for c in codes)
    nk = length - 6 + 1
    ranks = np.zeros(nk, np.int64)
    for j in range(6):
        ranks = (ranks << 2) | codes[j : nk + j]
    counts = rng.integers(1, 3, nk)
    means = (np.repeat(model["level_mean"][ranks], counts)
             + rng.normal(0, 0.4, int(counts.sum())))
    return seq, means.astype(np.float32)


def golden_pore_levels() -> np.ndarray:
    """tests/generate_fixtures.py:_pore_levels as an array by k-mer rank."""
    i = np.arange(4096, dtype=np.int64)
    return 60.0 + 80.0 * ((i * 2654435761) % 4096) / 4096.0


def write_pore_model(path):
    """The golden fixtures' model TSV: each level to 2 decimals, stdv 1.50."""
    with open(path, "w") as f:
        f.write("kmer\tlevel_mean\tlevel_stdv\n")
        for r, mean in enumerate(golden_pore_levels().tolist()):
            kmer = "".join("ACGT"[(r >> (2 * (5 - j))) & 3] for j in range(6))
            f.write(f"{kmer}\t{mean:.2f}\t1.50\n")


def golden_reads(lengths, rng):
    """Reads of the given lengths and their raw signals by the golden recipe
    (tests/generate_fixtures.py:390-426), vectorised: per k-mer 3-13
    samples at its level plus N(0, 0.8), or N(0, 6.0) for 20% of k-mers.
    Yields (sequence, f32 signal)."""
    levels = golden_pore_levels()
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for n in (int(v) for v in lengths):
        codes = rng.integers(0, 4, n)
        nk = n - 5
        ranks = np.zeros(nk, np.int64)
        for j in range(6):
            ranks = (ranks << 2) | codes[j : nk + j]
        dwell = rng.integers(3, 14, nk)
        sigma = np.where(rng.random(nk) < 0.8, 0.8, 6.0)
        sig = (np.repeat(levels[ranks], dwell)
               + rng.normal(0, 1, int(dwell.sum())) * np.repeat(sigma, dwell))
        yield acgt[codes].tobytes().decode(), sig.astype(np.float32)


def write_abea_dataset(fasta, npz, model_tsv, lengths, rng) -> int:
    """golden_reads of the given lengths as a FASTA, an npz (read name ->
    f32 signal) and the model TSV; returns the number of samples."""
    signals, total = {}, 0
    with open(fasta, "w") as f:
        for r, (seq, sig) in enumerate(golden_reads(lengths, rng)):
            signals[f"read{r}"] = sig
            total += len(sig)
            f.write(f">read{r}\n{seq}\n")
    np.savez(npz, **signals)
    write_pore_model(model_tsv)
    return total


# ---------------------------------------------------------------- measures


def cells_of(batch_np) -> int:
    return int(np.sum(batch_np["rslen"].astype(np.int64) * batch_np["haplen"]))


def bound(batch_np, itemsize: int, ops_per_s: float, table_elems: int):
    """Least time for the function on these inputs: the larger of the bytes
    it must move (each input once, the output once) over HBM bandwidth and
    its operations (12 per real cell) over the peak rate."""
    b, rp = batch_np["rs_row"].shape
    hp = batch_np["hap"].shape[1]
    nbytes = 5 * b * rp + b * hp + 8 * b + itemsize * (hp + 1 + table_elems) + itemsize * b
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = OPS_PER_CELL * cells_of(batch_np) / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bound_of(n_pairs: int, n_bases: int, band_cells: int):
    """Least time (ms) for ksw_extend: the larger of the bytes it must move
    (each query and target base once, 28 bytes of offsets, lengths and h0
    and 24 of outputs a pair) over HBM bandwidth and its int32 operations
    (BSW_OPS_PER_CELL per band cell the data visits) over the int32 rate."""
    t_bytes = (n_bases + (28 + 24) * n_pairs) / HBM_BYTES_PER_S
    t_ops = BSW_OPS_PER_CELL * band_cells / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bsw_bound(batch, band_cells: int):
    n_bases = int(batch["q_len"].sum()) + int(batch["t_len"].sum())
    return bound_of(batch["h0"].numel(), n_bases, band_cells)


def bsw_cells(batch) -> int:
    """Sum of qlen x tlen: the cells GCUPS counts."""
    return int((batch["q_len"].long() * batch["t_len"].long()).sum())


def chain_bound(n_anchors: int, n_calls: int, bw: int, st: dict):
    """Least time (ms) for the chain DP: the larger of the bytes it must
    move (16 in and 12 out an anchor; a call's gap table, offset and count)
    over HBM bandwidth and its int32 operations on these inputs (from the
    plain version's counts of visited and scoring predecessors) over the
    int32 rate."""
    t_bytes = (28 * n_anchors + (4 * (bw + 1) + 12) * n_calls) / HBM_BYTES_PER_S
    t_ops = (CHAIN_OPS_PER_VISIT * st["predecessors"]
             + CHAIN_OPS_PER_ELIGIBLE * st["eligible"]) / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def abea_cells(torch, batch, fill) -> int:
    """Valid cells of the batch's bands, the cells the fill scores: in band
    bi of a read, the offsets o < 100 with 0 <= bk + o < nk and 0 <= be - o
    < ne, where be = bll_e and bk = bi - 2 - be."""
    ne, nk = batch["ne"].long(), batch["nk"].long()
    nb = ne + nk + 2
    read = torch.repeat_interleave(torch.arange(ne.numel(), device=ne.device), nb)
    bi = torch.arange(read.numel(), device=ne.device) - batch["band_off"][read]
    be = fill["bll_e"].long()
    bk = bi - 2 - be
    lo = torch.maximum(torch.maximum(-bk, be - (ne[read] - 1)), torch.zeros_like(bk))
    hi = torch.minimum(torch.minimum(nk[read] - bk, be + 1), torch.full_like(bk, 100))
    return int(torch.where(bi >= 2, (hi - lo).clamp(min=0), 0).sum())


def abea_fill_bound(batch, cells: int):
    """Least time (ms) for the fill: the larger of the bytes it must move
    (16 an event or k-mer and 64 a read in; 100 of trace, 8 of bll_e and
    last_val a band and 4 of seed a read out) over HBM bandwidth, and its
    operations on these inputs (per valid cell ABEA_FILL_F32_OPS f32 and
    ABEA_FILL_F64_OPS f64) over each type's peak rate."""
    b, n_ev, n_k = batch["ne"].numel(), batch["ev"].numel(), batch["gm"].numel()
    rows = n_ev + n_k + 2 * b
    t_bytes = (4 * n_ev + 12 * n_k + 68 * b + 108 * rows) / HBM_BYTES_PER_S
    t_ops = max(ABEA_FILL_F32_OPS * cells / F32_OPS_PER_S, ABEA_FILL_F64_OPS * cells / F64_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def abea_walk_bound(n_reads: int, steps: int):
    """Least time (ms) for the walk: the larger of the bytes it must move
    (a trace byte, bll_e, the emission's 16 bytes in and a pair out a step;
    48 bytes a read) over HBM bandwidth, and its operations (a step's
    ABEA_WALK_F32_OPS f32 and ABEA_WALK_F64_OPS f64) over each peak rate."""
    t_bytes = (29 * steps + 48 * n_reads) / HBM_BYTES_PER_S
    t_ops = max(ABEA_WALK_F32_OPS * steps / F32_OPS_PER_S, ABEA_WALK_F64_OPS * steps / F64_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def abea_moves(band_off, walk_np) -> dict:
    """The walks' moves between consecutive pairs: D (both indices down),
    U (the event) and L (the k-mer)."""
    n = walk_np["n"].astype(np.int64)
    rows = np.concatenate([np.arange(o, o + c - 1) for o, c in zip(band_off, n) if c > 1]
                          + [np.zeros(0, np.int64)])
    p = walk_np["pairs"].astype(np.int64)
    dk, de = p[rows, 0] - p[rows + 1, 0], p[rows, 1] - p[rows + 1, 1]
    return {"D": int(((dk == 1) & (de == 1)).sum()), "U": int(((dk == 0) & (de == 1)).sum()),
            "L": int(((dk == 1) & (de == 0)).sum())}


def time_ms(torch, fn, reps: int):
    """Best of `reps` single calls, CUDA events; returns (ms, last result)."""
    best, out = math.inf, None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best, out


def max_abs_diff(torch, a, b) -> float:
    """Max |a-b|; a NaN or inf where the other has another value is inf."""
    if a.shape != b.shape:
        return math.inf
    same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else a == b
    if bool(same.all()):
        return 0.0
    d = (a.double() - b.double()).abs()[~same]
    return float(d.max()) if bool(torch.isfinite(d).all()) else math.inf


def device_profile(torch, fn) -> dict:
    """Run fn under torch.profiler; device seconds by kind and the share
    of the wall time the device was busy (union of its intervals).  A
    trace can come back without any device event (seen once in a while on
    the H100 box, for a run that launched kernels): then fn runs under a
    new trace, up to PROFILE_ATTEMPTS times, and the count is reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            break
    spans, kinds = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        name = e.name
        kind = ("phmm_forward_f32" if "phmm_forward_kernel<float" in name else
                "phmm_forward_f64" if "phmm_forward_kernel<double" in name else
                "bsw_extend" if "bsw_extend_kernel" in name else
                "chain_dp" if "chain_dp_kernel" in name else
                "abea_fill" if "abea_fill_kernel" in name else
                "abea_walk" if "abea_walk_kernel" in name else
                "memcpy_htod" if "HtoD" in name else
                "memcpy_dtoh" if "DtoH" in name else "other")
        kinds[kind] = kinds.get(kind, 0.0) + (end - start) * 1e-6
    if not spans:
        return {"wall_s": wall, "attempts": attempt,
                "device": "not measured (the profiler saw no device events)"}
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) * 1e-6
    return {"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_s_by_kind": kinds, "device_events": len(spans), "attempts": attempt}


def compare(torch, P, batch_np, dtype, kernel_reps=3, plain_reps=2):
    """Kernel and plain version on the same tensors on the card."""
    tb = P.as_device_batch(batch_np, DEVICE)
    P.forward_raw(tb, dtype)  # warm-up: first launch, table upload
    ms, got = time_ms(torch, lambda: P.forward_raw(tb, dtype), kernel_reps)
    plain_ms, want = time_ms(torch, lambda: P.phmm_forward_plain(tb, dtype), plain_reps)
    return ms, plain_ms, max_abs_diff(torch, got, want)


# ---------------------------------------------------------------- phases


class Port:
    """The port's modules, imported after the CUDA check."""

    def __init__(self):
        from genomicsbench_palisade_tpu_torch.cli import abea as cli_abea
        from genomicsbench_palisade_tpu_torch.cli import bsw as cli_bsw
        from genomicsbench_palisade_tpu_torch.cli import chain as cli_chain
        from genomicsbench_palisade_tpu_torch.cli import phmm as cli
        from genomicsbench_palisade_tpu_torch.convert import (abea_batch_from_numpy,
                                                              bsw_batch_from_numpy,
                                                              chain_batch_from_numpy)
        from genomicsbench_palisade_tpu_torch.io import signal as abea_signal
        from genomicsbench_palisade_tpu_torch.io import chain_dump
        from genomicsbench_palisade_tpu_torch.io.pairs import parse_pairs_soa
        from genomicsbench_palisade_tpu_torch.io.phmm_batch import parse_testfile
        from genomicsbench_palisade_tpu_torch.io.fastq import read_sequences
        from genomicsbench_palisade_tpu_torch.ops import abea as A
        from genomicsbench_palisade_tpu_torch.ops import abea_cuda
        from genomicsbench_palisade_tpu_torch.ops import bsw as W
        from genomicsbench_palisade_tpu_torch.ops import bsw_cuda
        from genomicsbench_palisade_tpu_torch.ops import chain as C
        from genomicsbench_palisade_tpu_torch.ops import chain_cuda
        from genomicsbench_palisade_tpu_torch.ops import phmm as P
        from genomicsbench_palisade_tpu_torch.ops import phmm_cuda
        from genomicsbench_palisade_tpu_torch.ops import events as abea_events
        from genomicsbench_palisade_tpu_torch.ops.oracle import abea as abea_oracle
        from genomicsbench_palisade_tpu_torch.ops.oracle import bsw as bsw_oracle
        from genomicsbench_palisade_tpu_torch.ops.oracle import chain as chain_oracle
        from genomicsbench_palisade_tpu_torch.ops.oracle import phmm as oracle
        from genomicsbench_palisade_tpu_torch.utils import build

        vars(self).update(cli=cli, cli_bsw=cli_bsw, bsw_batch_from_numpy=bsw_batch_from_numpy,
                          parse_pairs_soa=parse_pairs_soa, parse_testfile=parse_testfile, W=W,
                          bsw_cuda=bsw_cuda, P=P, phmm_cuda=phmm_cuda, bsw_oracle=bsw_oracle,
                          oracle=oracle, build=build, cli_chain=cli_chain,
                          chain_batch_from_numpy=chain_batch_from_numpy, chain_dump=chain_dump,
                          C=C, chain_cuda=chain_cuda, chain_oracle=chain_oracle,
                          cli_abea=cli_abea, abea_batch_from_numpy=abea_batch_from_numpy,
                          abea_signal=abea_signal, read_sequences=read_sequences, A=A,
                          abea_cuda=abea_cuda, abea_events=abea_events,
                          abea_oracle=abea_oracle)
        self.kernels = [*phmm_cuda.KERNELS.values(), bsw_cuda.bsw_extend, chain_cuda.chain_dp,
                        *abea_cuda.KERNELS]

    def reset_launches(self):
        for k in self.kernels:
            k.launches = 0

    def launches(self) -> dict:
        return {k.name: k.launches for k in self.kernels}


class Record:
    """Per kernel: the numbers of its `kernels` entry; fails on the first
    disagreement with its plain version (tolerance 0)."""

    def __init__(self, names):
        self.kern = {n: {"max_abs_err": 0.0} for n in names}

    def check(self, name, err, where):
        self.kern[name]["max_abs_err"] = max(self.kern[name]["max_abs_err"], err)
        if err != 0.0:
            fail(f"{name} differs from its plain version at {where}: {err}")

    def launched(self, launches: dict, names):
        for name in names:
            n = launches[name]
            self.kern[name]["launches"] = n
            if n <= 0:
                fail(f"{name} was not launched on the main path")


def phmm_phases(torch, port: Port, rec: Record, seed: int):
    """Phases 3 and 4: the PairHMM kernels alone and the PairHMM main path."""
    P, cli, phmm_cuda, oracle = port.P, port.cli, port.phmm_cuda, port.oracle
    n_tables = sum(P.tables(np.float32)[k].size for k in ("ph2pr", "one_m_ph2pr",
                                                        "ph2pr_div3", "m2m"))

    # 3. f32 kernel vs plain version at bench.py's shapes
    rng = np.random.default_rng(seed)
    for b, rl, hl, r_pad, h_pad in ((8192, 250, 302, 256, 320), (4096, 250, 473, 256, 512)):
        reads, haps, pairs = synth_bench_cases(rng, b, rl, hl)
        batch_np = P.prepare_batch(reads, haps, pairs, r_pad=r_pad, h_pad=h_pad)
        ms, plain_ms, err = compare(torch, P, batch_np, torch.float32)
        bms, by = bound(batch_np, 4, F32_OPS_PER_S, n_tables)
        row = {"shape": f"{b}x({rl}x{hl}) bucket {r_pad}x{h_pad}", "ms": ms,
               "plain_ms": plain_ms, "max_abs_err": err,
               "gcups": cells_of(batch_np) / (ms * 1e-3) / 1e9,
               "bound_ms": bms, "bound_by": by}
        log("f32 kernel vs plain " + json.dumps(row))
        rec.check("phmm_forward_f32", err, row["shape"])

    # 4. the main path at the dataset shape
    with tempfile.TemporaryDirectory() as tmp:
        tf = Path(tmp) / "testfile.txt"
        t0 = time.perf_counter()
        synth_testfile(tf, np.random.default_rng(seed))
        log(f"testfile: {N_BATCHES} batches, {tf.stat().st_size / 1e6:.1f} MB, "
            f"written in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        batches = port.parse_testfile(tf)
        parse_s = time.perf_counter() - t0
        reads, haps, pairs = [], [], []
        for bt in batches:
            r0, h0 = len(reads), len(haps)
            reads.extend(bt.reads)
            haps.extend(bt.haps)
            pairs.extend((r0 + r, h0 + h) for r, h in bt.pairs)
        cells = sum(len(reads[r]["bases"]) * len(haps[h]) for r, h in pairs)

        # counts go to 0 just before the main path and are read just after;
        # two more runs give the spread of its wall time
        stats: dict = {}
        kept: list = []  # per bucket: the tensors each pass was given, its raw outputs
        port.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = cli.run_testcases(reads, haps, pairs, device=DEVICE, stats=stats, keep=kept)
        run_s = time.perf_counter() - t0
        launches = port.launches()
        runs_s = [run_s]
        for _ in range(2):
            t0 = time.perf_counter()
            again = cli.run_testcases(reads, haps, pairs, device=DEVICE)
            runs_s.append(time.perf_counter() - t0)
            if not np.array_equal(again, results):
                fail("a second run of the main path gave other results")
        run_s_median = float(np.median(runs_s))
        e2e = {"batches": len(batches), "testcases": len(pairs), "gcells": cells / 1e9,
               "parse_s": parse_s, "prep_s": stats["prep_s"], "f32_s": stats["f32_s"],
               "f64_s": stats["f64_s"], "run_s_all": runs_s, "run_s_median": run_s_median,
               "total_s": parse_s + run_s_median,
               "gcups_end_to_end": cells / (parse_s + run_s_median) / 1e9,
               "fallback_frac": stats["fallback"] / len(pairs), "launches": launches}
        log("end to end " + json.dumps(e2e))
        rec.launched(launches, ("phmm_forward_f32", "phmm_forward_f64"))
        if not np.all(np.isfinite(results)) or results.shape != (len(pairs),):
            fail("main path gave non-finite likelihoods or a wrong shape")

        # where the device time goes: the same run again under torch.profiler
        prof = device_profile(torch, lambda: cli.run_testcases(reads, haps, pairs, device=DEVICE))
        log("profile " + json.dumps(prof))

        # the CLI's printed lines for the first batches equal the pooled results
        n_cli = min(8, len(batches))
        small = Path(tmp) / "testfile_small.txt"
        with open(tf) as src, open(small, "w") as dst:
            for _ in range(n_cli):
                nr, nh = map(int, src.readline().split())
                dst.write(f"{nr} {nh}\n")
                for _ in range(nr + nh):
                    dst.write(src.readline())
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-f", str(small)])
        lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("i: ")]
        want, pos = [], 0
        for bt in batches[:n_cli]:
            n = len(bt.pairs)
            want += [f"i: {i}; result_final: {v:f}" for i, v in enumerate(results[pos : pos + n])]
            pos += n
        if rc != 0 or lines != want:
            fail(f"CLI lines differ from the pooled results (rc {rc}, "
                 f"{len(lines)} vs {len(want)} lines)")
        log(f"CLI: {len(lines)} lines of {n_cli} batches equal the pooled results")

    # every raw output of the counted run against the plain version on the
    # same device tensors, bucket by bucket
    passes = (("phmm_forward_f32", torch.float32, "batch", "raw_f32"),
              ("phmm_forward_f64", torch.float64, "f64_batch", "raw_f64"))
    seen = {name: {"buckets": 0, "cases": 0, "plain_s": 0.0} for name, *_ in passes}
    for kb in kept:
        for name, dtype, bkey, rkey in passes:
            if kb[bkey] is None:
                continue
            plain_ms, want = time_ms(torch, lambda: P.phmm_forward_plain(kb[bkey], dtype), 1)
            kb[rkey + "_plain_ms"] = plain_ms
            got = torch.from_numpy(kb[rkey]).to(want.device)
            rec.check(name, max_abs_diff(torch, got, want), f"main-path bucket {kb['bucket']}")
            seen[name]["buckets"] += 1
            seen[name]["cases"] += len(kb[rkey])
            seen[name]["plain_s"] += plain_ms * 1e-3
    log("main path vs plain, every output " + json.dumps(seen))

    # the kernels' times on the main path's largest bucket of each pass
    for name, dtype, bkey, rkey in passes:
        kb = max((kb for kb in kept if kb[bkey] is not None), key=lambda kb: len(kb[rkey]))
        tb = kb[bkey]
        ms, got = time_ms(torch, lambda: P.forward_raw(tb, dtype), 3)
        rec.check(name, max_abs_diff(torch, got, torch.from_numpy(kb[rkey]).to(got.device)),
                  f"a rerun on bucket {kb['bucket']}")
        tb_np = {k: v.cpu().numpy() for k, v in tb.items()}
        itemsize, peak = (4, F32_OPS_PER_S) if dtype == torch.float32 else (8, F64_OPS_PER_S)
        bms, by = bound(tb_np, itemsize, peak, n_tables)
        row = {"shape": f"{len(kb[rkey])} cases, bucket {kb['bucket'][0]}x{kb['bucket'][1]}",
               "ms": ms, "plain_ms": kb[rkey + "_plain_ms"],
               "gcups": cells_of(tb_np) / (ms * 1e-3) / 1e9, "bound_ms": bms, "bound_by": by}
        log(f"{name} on the main path's largest bucket " + json.dumps(row))
        rec.kern[name].update(ms=ms, plain_ms=row["plain_ms"], bound_ms=bms, bound_by=by)

    # 16 seeded testcases against the port's oracle, exactly
    sel = np.random.default_rng(seed).choice(len(pairs), min(16, len(pairs)), replace=False)
    t0 = time.perf_counter()
    bad = []
    for i in sel:
        r, h = pairs[i]
        rd = reads[r]
        want_v = oracle.compute_likelihood(rd["bases"], haps[h], rd["q"], rd["i"],
                                           rd["d"], rd["c"])
        if want_v != results[i]:
            bad.append((int(i), want_v, float(results[i])))
    log(f"oracle sample: {len(sel) - len(bad)}/{len(sel)} exact "
        f"({time.perf_counter() - t0:.1f} s)")
    if bad:
        fail(f"results differ from the oracle: {bad}")


def bsw_phases(torch, port: Port, rec: Record, seed: int):
    """Phases 5 and 6: the bsw kernel alone and the bsw main path."""
    W, cli_bsw, kernel = port.W, port.cli_bsw, port.bsw_cuda.bsw_extend
    name = kernel.name

    # 5. kernel vs plain version at tools/bench_all.py's shape
    pairs = synth_bsw_bench_pairs(np.random.default_rng(1))
    tb, ptuple = port.bsw_batch_from_numpy(W.prepare_pairs(pairs, q_pad=128, t_pad=256), DEVICE)
    W.bsw_extend(tb, ptuple)  # warm-up: first launch
    ms, got = time_ms(torch, lambda: W.bsw_extend(tb, ptuple), 3)
    st: dict = {}
    plain_ms, want = time_ms(torch, lambda: W.bsw_extend_plain(tb, ptuple, stats=st), 1)
    err = max_abs_diff(torch, got, want)
    bms, by = bsw_bound(tb, st["cells"])
    row = {"shape": "8192x(128x256)", "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
           "gcups": bsw_cells(tb) / (ms * 1e-3) / 1e9, "band_cells": st["cells"],
           "band_gcups": st["cells"] / (ms * 1e-3) / 1e9, "bound_ms": bms, "bound_by": by}
    log("bsw kernel vs plain " + json.dumps(row))
    rec.check(name, err, row["shape"])

    # 6. the main path at the reference's bsw_large size
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        pf = Path(tmp) / "pairs.txt"
        t0 = time.perf_counter()
        write_pairs(pf, BSW_PAIRS, np.random.default_rng(BSW_SEED))
        log(f"pairs file: {BSW_PAIRS} pairs, {pf.stat().st_size / 1e9:.3f} GB, "
            f"written in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        soa = port.parse_pairs_soa(pf)
        parse_s = time.perf_counter() - t0
        n = len(soa["h0"])
        if n != BSW_PAIRS:
            fail(f"parsed {n} pairs, wrote {BSW_PAIRS}")
        cells = int(soa["q_len"].astype(np.int64) @ soa["t_len"].astype(np.int64))

        stats: dict = {}
        kept: list = []  # per launch: the tensors it was given, its output
        port.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = cli_bsw.score_pairs_soa(soa, device=DEVICE, stats=stats, keep=kept)
        run_s = time.perf_counter() - t0
        launches = port.launches()
        runs_s = [run_s]
        for _ in range(2):
            t0 = time.perf_counter()
            again = cli_bsw.score_pairs_soa(soa, device=DEVICE)
            runs_s.append(time.perf_counter() - t0)
            if any(not np.array_equal(again[k], results[k]) for k in results):
                fail("a second run of the bsw main path gave other results")
        run_s_median = float(np.median(runs_s))
        total_s = parse_s + run_s_median
        e2e = {"pairs": n, "gcells": cells / 1e9, "file_gb": pf.stat().st_size / 1e9,
               "parse_s": parse_s, **stats, "run_s_all": runs_s, "run_s_median": run_s_median,
               "total_s": total_s, "pairs_per_s_end_to_end": n / total_s,
               "gcups_end_to_end": cells / total_s / 1e9, "launches": launches}
        log("bsw end to end " + json.dumps(e2e))
        rec.launched(launches, (name,))
        for k, v in results.items():
            if v.shape != (n,) or v.dtype != np.int32:
                fail(f"bsw main path gave {k} of shape {v.shape}, dtype {v.dtype}")
        if not (results["score"] >= soa["h0"]).all():  # the best score starts at h0
            fail("bsw main path gave a score below its pair's h0")

        prof = device_profile(torch, lambda: cli_bsw.score_pairs_soa(soa, device=DEVICE))
        log("bsw profile " + json.dumps(prof))

        # launch size: the kernel phase of score_pairs_soa on the file's head
        sub = {k: v if k == "codes" else v[:BSW_SWEEP_PAIRS] for k, v in soa.items()}
        sweep = {}
        for dev_batch in BSW_SWEEP_BATCHES:
            st = {}
            got = cli_bsw.score_pairs_soa(sub, device=DEVICE, stats=st, dev_batch=dev_batch)
            if any(not np.array_equal(got[k], results[k][:BSW_SWEEP_PAIRS]) for k in got):
                fail(f"launches of {dev_batch} pairs gave other results")
            sweep[dev_batch] = st["kernel_s"]
        log(f"bsw launch-size sweep, kernel_s on the first {BSW_SWEEP_PAIRS} pairs "
            f"(the main path uses {cli_bsw.DEV_BATCH}) " + json.dumps(sweep))

        # the CLI's --print-output lines for the file's head equal the pooled results
        head = Path(tmp) / "pairs_head.txt"
        with open(pf, "rb") as src, open(head, "wb") as dst:
            for _ in range(3 * BSW_CLI_PAIRS):
                dst.write(src.readline())
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_bsw.main(["-pairs", str(head), "--print-output"])
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln and all(tok.lstrip("-").isdigit() for tok in ln.split())]
        cols = np.stack([results[k][:BSW_CLI_PAIRS] for k in W.OUT_ORDER], axis=1)
        want = [" ".join(map(str, r)) for r in cols.tolist()]
        if rc != 0 or lines != want:
            fail(f"bsw CLI lines differ from the pooled results (rc {rc}, "
                 f"{len(lines)} vs {len(want)} lines)")
        log(f"bsw CLI: {len(lines)} --print-output lines equal the pooled results")

    # every output of the counted run against the plain version on the same
    # device tensors, consecutive launches of a bucket taken together up to
    # BSW_PLAIN_GROUP pairs; the plain version counts the band cells
    seen = {"launches": 0, "pairs": 0, "plain_calls": 0, "plain_s": 0.0, "band_cells": 0}
    groups, size = [], BSW_PLAIN_GROUP
    for kb in kept:
        m = kb["out"].shape[1]
        if size + m > BSW_PLAIN_GROUP or groups[-1][0]["bucket"] != kb["bucket"]:
            groups.append([])
            size = 0
        groups[-1].append(kb)
        size += m
    for grp in groups:
        batch = {k: v if k == "codes" else torch.cat([kb["batch"][k] for kb in grp])
                 for k, v in grp[0]["batch"].items()}
        st = {}
        plain_ms, want = time_ms(torch, lambda: W.bsw_extend_plain(batch, ptuple, stats=st), 1)
        got = torch.cat([kb["out"] for kb in grp], dim=1)
        rec.check(name, max_abs_diff(torch, got, want), f"main-path bucket {grp[0]['bucket']}")
        seen["launches"] += len(grp)
        seen["pairs"] += got.shape[1]
        seen["plain_calls"] += 1
        seen["plain_s"] += plain_ms * 1e-3
        seen["band_cells"] += st["cells"]
    if seen["launches"] != len(kept) or seen["pairs"] != n:
        fail(f"the plain check saw {seen['launches']} launches and {seen['pairs']} pairs")
    bases = int(soa["q_len"].sum(dtype=np.int64) + soa["t_len"].sum(dtype=np.int64))
    bound_all_ms, seen["bound_by"] = bound_of(n, bases, seen["band_cells"])
    seen["bound_s_all_launches"] = bound_all_ms * 1e-3
    seen["kernel_s_counted_run"] = stats["kernel_s"]
    log("bsw main path vs plain, every output " + json.dumps(seen))

    # the kernel and the plain version on the main path's largest launch
    kb = max(kept, key=lambda kb: kb["out"].shape[1])
    ms, got = time_ms(torch, lambda: W.bsw_extend(kb["batch"], ptuple), 3)
    rec.check(name, max_abs_diff(torch, got, kb["out"]), f"a rerun on launch {kb['bucket']}")
    st = {}
    plain_ms, _ = time_ms(torch, lambda: W.bsw_extend_plain(kb["batch"], ptuple, stats=st), 1)
    bms, by = bsw_bound(kb["batch"], st["cells"])
    row = {"shape": f"{kb['out'].shape[1]} pairs, bucket {kb['bucket'][0]}x{kb['bucket'][1]}",
           "ms": ms, "plain_ms": plain_ms,
           "gcups": bsw_cells(kb["batch"]) / (ms * 1e-3) / 1e9, "band_cells": st["cells"],
           "band_gcups": st["cells"] / (ms * 1e-3) / 1e9, "bound_ms": bms, "bound_by": by}
    log(f"{name} on the main path's largest launch " + json.dumps(row))
    rec.kern[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)

    # seeded pairs against the port's oracle, exactly
    sel = np.random.default_rng(seed).choice(n, min(BSW_ORACLE_PAIRS, n), replace=False)
    t0 = time.perf_counter()
    params = port.bsw_oracle.DEFAULT_PARAMS
    bad = []
    for i in sel:
        q = soa["codes"][soa["q_off"][i] : soa["q_off"][i] + soa["q_len"][i]]
        t = soa["codes"][soa["t_off"][i] : soa["t_off"][i] + soa["t_len"][i]]
        want_o = port.bsw_oracle.scalar_banded_swa(q, t, int(soa["h0"][i]), params)
        got_o = {k: int(results[k][i]) for k in W.OUT_ORDER}
        if got_o != want_o:
            bad.append((int(i), got_o, want_o))
    log(f"bsw oracle sample: {len(sel) - len(bad)}/{len(sel)} exact "
        f"({time.perf_counter() - t0:.1f} s)")
    if bad:
        fail(f"bsw results differ from the oracle: {bad[:8]}")


def chain_inputs(make, calls):
    """`make` (io.chain_dump.ChainCallInput) of the fixtures' calls (json
    dicts) or of the big goldens' npz arrays (prepare_call's defaults)."""
    if isinstance(calls, list):
        return [make(c["n"], c["avg_qspan"], c["max_dist_x"], c["max_dist_y"], c["bw"], c["n_segs"],
                     np.array([int(v) for v in c["x"]], np.uint64),
                     np.array([int(v) for v in c["y"]], np.uint64)) for c in calls]
    return [make(len(calls[f"x{ci}"]), float(calls[f"qspan{ci}"]), 5000, 5000, 500, 1,
                 calls[f"x{ci}"], calls[f"y{ci}"]) for ci in range(int(calls["n_cases"]))]


def chain_phases(torch, port: Port, rec: Record, seed: int):
    """Phases 7 and 8: the chain kernel alone and the chain main path."""
    C, cli_chain, kernel = port.C, port.cli_chain, port.chain_cuda.chain_dp
    name = kernel.name

    # 7. kernel vs plain version, 128 calls of 4096 anchors, as generated and with spans
    rng = np.random.default_rng(0)
    n_calls, n = CHAIN_BENCH
    raw = []
    for _ in range(n_calls):
        x, y = synth_call(rng, n)
        raw.append((x, y, float(rng.uniform(10, 40))))
    spans_rng = np.random.default_rng(seed)
    for label, ys in (("as generated", [y for _, y, _ in raw]),
                      ("spans 10-29", [with_spans(y, spans_rng) for _, y, _ in raw])):
        preps = [C.prepare_call(x, y, aq) for (x, _, aq), y in zip(raw, ys)]
        tb, params = port.chain_batch_from_numpy(preps, DEVICE)
        C.chain_dp(tb, params)  # warm-up: first launch
        ms, got = time_ms(torch, lambda: C.chain_dp(tb, params), 3)
        st: dict = {}
        plain_ms, want = time_ms(torch, lambda: C.chain_dp_plain(tb, params, stats=st), 1)
        err = max_abs_diff(torch, got, want)
        bms, by = chain_bound(n_calls * n, n_calls, params[2], st)
        row = {"shape": f"{n_calls}x{n}", "y": label, "ms": ms, "plain_ms": plain_ms,
               "max_abs_err": err, "anchors_per_s": n_calls * n / (ms * 1e-3),
               "w_need_max": max(p["w_need"] for p in preps), **st,
               "predecessors_per_s": st["predecessors"] / (ms * 1e-3),
               "scores_nonzero": int((got[0] != 0).sum()), "bound_ms": bms, "bound_by": by}
        log("chain kernel vs plain " + json.dumps(row))
        rec.check(name, err, f"{row['shape']} ({label})")

    # 8. the main path at the reference dataset's size
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        dump = Path(tmp) / "calls.txt"
        t0 = time.perf_counter()
        total = write_dump(dump, np.random.default_rng(CHAIN_SEED), CHAIN_CALLS,
                           spans_rng=np.random.default_rng(seed))
        log(f"chain dump: {CHAIN_CALLS} calls, {total} anchors, "
            f"{dump.stat().st_size / 1e6:.1f} MB, written in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        calls = port.chain_dump.parse_chain_dump(dump)
        parse_s = time.perf_counter() - t0
        anchors = sum(c.n for c in calls)
        if len(calls) != CHAIN_CALLS or anchors != total or max(c.n for c in calls) != CHAIN_MAX_N:
            fail(f"parsed {len(calls)} calls and {anchors} anchors, wrote {CHAIN_CALLS} and {total}")

        stats: dict = {}
        kept: list = []  # per launch: the tensors it was given, its output
        port.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = cli_chain.run_calls(calls, device=DEVICE, stats=stats, keep=kept)
        run_s = time.perf_counter() - t0
        launches = port.launches()
        runs_s = [run_s]
        for _ in range(2):
            t0 = time.perf_counter()
            again = cli_chain.run_calls(calls, device=DEVICE)
            runs_s.append(time.perf_counter() - t0)
            if any(not np.array_equal(a, b) for ra, rb in zip(again, results) for a, b in zip(ra, rb)):
                fail("a second run of the chain main path gave other results")
        run_s_median = float(np.median(runs_s))
        total_s = parse_s + run_s_median
        scored = sum(int(np.count_nonzero(sc)) for sc, _, _ in results)
        with_parent = sum(int(np.count_nonzero(par >= 0)) for _, par, _ in results)
        e2e = {"calls": len(calls), "anchors": anchors, "file_mb": dump.stat().st_size / 1e6,
               "parse_s": parse_s, **stats, "run_s_all": runs_s, "run_s_median": run_s_median,
               "total_s": total_s, "anchors_per_s_end_to_end": anchors / total_s,
               "scores_nonzero_share": scored / anchors, "parents_share": with_parent / anchors,
               "launches": launches}
        log("chain end to end " + json.dumps(e2e))
        rec.launched(launches, (name,))
        for c, (sc, par, pk) in zip(calls, results):
            if (sc.shape != (c.n,) or par.shape != (c.n,) or pk.shape != (c.n,)
                    or sc.dtype != np.int32 or par.dtype != np.int64):
                fail(f"chain main path gave shapes {sc.shape}, {par.shape}, {pk.shape} for n {c.n}")
            if not (np.all((par >= -1) & (par < np.arange(c.n))) and np.all(pk >= sc)):
                fail("chain main path gave a parent at or after its anchor, or a peak below its score")

        prof = device_profile(torch, lambda: cli_chain.run_calls(calls, device=DEVICE))
        log("chain profile " + json.dumps(prof))

        # the CLI's output file for the dump's first calls equals print_return
        # of the pooled results
        head, out_file = Path(tmp) / "calls_head.txt", Path(tmp) / "out.txt"
        with open(dump) as src, open(head, "w") as dst:
            records = 0
            while records < CHAIN_CLI_CALLS:
                line = src.readline()
                dst.write(line)
                records += line == "EOR\n"
        with contextlib.redirect_stderr(io.StringIO()) as err_buf:
            rc = cli_chain.main(["-i", str(head), "-o", str(out_file)])
        want_buf = io.StringIO()
        for sc, par, _ in results[:CHAIN_CLI_CALLS]:
            port.chain_dump.print_return(want_buf, sc, par)
        if rc != 0 or out_file.read_text() != want_buf.getvalue():
            fail(f"chain CLI output differs from the pooled results (rc {rc})")
        log(f"chain CLI: the output file of {CHAIN_CLI_CALLS} calls equals print_return of the "
            f"pooled results ({out_file.stat().st_size} bytes; {err_buf.getvalue().strip()})")

    # every output of the counted run against the plain version on the same
    # device tensors; the plain version counts the predecessors
    seen = {"launches": 0, "anchors": 0, "plain_s": 0.0}
    for kb in kept:
        st = {}
        plain_ms, want = time_ms(torch, lambda: C.chain_dp_plain(kb["batch"], kb["params"],
                                                                 stats=st), 1)
        rec.check(name, max_abs_diff(torch, kb["out"], want), f"main-path launch {kb['params']}")
        kb.update(plain_ms=plain_ms, stats=st)
        seen["launches"] += 1
        seen["anchors"] += kb["out"].shape[1]
        seen["plain_s"] += plain_ms * 1e-3
        for k, v in st.items():
            seen[k] = max(seen.get(k, 0), v) if k == "predecessors_max_call" else seen.get(k, 0) + v
    if seen["launches"] != len(kept) or seen["anchors"] != anchors:
        fail(f"the plain check saw {seen['launches']} launches and {seen['anchors']} anchors")
    log("chain main path vs plain, every output " + json.dumps(seen))
    if not (e2e["scores_nonzero_share"] > 0 and e2e["parents_share"] > 0 and seen["breaks"] > 0):
        fail("the chain main path's calls did not score, chain and break: the check would "
             "hold nothing")

    # the kernel on the main path's largest launch
    kb = max(kept, key=lambda kb: kb["out"].shape[1])
    ms, got = time_ms(torch, lambda: C.chain_dp(kb["batch"], kb["params"]), 3)
    rec.check(name, max_abs_diff(torch, got, kb["out"]), "a rerun of the main path's launch")
    n_launch = kb["out"].shape[1]
    bms, by = chain_bound(n_launch, kb["batch"]["n"].numel(), kb["params"][2], kb["stats"])
    row = {"shape": f"{kb['batch']['n'].numel()} calls, {n_launch} anchors", "ms": ms,
           "plain_ms": kb["plain_ms"], "anchors_per_s": n_launch / (ms * 1e-3), **kb["stats"],
           "predecessors_per_s": kb["stats"]["predecessors"] / (ms * 1e-3),
           "bound_ms": bms, "bound_by": by}
    log(f"{name} on the main path's launch " + json.dumps(row))
    rec.kern[name].update(ms=ms, plain_ms=kb["plain_ms"], bound_ms=bms, bound_by=by)

    # the reference goldens through run_calls on the card, scores and parents exactly
    fixtures = HERE / "tests" / "fixtures"
    for label, src in (("chain_golden.json", json.loads((fixtures / "chain_golden.json").read_text())),
                       ("chain_big_golden.npz", np.load(fixtures / "chain_big_golden.npz"))):
        gcalls = chain_inputs(port.chain_dump.ChainCallInput, src)
        t0 = time.perf_counter()
        got = cli_chain.run_calls(gcalls, device=DEVICE)
        if isinstance(src, list):
            want = [(c["scores"], c["parents"]) for c in src]
        else:
            want = [(src[f"scores{ci}"], src[f"parents{ci}"]) for ci in range(len(gcalls))]
        good = sum(np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
                   for g, w in zip(got, want))
        log(f"chain goldens {label}: {good}/{len(want)} exact, up to "
            f"{max(c.n for c in gcalls)} anchors ({time.perf_counter() - t0:.1f} s)")
        if good != len(want):
            fail(f"chain goldens {label}: {good}/{len(want)}")

    # calls of the dump against the port's oracle, exactly
    t0 = time.perf_counter()
    sel = [i for i, c in enumerate(calls) if 0 < c.n <= CHAIN_ORACLE_MAX_N][:CHAIN_ORACLE_CALLS]
    bad = []
    for i in sel:
        c = calls[i]
        want = port.chain_oracle.chain_dp(port.chain_oracle.ChainCall(
            c.n, c.avg_qspan, c.max_dist_x, c.max_dist_y, c.bw, c.n_segs, c.x, c.y))
        if not all(np.array_equal(results[i][r], want[k])
                   for r, k in enumerate(("scores", "parents", "peak_scores"))):
            bad.append(i)
    log(f"chain oracle sample: {len(sel) - len(bad)}/{len(sel)} calls exact "
        f"({time.perf_counter() - t0:.1f} s)")
    if bad or not sel:
        fail(f"chain results differ from the oracle in calls {bad}")


def abea_time(torch, port, batch, reps=3):
    """The fill and the walk on `batch`, each the best of `reps` (CUDA
    events) after a warm-up: (fill ms, fill, walk ms, walk)."""
    A = port.A
    A.abea_walk(batch, A.abea_fill(batch))
    fill_ms, fill = time_ms(torch, lambda: A.abea_fill(batch), reps)
    walk_ms, walk = time_ms(torch, lambda: A.abea_walk(batch, fill), reps)
    return fill_ms, fill, walk_ms, walk


def abea_check(torch, port, rec, batch, fill, walk, where):
    """Every output of the kernels against the plain versions on the same
    tensors (tolerance 0); returns the plain fill's and walk's ms."""
    A = port.A
    pf_ms, pf = time_ms(torch, lambda: A.abea_fill_plain(batch), 1)
    rec.check("abea_fill", max(max_abs_diff(torch, fill[k], v) for k, v in pf.items()), where)
    pw_ms, pw = time_ms(torch, lambda: A.abea_walk_plain(batch, fill), 1)
    rec.check("abea_walk", max(max_abs_diff(torch, walk[k], v) for k, v in pw.items()), where)
    return pf_ms, pw_ms


def abea_row(torch, port, batch_np, batch, fill_ms, fill, walk_ms, walk) -> dict:
    """The kernels' numbers on one batch: bands, valid cells, walk steps,
    rates, bounds and the reads that align."""
    walk_np = {k: v.cpu().numpy() for k, v in walk.items()}
    cells, steps, b = abea_cells(torch, batch, fill), int(walk_np["n"].sum()), len(batch_np["ne"])
    fb, fby = abea_fill_bound(batch, cells)
    wb, wby = abea_walk_bound(b, steps)
    return {"reads": b, "events": int(batch_np["ne"].sum()), "kmers": int(batch_np["nk"].sum()),
            "bands": port.A.n_rows(batch), "bands_max_read": int((batch_np["ne"] + batch_np["nk"]).max()) + 2,
            "cells": cells, "walk_steps": steps, "fill_ms": fill_ms, "walk_ms": walk_ms,
            "cells_per_s": cells / (fill_ms * 1e-3), "fill_bound_ms": fb, "fill_bound_by": fby,
            "walk_bound_ms": wb, "walk_bound_by": wby,
            "aligned": sum(1 for r in port.A.decode(batch_np["band_off"], walk_np) if r)}


def abea_phases(torch, port: Port, rec: Record, seed: int):
    """Phases 9 and 10: the abea kernels alone and the abea main path."""
    A, cli_abea = port.A, port.cli_abea

    # 9. kernels vs plain versions, 128 reads of 1-4 kb (tools/abea_scale_bench.py)
    rng = np.random.default_rng(ABEA_SEED)
    model = synth_model(rng)
    n_reads, lo_len, hi_len = ABEA_BENCH
    reads = [synth_read(rng, model, n) for n in np.linspace(lo_len, hi_len, n_reads).astype(int)]
    batch_np, _ = A.prepare_batch([s for s, _ in reads], [e for _, e in reads], model,
                                  [1.0] * n_reads, [0.0] * n_reads)
    tb = port.abea_batch_from_numpy(batch_np, DEVICE)
    fill_ms, fill, walk_ms, walk = abea_time(torch, port, tb)
    pf_ms, pw_ms = abea_check(torch, port, rec, tb, fill, walk, "128 reads of 1-4 kb")
    row = {"shape": f"{n_reads} reads of {lo_len}-{hi_len} bases",
           **abea_row(torch, port, batch_np, tb, fill_ms, fill, walk_ms, walk),
           "plain_fill_ms": pf_ms, "plain_walk_ms": pw_ms, "max_abs_err": 0.0}
    log("abea kernels vs plain " + json.dumps(row))
    if row["aligned"] != n_reads:
        fail(f"abea: {row['aligned']} of the {n_reads} bench reads aligned")

    # 9. the kernels alone on the long-read workload: 16 reads of 10-50 kb, one of 100 kb
    rng = np.random.default_rng(ABEA_SEED)
    model = synth_model(rng)
    n_long, lmin, lmax, l100 = ABEA_LONG
    reads = [synth_read(rng, model, n) for n in
             [*np.linspace(lmin, lmax, n_long).astype(int).tolist(), l100]]
    batch_np, _ = A.prepare_batch([s for s, _ in reads], [e for _, e in reads], model,
                                  [1.0] * len(reads), [0.0] * len(reads))
    tb = port.abea_batch_from_numpy(batch_np, DEVICE)
    row = {"shape": f"{n_long} reads of {lmin}-{lmax} bases and one of {l100}",
           **abea_row(torch, port, batch_np, tb, *abea_time(torch, port, tb))}
    log("abea kernels on long reads " + json.dumps(row))
    if row["aligned"] != len(reads):
        fail(f"abea: {row['aligned']} of the {len(reads)} long reads aligned")
    del tb, reads

    # 9. the host's event detection on signals of the long-read lengths
    lengths = [*np.linspace(lmin, lmax, n_long).astype(int).tolist(), l100]
    sigs = [sig for _, sig in golden_reads(lengths, np.random.default_rng(ABEA_SEED))]
    t0 = time.perf_counter()
    evs = port.abea_events.detect_events_batch(sigs)
    det = {"reads": len(sigs), "samples": sum(len(v) for v in sigs),
           "events": sum(len(e) for e in evs), "events_s": time.perf_counter() - t0,
           "per_read_loop_reads": port.abea_events.lockstep_split(
               sorted((len(v) for v in sigs), reverse=True))}
    log("abea host detection on long-read signals " + json.dumps(det))
    del sigs, evs

    # 10. the main path, abea-512
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        fa, npz, tsv = Path(tmp) / "reads.fa", Path(tmp) / "signals.npz", Path(tmp) / "pore.tsv"
        lengths = np.linspace(*ABEA_LENS, ABEA_READS).astype(int)
        t0 = time.perf_counter()
        samples = write_abea_dataset(fa, npz, tsv, lengths, np.random.default_rng(seed))
        log(f"abea dataset: {ABEA_READS} reads, {int(lengths.sum())} bases, {samples} samples, "
            f"npz {npz.stat().st_size / 1e6:.1f} MB, written in {time.perf_counter() - t0:.1f} s")

        port.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = port.abea_signal.load_pore_model(str(tsv))
        signals = port.abea_signal.load_signals_npz(str(npz))
        records = list(port.read_sequences(str(fa)))
        load_s = time.perf_counter() - t0
        # one f5c batch: -K 512 reads, -B 3.7M bases
        groups = list(cli_abea.batches(records, ABEA_READS, cli_abea.parse_bases(ABEA_MAX_BASES)))
        if len(groups) != 1:
            fail(f"abea-512 makes {len(groups)} batches at -K {ABEA_READS} -B {ABEA_MAX_BASES}")
        pstats: dict = {}
        t0 = time.perf_counter()
        prep = cli_abea.prepare_reads(records, signals, model, stats=pstats)
        prep_s = time.perf_counter() - t0
        stats: dict = {}
        kept: dict = {}  # the tensors the kernels were given and their outputs
        t0 = time.perf_counter()
        results = cli_abea.run_reads(prep, model, DEVICE, stats=stats, keep=kept)
        runs_s = [time.perf_counter() - t0]
        launches = port.launches()
        for _ in range(2):
            t0 = time.perf_counter()
            again = cli_abea.run_reads(prep, model, DEVICE)
            runs_s.append(time.perf_counter() - t0)
            if again != results:
                fail("a second run of the abea main path gave other results")
        run_s_median = float(np.median(runs_s))
        n_events = sum(len(e) for e in prep.events)
        total_s = load_s + prep_s + run_s_median
        t0 = time.perf_counter()
        tsv_buf = io.StringIO()
        n_pairs = cli_abea.emit(prep, results, model, tsv_buf)
        emit_s = time.perf_counter() - t0
        aligned = sum(1 for r in results if r)
        walk_np = {k: v.cpu().numpy() for k, v in kept["walk"].items()}
        e2e = {"reads": len(records), "bases": int(lengths.sum()), "samples": samples,
               "events": n_events, "reads_aligned": aligned,
               "reads_qc_dropped": len(results) - aligned,
               "reads_too_short": prep.n_reads - len(results), "pairs": n_pairs,
               "moves": abea_moves(kept["batch"]["band_off"].cpu().numpy(), walk_np),
               "per_read_loop_reads": port.abea_events.lockstep_split(
                   sorted((len(v) for v in signals.values()), reverse=True)),
               "load_s": load_s, "prep_s": prep_s, **pstats, **stats, "run_s_all": runs_s,
               "run_s_median": run_s_median, "total_s": total_s,
               "events_per_s_end_to_end": n_events / total_s,
               "reads_per_s_end_to_end": len(records) / total_s, "emit_s": emit_s,
               "tsv_mb": len(tsv_buf.getvalue()) / 1e6, "launches": launches}
        del tsv_buf
        log("abea end to end " + json.dumps(e2e))
        rec.launched(launches, ("abea_fill", "abea_walk"))
        if launches["abea_fill"] != 1 or launches["abea_walk"] != 1:
            fail(f"the abea main path launched {launches}: one fill and one walk expected")
        if aligned == 0:
            fail("no read of the abea main path aligned")

        prof = device_profile(torch, lambda: cli_abea.run_reads(prep, model, DEVICE))
        log("abea profile " + json.dumps(prof))

        # the CLI's output for the first reads equals the TSV of the pooled pairs
        head, out = Path(tmp) / "head.fa", Path(tmp) / "out.tsv"
        with open(fa) as src, open(head, "w") as dst:
            for _ in range(2 * ABEA_CLI_READS):
                dst.write(src.readline())
        names = {f"read{r}" for r in range(ABEA_CLI_READS)}
        sel = [j for j, n in enumerate(prep.names) if n in names]
        sub = cli_abea.PreparedReads(ABEA_CLI_READS, *([getattr(prep, f)[j] for j in sel]
                                                       for f in ("names", "seqs", "events",
                                                                 "shifts", "scales")))
        want = io.StringIO()
        want.write(cli_abea.HEADER)
        want_pairs = cli_abea.emit(sub, [results[j] for j in sel], model, want)
        with contextlib.redirect_stderr(io.StringIO()) as err_buf:
            rc = cli_abea.main(["--reads", str(head), "--raw", str(npz), "--model", str(tsv),
                                "-o", str(out)])
        summary = f"[eventalign] {ABEA_CLI_READS} reads, {want_pairs} aligned event-kmer pairs"
        if rc != 0 or out.read_text() != want.getvalue() or summary not in err_buf.getvalue():
            fail(f"abea CLI output differs from the pooled pairs (rc {rc})")
        log(f"abea CLI: the output of the first {ABEA_CLI_READS} reads equals the TSV of the "
            f"pooled pairs ({out.stat().st_size} bytes; {summary})")

        # the goldens through the port's host prep and alignment on the card
        cases = json.loads((HERE / "tests" / "fixtures" / "abea_golden.json").read_text())["cases"]
        gtsv = Path(tmp) / "golden_pore.tsv"
        write_pore_model(gtsv)
        gmodel = port.abea_signal.load_pore_model(str(gtsv))
        t0 = time.perf_counter()
        gev = port.abea_events.detect_events_batch(
            [np.array([float(x) for x in c["signal"]], np.float32) for c in cases])
        gsh, gsc = port.abea_events.estimate_scalings_mom_batch([c["seq"] for c in cases],
                                                                gmodel, gev)
        got = A.align_events_batch([c["seq"] for c in cases], [e["mean"] for e in gev], gmodel,
                                   [float(v) for v in gsc], [float(v) for v in gsh], DEVICE)
        good = sum(e["start"].astype(np.int64).tolist() == [x[0] for x in c["events"]]
                   and np.array_equal(e["mean"], np.array([float.fromhex(x[2]) for x in c["events"]],
                                                          np.float32))
                   and sc == np.float32(float.fromhex(c["scale"]))
                   and sh == np.float32(float.fromhex(c["shift"]))
                   and g == [tuple(x) for x in c["pairs"]]
                   for c, e, sc, sh, g in zip(cases, gev, gsc, gsh, got))
        log(f"abea goldens abea_golden.json: {good}/{len(cases)} exact (events, scale, shift, "
            f"pairs; {time.perf_counter() - t0:.1f} s)")
        if good != len(cases):
            fail(f"abea goldens: {good}/{len(cases)}")

    # every output of the counted run against the plain versions on the same tensors
    batch, fill, walk = kept["batch"], kept["fill"], kept["walk"]
    pf_ms, pw_ms = abea_check(torch, port, rec, batch, fill, walk, "abea-512's counted run")
    log("abea main path vs plain, every output " + json.dumps(
        {"bands": A.n_rows(batch), "reads": batch["ne"].numel(), "plain_fill_s": pf_ms * 1e-3,
         "plain_walk_s": pw_ms * 1e-3}))

    # the kernels on the main path's launch
    fill_ms, fill2, walk_ms, walk2 = abea_time(torch, port, batch)
    rec.check("abea_fill", max(max_abs_diff(torch, fill2[k], v) for k, v in fill.items()),
              "a rerun of the main path's launch")
    rec.check("abea_walk", max(max_abs_diff(torch, walk2[k], v) for k, v in walk.items()),
              "a rerun of the main path's launch")
    batch_np = {k: v.cpu().numpy() for k, v in batch.items()}
    row = {"shape": "abea-512's launch", **abea_row(torch, port, batch_np, batch, fill_ms, fill2,
                                                     walk_ms, walk2),
           "plain_fill_ms": pf_ms, "plain_walk_ms": pw_ms}
    log("abea kernels on the main path's launch " + json.dumps(row))
    rec.kern["abea_fill"].update(ms=fill_ms, plain_ms=pf_ms, bound_ms=row["fill_bound_ms"],
                                 bound_by=row["fill_bound_by"])
    rec.kern["abea_walk"].update(ms=walk_ms, plain_ms=pw_ms, bound_ms=row["walk_bound_ms"],
                                 bound_by=row["walk_bound_by"])

    # the batch's shortest reads against the port's oracle, exactly
    t0 = time.perf_counter()
    sel = sorted(range(len(prep.seqs)), key=lambda j: len(prep.seqs[j]))[:ABEA_ORACLE_READS]
    bad = [j for j in sel if port.abea_oracle.align(prep.seqs[j], prep.events[j]["mean"], model,
                                                    prep.scales[j], prep.shifts[j]) != results[j]]
    lens = [len(prep.seqs[j]) for j in sel]
    log(f"abea oracle sample: {len(sel) - len(bad)}/{len(sel)} of the batch's shortest reads "
        f"({min(lens)}-{max(lens)} bases) exact ({time.perf_counter() - t0:.1f} s)")
    if bad or len(sel) != ABEA_ORACLE_READS:
        fail(f"abea results differ from the oracle in reads {bad}")


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        port = Port()
    except ImportError as e:
        fail(f"the port is not importable ({e}); run from the repository root")
    log(f"seed {args.seed}")

    # 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    smi = smi[0].strip() if smi else "nvidia-smi gave nothing"
    nvcc = port.build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()
    env = {"python": sys.version.split()[0], "torch": torch.__version__,
           "torch_cuda": torch.version.cuda, "nvcc": nvcc_ver[-1] if nvcc_ver else "",
           "device": torch.cuda.get_device_name(0),
           "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
           "build_dir_free_gb": shutil.disk_usage(HERE).free / 1e9}
    log("env " + json.dumps(env))

    # 2. build: one nvcc per source, all started together
    sources = (port.phmm_cuda.SOURCE, port.bsw_cuda.SOURCE, port.chain_cuda.SOURCE,
               port.abea_cuda.FILL_SOURCE, port.abea_cuda.WALK_SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as ex:
        lib_paths = list(ex.map(port.build.build, sources))
    for src in sources:
        port.build.load(src)
    log(f"build {', '.join(p.name for p in lib_paths)}: {time.perf_counter() - t0:.2f} s")
    for lib_path in lib_paths:
        for ln in lib_path.with_suffix(".log").read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  ptxas {lib_path.name}: {ln.strip()}")

    rec = Record(port.launches())
    phmm_phases(torch, port, rec, args.seed)
    bsw_phases(torch, port, rec, args.seed)
    chain_phases(torch, port, rec, args.seed)
    abea_phases(torch, port, rec, args.seed)

    # 11. the kernels line, the card, the last line
    where = {"phmm_forward_f32": (SOURCE, REPLACES), "phmm_forward_f64": (SOURCE, REPLACES),
             "bsw_extend": (BSW_SOURCE, BSW_REPLACES), "chain_dp": (CHAIN_SOURCE, CHAIN_REPLACES),
             "abea_fill": (ABEA_FILL_SOURCE, ABEA_FILL_REPLACES),
             "abea_walk": (ABEA_WALK_SOURCE, ABEA_WALK_REPLACES)}
    kernels = []
    for name, k in rec.kern.items():
        kernels.append({"name": name, "route": "cuda", "source": where[name][0],
                        "replaces": where[name][1], "launches": k["launches"],
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
                        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
