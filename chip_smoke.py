#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's PairHMM, bsw, chain, abea (read-coordinate and
eventalign modes), fmi, kmer, poa, grm, basecall and call_var paths and its
occ-gather, bsw roofline and chain roofline probes on one GPU and hold their
kernels to their plain PyTorch versions.

    python3 chip_smoke.py [--seed 0]

Phases, run in the order 1, 2, 11, 12, 3-10, 16-21, 13-15 (any failure
exits non-zero and prints no result):
  1. environment: Python, torch, CUDA, nvcc and the card (nvidia-smi);
  2. build csrc/phmm_forward.cu, csrc/bsw_extend.cu, csrc/chain_dp.cu,
     csrc/abea_fill.cu, csrc/abea_walk.cu, csrc/occ_gather.cu,
     csrc/bsw_stripped.cu and csrc/chain_micro.cu with nvcc, one process
     per source, started together (timed; ptxas register and spill lines);
  3. the f32 PairHMM kernel against the plain version on the card, bit for
     bit, at bench.py's shapes 8192x(250x302) and 4096x(250x473), with
     kernel and plain times (CUDA events), GCUPS and the bound; then both
     instances on the batches of `phmm_edge_cases` (read lengths at the
     lane, tile and bucket edges, haps of 1 and h_pad bases, N, quals 0 and
     126, float underflows, B = 1; r_pad 64-640, so every row-edge instance
     in one tile and in more; seeded from --seed), tolerance 0;
  4. the PairHMM main path: `cli.phmm.run_testcases` over a testfile written
     from --seed in the shape of the reference benchmark's dataset (550
     batches of <=110 reads x <=37 haps), launch counts reset just before
     and read just after; phase split, end-to-end GCUPS (parse plus the
     median of three runs), fallback fraction; the run once more under
     torch.profiler for the device's busy share and time by kind; the CLI's
     printed lines against the pooled results; then every raw output of the
     counted run, f32 and f64, bucket by bucket, against the plain version
     on the same device tensors; every launch of the counted run (12 f32,
     8 f64) timed again on its bucket's tensors, one line each with its
     cases, ms and bound (the kernels' figures are the largest bucket's);
     and 16 seeded testcases against the port's oracle (exactly);
  5. the bsw kernel against its plain version on the card, bit for bit, at
     tools/bench_all.py's shape 8192x(128x256) (8% mutations, h0 20-59),
     with kernel and plain times, GCUPS and the bound; then on the edge
     pairs of `bsw_edge_pairs` (query lengths at lane and bucket edges,
     breaks, ties, h0 around o_ins + e_ins, seeded from --seed), through
     `cli.bsw.score_pairs` (each bucket on its edge's instance) and whole
     on the widest instance;
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
     launch; 512 seeded pairs against the port's oracle (exactly); the 300
     reference goldens (tests/fixtures/bsw_golden.json) through
     `cli.bsw.score_pairs` on the card, every output exactly;
  7. the chain kernel against its plain version on the card, bit for bit,
     on 128 calls of 4096 anchors made by the generator of
     tools/chain_scale_bench.py (rng seed 0, avg_qspan 10-40), and on the
     same anchors with query spans 10-29 (--seed) written into y (the
     generator's y has none, so every score there is 0 and no call reaches
     the max_skip break); kernel and plain times, anchors/s, the
     predecessors visited and the bound; then on the edge calls of
     `chain_edge_calls` (windows of 1-250 and MAX_ITER predecessors, breaks
     at every offset of a step, in-step marks, ties; seeded from --seed);
  8. the chain main path at the reference dataset's size: 1001 calls,
     12,030,789 anchors, up to 87,271 a call, written with the generator of
     tools/chain_scale_bench.py (rng seed 5) with query spans 10-29 (--seed)
     written into y, so that the calls score, mark and break;
     `io.chain_dump.parse_chain_dump`,
     then `cli.chain.run_calls` on the card, launch counts reset just before
     and read just after; phase split, the median of three runs, end-to-end
     anchors/s (parse plus the median run); the run once more under
     torch.profiler; the CLI's output file for the dump's first 50 calls
     against print_return of the pooled results; the counted run's
     outputs of every call of up to 16,384 anchors (CHAIN_PLAIN_MAX_N;
     ~77% of the calls) against the plain version on the same device
     tensors (tolerance 0: integers), which also counts their predecessors
     for the bound; the kernel timed on the main path's launch and on
     those calls as one launch (the kernels line's figures); the 25 + 6
     reference goldens through `run_calls` on the card; up to 8 calls of
     the dump with n <= 1500 against the port's oracle (exactly);
  9. the abea kernels (fill and walk) against their plain versions on the
     card, bit for bit, on 128 reads of 1-4 kb made by the generator of
     tools/abea_scale_bench.py (synth_read, rng seed 17), with kernel and
     plain times, band cells/s and the bounds; then on the batches of
     `abea_edge_reads` (ne or nk of 1, reads shorter than the band, stay-
     and skip-heavy reads, ties, sums that round, a read of 13 windows, a
     batch of one read; seeded from --seed) and the first of them blocked
     (`abea_blocked`: seed 0, clamped offsets), tolerance 0; then the
     kernels alone on that tool's long-read workload (16 reads of 10-50 kb
     and one of 100 kb, seed 17), which must all align; and the host's
     event detection on raw signals of those lengths (golden recipe, seed
     17); each kernel row gives the longest read's bands and walk steps
     and the ns a band and a step;
 10. the abea main path, cell abea-512: one f5c batch of 512 reads of
     1,000-13,450 bases (3,698,945 bases, the reference's `-B 3.7M`), raw
     signals by the golden recipe of tests/generate_fixtures.py (seeded
     from --seed) written to an npz and a FASTA; load, `cli.abea.
     prepare_reads` (events and scalings on the host) and three runs of
     `cli.abea.run_reads`, launch counts reset just before and read just
     after; phase split, events/s end to end (load + prep + the median
     run), the TSV emit timed apart; the run once more under
     torch.profiler; the CLI's output for the first 20 reads against the
     TSV of the pooled pairs; the counted run's outputs of every read of
     up to 4,000 bases (ABEA_PLAIN_MAX_BASES) against the plain versions
     on the same device tensors; the kernels timed on the main path's
     launch and on those reads as one launch (the kernels line's
     figures); the 25 abea goldens on the card; the batch's 8 shortest
     reads against the port's oracle;
 11. the occ-gather probes, cell occ-gather-4m: the probe tool
     (`tools.occ_gather_experiment.run`) on its workload (4,000,000 random
     64-byte rows, 256 MB, rng seed 3; 16,384 indices), launch counts reset
     just before and read just after, every variant checked against numpy;
     then `occ_gather_row` (2 and 8 rows in flight) and `occ_gather_tile`
     against their plain versions on the card, bit for bit, on the tool's
     indices and on 16,777,216 indices from --seed, with times (CUDA
     events), MB/s, Mrows/s, the bound by bytes, `index_select` of the same
     rows (the library gather) and of 32- and 128-byte rows;
 12. the fmi main path, cell fmi-256m-2048 (tools/genome_scale_fmi.py's
     rehearsal): a uniform random 256 Mbp reference (synth_reference, seeded
     from --seed; 512,000,001 text characters, 8,000,001 occ rows, 512 MB)
     indexed on the card by the port's builder (set-up: time and peak
     memory), 2,048 reads of 151 bp with 1% substitutions (synth_reads)
     written as a FASTQ; `cli.fmi.prepare` and three runs of `cli.fmi.run`
     (batch 512, min seed length 19), launch counts reset just before and
     read just after; the phase split (load, encode, search, D2H + unpack
     + sort), reads/s, SMEMs a phase, lockstep steps (= host syncs), occ
     rows gathered and the gather bound (those rows at `occ_gather_row`'s
     rate on this table); the run once more under torch.profiler; the CLI's
     --print-output dump of the first 16 reads against the pooled results;
     batch 0 against the same batch through the port on the CPU; 8 reads
     against the port's oracle over the same index (`oracle_view`); the 25
     fmi goldens, indexes built and searched on the card;
 13. the bsw roofline probe, cell bsw-roofline-8192: the probe tool
     (`tools.bsw_roofline.run`) on its workload (8,192 pairs of 128 x 256,
     rng seed 5, h0 30), launch counts reset just before and read just
     after (`bsw_stripped` and `bsw_extend` must both launch), the SM
     clock and power sampled meanwhile; then `bsw_stripped` against its
     plain version on the card, bit for bit on the whole final H and E
     [2, 136, 8192], from zero (the tool's input, which must stay all
     zero) and from a start seeded from --seed (H 0-60, E 0-30, the start
     that tests the kernel and gives its time; both sides timed as the
     best of 5 means of 8 calls in a row, and as the best of 5 single
     calls, PR 6's yardstick), with the tool's strip time over each of
     the phase's, the bound, the cells
     each side computes (every cell of 136 x 256 against the band cells
     of ksw_extend, counted by the plain bsw version, whose outputs the
     prod side's are held to) and ns a cell; the slots each side's layout
     computes (strip: lanes x rows a lane x target rows; prod: bsw_extend's
     lanes x entries a lane x the rows each warp steps), ns a slot and
     their ratio, and the chain floor (`strip_chain_cycles` a target row);
     then, after the timed checks, the kernel against its plain version at
     the edge instances, qe_pad 8 and 520, from the four starts of
     `strip_edge_batch` (zero, seeded, INT32_MAX, H near INT32_MAX with E
     small);
 14. the chain roofline probe, cell chain-roofline-128x4096: the probe tool
     (`tools.chain_roofline.run`) on its workload (128 calls of 4096
     anchors, rng seed 0, w 64, bw 500), counts reset just before and read
     just after (`chain_micro` and `chain_dp` must both launch), the SM
     clock and power sampled meanwhile; then
     `chain_micro` against its plain version on the card, bit for bit on
     the whole [128, 4096], with times (both yardsticks, as phase 13) and
     the bound; the prod side
     (`chain_dp` on the same anchors, windows 64 back) timed and held to
     the plain chain version, which counts the predecessors it visits; ns
     and SM cycles an anchor on each side at the phase's median clock, and
     the chain floor (MICRO_CHAIN_CYCLES an anchor); then the kernel
     against its plain version at windows 1, 33, 129, 257 and 700 on the
     calls of `micro_edge_calls` (phantom predecessors, slopes whose
     products wrap);
 16. the eventalign main path, cell eventalign-512 (run after phase 10):
     abea-512's reads and signals (seeded from --seed) laid into one
     contig, every other read reverse complemented, with 50-499 random
     bases between reads and 1-3 insertions or deletions and a soft clip
     in each read's cigar; 16 unmapped, 16 MAPQ-5 and 16 secondary records
     besides (`write_eventalign_dataset`); a sorted BAM and its .bai
     written with the port's io.bam, the genome, a FASTQ, the npz and the
     model; load, `cli.abea.load_bam`, `bam_entries` and one f5c batch (-K
     512 -B 3.7M) through `cli.abea.eventalign_batch` on the card, launch
     counts reset just before and read just after (one fill and one walk);
     the phase split (load, BAM, events, MoM, the kernels, scaling and QC,
     the realign with its window steps = host syncs and wavefront steps,
     the emit), TSV rows/s and events/s end to end, the entry counts; -w
     over chr1's first 100 kb through the .bai (the same records as the
     record filter), its rows inside the region and its 2 shortest reads
     equal to the port's oracle with the region's bounds; the batch's 8
     shortest reads through `ops.eventalign.realign_batch` on the card and
     on the CPU against the main run's and the port's oracle, exactly; the
     25 eventalign goldens through `eventalign_batch` on the card, every
     status, scaling, summary and TSV row exactly;
 17. the kmer main path, cell kmer-0.25g (tools/kmer_scale_bench.py's
     synth_reads at its 0.25 Gbp rehearsal): 25,000 reads of 10,000 bases
     drawn from one uniform random 25 Mbp genome with 0.1% substitutions
     (seeded from --seed), written as FASTA with a config of k 17 and no
     minimizers; `cli.kmer_cnt.read_reads` (the 5,000-base overlap filter)
     and `cli.kmer_cnt.count` on the card, which streams the 250 Mbp
     through `ops.kmer.count_kmers_batched` (96 Mbp batches: 3 merges into
     the 2^26-slot accumulator); the phase split (parse, encode, H2D, pack
     and canonical, sort, merge), the merges (each waits for the device
     twice: the valid windows' compaction and the run ends' count), the three
     metrics, Mbases/s end to end (parse + count) and peak device memory;
     the CLI's lines for the first 512 reads; those reads through the
     one-shot and the streamed counter (3 merges) on the card and the CPU,
     all four metric sets equal; k 31 and 32 on 64 reads, card against
     CPU; the 25 kmer goldens on the card;
 18. the poa main path, cell poa-64x10x750 (tools/poa_scale_bench.py's
     synth_windows at its defaults): 64 windows of 10 sequences, each 750
     bases with 4% substitutions and 2 deletions (seeded from --seed),
     written as '>0'-delimited FASTA; `cli.poa.read_batches` and
     `ops.poa.msa_consensus_batch` on the card with the driver's scores;
     seqs/s end to end, the align / add / consensus split, rounds, fill
     rows and walk steps a round, fixpoint passes and reruns, host syncs a
     round, the torch ops of a row step and a walk step (counted on the CPU)
     and so the kernels and CUDA graph replays a round, and peak device
     memory; the CLI's stdout against the pooled
     consensus; 2 windows round by round on the card and the CPU (every
     alignment and the consensus equal); 4 seeded windows of 6 x 200 bases
     against the port's oracle; the 48 poa goldens (nw) and the 10 sw/ov
     cases on the card, exactly;
 19. the grm main path, cell grm-8192x65536 (tools/bench_all.py:405-431's
     genotypes: dosage 0/1/2 at 0.5/0.3/0.15, 5% missing, seeded from
     --seed): 65,536 variants x 8,192 samples written as a .bed by the
     port's write_bed, then `cli.grm` with --maf 0.01 --make-grm-bin at its
     default block (512), no hand-written kernel on the path (launch counts
     must stay 0); the split read / filter / H2D / products / D2H / write,
     variants/s end to end, the products' TFLOP/s, peak device memory; the
     CLI's lines; the written .grm.N.bin's diagonal against V's integer
     column sums (exactly) and the first 16 samples' .grm.bin against
     float64 over every variant (2e-5); the products timed in each
     precision mode; a 2,048 x 512 cut on the card and the CPU in every
     mode (counts exact, GRM within 2e-5); the 25 grm goldens on the card;
 20. the basecall main path, cell basecall-512: abea-512's 512 reads (the
     same signals from --seed, 29.6 M samples) through `cli.basecall` with
     the full DNA_R941 model, seeded weights, chunks of 4,000, --precision
     bf16, --beamsize 1; the split normalise / forward / decode, samples/s
     (the CLI's own figure and end to end), the forward's TFLOP/s, peak
     device memory; the FASTA (512 records over ACGT); bonito_golden.npz at
     f32 on the card within atol 5e-4 (fails if TF32 leaks in); bf16
     against f32 frame labels and called reads on the first 64 reads; card
     f32 log-probs against the CPU's on 4 reads (5e-4); the 4 shortest
     reads at the default --beamsize 5 (the Python beam's host time);
 21. the call_var main path, cell clair-131072: 32 batches of 4,096 pileup
     tensors [33, 8, 4] of Poisson(3) counts (seeded from --seed) in one
     npz through `cli.call_var` with seeded weights; load / predict /
     write, tensors/s, TFLOP/s, peak device memory; the four heads' shapes
     and sums; clair_golden.npz on the card (2e-5); one batch on the card
     and the CPU (2e-5) and against the CLI's rows;
 15. the abea chain cost: per abea cell the ns and SM cycles (at the
     median clock of phases 13-14) a band of the fill and a step of the
     walk, and the chain floors; each kernel's device seconds over one
     main-path run (the profiles of phases 4, 6, 8 and 10), a `kernels`
     JSON line, the card's name and power limit, and the last line
     {"ok": true, "device": {...}}.
Every measurement is printed as it is taken.  Needs one CUDA card; without
one it exits 1.  The bsw dataset (~3.8 GB), the chain dump (~236 MB), the
abea signals (~118 MB, twice: phases 10 and 16), the fmi reads and
index npz (~0.5 GB), the kmer reads (~255 MB), the poa windows, the grm
.bed (~134 MB) and its outputs (~268 MB), the basecall signals (~118 MB)
and the clair tensors (~554 MB) are written under build/ beside this
script and deleted at the end.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import gc
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
# f32 and f64 instruction rates of the H100 SXM outside the tensor cores:
# 132 SMs x 128 FP32 or 64 FP64 units x 1.98 GHz (the boost clock at which
# the data sheet gives 67 and 34 TFLOP/s, counting an FMA as two).  Every
# port kernel is built with -fmad=false and rounds each multiply and add on
# its own, so each floating-point operation is one instruction.
F32_OPS_PER_S = 132 * 128 * 1.98e9
F64_OPS_PER_S = 132 * 64 * 1.98e9
# int32: the issue rate, 4 warp instructions an SM a clock (128 lanes), which
# the 64 INT32 lanes (Hopper architecture white paper) and integer IMADs on
# the FMA pipe's other 64 fill together; likewise at 1.98 GHz
INT32_OPS_PER_S = 132 * 128 * 1.98e9
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
# grm-8192x65536: tools/bench_all.py:405-431's genotypes (dosage 0/1/2 at
# 0.5/0.3/0.15, 5% missing) at 8,192 samples x 65,536 variants, as a .bed
# through the CLI at its default block and the reference's --maf 0.01
GRM_SAMPLES, GRM_VARIANTS = 8192, 65_536
GRM_MAF = 0.01
GRM_CUT = (2048, 512)  # variants x samples of the cell held card against CPU in every mode
GRM_F64_SAMPLES = 16  # the card's GRM of these samples against float64 over all variants
GRM_TOL = 2e-5  # plink2's single-precision contract
# basecall-512: abea-512's reads (the same signals from --seed) through
# cli.basecall's main path, the full DNA_R941 model with seeded weights
BASECALL_CHUNK = 4000
BASECALL_F32_READS = 64  # reads called at f32 too: bf16 against f32 frame labels
BASECALL_CPU_READS = 4  # card f32 log-probs against the CPU's
BASECALL_BEAM_READS = 4  # the shortest reads at the default --beamsize 5
BASECALL_TOL = 5e-4  # bonito_golden.npz's atol, and card f32 against CPU f32
# clair-131072: 32 batches of 4,096 pileup tensors [33, 8, 4] (Poisson counts)
CLAIR_BATCHES, CLAIR_BATCH = 32, 4096
CLAIR_LAMBDA = 3.0
CLAIR_TOL = 2e-5  # clair_golden.npz's atol, and card against CPU
# the main paths' outputs held to the plain versions: chain-1001's calls of
# up to CHAIN_PLAIN_MAX_N anchors (the plain version steps once per anchor
# of its longest call) and abea-512's reads of up to ABEA_PLAIN_MAX_BASES
# bases (once per band of its longest read)
CHAIN_PLAIN_MAX_N = 16_384
ABEA_PLAIN_MAX_BASES = 4_000
EA_DROPPED = 16  # eventalign-512's records of each kind f5c's filters drop
EA_SPACER = (50, 500)  # random bases between two reads in its genome
EA_WINDOW = "chr1:1-100000"  # the -w region read through the .bai
EA_ORACLE_READS = 8
# kmer-0.25g: tools/kmer_scale_bench.py's synth_reads (genome_mbp, read_len,
# err) at its --gbp 0.25 rehearsal (KMER_SCALE.json), the driver's config
KMER_READS = 25_000  # 250 Mbp of 10,000-base reads: past the CLI's 192 Mbp, so streamed
KMER_READ_LEN = 10_000
KMER_GENOME_MBP = 25
KMER_ERR = 0.001
KMER_K = 17
KMER_MIN_LEN = 5_000  # the driver's minimum overlap (cli/kmer_cnt.py --min-ovlp)
KMER_MERGES = 3  # 96 Mbp batches (count_kmers_batched's default)
KMER_PARITY_READS = 512
KMER_WIDE_READS = 64  # reads counted at k = 31 and 32, card against CPU
# poa-64x10x750: tools/poa_scale_bench.py's synth_windows at its defaults,
# the reference driver's scores (oe1 = o1+e1, oe2 = o2+e2)
POA_WINDOWS, POA_SEQS, POA_LEN = 64, 10, 750
POA_PARAMS = (2, -4, -6, -2, -25, -1)
POA_CPU_WINDOWS = 2  # windows held card against CPU round by round
POA_ORACLE = (4, 6, 200)  # windows x sequences x bases against the port's oracle
# operations of csrc/abea_fill.cu a valid cell: f32 6 for the emission
# (two subtractions, the division, two multiplications, the addition) and 4
# compares; f64 4 conversions in, 5 additions, 3 conversions out
ABEA_FILL_F32_OPS = 10
ABEA_FILL_F64_OPS = 12
# csrc/abea_walk.cu a step: the emission's 6 f32; one conversion and one addition in f64
ABEA_WALK_F32_OPS = 6
ABEA_WALK_F64_OPS = 2
# The fewest dependent SM cycles a band (fill) or a step (walk) of the two
# designs can take, from the chain in their sources and Hopper's usual
# latencies (not measured here): the fill's band is a cell's conversion to
# double (~8), the halo shuffle (~23), two dependent f64 additions (~8
# each), a conversion to float (~8), two compare-and-selects (~8 each) and
# the move's uniform select and branch (~14): ~85; the walk's step is a
# shared load of the trace byte (~30), the move's compare (~4) and the next
# offset's subtract and clamp (~12): ~46.  Times the longest read's bands
# or steps, they give each kernel's chain floor.
ABEA_FILL_CHAIN_CYCLES = 85
ABEA_WALK_CHAIN_CYCLES = 46
OCC_SOURCE = "genomicsbench_palisade_tpu_torch/csrc/occ_gather.cu"
OCC_ROW_REPLACES = "tools/occ_gather_experiment.py:42"
OCC_TILE_REPLACES = "tools/occ_gather_experiment.py:111"
OCC_RATE_IDX = 1 << 24  # 16,777,216 indices: a rate, not a launch
OCC_BIG_ROWS = 40_000_000  # occ-gather-40m: 2.56 GB of rows, 51x the L2
FMI_MBP = 256  # tools/genome_scale_fmi.py's --mbp default: 512,000,001 text characters
FMI_READS = 2048  # its --reads
FMI_READ_LEN = 151  # its --read-len
FMI_BATCH = 512  # the reference driver's batch_size default (fmi.cpp)
FMI_MIN_SEED = 19  # and its min_seed_len
FMI_ORACLE_READS = 8
FMI_CLI_READS = 16
STRIP_SOURCE = "genomicsbench_palisade_tpu_torch/csrc/bsw_stripped.cu"
STRIP_REPLACES = "tools/bsw_roofline.py:36"
# int32 instructions a cell that the stripped recurrence needs, with what
# Hopper fuses counted as one (three-way add, add and max, three-way max) and
# no loop-invariant term (csrc/bsw_stripped.cu's note): score 2, M 3, H0 1,
# c 1, the running prefix max 1, F and H' 2, E' 2
STRIP_OPS_PER_CELL = 12
MICRO_SOURCE = "genomicsbench_palisade_tpu_torch/csrc/chain_micro.cu"
MICRO_REPLACES = "tools/chain_roofline.py:38"
# int32 instructions a visited predecessor that the chain_micro function
# needs, counted as STRIP_OPS_PER_CELL (csrc/chain_micro.cu's note): dr 1,
# dq 1, dd 2 (subtract, abs), eligibility 4 (compares that chain their
# predicates), slope 2 (multiply, shift), ilog 3 (max with 1, find leading
# one, halve), gap 1, min_d 1, the candidate 1 (min_d - gap + sc_j), the
# predicated max 1
MICRO_OPS_PER_VISIT = 17
# The fewest dependent SM cycles a target row (bsw_stripped, a group of L
# lanes of K rows) or an anchor (chain_micro) of the two designs can take,
# from the chain in their sources and Hopper's usual latencies (not
# measured here: ~4 an integer op, ~23 a shuffle, ~30 a warp reduction).
# A stripped row: the roll's shuffle into the lane's first row (23), its M,
# c and g (7 ops, 28), the fold of the lane's K values (4K), log2(L) scan
# rounds of a shuffle and a max (27 each), the exclusive shuffle (23), the
# replay's K maxes, F and max(H0, F) (4(K + 2)).  A micro anchor: the add
# and select of a slot (8), the lane's max (4), the warp reduction (30),
# the max with qspan (4), the owning lane's select (4): ~50.  Times the
# target rows or the anchors of a call, they give each kernel's chain floor.
MICRO_CHAIN_CYCLES = 50
PROBE_CHAIN = 8  # calls in a row a timing of the roofline phases (the bsw tool's --chain)
# the kernel's narrowest and widest register instances, and one past them
# (the long-column kernel: three chunks of 512 rows, the last part full)
STRIP_EDGE_QE = (8, 520, 1032)
MICRO_EDGE_W = (1, 33, 129, 257, 700)  # one bank, two, five, past eight into shared memory


def strip_chain_cycles(lanes: int, k: int) -> int:
    return 23 + 28 + 4 * k + 27 * (lanes.bit_length() - 1) + 23 + 4 * (k + 2)


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


def bsw_long_pairs(rng, n, q_lo, q_hi, t_hi=None):
    """n pairs with queries of q_lo-q_hi bases past the register instances,
    targets of 1-2 query lengths (at most t_hi), h0 20-59.  Three in four:
    the query the target's head with 8% substituted and an indel of 1-6
    bases every ~64 (gap chains in both directions), and in one of them 6
    inserted bases over each edge of the long-query kernel's 512-entry
    chunks (an F chain across the edge); one in four: a period of 1-3
    bases in both (ties in the row max)."""
    pairs = []
    for k in range(n):
        ql = int(rng.integers(q_lo, q_hi + 1))
        tl = int(rng.integers(ql, 2 * ql + 1))
        tl = min(tl, t_hi or tl)
        if k % 4 == 3:
            period = rng.integers(0, 4, int(rng.integers(1, 4)))
            t, q = np.resize(period, tl), np.resize(np.roll(period, 1), ql)
        else:
            t = rng.integers(0, 4, tl)
            q = np.concatenate([t, rng.integers(0, 4, max(ql - tl, 0))])
            edges = np.arange(509, ql, 512)  # query bases 509-514 over j = 512, and so on
            spots = edges if k % 4 == 1 else np.sort(rng.integers(0, ql, max(ql // 64, 1)))
            for at in spots[::-1]:
                gap = 6 if k % 4 == 1 else int(rng.integers(1, 7))
                if k % 4 == 1 or rng.random() < 0.5:
                    q = np.concatenate([q[:at], rng.integers(0, 4, gap), q[at:]])
                else:
                    q = np.concatenate([q[:at], q[at + gap:]])
            q = np.concatenate([q, rng.integers(0, 4, max(ql - len(q), 0))])[:ql]
            mut = rng.random(ql) < 0.08
            q[mut] = rng.integers(0, 4, int(mut.sum()))
        pairs.append((q.astype(np.int8), t.astype(np.int8), int(rng.integers(20, 60))))
    return pairs


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


PHMM_EDGE_RPADS = (64, 128, 256, 512, 640)  # the CLI's row buckets, and one past them
PHMM_EDGE_HPADS = (72, 128, 300, 512, 700)
# row counts at the lane, tile and bucket edges of every power-of-two L*S
PHMM_EDGE_RSLENS = (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129,
                    255, 256, 257, 511, 512, 513)
BSW_EDGE_QLENS = (1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257, 511, 512)
CHAIN_EDGE_WINDOWS = (1, 31, 32, 33, 200, 250)
CHAIN_FAR_N = 5100  # anchors one apart: windows of MAX_ITER (5000) predecessors


def phmm_edge_cases(rng):
    """Batches (reads, haps, pairs, r_pad, h_pad) aimed at the lane layout
    of csrc/phmm_forward.cu (a group of lanes a testcase, S rows a lane,
    tiles of L*S rows), one for each r_pad of PHMM_EDGE_RPADS (with h_pad
    PHMM_EDGE_HPADS): the CLI's four row buckets and 640, which every
    instance walks in more than one tile.  For each read length of
    PHMM_EDGE_RSLENS below r_pad and for r_pad - 1, three testcases:
      0 the read a noisy (1%) substring of a hap of up to h_pad bases,
        quals 6-40 (results that stay finite in float up to 639 rows);
      1 a random read against a random hap of h_pad bases, quals 20-40
        (the float result underflows past ~20 rows: the f64 path's cases);
      2 read and hap with 10% N (code 4), quals 0-126 with 0 and 126 at
        fixed rows, against a hap of 1 base or of a random length.
    Every batch has an odd size (not a multiple of the testcases a block
    holds), and one more batch holds a single testcase, a read of 100
    bases from its hap."""
    batches = []
    for rp, hp in zip(PHMM_EDGE_RPADS, PHMM_EDGE_HPADS):
        reads, haps, pairs = [], [], []
        lens = [n for n in PHMM_EDGE_RSLENS if n < rp - 1] + [rp - 1]
        for rl in lens:
            for kind in range(3):
                if kind == 0:
                    hl = int(rng.integers(rl, max(rl, hp) + 1)) if rl <= hp else hp
                    hap = rng.integers(0, 4, hl)
                    if rl <= hl:
                        s = int(rng.integers(0, hl - rl + 1))
                        bases = hap[s : s + rl].copy()
                    else:
                        bases = rng.integers(0, 4, rl)
                    noise = rng.random(rl) < 0.01
                    bases[noise] = rng.integers(0, 4, int(noise.sum()))
                    quals = {k: rng.integers(6, 41, rl) for k in "qidc"}
                elif kind == 1:
                    hap, bases = rng.integers(0, 4, hp), rng.integers(0, 4, rl)
                    quals = {k: rng.integers(20, 41, rl) for k in "qidc"}
                else:
                    hl = 1 if len(haps) % 2 else int(rng.integers(2, hp + 1))
                    hap, bases = rng.integers(0, 4, hl), rng.integers(0, 4, rl)
                    hap[rng.random(hl) < 0.1] = 4
                    bases[rng.random(rl) < 0.1] = 4
                    quals = {k: rng.integers(0, 127, rl) for k in "qidc"}
                    for j, k in enumerate("qidc"):
                        quals[k][j % rl] = 0
                        quals[k][(j + rl // 2) % rl] = 126
                reads.append({"bases": bases, **quals})
                haps.append(hap)
                pairs.append((len(reads) - 1, len(haps) - 1))
        if len(pairs) % 2 == 0:
            pairs.append((len(reads) - 1, 0))
        batches.append((reads, haps, pairs, rp, hp))
    hap = rng.integers(0, 4, 120)
    read = {"bases": hap[10:110].copy(), **{k: rng.integers(10, 41, 100) for k in "qidc"}}
    batches.append(([read], [hap], [(0, 0)], 128, 128))
    return batches


def bsw_edge_pairs(rng, o_ins=6, e_ins=1):
    """Pairs aimed at the lane layout of csrc/bsw_extend.cu: for each query
    length of BSW_EDGE_QLENS (a lane's entries, lane and group boundaries,
    every bucket edge), five kinds, targets of 1 to min(2 qlen + 8, 512)
    bases:
      0 the query the target's head with 8% substituted, h0 20-59 (bands
        wider than 32 entries);
      1 unrelated bases with 10% ambiguous codes, h0 0-9 (the m == 0 break);
      2 the target's head for half the query, unrelated bases after it, h0
        30 (the z-drop break);
      3 a period of 1-3 bases in both, h0 20-39 (ties in the row max);
      4 the query the target's head, h0 one of oe_ins - 2 .. oe_ins +
        3 e_ins and -1, 0 (the first row's decay at its edge)."""
    oe = o_ins + e_ins
    h0_edge = (oe - 2, oe - 1, oe, oe + 1, oe + e_ins, oe + 2 * e_ins, oe + 3 * e_ins, -1, 0)
    pairs = []
    for n, ql in enumerate(BSW_EDGE_QLENS):
        for kind in range(5):
            tl = int(rng.integers(1, min(2 * ql + 8, 512) + 1))
            if kind == 1:
                t, q = rng.integers(0, 4, tl), rng.integers(0, 4, ql)
                t[rng.random(tl) < 0.1] = 4
                q[rng.random(ql) < 0.1] = 4
                h0 = int(rng.integers(0, 10))
            elif kind == 3:
                period = rng.integers(0, 4, int(rng.integers(1, 4)))
                t, q = np.resize(period, tl), np.resize(np.roll(period, 1), ql)
                h0 = int(rng.integers(20, 40))
            else:
                base = rng.integers(0, 4, max(tl, ql))
                t, q = base[:tl], base[:ql].copy()
                if kind == 2:
                    q[ql // 2 :] = rng.integers(0, 4, ql - ql // 2)
                else:
                    mut = rng.random(ql) < 0.08
                    q[mut] = rng.integers(0, 4, int(mut.sum()))
                h0 = (int(rng.integers(20, 60)), 0, 30, 0, h0_edge[n % len(h0_edge)])[kind]
            pairs.append((q.astype(np.int8), t.astype(np.int8), h0))
    return pairs


def chain_edge_calls(rng):
    """Calls (x, y, avg_qspan) aimed at the steps of 32 predecessors of
    csrc/chain_dp.cu, for prepare_call's defaults (max_dist 5000, bw 500):
      windows of exactly CHAIN_EDGE_WINDOWS predecessors (x steps of
        5000 // w), the query following x exactly or within half a step;
      dense calls (x gaps 0-3, the query within 5-60 of x, spans 10-19 or
        all 15) that break on max_skip at offsets across a step, mark their
        own step's lanes and tie;
      one call of CHAIN_FAR_N anchors one apart with the query within
        20,000 of x, whose windows reach MAX_ITER with few visits passing."""
    calls = []
    for w in CHAIN_EDGE_WINDOWS:
        step = 5000 // w
        n = w + 60
        x = 1000 + step * np.arange(n, dtype=np.int64)
        for jitter in (0, step // 2):
            qpos = x + rng.integers(-jitter, jitter + 1, n) if jitter else x
            span = rng.integers(10, 30, n)
            calls.append((x.astype(np.uint64), pack_y(qpos, span), float(rng.uniform(10, 40))))
    for k in range(12):
        n = int(rng.integers(300, 700))
        x = np.cumsum(rng.integers(0, 1 + k % 4, n)).astype(np.int64) + 500
        noise = (5, 15, 30, 60)[k % 4]
        qpos = np.maximum(x + rng.integers(-noise, noise + 1, n), 0)
        span = np.full(n, 15) if k % 3 == 0 else rng.integers(10, 20, n)
        calls.append((x.astype(np.uint64), pack_y(qpos, span), float(rng.uniform(10, 40))))
    x = np.arange(CHAIN_FAR_N, dtype=np.int64) + 10_000
    qpos = x + rng.integers(-20000, 20000 + 1, CHAIN_FAR_N)
    calls.append((x.astype(np.uint64), pack_y(qpos, rng.integers(10, 30, CHAIN_FAR_N)), 20.0))
    return calls


def pack_y(qpos, span):
    """minimap2's y: the query span in bits 32-39, the query position below."""
    return (np.asarray(span, np.uint64) << np.uint64(32)) | np.asarray(qpos, np.int64).astype(np.uint64)


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


def kmer_rank(kmer: str) -> int:
    """The rank of a 6-mer of ACGT: the first base is the high bits."""
    return int(sum("ACGT".index(ch) << (2 * (5 - j)) for j, ch in enumerate(kmer)))


def abea_events(rng, model, seq, counts, noise=0.4, scale=1.0, shift=0.0):
    """Event means for `seq`: counts[i] events at k-mer i's scaled level
    (scale * mean + shift, f32) plus N(0, noise) (none when noise is 0)."""
    ranks = np.array([kmer_rank(seq[i : i + 6]) for i in range(len(seq) - 5)], np.int64)
    level = np.float32(scale) * model["level_mean"][ranks] + np.float32(shift)
    means = np.repeat(level, counts).astype(np.float64)
    if noise:
        means = means + rng.normal(0, noise, len(means))
    return means.astype(np.float32)


def abea_edge_reads(rng):
    """(model, batches) aimed at csrc/abea_fill.cu (a warp a read, 4 cells
    a lane, the band's ends by shuffles) and csrc/abea_walk.cu (windows of
    128 band rows in shared memory); each batch (seqs, events, scales,
    shifts).  The first batch holds, read by read:
      0-2 nk 1 with 1 and 7 events, and nk 50 with 1 event;
      3-4 reads shorter than the band (30 and 60 k-mers, 1-2 events each);
      5 stay-heavy: 4-8 events a k-mer;
      6 skip-heavy: an event for every third k-mer;
      7 a run of 70 k-mers with no event inside 1-2 events a k-mer (the
        band does not follow a skip that long: QC drops the read);
      8 295 k-mers and 20 events: once the events run out the band slides
        onto the last k-mer's column (so no input of finite events leaves
        that column all -inf: `abea_blocked` makes one), and the walk's
        longest skip run passes MAX_GAP (50);
      9 a homopolymer with one event a k-mer exactly at its level (ne = nk,
        so lp_step and lp_stay round alike): exact D/U/L score ties;
     10 a repeat of 3 bases, events at their levels with no noise: ties
        across bands;
     11 700 bases, 1-2 events a k-mer: 13 windows, D moves across window
        edges;
     12-15 reads of 120-400 bases, scaled 0.9-1.1 and shifted -3..3, with
        noise 0.4-2.0;
     16-20 30 k-mers, one event each at its level, then 40 more at the last
        k-mer at a level (-2 to 2 ulps off the solution) where a stay costs
        what the trim term gains: ties between seed scores;
     21 80 k-mers, one event each; in every other run of 5 k-mers the
        model log-stdv is the emission's constant (the model is changed at
        their ranks) and the events 1-3 ulps off their levels: runs of
        emissions of ~1e-9 with full mantissas between runs of ones of
        ~-1, so that the double sum rounds and only the walk order gives
        its bits;
     22 100 bases, one event a k-mer, the fifth one 1e-12: outside the
        range of the fill's fast division, so the read takes IEEE's own;
    a batch of more than one block at every size; the second batch is one
    read of 300 bases.  Most bands past the 50th of the short reads take
    the both-ends -inf parity rule."""
    model = synth_model(rng)
    acgt = np.array(list("ACGT"))
    seq_of = lambda n: "".join(acgt[rng.integers(0, 4, n)])  # noqa: E731
    reads = []  # (seq, events, scale, shift)

    def add(seq, counts, noise=0.4, scale=1.0, shift=0.0):
        reads.append((seq, abea_events(rng, model, seq, counts, noise, scale, shift),
                      scale, shift))

    add(seq_of(6), [1])
    add(seq_of(6), [7])
    s = seq_of(55)
    reads.append((s, abea_events(rng, model, s, np.eye(1, 50, 20, np.int64)[0]), 1.0, 0.0))
    for nk in (30, 60):
        add(seq_of(nk + 5), rng.integers(1, 3, nk))
    add(seq_of(85), rng.integers(4, 9, 80))
    add(seq_of(405), (np.arange(400) % 3 == 0).astype(np.int64))
    counts = rng.integers(1, 3, 300)
    counts[120:190] = 0
    add(seq_of(305), counts)
    s = seq_of(300)
    reads.append((s, abea_events(rng, model, s, rng.integers(1, 3, 295))[:20], 1.0, 0.0))
    add("A" * 70, np.ones(65, np.int64), noise=0)
    add("ACG" * 40, np.ones(115, np.int64), noise=0)
    add(seq_of(700), rng.integers(1, 3, 695))
    for n in (120, 210, 320, 400):
        add(seq_of(n), rng.integers(1, 3, n - 5), float(rng.uniform(0.4, 2.0)),
            float(np.float32(rng.uniform(0.9, 1.1))), float(np.float32(rng.uniform(-3, 3))))
    # seed ties: staying at the last k-mer emits lp_trim - lp_stay
    s = seq_of(35)
    head = abea_events(rng, model, s, np.ones(30, np.int64), noise=0)[:-1]
    ne = len(head) + 40
    lp_stay = np.log(1 - 1 / (ne / 30 + 1))
    last = kmer_rank(s[-6:])
    a = np.sqrt(2 * ((np.float32(-0.918938) - model["level_log_stdv"][last])
                     - (np.log(0.01) - lp_stay)))
    level = np.float32(model["level_mean"][last] + a * model["level_stdv"][last])
    for d in range(-2, 3):
        x = level
        for _ in range(abs(d)):
            x = np.nextafter(x, np.float32(np.inf if d > 0 else -np.inf))
        reads.append((s, np.concatenate([head, np.full(40, x, np.float32)]), 1.0, 0.0))
    # emissions of ~1e-10 beside ones of ~-1: the double sum rounds
    s = seq_of(85)
    ranks = [kmer_rank(s[i : i + 6]) for i in range(80)]
    tiny = [i for i in range(80) if i // 5 % 2]
    model["level_log_stdv"][[ranks[i] for i in tiny]] = np.float32(-0.918938)
    model["level_stdv"][[ranks[i] for i in tiny]] = np.float32(0.37)
    ev = abea_events(rng, model, s, np.ones(80, np.int64))
    for i in tiny:
        x = model["level_mean"][ranks[i]]
        for _ in range(int(rng.integers(1, 4))):
            x = np.nextafter(x, np.float32(np.inf))
        ev[i] = x
    reads.append((s, ev, 1.0, 0.0))
    s = seq_of(100)
    ev = abea_events(rng, model, s, np.ones(95, np.int64))
    ev[4] = np.float32(1e-12)
    reads.append((s, ev, 1.0, 0.0))
    one = seq_of(300)
    batches = [tuple(list(v) for v in zip(*reads)),
               ([one], [abea_events(rng, model, one, rng.integers(1, 3, 295))], [1.0], [0.0])]
    return model, batches


def abea_blocked(batch_np) -> dict:
    """A copy of a flat abea batch (ops.abea.prepare_batch's) whose four
    transition penalties are -inf, which the host never makes: every band
    cell but the origin is -inf, the last k-mer's column too, so the seed
    is 0 and the walk clamps its offsets to the band's edge."""
    out = {k: v.copy() for k, v in batch_np.items()}
    out["lp"][:] = -np.inf
    return out


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


def revcomp(seq: str) -> str:
    return seq.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def write_eventalign_dataset(tmp: Path, lengths, rng, bam) -> dict:
    """eventalign-512's inputs under `tmp`: golden_reads of `lengths` (from
    the same rng, abea-512's reads and signals) laid into one contig, chr1,
    every other read as its reverse complement, 50-499 random bases between
    two reads; each read's cigar a soft clip of 0-19 bases and 1-3
    insertions or deletions of 1-5 bases, on a 50-base grid; besides,
    EA_DROPPED each of unmapped, MAPQ-5 and secondary records (the last two
    copies of reads, beside them).  Writes reads.bam and its .bai (`bam`,
    the port's io.bam), genome.fa, reads.fq, signals.npz and pore.tsv;
    returns counts."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    nt16 = np.zeros(256, np.uint8)
    nt16[acgt] = [1, 2, 4, 8]

    def rand(n):
        return acgt[rng.integers(0, 4, n)].tobytes().decode()

    genome, glen, records, signals = [], 0, [], {}
    with open(tmp / "reads.fq", "w") as fq:
        for r, (seq, sig) in enumerate(golden_reads(lengths, rng)):
            name = f"read{r}"
            signals[name] = sig
            fq.write(f"@{name}\n{seq}\n+\n{'5' * len(seq)}\n")
            g = revcomp(seq) if r % 2 else seq
            spacer = rand(int(rng.integers(*EA_SPACER)))
            genome.append(spacer)
            glen += len(spacer)
            clip = int(rng.integers(0, 20))
            cigar, pos, cur, nm = ([("S", clip)] if clip else []), glen, clip, 0
            for p in np.sort(rng.choice(np.arange(200, len(g) - 200, 50), int(rng.integers(1, 4)),
                                        replace=False)).tolist():
                ln = int(rng.integers(1, 6))
                genome.append(g[cur:p])
                glen += p - cur
                cigar.append(("M", p - cur))
                if rng.random() < 0.5:
                    cigar.append(("I", ln))
                    cur = p + ln
                else:
                    genome.append(rand(ln))
                    glen += ln
                    cigar.append(("D", ln))
                    cur = p
                nm += ln
            genome.append(g[cur:])
            glen += len(g) - cur
            cigar.append(("M", len(g) - cur))
            codes = nt16[np.frombuffer(g.encode(), np.uint8)]
            records.append(bam.BamRecord(name, bam.FREVERSE if r % 2 else 0, 0, pos, 60, cigar,
                                         codes, np.full(len(g), 30, np.uint8), {"NM": nm}))
    step = len(records) // EA_DROPPED
    out = []
    for j, r in enumerate(records):
        out.append(r)
        if j % step == 0 and j // step < EA_DROPPED:
            i = j // step
            out.append(bam.BamRecord(f"lowmapq{i}", r.flag, 0, r.pos, 5, r.cigar, r.seq_nt16,
                                     r.qual, {"NM": 0}))
            out.append(bam.BamRecord(r.name, r.flag | bam.FSECONDARY, 0, r.pos, 60, r.cigar,
                                     r.seq_nt16, r.qual, r.tags))
    for i in range(EA_DROPPED):
        codes = nt16[acgt[rng.integers(0, 4, 100)]]
        out.append(bam.BamRecord(f"unmapped{i}", bam.FUNMAP, -1, -1, 0, [], codes,
                                 np.full(100, 30, np.uint8), {}))
    bam.write_bam(str(tmp / "reads.bam"), [("chr1", glen)], out)
    bam.build_bai(str(tmp / "reads.bam"))
    (tmp / "genome.fa").write_text(">chr1\n" + "".join(genome) + "\n")
    np.savez(tmp / "signals.npz", **signals)
    write_pore_model(tmp / "pore.tsv")
    return {"records": len(out), "reads": len(records), "genome_bases": glen,
            "bases": int(np.sum(lengths)),
            "samples": sum(len(s) for s in signals.values()),
            "bam_mb": (tmp / "reads.bam").stat().st_size / 1e6}


def synth_reference_codes(mbp: int, rng) -> np.ndarray:
    """tools/genome_scale_fmi.py:synth_reference's bases, as codes 0-3
    (uint8): `mbp` million uniform bases drawn 4 Mi at a time from `rng`
    (its FASTA holds these bases, 80 a line)."""
    n = mbp * 1_000_000
    chunk = 1 << 22
    return np.concatenate([rng.integers(0, 4, min(chunk, n - s), dtype=np.int8)
                           for s in range(0, n, chunk)]).astype(np.uint8)


def synth_reads(codes, n_reads: int, read_len: int, rng) -> np.ndarray:
    """tools/genome_scale_fmi.py:synth_reads: reads sampled from the forward
    reference with 1% substitutions, int8 codes [n_reads, read_len]."""
    starts = rng.integers(0, len(codes) - read_len, n_reads)
    enc = np.stack([codes[s : s + read_len] for s in starts]).astype(np.int8)
    sub = rng.random(enc.shape) < 0.01
    enc[sub] = rng.integers(0, 4, int(sub.sum()), dtype=np.int8)
    return enc


def write_fastq(path, enc):
    """The reads as FASTQ records @r0, @r1, ... (quality I)."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "w") as f:
        for i, row in enumerate(enc):
            f.write(f"@r{i}\n{acgt[row].tobytes().decode()}\n+\n{'I' * len(row)}\n")


def synth_kmer_reads(rng, n_reads: int, read_len: int, genome_mbp: int, err: float):
    """tools/kmer_scale_bench.py's synth_reads, vectorised: reads [n, len]
    uint8 codes drawn from one uniform random genome, a substitution (a
    random code, maybe the same) at each base with probability err."""
    genome = rng.integers(0, 4, genome_mbp * 1_000_000, dtype=np.uint8)
    starts = rng.integers(0, len(genome) - read_len, n_reads)
    reads = np.empty((n_reads, read_len), np.uint8)
    for i, st in enumerate(starts):
        reads[i] = genome[st : st + read_len]
    flat = reads.reshape(-1)
    n_sub = int(rng.binomial(flat.size, err))
    flat[rng.integers(0, flat.size, n_sub)] = rng.integers(0, 4, n_sub, dtype=np.uint8)
    return reads


def write_fasta(path, rows, names=None):
    """Rows of 2-bit codes (or strings) as one-line FASTA records."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for i, row in enumerate(rows):
            seq = row.encode() if isinstance(row, str) else acgt[row].tobytes()
            f.write(f">{names[i] if names else f'r{i}'}\n".encode() + seq + b"\n")


def synth_windows(rng, n_win: int, n_seq: int, length: int):
    """tools/poa_scale_bench.py's synth_windows: a random base sequence a
    window, each of its sequences with 4% substitutions and 2 deletions."""
    batches = []
    for _ in range(n_win):
        base = rng.integers(0, 4, length)
        seqs = []
        for _ in range(n_seq):
            s = base.copy()
            mut = rng.random(length) < 0.04
            s[mut] = rng.integers(0, 4, int(mut.sum()))
            s = np.delete(s, np.sort(rng.choice(length, 2, replace=False)))
            seqs.append("".join("ACGT"[c] for c in s))
        batches.append(seqs)
    return batches


def synth_genotypes(rng, m: int, n: int, rows: int = 4096) -> np.ndarray:
    """tools/bench_all.py:416's genotypes: [m, n] int8 dosage 0/1/2 at
    0.5/0.3/0.15 and 3 (missing) at 0.05, drawn as uniform thresholds a
    block of rows at a time."""
    geno = np.empty((m, n), np.int8)
    for s in range(0, m, rows):
        u = rng.random((min(rows, m - s), n), dtype=np.float32)
        geno[s : s + rows] = ((u >= 0.5).view(np.int8) + (u >= 0.8).view(np.int8)
                              + (u >= 0.95).view(np.int8))
    return geno


def bonito_weight_arrays(names_shapes, seed=20260825) -> dict:
    """tests/generate_fixtures.py:_bonito_weight_arrays: bonito_golden.npz's
    weights, one rng stream over the state dict's key order."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in names_shapes:
        if name.endswith("num_batches_tracked"):
            out[name] = np.zeros(shape, np.int64)
        elif "running_var" in name:
            out[name] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        elif "running_mean" in name:
            out[name] = rng.normal(0, 0.3, shape).astype(np.float32)
        else:
            out[name] = rng.normal(0, 0.08, shape).astype(np.float32)
    return out


def clair_variables(seed=20260826, units=128) -> dict:
    """tests/generate_fixtures.py:_clair_variables: clair_golden.npz's TF1
    variable map, one rng stream over the reference graph's variables."""
    names = []
    for scope, n_in in (("LSTM1", 32), ("LSTM2", 256)):
        for d in ("fw", "bw"):
            base = (f"{scope}/stack_bidirectional_rnn/cell_0/"
                    f"bidirectional_rnn/{d}/cudnn_compatible_lstm_cell")
            names += [(base + "/kernel", (n_in + units, 4 * units)), (base + "/bias", (4 * units,))]
    for c in range(2 * units):
        names += [(f"L3/Unit_{c}/kernel", (33, 30)), (f"L3/Unit_{c}/bias", (30,))]
    names += [("L4/kernel", (30 * 256, 192)), ("L4/bias", (192,))]
    for k in range(4):
        names += [(f"L5_{k + 1}/kernel", (192, 96)), (f"L5_{k + 1}/bias", (96,))]
    heads = ("Y_base_change_logits", "Y_genotype_logits", "Y_indel_length_logits_1",
             "Y_indel_length_logits_2")
    for k, out in enumerate((21, 3, 33, 33)):
        names += [(f"Prediction/{heads[k]}/kernel", (96, out)),
                  (f"Prediction/{heads[k]}/bias", (out,))]
    rng = np.random.default_rng(seed)
    return {name: rng.normal(0, 0.08, shape).astype(np.float32) for name, shape in names}


def bonito_flops(blocks, t: int, n_classes: int = 5) -> int:
    """2 x the multiply-adds of the model's convolutions on one chunk of t
    samples (depthwise, pointwise, full, residual and decoder)."""
    flops, c = 0, 1
    for f, rep, k, s, res, sep in blocks:
        c_in, t_in = c, t
        for _ in range(rep):
            t = (t - 1) // s + 1  # padding k // 2 each side, odd k
            flops += 2 * c * k * t if sep else 2 * c * f * k * t
            if sep:
                t = (t - 1) // s + 1  # the pointwise conv carries the stride too
                flops += 2 * c * f * t
            c = f
        if res:
            flops += 2 * c_in * f * t_in
    return flops + 2 * c * n_classes * t


def strip_edge_batch(rng, qe_pad: int, tp: int, n: int):
    """(q_codes, target, h_init, e_init) int32 numpy for `bsw_stripped`: n
    pairs from each of four starts side by side (zero; seeded, H 0-60 and E
    0-30; all INT32_MAX, interpret mode's "nan" scratch; H near INT32_MAX
    with E small, where c + j*e_ins wraps), tp target rows, queries the
    target's head with 8% substituted and PAD_CODE past it (the probe's
    kind).  The zero start's pairs come first."""
    big = 2**31 - 1
    shape = (qe_pad, n)
    starts = [(np.zeros(shape), np.zeros(shape)),
              (rng.integers(0, 61, shape), rng.integers(0, 31, shape)),
              (np.full(shape, big), np.full(shape, big)),
              (rng.integers(big - 40, big, shape, endpoint=True), rng.integers(0, 30, shape))]
    b = n * len(starts)
    t = rng.integers(0, 4, (tp, b))
    ql = min(qe_pad - 1, tp)
    q = np.full((qe_pad, b), 5)  # ops.bsw_stripped.PAD_CODE
    q[:ql] = np.where(rng.random((ql, b)) < 0.08, rng.integers(0, 4, (ql, b)), t[:ql])
    h = np.concatenate([v[0] for v in starts], 1)
    e = np.concatenate([v[1] for v in starts], 1)
    return tuple(np.ascontiguousarray(a, dtype=np.int32) for a in (q, t, h, e))


def micro_edge_calls(rng, b: int, n: int):
    """(x_lo, qi, qspan, m_fp, gap0) int32 numpy for `chain_micro`: b calls
    of n anchors, the first half of the probe's kind (x and q steps 1-39 and
    1-29, the Q20 slope 157,286), the second with 10% of x's steps 20,000 to
    2,000,000 and any int32 slope, so that dd * m wraps; qspan 10-29, gap0
    0-9.  Every call starts on the phantom predecessors."""
    steps = rng.integers(1, 40, (b, n))
    half = b // 2
    steps[half:] += (rng.random((b - half, n)) < 0.1) * rng.integers(20_000, 2_000_000,
                                                                      (b - half, n))
    x = np.cumsum(steps, axis=1).astype(np.int64).astype(np.uint32).view(np.int32)
    qi = np.cumsum(rng.integers(1, 30, (b, n)), axis=1).astype(np.int32)
    qspan = rng.integers(10, 30, (b, n)).astype(np.int32)
    m_fp = np.concatenate([np.full(half, 157286),
                           rng.integers(0, 2**31, b - half)]).astype(np.int32)
    gap0 = rng.integers(0, 10, b).astype(np.int32)
    return x, qi, qspan, m_fp, gap0


# ---------------------------------------------------------------- measures


def cells_of(batch_np) -> int:
    return int(np.sum(batch_np["rslen"].astype(np.int64) * batch_np["haplen"]))


def bound(batch_np, itemsize: int, ops_per_s: float, table_elems: int):
    """Least time for the function on these inputs: the larger of the bytes
    it must move (each input once, the output once) over HBM bandwidth and
    its operations (12 per real cell) over the instruction rate."""
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
    new trace, up to PROFILE_ATTEMPTS times, and the count is reported.
    The trace's events sit in reference cycles (fmi's: ~3.7 M objects)
    that slowed every later Python-heavy phase by 5-15% until a full
    collection, so one runs before this returns."""
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
                "occ_gather_row" if "occ_gather_row_kernel" in name else
                "occ_gather_tile" if "occ_gather_tile_kernel" in name else
                "memcpy_htod" if "HtoD" in name else
                "memcpy_dtoh" if "DtoH" in name else "other")
        kinds[kind] = kinds.get(kind, 0.0) + (end - start) * 1e-6
    del prof
    gc.collect()
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
        from genomicsbench_palisade_tpu_torch.cli import fmi as cli_fmi
        from genomicsbench_palisade_tpu_torch.cli import kmer_cnt as cli_kmer
        from genomicsbench_palisade_tpu_torch.cli import poa as cli_poa
        from genomicsbench_palisade_tpu_torch.cli import basecall as cli_basecall
        from genomicsbench_palisade_tpu_torch.cli import call_var as cli_call_var
        from genomicsbench_palisade_tpu_torch.cli import grm as cli_grm
        from genomicsbench_palisade_tpu_torch.io import plink
        from genomicsbench_palisade_tpu_torch.models import bonito, clair
        from genomicsbench_palisade_tpu_torch.ops import grm as G
        from genomicsbench_palisade_tpu_torch.cli import phmm as cli
        from genomicsbench_palisade_tpu_torch.convert import (abea_batch_from_numpy,
                                                              bsw_batch_from_numpy,
                                                              chain_batch_from_numpy,
                                                              fmi_index_from_numpy)
        from genomicsbench_palisade_tpu_torch.config import load_flye_cfg
        from genomicsbench_palisade_tpu_torch.index import builder as fmi_builder
        from genomicsbench_palisade_tpu_torch.index import fmi_index
        from genomicsbench_palisade_tpu_torch.io import bam
        from genomicsbench_palisade_tpu_torch.io import signal as abea_signal
        from genomicsbench_palisade_tpu_torch.io import chain_dump
        from genomicsbench_palisade_tpu_torch.io.pairs import parse_pairs_soa
        from genomicsbench_palisade_tpu_torch.io.phmm_batch import parse_testfile
        from genomicsbench_palisade_tpu_torch.io.fastq import encode_reads, read_sequences
        from genomicsbench_palisade_tpu_torch.ops import abea as A
        from genomicsbench_palisade_tpu_torch.ops import abea_cuda
        from genomicsbench_palisade_tpu_torch.ops import bsw as W
        from genomicsbench_palisade_tpu_torch.ops import bsw_cuda
        from genomicsbench_palisade_tpu_torch.ops import bsw_stripped
        from genomicsbench_palisade_tpu_torch.ops import chain as C
        from genomicsbench_palisade_tpu_torch.ops import chain_cuda
        from genomicsbench_palisade_tpu_torch.ops import chain_micro
        from genomicsbench_palisade_tpu_torch.ops import fmi_pipeline
        from genomicsbench_palisade_tpu_torch.ops import kmer as K
        from genomicsbench_palisade_tpu_torch.ops import poa as POA
        from genomicsbench_palisade_tpu_torch.ops import occ_gather
        from genomicsbench_palisade_tpu_torch.ops import phmm as P
        from genomicsbench_palisade_tpu_torch.ops import phmm_cuda
        from genomicsbench_palisade_tpu_torch.ops import eventalign as EA
        from genomicsbench_palisade_tpu_torch.ops import events as abea_events
        from genomicsbench_palisade_tpu_torch.ops.oracle import abea as abea_oracle
        from genomicsbench_palisade_tpu_torch.ops.oracle import bsw as bsw_oracle
        from genomicsbench_palisade_tpu_torch.ops.oracle import chain as chain_oracle
        from genomicsbench_palisade_tpu_torch.ops.oracle import eventalign as ea_oracle
        from genomicsbench_palisade_tpu_torch.ops.oracle import fmi as fmi_oracle
        from genomicsbench_palisade_tpu_torch.ops.oracle import phmm as oracle
        from genomicsbench_palisade_tpu_torch.ops.oracle import poa as poa_oracle
        from genomicsbench_palisade_tpu_torch import tools
        from genomicsbench_palisade_tpu_torch.tools import bsw_roofline as bsw_probe
        from genomicsbench_palisade_tpu_torch.tools import chain_roofline as chain_probe
        from genomicsbench_palisade_tpu_torch.tools import occ_gather_experiment as occ_tool
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
                          abea_oracle=abea_oracle, cli_fmi=cli_fmi,
                          fmi_index_from_numpy=fmi_index_from_numpy, fmi_builder=fmi_builder,
                          fmi_index=fmi_index, encode_reads=encode_reads,
                          fmi_pipeline=fmi_pipeline, occ_gather=occ_gather,
                          fmi_oracle=fmi_oracle, occ_tool=occ_tool, bsw_stripped=bsw_stripped,
                          chain_micro=chain_micro, bsw_probe=bsw_probe, chain_probe=chain_probe,
                          tools=tools, bam=bam, EA=EA, ea_oracle=ea_oracle,
                          cli_kmer=cli_kmer, K=K, cli_poa=cli_poa, POA=POA,
                          poa_oracle=poa_oracle, load_flye_cfg=load_flye_cfg,
                          cli_grm=cli_grm, G=G, plink=plink, cli_basecall=cli_basecall,
                          cli_call_var=cli_call_var, bonito=bonito, clair=clair)
        self.kernels = [*phmm_cuda.KERNELS.values(), bsw_cuda.bsw_extend, chain_cuda.chain_dp,
                        *abea_cuda.KERNELS, *occ_gather.KERNELS, *bsw_stripped.KERNELS,
                        *chain_micro.KERNELS]

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
        self.device_s = {}  # kernel: its device seconds over one main-path run
        self.sm_mhz = []  # the median SM clock of each sampled phase (13-14)
        self.abea_chain = []  # the abea kernels' chain rows, printed at the end
        self.card = ""  # nvidia-smi's name and power limit, beside phases 17-18's figures

    def profiled(self, cell, prof):
        """Keep each kernel's summed device time from a main path's profile."""
        for name, secs in prof.get("device_s_by_kind", {}).items():
            if name in self.kern:
                self.device_s[name] = {"cell": cell, "device_s": secs}

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

    # both instances on the edge cases, each batch at its r_pad
    edge = phmm_edge_cases(np.random.default_rng(seed))
    for name, dtype in (("phmm_forward_f32", torch.float32), ("phmm_forward_f64", torch.float64)):
        err = 0.0
        for reads, haps, pairs, r_pad, h_pad in edge:
            tb = P.as_device_batch(P.prepare_batch(reads, haps, pairs, r_pad=r_pad, h_pad=h_pad),
                                   DEVICE)
            err = max(err, max_abs_diff(torch, P.forward_raw(tb, dtype),
                                        P.phmm_forward_plain(tb, dtype)))
        log(f"{name} edge cases: {len(edge)} batches, {sum(len(e[2]) for e in edge)} testcases, "
            f"r_pad {[e[3] for e in edge]}, max_abs_err {err}")
        rec.check(name, err, "the edge cases")

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
        rec.profiled("dataset-550", prof)

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

    # every launch of the counted run timed again on its bucket's tensors;
    # the kernels' figures are those of each pass's largest bucket
    for name, dtype, bkey, rkey in passes:
        itemsize, peak = (4, F32_OPS_PER_S) if dtype == torch.float32 else (8, F64_OPS_PER_S)
        rows = []
        for kb in kept:
            if kb[bkey] is None:
                continue
            tb = kb[bkey]
            ms, got = time_ms(torch, lambda: P.forward_raw(tb, dtype), 3)
            rec.check(name, max_abs_diff(torch, got, torch.from_numpy(kb[rkey]).to(got.device)),
                      f"a rerun on bucket {kb['bucket']}")
            tb_np = {k: v.cpu().numpy() for k, v in tb.items()}
            bms, by = bound(tb_np, itemsize, peak, n_tables)
            row = {"bucket": f"{kb['bucket'][0]}x{kb['bucket'][1]}", "cases": len(kb[rkey]),
                   "ms": ms, "plain_ms": kb[rkey + "_plain_ms"],
                   "gcups": cells_of(tb_np) / (ms * 1e-3) / 1e9, "bound_ms": bms,
                   "bound_by": by}
            log(f"{name} bucket " + json.dumps(row))
            rows.append(row)
        log(f"{name} over the counted run's {len(rows)} launches " + json.dumps(
            {"ms": sum(r["ms"] for r in rows), "bound_ms": sum(r["bound_ms"] for r in rows)}))
        big = max(rows, key=lambda r: r["cases"])
        log(f"{name} on the main path's largest bucket " + json.dumps(big))
        rec.kern[name].update(ms=big["ms"], plain_ms=big["plain_ms"], bound_ms=big["bound_ms"],
                              bound_by=big["bound_by"])

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
    W.bsw_extend(tb, ptuple, q_max=128)  # warm-up: first launch
    ms, got = time_ms(torch, lambda: W.bsw_extend(tb, ptuple, q_max=128), 3)
    st: dict = {}
    plain_ms, want = time_ms(torch, lambda: W.bsw_extend_plain(tb, ptuple, stats=st), 1)
    err = max_abs_diff(torch, got, want)
    bms, by = bsw_bound(tb, st["cells"])
    row = {"shape": "8192x(128x256)", "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
           "gcups": bsw_cells(tb) / (ms * 1e-3) / 1e9, "band_cells": st["cells"],
           "band_gcups": st["cells"] / (ms * 1e-3) / 1e9, "bound_ms": bms, "bound_by": by}
    log("bsw kernel vs plain " + json.dumps(row))
    rec.check(name, err, row["shape"])

    # the edge pairs (lane and bucket edges, breaks, ties, h0 around
    # o_ins + e_ins): through cli.bsw's buckets, each on its edge's instance
    # of the kernel, and whole on the widest instance
    pairs = bsw_edge_pairs(np.random.default_rng(seed))
    tb, ptuple = port.bsw_batch_from_numpy(W.prepare_pairs(pairs), DEVICE)
    want = W.bsw_extend_plain(tb, ptuple)
    by_bucket = cli_bsw.score_pairs(pairs, device=DEVICE)
    got = torch.from_numpy(np.stack([by_bucket[k] for k in W.OUT_ORDER])).to(DEVICE)
    err = max(max_abs_diff(torch, got, want),
              max_abs_diff(torch, W.bsw_extend(tb, ptuple, q_max=512), want))
    log(f"bsw edge pairs: {len(pairs)} pairs, query lengths {BSW_EDGE_QLENS}, "
        f"max_abs_err {err}")
    rec.check(name, err, "the edge pairs")
    t0 = time.perf_counter()
    bsw_new_paths(torch, port, rec, seed)
    log(f"bsw long queries and e_ins < 0: {time.perf_counter() - t0:.1f} s")

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
        rec.profiled("bsw-large", prof)

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
    ms, got = time_ms(torch, lambda: W.bsw_extend(kb["batch"], ptuple, q_max=kb["bucket"][0]), 3)
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

    # the reference goldens through cli.bsw on the card, every output exactly
    cases = json.loads((HERE / "tests" / "fixtures" / "bsw_golden.json").read_text())
    got = cli_bsw.score_pairs([(np.array(c["query"], np.int8), np.array(c["target"], np.int8),
                                c["h0"]) for c in cases], device=DEVICE)
    good = sum({k: int(got[k][i]) for k in W.OUT_ORDER} == c["out"] for i, c in enumerate(cases))
    log(f"bsw goldens bsw_golden.json: {good}/{len(cases)} exact")
    if good != len(cases) or not cases:
        fail(f"bsw goldens: {good}/{len(cases)}")


def bsw_new_paths(torch, port: Port, rec: Record, seed: int):
    """Phase 5's long queries and negative gap extension: the kernel against
    its plain version, bit for bit."""
    W, cli_bsw, kernel = port.W, port.cli_bsw, port.bsw_cuda.bsw_extend
    name = kernel.name
    rng = np.random.default_rng(seed + 11)
    # the times at 1,024 and 4,096 bases: 512 pairs each, targets of 1-2 query
    # lengths; the plain version (a step a target row) is timed at 1,024
    timed = {}
    for ql in (1024, 4096):
        pairs = bsw_long_pairs(rng, 512, ql, ql)
        tb, ptuple = port.bsw_batch_from_numpy(W.prepare_pairs(pairs), DEVICE)
        W.bsw_extend(tb, ptuple, q_max=ql)  # warm-up
        ms, got = time_ms(torch, lambda: W.bsw_extend(tb, ptuple, q_max=ql), 3)
        timed[ql] = (pairs, tb, got)
        row = {"shape": f"512x({ql}x{ql}-{2 * ql})", "ms": ms}
        if ql == 1024:
            st: dict = {}
            plain_ms, want = time_ms(torch, lambda: W.bsw_extend_plain(tb, ptuple, stats=st), 1)
            err = max_abs_diff(torch, got, want)
            rec.check(name, err, f"512 pairs of {ql} bases")
            bms, by = bsw_bound(tb, st["cells"])
            row.update({"plain_ms": plain_ms, "max_abs_err": err, "band_cells": st["cells"],
                        "band_gcups": st["cells"] / (ms * 1e-3) / 1e9, "bound_ms": bms,
                        "bound_by": by})
        log("bsw long-query kernel vs plain " + json.dumps(row))
    # 512 pairs of 513-4,096 bases (targets up to 4,096) on the long-query
    # kernel (rows in shared memory), and the 64 pairs of the 4,096-base
    # launch with the shortest targets, held to one plain call
    t0 = time.perf_counter()
    mixed = bsw_long_pairs(rng, 512, 513, 4096, t_hi=4096)
    tb, ptuple = port.bsw_batch_from_numpy(W.prepare_pairs(mixed), DEVICE)
    got = W.bsw_extend(tb, ptuple)
    if not (got[0] > tb["h0"]).any():
        fail("bsw long queries: no score rose above its h0")
    pairs4k, tb4k, got4k = timed[4096]
    pick = torch.argsort(tb4k["t_len"].cpu(), stable=True)[:64]
    both = mixed + [pairs4k[k] for k in pick.tolist()]
    tb, ptuple = port.bsw_batch_from_numpy(W.prepare_pairs(both), DEVICE)
    want = W.bsw_extend_plain(tb, ptuple)
    err = max_abs_diff(torch, got, want[:, : len(mixed)])
    rec.check(name, err, "512 pairs of 513-4,096 bases")
    err4k = max_abs_diff(torch, got4k[:, pick.to(got4k.device)], want[:, len(mixed) :])
    rec.check(name, err4k, "64 pairs of the 4,096-base launch")
    log("bsw long queries " + json.dumps({"pairs": 512, "query_bases": [513, 4096],
                                          "max_abs_err": err, "of_4096_launch": 64,
                                          "max_abs_err_4096": err4k,
                                          "seconds": time.perf_counter() - t0}))
    # past a block's shared memory: the rows in global scratch
    ql = 30_000
    if not port.bsw_cuda.long_in_scratch(ql):
        fail(f"bsw: a query of {ql} bases should keep its rows in scratch")
    tb, ptuple = port.bsw_batch_from_numpy(
        W.prepare_pairs(bsw_long_pairs(rng, 8, ql - 100, ql, t_hi=2000)), DEVICE)
    err = max_abs_diff(torch, W.bsw_extend(tb, ptuple, q_max=ql), W.bsw_extend_plain(tb, ptuple))
    rec.check(name, err, f"8 pairs of up to {ql} bases (scratch)")
    log(f"bsw long queries in scratch: 8 pairs of {ql - 100}-{ql} bases, max_abs_err {err}")
    # a tie across the first chunk edge: o_ins + e_ins = 0 ties H(i, i) and
    # H(i, i + 1), and the best row is 511 (the later entry wins: qle 513)
    params = port.bsw_oracle.BswParams(o_ins=-1, e_ins=1)
    q = np.random.default_rng(7).integers(0, 4, 600).astype(np.int8)
    tb, ptuple = port.bsw_batch_from_numpy(W.prepare_pairs([(q, q[:512], 30)], params), DEVICE,
                                           params)
    got = W.bsw_extend(tb, ptuple)
    rec.check(name, max_abs_diff(torch, got, W.bsw_extend_plain(tb, ptuple)),
              "a tie across a chunk edge")
    if int(got[1, 0]) != 513:
        fail(f"bsw tie across a chunk edge: qle {int(got[1, 0])}, want 513")
    # e_ins -1 and -3: the edge pairs through cli.bsw's buckets (the register
    # instances' e_ins < 0 variant), whole on the widest instance and on the
    # long-query kernel
    for e_ins in (-1, -3):
        params = port.bsw_oracle.BswParams(e_ins=e_ins)
        pairs = bsw_edge_pairs(np.random.default_rng(seed), params.o_ins, e_ins)
        tb, ptuple = port.bsw_batch_from_numpy(W.prepare_pairs(pairs, params), DEVICE, params)
        want = W.bsw_extend_plain(tb, ptuple)
        by_bucket = cli_bsw.score_pairs(pairs, params, device=DEVICE)
        got = torch.from_numpy(np.stack([by_bucket[k] for k in W.OUT_ORDER])).to(DEVICE)
        err = max(max_abs_diff(torch, got, want),
                  max_abs_diff(torch, W.bsw_extend(tb, ptuple, q_max=512), want),
                  max_abs_diff(torch, W.bsw_extend(tb, ptuple, q_max=1024), want))
        rec.check(name, err, f"the edge pairs at e_ins {e_ins}")
        log(f"bsw edge pairs at e_ins {e_ins}: {len(pairs)} pairs, buckets, edge 512 and the "
            f"long-query kernel, max_abs_err {err}")


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

    # the edge calls (windows of 1-250 and MAX_ITER predecessors, breaks at
    # every offset of a step, in-step marks, ties)
    preps = [C.prepare_call(x, y, aq) for x, y, aq in
             chain_edge_calls(np.random.default_rng(seed))]
    tb, params = port.chain_batch_from_numpy(preps, DEVICE)
    st = {}
    err = max_abs_diff(torch, C.chain_dp(tb, params), C.chain_dp_plain(tb, params, stats=st))
    log(f"chain edge calls: {len(preps)} calls, {sum(p['n'] for p in preps)} anchors, "
        f"windows up to {max(p['w_need'] for p in preps)}, {st['breaks']} breaks, "
        f"max_abs_err {err}")
    rec.check(name, err, "the edge calls")

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
        rec.profiled("chain-1001", prof)

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

    # the counted run's outputs of every call of up to CHAIN_PLAIN_MAX_N
    # anchors against the plain version on the same device tensors; the
    # plain version counts the predecessors
    if len(kept) != 1:
        fail(f"the chain main path made {len(kept)} launches: one expected")
    kb = kept[0]
    n_calls = kb["batch"]["n"].cpu().numpy()
    sel = torch.from_numpy(np.nonzero(n_calls <= CHAIN_PLAIN_MAX_N)[0]).to(DEVICE)
    sub, cols = chain_subset(torch, kb["batch"], sel)
    st = {}
    plain_ms, want = time_ms(torch, lambda: C.chain_dp_plain(sub, kb["params"], stats=st), 1)
    rec.check(name, max_abs_diff(torch, kb["out"][:, cols], want),
              f"main-path calls of up to {CHAIN_PLAIN_MAX_N} anchors")
    seen = {"calls": int(sel.numel()), "of_calls": len(n_calls), "anchors": int(cols.numel()),
            "of_anchors": anchors, "max_n": int(n_calls[n_calls <= CHAIN_PLAIN_MAX_N].max()),
            "plain_s": plain_ms * 1e-3, **st}
    log("chain main path vs plain, calls up to the cut " + json.dumps(seen))
    if not (e2e["scores_nonzero_share"] > 0 and e2e["parents_share"] > 0 and st["breaks"] > 0):
        fail("the chain main path's calls did not score, chain and break: the check would "
             "hold nothing")

    # the kernel on the main path's launch, and on those calls alone (the
    # kernels line's figures: the plain time and the bound are theirs)
    full_ms, got = time_ms(torch, lambda: C.chain_dp(kb["batch"], kb["params"]), 3)
    rec.check(name, max_abs_diff(torch, got, kb["out"]), "a rerun of the main path's launch")
    ms, got = time_ms(torch, lambda: C.chain_dp(sub, kb["params"]), 3)
    rec.check(name, max_abs_diff(torch, got, want), "the cut's calls as one launch")
    bms, by = chain_bound(seen["anchors"], seen["calls"], kb["params"][2], st)
    row = {"shape": f"{seen['calls']} calls, {seen['anchors']} anchors (calls of up to "
                    f"{CHAIN_PLAIN_MAX_N})", "ms": ms, "plain_ms": plain_ms,
           "anchors_per_s": seen["anchors"] / (ms * 1e-3), **st,
           "predecessors_per_s": st["predecessors"] / (ms * 1e-3), "bound_ms": bms,
           "bound_by": by, "main_path_launch_ms": full_ms,
           "main_path_launch": f"{len(n_calls)} calls, {anchors} anchors"}
    log(f"{name} on the main path's calls of up to {CHAIN_PLAIN_MAX_N} anchors " + json.dumps(row))
    rec.kern[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                          main_path_launch_ms=full_ms)

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


def ranges(torch, starts, counts):
    """The row indices start .. start + count - 1 of each (start, count),
    concatenated in order."""
    total = int(counts.sum())
    first = torch.cumsum(counts, 0) - counts
    return (torch.repeat_interleave(starts - first, counts)
            + torch.arange(total, device=counts.device))


def exclusive_cumsum(torch, counts):
    return torch.cumsum(counts, 0) - counts


def chain_subset(torch, batch, sel):
    """The flat chain batch of the calls `sel` (ascending indices) of
    `batch`, and the anchor columns they hold in `batch`."""
    n = batch["n"][sel]
    cols = ranges(torch, batch["off"][sel], n.long())
    sub = {k: batch[k][cols] for k in ("x_lo", "qi", "qspan", "st_eff")}
    sub.update(n=n, off=exclusive_cumsum(torch, n.long()), gap_table=batch["gap_table"][sel])
    return sub, cols


def abea_subset(torch, batch, sel):
    """The flat abea batch of the reads `sel` (ascending indices) of
    `batch`, and the band rows they hold in `batch`."""
    ne, nk = batch["ne"][sel], batch["nk"][sel]
    ne64, nk64 = ne.long(), nk.long()
    sub = {"ev": batch["ev"][ranges(torch, batch["ev_off"][sel], ne64)]}
    k_rows = ranges(torch, batch["k_off"][sel], nk64)
    sub.update({k: batch[k][k_rows] for k in ("gm", "stdv", "lstdv")})
    sub.update(ne=ne, nk=nk, lp=batch["lp"][sel], ev_off=exclusive_cumsum(torch, ne64),
               k_off=exclusive_cumsum(torch, nk64))
    sub["band_off"] = sub["ev_off"] + sub["k_off"] + 2 * torch.arange(len(sel), device=ne.device)
    return sub, ranges(torch, batch["band_off"][sel], ne64 + nk64 + 2)


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


def abea_row(torch, port, rec, batch_np, batch, fill_ms, fill, walk_ms, walk, cell) -> dict:
    """The kernels' numbers on one batch: bands, valid cells, walk steps,
    rates, bounds, the reads that align, and the chain: the longest read's
    bands and the longest walk's steps, ns a band and a step (their cycles
    are printed at the end, with the clock phases 13-14 sample)."""
    walk_np = {k: v.cpu().numpy() for k, v in walk.items()}
    cells, steps, b = abea_cells(torch, batch, fill), int(walk_np["n"].sum()), len(batch_np["ne"])
    fb, fby = abea_fill_bound(batch, cells)
    wb, wby = abea_walk_bound(b, steps)
    bands_max = int((batch_np["ne"].astype(np.int64) + batch_np["nk"]).max()) + 2
    steps_max = int(walk_np["n"].max())
    rec.abea_chain.append({"cell": cell, "fill_ms": fill_ms, "bands_max_read": bands_max,
                           "walk_ms": walk_ms, "steps_max_read": steps_max})
    return {"reads": b, "events": int(batch_np["ne"].sum()), "kmers": int(batch_np["nk"].sum()),
            "bands": port.A.n_rows(batch), "bands_max_read": bands_max, "steps_max_read": steps_max,
            "cells": cells, "walk_steps": steps, "fill_ms": fill_ms, "walk_ms": walk_ms,
            "fill_ns_per_band": fill_ms * 1e6 / bands_max, "walk_ns_per_step": walk_ms * 1e6 / steps_max,
            "cells_per_s": cells / (fill_ms * 1e-3), "fill_bound_ms": fb, "fill_bound_by": fby,
            "walk_bound_ms": wb, "walk_bound_by": wby,
            "aligned": sum(1 for r in port.A.decode(batch_np["band_off"], walk_np) if r)}


def abea_chain_lines(rec):
    """Per abea row: ns and SM cycles a band and a step at the median clock
    of phases 13-14, and the chain floor (the longest read's bands or steps
    times ABEA_FILL_CHAIN_CYCLES or ABEA_WALK_CHAIN_CYCLES)."""
    mhz = float(np.median(rec.sm_mhz)) if rec.sm_mhz else None
    for row in rec.abea_chain:
        out = {"cell": row["cell"], "sm_mhz": mhz if mhz else "not sampled"}
        for kern, count, cyc in (("fill", "bands_max_read", ABEA_FILL_CHAIN_CYCLES),
                                 ("walk", "steps_max_read", ABEA_WALK_CHAIN_CYCLES)):
            ns = row[f"{kern}_ms"] * 1e6 / row[count]
            out.update({f"{kern}_ms": row[f"{kern}_ms"], count: row[count],
                        f"{kern}_ns_each": ns,
                        f"{kern}_cycles_each": ns * mhz / 1e3 if mhz else "not sampled",
                        f"{kern}_chain_cycles_each": cyc,
                        f"{kern}_chain_floor_ms": (row[count] * cyc / (mhz * 1e3)) if mhz
                        else "not sampled"})
        log("abea chain cost " + json.dumps(out))


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
           **abea_row(torch, port, rec, batch_np, tb, fill_ms, fill, walk_ms, walk,
                      "abea-bench-128"),
           "plain_fill_ms": pf_ms, "plain_walk_ms": pw_ms, "max_abs_err": 0.0}
    log("abea kernels vs plain " + json.dumps(row))
    if row["aligned"] != n_reads:
        fail(f"abea: {row['aligned']} of the {n_reads} bench reads aligned")

    # 9. both kernels on the edge reads, and on their first batch blocked
    t0 = time.perf_counter()
    emodel, ebatches = abea_edge_reads(np.random.default_rng(seed))
    flat = [A.prepare_batch(seqs, evs, emodel, scales, shifts)[0]
            for seqs, evs, scales, shifts in ebatches]
    flat.append(abea_blocked(flat[0]))
    for k, batch_np in enumerate(flat):
        tb = port.abea_batch_from_numpy(batch_np, DEVICE)
        fill = A.abea_fill(tb)
        abea_check(torch, port, rec, tb, fill, A.abea_walk(tb, fill), f"edge batch {k}")
    log("abea edge reads " + json.dumps(
        {"batches": len(flat), "reads": [len(b["ne"]) for b in flat], "max_abs_err": 0.0,
         "seconds": time.perf_counter() - t0}))

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
           **abea_row(torch, port, rec, batch_np, tb, *abea_time(torch, port, tb),
                      "abea-long-17")}
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
        rec.profiled("abea-512", prof)

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

    # the counted run's outputs of every read of up to ABEA_PLAIN_MAX_BASES
    # bases against the plain versions on the same tensors
    batch, fill, walk = kept["batch"], kept["fill"], kept["walk"]
    bases = batch["nk"].long() + (port.abea_oracle.KMER_SIZE - 1)
    sel = torch.nonzero(bases <= ABEA_PLAIN_MAX_BASES)[:, 0]
    sub, rows = abea_subset(torch, batch, sel)
    sub_fill = {k: v[sel] if k == "seed" else v[rows] for k, v in fill.items()}
    sub_walk = {k: v[rows] if k == "pairs" else v[sel] for k, v in walk.items()}
    pf_ms, pw_ms = abea_check(torch, port, rec, sub, sub_fill, sub_walk,
                              f"abea-512's reads of up to {ABEA_PLAIN_MAX_BASES} bases")
    log("abea main path vs plain, reads up to the cut " + json.dumps(
        {"reads": int(sel.numel()), "of_reads": batch["ne"].numel(),
         "bases": int(bases[sel].sum()), "longest": int(bases[sel].max()),
         "bands": A.n_rows(sub), "of_bands": A.n_rows(batch), "plain_fill_s": pf_ms * 1e-3,
         "plain_walk_s": pw_ms * 1e-3}))

    # the kernels on the main path's launch, and on those reads alone (the
    # kernels line's figures: the plain times and the bounds are theirs)
    batch_np = {k: v.cpu().numpy() for k, v in batch.items()}
    full = abea_time(torch, port, batch)
    rec.check("abea_fill", max(max_abs_diff(torch, full[1][k], v) for k, v in fill.items()),
              "a rerun of the main path's launch")
    rec.check("abea_walk", max(max_abs_diff(torch, full[3][k], v) for k, v in walk.items()),
              "a rerun of the main path's launch")
    row = {"shape": "abea-512's launch", **abea_row(torch, port, rec, batch_np, batch, *full,
                                                     "abea-512")}
    log("abea kernels on the main path's launch " + json.dumps(row))
    fill_ms, fill2, walk_ms, walk2 = abea_time(torch, port, sub)
    rec.check("abea_fill", max(max_abs_diff(torch, fill2[k], v) for k, v in sub_fill.items()),
              "the cut's reads as one launch")
    rec.check("abea_walk", max(max_abs_diff(torch, walk2[k], v) for k, v in sub_walk.items()),
              "the cut's reads as one launch")
    sub_np = {k: v.cpu().numpy() for k, v in sub.items()}
    cut = {"shape": f"abea-512's reads of up to {ABEA_PLAIN_MAX_BASES} bases",
           **abea_row(torch, port, rec, sub_np, sub, fill_ms, fill2, walk_ms, walk2,
                      "abea-512-cut"),
           "plain_fill_ms": pf_ms, "plain_walk_ms": pw_ms}
    log("abea kernels on the main path's reads up to the cut " + json.dumps(cut))
    rec.kern["abea_fill"].update(ms=fill_ms, plain_ms=pf_ms, bound_ms=cut["fill_bound_ms"],
                                 bound_by=cut["fill_bound_by"], main_path_launch_ms=full[0])
    rec.kern["abea_walk"].update(ms=walk_ms, plain_ms=pw_ms, bound_ms=cut["walk_bound_ms"],
                                 bound_by=cut["walk_bound_by"], main_path_launch_ms=full[2])

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


def golden_eventalign_entries(port, counts):
    """tests/fixtures/eventalign_golden.json's 25 cases as one batch of
    cli.abea.bam_entries (case i's records on reference i, its contig
    ctg1), their contigs, and per case its results."""
    cases = json.loads((HERE / "tests" / "fixtures" / "eventalign_golden.json").read_text())
    nt16 = {c: i for i, c in enumerate(port.bam.SEQ_NT16_STR)}
    entries, contigs, want = [], [], []
    for ci, case in enumerate(cases["cases"]):
        recs = sorted((port.bam.BamRecord(
            rd["qname"], rd["flag"], ci, rd["pos"], rd["mapq"], [tuple(c) for c in rd["cigar"]],
            np.array([nt16[ch] for ch in rd["query"]], np.uint8),
            np.full(len(rd["query"]), 30, np.uint8), {"NM": rd["nm"]}) for rd in case["reads"]),
            key=lambda r: r.pos)
        reads = {rd["qname"]: rd["fastq"] for rd in case["reads"]}
        sigs = {rd["qname"]: np.array([float(x) for x in rd["signal"]], np.float32)
                for rd in case["reads"]}
        entries += port.cli_abea.bam_entries(recs, reads, sigs, counts)
        contigs.append(("ctg1", case["genome"]))
        want += case["results"]
    return entries, contigs, want


def oracle_tsv(port, model, r, region=(-1, -1)) -> str:
    """The port's oracle's TSV rows (read index 0, contig chr1) of a
    RealignRead: align_read_to_ref, then emit_tsv_lines."""
    EO = port.ea_oracle
    aln = EO.align_read_to_ref(r.record, r.ref_segment, r.record.pos, r.read_length, r.events,
                               r.sc, model, r.b2e, r.events_per_base, 0, *region)
    return "".join(EO.emit_tsv_lines(r.events, model, r.sc, aln, 0, r.record.name, "chr1",
                                     4000.0))


def eventalign_phase(torch, port: Port, rec: Record, seed: int):
    """Phase 16: the eventalign main path, cell eventalign-512."""
    cli, EA = port.cli_abea, port.EA
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        tmp = Path(tmp)
        lengths = np.linspace(*ABEA_LENS, ABEA_READS).astype(int)
        t0 = time.perf_counter()
        info = write_eventalign_dataset(tmp, lengths, np.random.default_rng(seed), port.bam)
        log("eventalign dataset " + json.dumps({**info, "written_s": time.perf_counter() - t0}))

        # the timed run: load, the BAM, one f5c batch (-K 512 -B 3.7M)
        port.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = port.abea_signal.load_pore_model(str(tmp / "pore.tsv"))
        signals = port.abea_signal.load_signals_npz(str(tmp / "signals.npz"))
        genome = {n: s.upper() for n, s, _ in port.read_sequences(str(tmp / "genome.fa"))}
        reads = {n: s for n, s, _ in port.read_sequences(str(tmp / "reads.fq"))}
        t1 = time.perf_counter()
        ref_names, records, _, _ = cli.load_bam(str(tmp / "reads.bam"))
        contigs = [(n, genome.get(n)) for n in ref_names]
        counts = dict.fromkeys(cli.COUNTS, 0)
        groups = list(cli.batches(cli.bam_entries(records, reads, signals, counts), ABEA_READS,
                                  cli.parse_bases(ABEA_MAX_BASES)))
        t2 = time.perf_counter()
        if len(groups) != 1:
            fail(f"eventalign-512 makes {len(groups)} batches at -K {ABEA_READS} -B "
                 f"{ABEA_MAX_BASES}")
        stats, keep = {}, {}
        text, summary, n_rows = cli.eventalign_batch(
            groups[0], contigs, model, cli.EventalignOptions(summary=True), counts, DEVICE,
            stats=stats, keep=keep)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = port.launches()
        total_s = t3 - t0
        e2e = {"records": len(records), "entries": len(groups[0]), **counts,
               "passed_qc": len(keep["realign"]), "tsv_rows": n_rows, "events": stats["events"],
               "load_s": t1 - t0, "bam_s": t2 - t1, **{k: v for k, v in stats.items()},
               "total_s": total_s, "tsv_rows_per_s_end_to_end": n_rows / total_s,
               "events_per_s_end_to_end": stats["events"] / total_s,
               "tsv_mb": len(text) / 1e6,
               "launches": {k: v for k, v in launches.items() if v}}
        log("eventalign end to end " + json.dumps(e2e))
        for name in ("abea_fill", "abea_walk"):
            rec.kern[name]["eventalign_512"] = {"launches": launches[name]}
            if launches[name] != 1:
                fail(f"the eventalign main path launched {name} {launches[name]} times: one "
                     "expected")
        passed = len(keep["realign"])
        rows = text.splitlines()
        if (counts["total"] != ABEA_READS or counts["bad_sig"] or passed < ABEA_READS // 2
                or len(rows) != n_rows or any(r.count("\t") != 12 for r in rows)
                or len(summary.splitlines()) != sum(len(a.ref_pos) > 0
                                                     for a in keep["alignments"])):
            fail(f"eventalign-512's output is malformed: {counts}, {passed} passed QC, "
                 f"{len(rows)} rows of {n_rows}")
        del text, rows

        # -w over EA_WINDOW through the .bai, the same records as the filter
        # without it; its two shortest reads against the port's oracle
        t0 = time.perf_counter()
        _, recs_w, r0, r1 = cli.load_bam(str(tmp / "reads.bam"), EA_WINDOW)
        shutil.copyfile(tmp / "reads.bam", tmp / "noindex.bam")
        _, recs_f, _, _ = cli.load_bam(str(tmp / "noindex.bam"), EA_WINDOW)
        if [(r.name, r.pos, r.flag) for r in recs_w] != [(r.name, r.pos, r.flag) for r in recs_f]:
            fail("-w through the .bai and through the record filter read other records")
        counts_w, keep_w = dict.fromkeys(cli.COUNTS, 0), {}
        text_w = cli.eventalign_batch(list(cli.bam_entries(recs_w, reads, signals, counts_w)),
                                      contigs, model, cli.EventalignOptions(r0, r1), counts_w,
                                      DEVICE, keep=keep_w)[0]
        pos = [int(r.split("\t")[1]) for r in text_w.splitlines()]
        t1 = time.perf_counter()
        pairs_w = sorted(zip(keep_w["realign"], keep_w["alignments"]),
                         key=lambda p: p[0].read_length)[:2]
        same = [oracle_tsv(port, model, r, (r0, r1)) == EA.emit_tsv(
            a, r.events, model, r.sc, 0, r.record.name, "chr1", 4000.0) for r, a in pairs_w]
        if not pos or min(pos) < r0 or max(pos) > r1 or not all(same) or len(same) != 2:
            fail(f"-w {EA_WINDOW}: {len(pos)} rows, oracle {same}")
        log(f"eventalign -w {EA_WINDOW}: {len(recs_w)} records through the .bai (the filter's), "
            f"{len(pos)} rows in [{min(pos)}, {max(pos)}] ({t1 - t0:.1f} s); its 2 shortest "
            f"reads equal the port's oracle ({time.perf_counter() - t1:.1f} s)")

    # the batch's shortest reads through realign_batch on the card and on the
    # CPU, against the main run's and the port's oracle
    t0 = time.perf_counter()
    rr, alns = keep["realign"], keep["alignments"]
    sel = sorted(range(len(rr)), key=lambda j: rr[j].read_length)[:EA_ORACLE_READS]
    sub = [rr[j] for j in sel]
    card, cpu = EA.realign_batch(sub, model, DEVICE), EA.realign_batch(sub, model, "cpu")
    t1 = time.perf_counter()
    bad = []
    for j, r, a, b in zip(sel, sub, card, cpu):
        got = [(x.ref_pos.tolist(), x.event_idx.tolist(), x.state.tolist())
               for x in (a, b, alns[j])]
        want = oracle_tsv(port, model, r)
        if got[0] != got[1] or got[0] != got[2] or want != EA.emit_tsv(
                a, r.events, model, r.sc, 0, r.record.name, "chr1", 4000.0) or not want:
            bad.append(r.record.name)
    lens = [r.read_length for r in sub]
    log(f"eventalign realign sample: {len(sel) - len(bad)}/{len(sel)} of the batch's shortest "
        f"reads ({min(lens)}-{max(lens)} bases) equal on the card, the CPU and the port's "
        f"oracle (card and CPU {t1 - t0:.1f} s, oracle {time.perf_counter() - t1:.1f} s)")
    if bad or len(sel) != EA_ORACLE_READS:
        fail(f"eventalign realign differs in reads {bad}")

    # the 25 goldens through the CLI's functions on the card: statuses,
    # scalings, summaries and every TSV row exactly
    t0 = time.perf_counter()
    gtsv = HERE / "build" / "eventalign_golden_pore.tsv"
    write_pore_model(gtsv)
    gmodel = port.abea_signal.load_pore_model(str(gtsv))
    gtsv.unlink()
    gcounts = dict.fromkeys(cli.COUNTS, 0)
    entries, gcontigs, want = golden_eventalign_entries(port, gcounts)
    gkeep = {}
    text, _, _ = cli.eventalign_batch(entries, gcontigs, gmodel, cli.EventalignOptions(),
                                      gcounts, DEVICE, keep=gkeep)
    passed = iter(zip(gkeep["realign"], gkeep["alignments"]))
    good = 0
    for (read_idx, status, sc, epb), ent, w in zip(gkeep["scaling"], entries, want):
        ok = (ent[0], read_idx, status) == (w["qname"], w["read_idx"], w["status"])
        if ok and status == 0:
            r, a = next(passed)
            s = EA.summarize(a, r.events, gmodel, sc, nm=ent[3].tags["NM"])
            ok = ([sc["shift"], sc["scale"], sc["var"], epb]
                  == [np.float32(float.fromhex(h)) for h in w["scale"][:3]]
                  + [float.fromhex(w["scale"][3])]
                  and [s[k] for k in ("num_events", "num_steps", "num_skips", "num_stays")]
                  == [int(x) for x in w["summary"][:4]]
                  and [s["sum_duration"], s["sum_z_score"]]
                  == [float.fromhex(x) for x in w["summary"][4:6]]
                  and EA.emit_tsv(a, r.events, gmodel, sc, read_idx, ent[0], "ctg1",
                                  4000.0).splitlines() == w["tsv"])
        good += ok
    rows_ok = text.splitlines() == [t for w in want for t in w.get("tsv", [])]
    log(f"eventalign goldens eventalign_golden.json: {good}/{len(want)} reads exact (status, "
        f"scalings, summary, TSV), batch text {'equal' if rows_ok else 'differs'} "
        f"({time.perf_counter() - t0:.1f} s)")
    if good != len(want) or len(gkeep["scaling"]) != len(want) or not rows_ok:
        fail(f"eventalign goldens: {good}/{len(want)}")

def kmer_phase(torch, port: Port, rec: Record, seed: int):
    """Phase 17: the kmer main path, cell kmer-0.25g."""
    cli, K = port.cli_kmer, port.K
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        codes = synth_kmer_reads(np.random.default_rng(seed), KMER_READS, KMER_READ_LEN,
                                 KMER_GENOME_MBP, KMER_ERR)
        write_fasta(tmp / "reads.fa", codes)
        write_fasta(tmp / "parity.fa", codes[:KMER_PARITY_READS])
        del codes
        cfg = tmp / "kmer.cfg"
        cfg.write_text(f"kmer_size = {KMER_K}\nuse_minimizers = 0\n")
        log(f"kmer dataset: {KMER_READS} reads of {KMER_READ_LEN} bases from a "
            f"{KMER_GENOME_MBP} Mbp genome, {KMER_ERR:.1%} substitutions, "
            f"{(tmp / 'reads.fa').stat().st_size / 1e6:.1f} MB of FASTA "
            f"({time.perf_counter() - t0:.1f} s)")

        # the timed run: the CLI's read (parse and the overlap filter) and counter
        port.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k = int(port.load_flye_cfg(str(cfg))["kmer_size"])
        with contextlib.redirect_stdout(io.StringIO()):
            reads = cli.read_reads(str(tmp / "reads.fa"), KMER_MIN_LEN)
        t1 = time.perf_counter()
        stats = {}
        metrics = cli.count(reads, k, KMER_MIN_LEN, DEVICE, stats)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = port.launches()
        bases = sum(len(r) for r in reads)
        e2e = {"reads": len(reads), "bases": bases, **metrics, "parse_s": t1 - t0, **stats,
               "count_s": t2 - t1, "total_s": t2 - t0,
               "mbases_per_s_end_to_end": bases / 1e6 / (t2 - t0),
               "mbases_per_s_count": bases / 1e6 / (t2 - t1),
               "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
               "kernel_launches": sum(launches.values()), "card": rec.card}
        log("kmer-0.25g end to end " + json.dumps(e2e))
        if (stats.get("merges") != KMER_MERGES or any(launches.values())
                or metrics["occurrences"] != KMER_READS * (KMER_READ_LEN - KMER_K)
                or not KMER_GENOME_MBP * 800_000 < metrics["total_kmers"] < KMER_GENOME_MBP * 1_600_000
                or not 0 < metrics["hash_size"] < metrics["total_kmers"]):
            fail(f"kmer-0.25g: {e2e}")

        # the CLI's lines for the first reads
        t0 = time.perf_counter()
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli.main(["--reads", str(tmp / "parity.fa"), "--config", str(cfg), "--debug"])
        parity = reads[:KMER_PARITY_READS]
        want = K.count_kmers(parity, k=k, device=DEVICE)
        lines = (f"Hash size: {want['hash_size']}", f"Total k-mers {want['total_kmers']}",
                 "useMinimizers: 0", "Kernel time: ")
        if not all(ln in out.getvalue() + err.getvalue() for ln in lines):
            fail(f"the kmer CLI printed {out.getvalue()!r} {err.getvalue()!r}")
        log(f"kmer CLI on {len(parity)} reads: its lines give the counter's metrics "
            f"({time.perf_counter() - t0:.1f} s)")
    del reads

    # the one-shot and the streamed counters (>= 2 merges) on the card and
    # the CPU; k = 31 and 32 (bit 63), card against CPU
    t0 = time.perf_counter()
    batched = dict(k=k, batch_bases=KMER_PARITY_READS * KMER_READ_LEN // 3)
    sets = {(dev, fn.__name__): fn(parity, device=dev, **(batched if fn is K.count_kmers_batched
                                                             else {"k": k}))
            for dev in (DEVICE, "cpu") for fn in (K.count_kmers, K.count_kmers_batched)}
    wide = parity[:KMER_WIDE_READS]
    for kk in (31, 32):
        for dev in (DEVICE, "cpu"):
            sets[dev, f"k{kk}"] = K.count_kmers_batched(wide, k=kk, batch_bases=200_000,
                                                        device=dev)
    log(f"kmer parity: {KMER_PARITY_READS} reads, four metric sets "
        f"{json.dumps(sets[DEVICE, 'count_kmers'])}; k 31 and 32 on {KMER_WIDE_READS} reads "
        f"{[sets[DEVICE, f'k{kk}']['total_kmers'] for kk in (31, 32)]} "
        f"({time.perf_counter() - t0:.1f} s)")
    if (len({json.dumps(v) for kk, v in sets.items() if kk[1].startswith("count")}) != 1
            or any(sets[DEVICE, f"k{kk}"] != sets["cpu", f"k{kk}"] for kk in (31, 32))):
        fail(f"kmer counters disagree: {sets}")

    # the 25 reference goldens on the card
    cases = json.loads((HERE / "tests" / "fixtures" / "kmer_golden.json").read_text())["cases"]
    good = 0
    for case in cases:
        args = dict(k=case["k"], min_read_length=case["min_read_length"], device=DEVICE)
        good += all((m["total_kmers"], m["hash_size"]) == (case["total_kmers"], case["hash_size"])
                    for m in (K.count_kmers(case["reads"], **args),
                              K.count_kmers_batched(case["reads"], batch_bases=600,
                                                    cap=1 << 13, **args)))
    log(f"kmer goldens kmer_golden.json: {good}/{len(cases)} exact (both counters)")
    if good != len(cases) or not cases:
        fail(f"kmer goldens: {good}/{len(cases)}")


def poa_lockstep(POA, PO, wins, device):
    """Every round's alignments of the windows through align_batch, and the
    consensus."""
    graphs, rounds = [PO.PoaGraph() for _ in wins], []
    for k in range(max(len(w) for w in wins)):
        idxs = [i for i, w in enumerate(wins) if k < len(w)]
        alns = POA.align_batch([graphs[i] for i in idxs], [wins[i][k] for i in idxs],
                               POA_PARAMS, device=device)
        for i, a in zip(idxs, alns):
            graphs[i].add_alignment(a, wins[i][k])
        rounds.append(alns)
    return rounds, [g.generate_consensus() for g in graphs]


def poa_ops_per_step(torch, POA) -> dict:
    """The torch ops (kernels, on the card) of one fill row step and one walk
    step of ops.poa's aligner, counted on the CPU under a dispatch mode
    (views and scalar wrappers launch nothing and are not counted)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    free = {"view", "unbind", "slice", "select", "expand", "unsqueeze", "squeeze", "alias",
            "detach", "as_strided", "_unsafe_view", "scalar_tensor", "lift_fresh"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func.__name__.split(".")[0] not in free
            return func(*args, **(kwargs or {}))

    al = POA._Aligner(2, 64, 64, 4, 132, "nw", POA_PARAMS, POA.FIX_PASSES, torch.device("cpu"))
    out = {}
    for name, fn in (("row_step", al._row_step), ("walk_step", al._walk_step)):
        with Count() as c:
            fn()
        out[name] = c.n
    return out


def poa_phase(torch, port: Port, rec: Record, seed: int):
    """Phase 18: the poa main path, cell poa-64x10x750."""
    cli, POA, PO = port.cli_poa, port.POA, port.poa_oracle
    (HERE / "build").mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    windows = synth_windows(rng, POA_WINDOWS, POA_SEQS, POA_LEN)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        fasta = Path(tmp) / "windows.fa"
        write_fasta(fasta, [s for w in windows for s in w],
                    [f"{int(i > 0)}_{w}_{i}" for w in range(POA_WINDOWS) for i in range(POA_SEQS)])

        # the timed run: the CLI's read and msa_consensus_batch
        port.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches = cli.read_batches(str(fasta))
        t1 = time.perf_counter()
        timings, stats = {}, {}
        cons = POA.msa_consensus_batch(batches, POA_PARAMS, timings=timings, device=DEVICE,
                                       stats=stats)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = port.launches()
        n_seqs = sum(len(b) for b in batches)
        rounds = stats["rounds"]
        ops = poa_ops_per_step(torch, POA)
        e2e = {"windows": len(batches), "seqs": n_seqs,
               "bases": sum(len(s) for b in batches for s in b), "load_s": t1 - t0,
               **{f"{k}_s": v for k, v in timings.items()}, **stats, "total_s": t2 - t0,
               "seqs_per_s_end_to_end": n_seqs / (t2 - t0),
               "fill_rows_per_round": stats["fill_rows"] / rounds,
               "tb_steps_per_round": stats["tb_steps"] / rounds,
               "fixpoint_reruns": stats.get("reruns", 0),
               "host_syncs_per_round": stats["syncs"] / rounds,
               "ops_per_row_step": ops["row_step"], "ops_per_walk_step": ops["walk_step"],
               "kernels_per_round": (ops["row_step"] * stats["fill_rows"]
                                     + ops["walk_step"] * stats["tb_steps"]) / rounds,
               "graph_replays_per_round": (stats["fill_rows"]
                                           + stats["tb_steps"] // POA.TB_BLOCK) / rounds,
               "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
               "kernel_launches": sum(launches.values()), "card": rec.card}
        log("poa-64x10x750 end to end " + json.dumps(e2e))
        if (batches != windows or len(cons) != POA_WINDOWS or rounds != POA_SEQS
                or any(launches.values())
                or not all(POA_LEN - 60 < len(c) < POA_LEN + 60 for c in cons)):
            fail(f"poa-64x10x750: {e2e}, consensus lengths {sorted(len(c) for c in cons)}")

        # the CLI's stdout for the file against the pooled consensus
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            cli.main(["-s", str(fasta)])
        lines = out.getvalue().splitlines()
        want = [f"Number of batches: {POA_WINDOWS}"] + [
            f"batches[{i}].consensus_seq: {c}" for i, c in enumerate(cons)]
        if lines[:-1] != want or not lines[-1].startswith("Runtime: "):
            fail("the poa CLI's stdout differs from the pooled consensus")
        log(f"poa CLI: its stdout is the pooled consensus ({time.perf_counter() - t0:.1f} s)")

    # two windows on the card and the CPU: every round's alignments and the
    # consensus (the main run's too)
    t0 = time.perf_counter()
    sub = windows[:POA_CPU_WINDOWS]
    card, cpu = poa_lockstep(POA, PO, sub, DEVICE), poa_lockstep(POA, PO, sub, "cpu")
    log(f"poa card vs CPU: {POA_CPU_WINDOWS} windows, {len(card[0])} rounds, alignments "
        f"{'equal' if card[0] == cpu[0] else 'differ'}, consensus "
        f"{'equal' if card[1] == cpu[1] == cons[:POA_CPU_WINDOWS] else 'differs'} "
        f"({time.perf_counter() - t0:.1f} s)")
    if card != cpu or card[1] != cons[:POA_CPU_WINDOWS]:
        fail("poa: the card and the CPU disagree")

    # seeded small windows against the port's oracle, exactly
    n_win, n_seq, length = POA_ORACLE
    small = synth_windows(rng, n_win, n_seq, length)
    got = POA.msa_consensus_batch(small, POA_PARAMS, device=DEVICE)
    want = [PO.msa_consensus(w, PO.PoaParams(*POA_PARAMS)) for w in small]
    log(f"poa oracle sample: {sum(a == b for a, b in zip(got, want))}/{n_win} windows of "
        f"{n_seq} x {length} exact")
    if got != want:
        fail("poa consensus differs from the port's oracle")

    # the reference goldens on the card: 48 windows (nw), 10 cases in sw and ov
    t0 = time.perf_counter()
    fx = HERE / "tests" / "fixtures"
    cases = json.loads((fx / "poa_golden.json").read_text())["cases"]
    batches = [seqs for case in cases for seqs in case["batches"]]
    wants = [w for case in cases for w in case["consensus"]]
    good = sum(a == b for a, b in zip(POA.msa_consensus_batch(batches, device=DEVICE), wants))
    golden = json.loads((fx / "poa_swov_golden.json").read_text())["cases"]
    swov = {}
    for atype in ("sw", "ov"):
        graphs = [PO.PoaGraph() for _ in golden]
        exact = [True] * len(golden)
        for k in range(max(len(c["seqs"]) for c in golden)):
            idxs = [ci for ci, c in enumerate(golden) if k < len(c["seqs"])]
            alns = POA.align_batch([graphs[ci] for ci in idxs],
                                   [golden[ci]["seqs"][k] for ci in idxs], align_type=atype,
                                   device=DEVICE)
            for ci, aln in zip(idxs, alns):
                exact[ci] &= [list(p) for p in aln] == golden[ci][atype]["alignments"][k]
                graphs[ci].add_alignment(aln, golden[ci]["seqs"][k])
        swov[atype] = sum(ok and g.generate_consensus() == c[atype]["consensus"]
                          for ok, g, c in zip(exact, graphs, golden))
    log(f"poa goldens: poa_golden.json {good}/{len(wants)} consensus exact; "
        f"poa_swov_golden.json sw {swov['sw']}/{len(golden)}, ov {swov['ov']}/{len(golden)} "
        f"(alignments and consensus) ({time.perf_counter() - t0:.1f} s)")
    if good != len(wants) or any(v != len(golden) for v in swov.values()) or not wants:
        fail(f"poa goldens: {good}/{len(wants)}, {swov}")


def grm_phase(torch, port: Port, rec: Record, seed: int):
    """Phase 19: the grm main path, cell grm-8192x65536."""
    cli, G, plink = port.cli_grm, port.G, port.plink
    n = GRM_SAMPLES
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        geno = synth_genotypes(np.random.default_rng(seed), GRM_VARIANTS, n)
        t1 = time.perf_counter()
        plink.write_bed(str(tmp / "cell"), geno)
        log(f"grm dataset: {GRM_VARIANTS} variants x {n} samples, "
            f"{(tmp / 'cell.bed').stat().st_size / 1e6:.1f} MB of .bed (made {t1 - t0:.2f} s, "
            f"written {time.perf_counter() - t1:.2f} s)")

        # the timed run: the CLI (read, --maf, H2D, products, D2H, write)
        port.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        timings, out = {}, io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(["--bfile", str(tmp / "cell"), "--maf", str(GRM_MAF), "--make-grm-bin",
                      "--out", str(tmp / "out")], timings=timings)
        total = time.perf_counter() - t0
        launches = port.launches()
        kept_m = timings["variants"]
        flops = 4 * kept_m * n * n  # ZᵀZ and VᵀV, two operations a multiply-add
        e2e = {"variants": GRM_VARIANTS, "kept": kept_m, "samples": n,
               **{k: timings[k] for k in ("read_s", "filter_s", "h2d_s", "products_s", "d2h_s",
                                          "write_s")},
               "total_s": total, "variants_per_s_end_to_end": GRM_VARIANTS / total,
               "products_tflops": flops / timings["products_s"] / 1e12,
               "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
               "kernel_launches": sum(launches.values()), "card": rec.card}
        log("grm-8192x65536 end to end " + json.dumps(e2e))
        lines = out.getvalue().splitlines()
        want = [f"{GRM_VARIANTS} variants, {n} samples loaded",
                f"{GRM_VARIANTS - kept_m} variants removed due to allele frequency threshold(s)"]
        if (lines[:2] != want or len(lines) != 3
                or not lines[2].startswith(f"GRM written to {tmp / 'out'}.grm.bin (")
                or any(launches.values()) or not 0 < kept_m <= GRM_VARIANTS):
            fail(f"grm-8192x65536: {e2e}, printed {lines}")

        # the written matrices: .grm.N.bin's diagonal is V's integer column
        # sums; the first samples' GRM against float64 over every variant
        t0 = time.perf_counter()
        nbin = np.fromfile(tmp / "out.grm.N.bin", "<f4")
        gbin = np.fromfile(tmp / "out.grm.bin", "<f4")
        alt, nonmiss = G.allele_counts(geno)
        kept = G.maf_filter(geno, GRM_MAF, (alt, nonmiss))
        gk = geno if kept.all() else geno[kept]
        freqs = G.allele_freqs(alt[kept], nonmiss[kept])
        ok = 2.0 * freqs * (1.0 - freqs) > G.K_SMALL_EPSILON
        col = np.zeros(n, np.int64)
        for s in range(0, len(gk), 4096):
            col += ((gk[s : s + 4096] != 3) & ok[s : s + 4096, None]).sum(0)
        j = np.arange(n)
        diag_exact = bool(np.array_equal(nbin[j * (j + 1) // 2 + j], col.astype(np.float32)))
        k = GRM_F64_SAMPLES
        sub = gk[:, :k].astype(np.float64)
        dead = (gk[:, :k] == 3) | ~ok[:, None]
        isd = np.where(ok, 1.0 / np.sqrt(np.where(ok, 2.0 * freqs * (1.0 - freqs), 1.0)), 0.0)
        z = np.where(dead, 0.0, (sub - 2.0 * freqs[:, None]) * isd[:, None])
        v = (~dead).astype(np.float64)
        want64 = (z.T @ z) / np.maximum(v.T @ v, 1.0)
        rows, cols = np.tril_indices(k)
        f64_err = float(np.max(np.abs(gbin[rows * (rows + 1) // 2 + cols] - want64[rows, cols])
                               / np.maximum(np.abs(want64[rows, cols]), 1.0)))
        diag = gbin[j * (j + 1) // 2 + j]
        log(f"grm outputs: {len(gbin)} values each, all finite {bool(np.isfinite(gbin).all())}; "
            f"N.bin diagonal = V's column sums {diag_exact}; GRM diagonal mean "
            f"{float(diag.mean()):.6f}; first {k} samples against float64: max rel err "
            f"{f64_err:.3g} ({time.perf_counter() - t0:.1f} s)")
        if (len(gbin) != len(nbin) or len(gbin) != n * (n + 1) // 2 or not diag_exact
                or not np.isfinite(gbin).all() or f64_err > GRM_TOL):
            fail("grm-8192x65536's written matrices")

        # the products in each precision mode on the cell's kept genotypes
        geno_t = torch.from_numpy(gk).to(DEVICE)
        args = [torch.from_numpy(a.astype(np.float32)).to(DEVICE) for a in (2.0 * freqs, isd)]
        ok_t = torch.from_numpy(ok).to(DEVICE)
        modes = {}
        for prec in G.PRECISIONS:
            ms, _ = time_ms(torch, lambda: G.grm_device(geno_t, *args, ok_t, 512, prec), 1)
            modes[prec] = {"ms": ms, "tflops": flops / ms / 1e9}
        del geno_t
        log(f"grm products by precision mode at block 512 (CUDA events, one call each): "
            f"{json.dumps(modes)} ({rec.card})")
    del geno, gk

    # card against CPU in every mode on a cut of the cell: counts exact,
    # the GRM within 2e-5
    cut = synth_genotypes(np.random.default_rng(seed), *GRM_CUT)
    errs = {}
    for prec in G.PRECISIONS:
        card = G.compute_grm(cut, block=512, precision=prec, device=DEVICE)
        cpu = G.compute_grm(cut, block=512, precision=prec, device="cpu")
        errs[prec] = float(np.max(np.abs(card[0] - cpu[0]) / np.maximum(np.abs(cpu[0]), 1.0)))
        if not np.array_equal(card[1], cpu[1]) or errs[prec] > GRM_TOL:
            fail(f"grm {prec}: card and CPU disagree on {GRM_CUT} (grm {errs[prec]})")
    log(f"grm card vs CPU on {GRM_CUT[0]} x {GRM_CUT[1]}: counts exact, GRM max rel err "
        f"{json.dumps(errs)}")

    # the 25 plink2 goldens on the card
    cases = json.loads((HERE / "tests" / "fixtures" / "grm_golden.json").read_text())["cases"]
    good = 0
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        for case in cases:
            files = [Path(tmp) / f"c.{e}" for e in ("pgen", "pvar", "psam")]
            files[0].write_bytes(base64.b64decode(case["pgen"]))
            files[1].write_text(case["pvar"])
            files[2].write_text(case["psam"])
            geno = port.plink.read_pgen(*map(str, files))[0]
            kept = G.maf_filter(geno, case["maf"])
            grm, counts = G.compute_grm(geno[kept], device=DEVICE)
            tril = np.tril_indices(geno.shape[1])
            good += (len(geno) - int(kept.sum()) == case["removed"]
                     and np.array_equal(counts[tril], np.array(case["n_bin"], np.float32))
                     and np.allclose(grm[tril], np.array(case["grm_bin"], np.float32),
                                     atol=GRM_TOL, rtol=GRM_TOL))
    log(f"grm goldens grm_golden.json: {good}/{len(cases)} (N.bin exact, grm.bin 2e-5)")
    if good != len(cases) or not cases:
        fail(f"grm goldens: {good}/{len(cases)}")


def basecall_chunks(n: int) -> int:
    """Chunks models.bonito.chunk_signal cuts n samples into (overlap 0)."""
    return n // BASECALL_CHUNK + 1 if n > BASECALL_CHUNK else 1


def basecall_frames(n: int) -> int:
    """Posterior frames (decode steps) of a read of n samples: every chunk of
    a read longer than one is padded to BASECALL_CHUNK samples."""
    if n <= BASECALL_CHUNK:
        return -(-n // 3)
    return basecall_chunks(n) * -(-BASECALL_CHUNK // 3)


def basecall_phase(torch, port: Port, rec: Record, seed: int):
    """Phase 20: the basecall main path, cell basecall-512."""
    cli, Bm = port.cli_basecall, port.bonito
    (HERE / "build").mkdir(exist_ok=True)
    lengths = np.linspace(*ABEA_LENS, ABEA_READS).astype(int)
    signals = {f"read{r}": sig for r, (_, sig)
               in enumerate(golden_reads(lengths, np.random.default_rng(seed)))}
    samples = sum(len(v) for v in signals.values())
    chunks = sum(basecall_chunks(len(v)) for v in signals.values())
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        npz = Path(tmp) / "reads.npz"
        np.savez(npz, **signals)
        log(f"basecall dataset: abea-512's {len(signals)} reads, {samples} samples, "
            f"{chunks} chunks of {BASECALL_CHUNK}")

        # the timed run: the CLI at bf16, viterbi
        port.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        timings, out, err = {}, io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli.main(["random", str(npz), "--chunksize", str(BASECALL_CHUNK), "--beamsize", "1",
                      "--precision", "bf16"], timings=timings)
        total = time.perf_counter() - t0
        launches = port.launches()
    flops = chunks * bonito_flops(Bm.DNA_R941_BLOCKS, BASECALL_CHUNK)
    e2e = {"reads": timings["reads"], "samples": timings["samples"], "chunks": chunks,
           "load_s": total - timings["duration_s"],
           **{k: timings.get(k, 0.0) for k in ("normalise_s", "forward_s", "decode_s")},
           "duration_s": timings["duration_s"],
           "samples_per_s": timings["samples"] / timings["duration_s"],
           "samples_per_s_end_to_end": timings["samples"] / total,
           "forward_tflops": flops / timings["forward_s"] / 1e12,
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
           "kernel_launches": sum(launches.values()), "card": rec.card}
    log("basecall-512 end to end " + json.dumps(e2e))
    log("basecall CLI stderr: " + " | ".join(err.getvalue().splitlines()))
    called = {}
    for rec_text in out.getvalue().split(">")[1:]:
        name, seq = rec_text.rstrip("\n").split("\n")
        called[name] = seq
    if (list(called) != list(signals) or any(launches.values())
            or not all(seq and set(seq) <= set("ACGT") for seq in called.values())
            or f"> completed reads: {ABEA_READS}" not in err.getvalue()):
        fail(f"basecall-512: {e2e}, {len(called)} records")

    # bonito_golden.npz at f32 on the card (fails if TF32 leaks in)
    data = np.load(HERE / "tests" / "fixtures" / "bonito_golden.npz")
    model = Bm.load_reference_state(Bm.BonitoModel(), bonito_weight_arrays(
        json.loads(str(data["names"])))).to(DEVICE)
    with torch.no_grad():
        got = model(torch.from_numpy(data["input"]).to(DEVICE)).cpu().numpy()
    golden_err = float(np.max(np.abs(got - data["logits"])))
    log(f"bonito golden on the card at f32: max abs err {golden_err:.3g} "
        f"(atol {BASECALL_TOL}, rtol 1e-3)")
    if not np.allclose(got, data["logits"], atol=BASECALL_TOL, rtol=1e-3):
        fail(f"bonito golden on the card: {golden_err}")

    # bf16 against f32 frame labels on the first reads; card f32 against CPU f32
    t0 = time.perf_counter()
    models = {(dev, str(dt)): cli.load_model("random", dt, device=dev)
              for dev, dt in ((DEVICE, torch.bfloat16), (DEVICE, torch.float32),
                              ("cpu", torch.float32))}

    def posteriors(key, raw):
        x = torch.from_numpy(Bm.chunk_signal(Bm.norm_by_noisiest_section(raw), BASECALL_CHUNK,
                                             0)[:, None, :])
        with torch.no_grad():
            return Bm.stitch(models[key](x.to(key[0])), 0).cpu()

    same_frames = frames = same_reads = same_cli = 0
    cpu_err = 0.0
    for i, name in enumerate(list(signals)[:BASECALL_F32_READS]):
        lb = posteriors((DEVICE, "torch.bfloat16"), signals[name])
        lf = posteriors((DEVICE, "torch.float32"), signals[name])
        same_frames += int((lb.argmax(-1) == lf.argmax(-1)).sum())
        frames += len(lb)
        same_reads += Bm.viterbi_decode(lf) == called[name]
        same_cli += Bm.viterbi_decode(lb) == called[name]
        if i < BASECALL_CPU_READS:
            cpu_err = max(cpu_err, max_abs_diff(torch, lf, posteriors(("cpu", "torch.float32"),
                                                                      signals[name])))
    log(f"basecall bf16 vs f32 on the first {BASECALL_F32_READS} reads: "
        f"{same_frames / frames:.6f} of {frames} frame labels equal, {same_reads} reads called "
        f"identically ({same_cli} bf16 reads equal the CLI's); card f32 vs CPU f32 on "
        f"{BASECALL_CPU_READS} reads: max abs err {cpu_err:.3g} (tolerance {BASECALL_TOL}) "
        f"({time.perf_counter() - t0:.1f} s)")
    if cpu_err > BASECALL_TOL:
        fail(f"basecall: card and CPU f32 log-probs differ by {cpu_err}")

    # the beam: the shortest reads at the default --beamsize 5 on the card's posteriors
    beam_t, beam = {}, []
    for name in list(signals)[:BASECALL_BEAM_READS]:
        beam.append(cli.call_read(models[DEVICE, "torch.bfloat16"], signals[name],
                                  BASECALL_CHUNK, 0, 5, beam_t))
    steps = sum(basecall_frames(len(signals[k])) for k in list(signals)[:BASECALL_BEAM_READS])
    log(f"basecall beam (--beamsize 5) on {BASECALL_BEAM_READS} reads: host {beam_t['beam_s']:.3f} "
        f"s for ~{steps} steps ({beam_t['beam_s'] / steps * 1e3:.3f} ms a step); forward "
        f"{beam_t['forward_s']:.3f} s; bases {[len(b) for b in beam]}")
    if not all(b and set(b) <= set("ACGT") for b in beam):
        fail("basecall: the beam called no bases")


def clair_flops() -> int:
    """2 x the multiply-adds of one pileup tensor through ClairModel."""
    u, t = 128, 33
    lstm = sum(2 * t * 4 * u * (n_in + u) * 2 for n_in in (32, 2 * u))
    return lstm + 2 * (2 * u * t * 30 + 30 * 2 * u * 192 + 4 * 192 * 96 + 96 * (21 + 3 + 33 + 33))


def clair_phase(torch, port: Port, rec: Record, seed: int):
    """Phase 21: the call_var main path, cell clair-131072."""
    cli, C = port.cli_call_var, port.clair
    (HERE / "build").mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    n = CLAIR_BATCHES * CLAIR_BATCH
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        batches = {f"X{i}": rng.poisson(CLAIR_LAMBDA, (CLAIR_BATCH, C.POSITIONS, C.MATRIX_ROW,
                                                       C.MATRIX_NUM)).astype(np.float32)
                   for i in range(CLAIR_BATCHES)}
        np.savez(tmp / "tensors.npz", **batches)
        log(f"clair dataset: {CLAIR_BATCHES} batches of {CLAIR_BATCH} tensors "
            f"[{C.POSITIONS}, {C.MATRIX_ROW}, {C.MATRIX_NUM}], Poisson({CLAIR_LAMBDA}) counts, "
            f"{(tmp / 'tensors.npz').stat().st_size / 1e6:.1f} MB ({time.perf_counter() - t0:.1f} s)")

        # the timed run: the CLI with seeded weights
        port.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        timings, out = {}, io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(["--input_fn", str(tmp / "tensors.npz"), "--output_fn",
                      str(tmp / "pred.npz")], timings=timings)
        total = time.perf_counter() - t0
        launches = port.launches()
        e2e = {"tensors": timings["tensors"], "batches": timings["batches"],
               **{k: timings[k] for k in ("load_s", "predict_s", "write_s")}, "total_s": total,
               "tensors_per_s": timings["tensors"] / timings["predict_s"],
               "tensors_per_s_end_to_end": timings["tensors"] / total,
               "predict_tflops": clair_flops() * timings["tensors"] / timings["predict_s"] / 1e12,
               "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
               "kernel_launches": sum(launches.values()), "card": rec.card}
        log("clair-131072 end to end " + json.dumps(e2e))
        pred = dict(np.load(tmp / "pred.npz"))
    lines = out.getvalue().splitlines()
    sums_ok = all(np.allclose(pred[h].sum(-1), 1.0, atol=1e-5) and np.isfinite(pred[h]).all()
                  for h in cli.HEADS)
    if (lines[0] != "Begin predicting..." or not lines[1].startswith("Time taken: ")
            or [pred[h].shape for h in cli.HEADS] != [(n, s) for s in C.HEAD_SIZES]
            or not sums_ok or any(launches.values())):
        fail(f"clair-131072: {e2e}, printed {lines}")

    # clair_golden.npz on the card
    data = np.load(HERE / "tests" / "fixtures" / "clair_golden.npz")
    model = C.ClairModel()
    model.load_state_dict(C.load_tf_variables(clair_variables()))
    model = model.eval().to(DEVICE)
    with torch.no_grad():
        got = [h.cpu().numpy() for h in model(torch.from_numpy(data["input"]).to(DEVICE))]
    names = ("gt21", "genotype", "indel1", "indel2")
    golden_err = max(float(np.max(np.abs(g - data[k]))) for g, k in zip(got, names))
    log(f"clair golden on the card: max abs err {golden_err:.3g} (atol {CLAIR_TOL}, rtol 1e-4)")
    if not all(np.allclose(g, data[k], atol=CLAIR_TOL, rtol=1e-4) for g, k in zip(got, names)):
        fail(f"clair golden on the card: {golden_err}")

    # one batch on the card and the CPU, and against the CLI's output
    t0 = time.perf_counter()
    x = torch.from_numpy(batches["X0"])
    with torch.no_grad():
        card = [h.cpu() for h in cli.load_model(None, DEVICE)(x.to(DEVICE))]
        cpu = cli.load_model(None, "cpu")(x)
    err = max(max_abs_diff(torch, a, b) for a, b in zip(card, cpu))
    cli_err = max(float(np.max(np.abs(a.numpy() - pred[h][:CLAIR_BATCH])))
                  for a, h in zip(card, cli.HEADS))
    log(f"clair card vs CPU on one batch of {CLAIR_BATCH}: max abs err {err:.3g} (tolerance "
        f"{CLAIR_TOL}); against the CLI's X0 rows {cli_err:.3g} ({time.perf_counter() - t0:.1f} s)")
    if err > CLAIR_TOL or cli_err > CLAIR_TOL:
        fail(f"clair: card and CPU disagree ({err}, {cli_err})")


def occ_bound(rows_needed: int, n_idx: int, row_bytes: int):
    """Least time (ms) for a gather fold: the distinct rows (or tiles) its
    indices pick, each read once (row_bytes each), the indices (4 bytes
    each) and its output, over HBM bandwidth; it does one XOR a word, far
    below any operation peak."""
    return ((rows_needed + 1) * row_bytes + 4 * n_idx) / HBM_BYTES_PER_S * 1e3, "bytes"


def occ_phase(torch, port: Port, rec: Record, seed: int):
    """Phase 11, occ-gather-4m and occ-gather-40m: the probe tool on its
    workload (the counted path), then the kernels against their plain
    versions and timed on the tool's indices and at 16,777,216 indices on
    the same table, then at 16,777,216 indices on a table of 40,000,000
    rows (2.56 GB, 51x the L2: its fetch floor is clean of L2 hits)."""
    tool = port.occ_tool
    t0 = time.perf_counter()
    table_np, idx_np = tool.make_workload()
    log(f"occ-gather-4m: table {table_np.shape[0]} rows x 64 B ({table_np.nbytes / 1e6:.0f} MB), "
        f"{len(idx_np)} indices, made in {time.perf_counter() - t0:.1f} s")

    # the tool's run is this path: counts to 0 just before, read just after
    port.reset_launches()
    torch.cuda.synchronize()
    res = tool.run(table_np, idx_np, DEVICE)
    launches = port.launches()
    log("occ-gather-4m tool " + json.dumps({**res, "launches": launches}))
    rec.launched(launches, ("occ_gather_row", "occ_gather_tile"))
    wrong = [k for k, v in res.items() if k.endswith("_correct") and not v]
    if wrong:
        fail(f"occ_gather_experiment: {wrong} differ from numpy")

    table4m = torch.from_numpy(table_np).to(DEVICE)
    rate_idx = np.random.default_rng(seed).integers(0, len(table_np), OCC_RATE_IDX).astype(np.int32)
    occ_table_rates(torch, port, rec, "occ-gather-4m", table4m, idx_np, extras=True)
    occ_table_rates(torch, port, rec, "occ-gather-4m", table4m, rate_idx, extras=True)
    del table4m

    # occ-gather-40m: 51x the L2, made on the card from --seed
    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    table = torch.randint(-(1 << 62), 1 << 62, (OCC_BIG_ROWS, 8), generator=g, device=DEVICE,
                          dtype=torch.int64)
    idx = torch.randint(0, OCC_BIG_ROWS, (OCC_RATE_IDX,), generator=g, device=DEVICE,
                        dtype=torch.int32)
    torch.cuda.synchronize()
    log(f"occ-gather-40m: table {OCC_BIG_ROWS} rows x 64 B ({OCC_BIG_ROWS * 64 / 1e9:.2f} GB), "
        f"{OCC_RATE_IDX} indices, made on the card in {time.perf_counter() - t0:.1f} s")
    occ_table_rates(torch, port, rec, "occ-gather-40m", table, idx.cpu().numpy())
    del table, idx
    torch.cuda.empty_cache()


def occ_table_rates(torch, port: Port, rec: Record, cell: str, table, idx_host, extras=False):
    """The gather kernels against their plain versions on `table` and the
    indices `idx_host`, bit for bit, with times (single calls and the mean
    of PROBE_CHAIN in a row), MB/s, Mrows/s, the bound by distinct bytes and
    the fetch floor (every pick read once at the peak rate), and the library
    gathers (`index_select` of the picked rows or tiles; `extras`: also of
    32- and 128-byte rows).  At OCC_RATE_IDX indices the numbers go into the
    kernels line: occ-gather-4m's as the kernel's own, occ-gather-40m's
    under "occ_gather_40m"."""
    G = port.occ_gather
    idx = torch.from_numpy(idx_host).to(DEVICE)
    tiles = table.view(-1, 64)
    n = idx.numel()
    label = f"{cell}, {n:,} indices"
    lib_ms = {64: time_ms(torch, lambda: table.index_select(0, idx), 5)[0],
              512: time_ms(torch, lambda: tiles.index_select(0, idx >> 3), 5)[0]}
    distinct = {64: len(np.unique(idx_host)), 512: len(np.unique(idx_host >> 3))}
    row = {"cell": cell, "indices": n, "distinct_rows": distinct[64],
           "distinct_tiles": distinct[512], "library_index_select_ms": lib_ms[64],
           "library_tile_select_ms": lib_ms[512]}
    if extras:
        for width, tb in ((32, table[:, :4].contiguous()), (128, torch.cat([table, table], 1))):
            ms, _ = time_ms(torch, lambda: tb.index_select(0, idx), 5)
            row[f"index_select{width}_ms"] = ms
            row[f"index_select{width}_mb_s"] = n * width / (ms * 1e-3) / 1e6
    for key, name, fn, plain, width in (
            ("row2", "occ_gather_row", lambda: G.occ_gather_row(table, idx, 2),
             lambda: G.occ_gather_row_plain(table, idx), 64),
            ("row8", "occ_gather_row", lambda: G.occ_gather_row(table, idx, 8),
             lambda: G.occ_gather_row_plain(table, idx), 64),
            ("tile8", "occ_gather_tile", lambda: G.occ_gather_tile(table, idx),
             lambda: G.occ_gather_tile_plain(table, idx), 512)):
        fn()  # warm-up
        ms, got = time_ms(torch, fn, 5)
        chain_ms, _ = probe_ms(torch, port, fn, 5)
        plain_ms, want = time_ms(torch, plain, 1)
        rec.check(name, max_abs_diff(torch, got, want), f"{label} ({key})")
        bms, by = occ_bound(distinct[width], n, width)
        floor_ms = occ_bound(n, n, width)[0]  # every pick fetched once at the peak rate
        row[key] = {"ms": ms, "ms_in_a_row": chain_ms, "plain_ms": plain_ms,
                    "mb_s": n * width / (chain_ms * 1e-3) / 1e6,
                    "mrows_s": n / (chain_ms * 1e-3) / 1e6, "ns_per_index": chain_ms * 1e6 / n,
                    "bound_ms": bms, "bound_by": by, "bound_share": bms / chain_ms,
                    "fetch_floor_ms": floor_ms, "fetch_floor_share": floor_ms / chain_ms}
        # the kernels line: the row kernel at its default 8 in flight
        if n == OCC_RATE_IDX and key != "row2":
            mine = {"ms": chain_ms, "ms_single_call": ms, "plain_ms": plain_ms, "bound_ms": bms,
                    "bound_by": by, "fetch_floor_ms": floor_ms, "library_ms": lib_ms[width]}
            if cell == "occ-gather-4m":
                rec.kern[name].update(mine)
            else:
                rec.kern[name]["occ_gather_40m"] = mine
    log(f"occ-gather kernels vs plain, {label} " + json.dumps(row))


def fnv64(h: int, data: bytes) -> int:
    for byte in data:
        h ^= byte
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def fmi_index_hashes(idx):
    """FNV-64 of the CP_OCC records and of sa_ms_byte then sa_ls_word, as
    the reference's golden harness hashes them (tests/test_fmi_golden.py)."""
    hcp = fnv64(14695981039346656037, np.ascontiguousarray(idx.cp_occ).tobytes())
    hsa = fnv64(14695981039346656037, idx.sa_ms_byte.tobytes())
    return f"{hcp:016x}", f"{fnv64(hsa, idx.sa_ls_word.tobytes()):016x}"


def smem_tuples(allm):
    return list(zip(*(allm[k].tolist() for k in ("rid", "m", "n", "k", "l", "s"))))


def fmi_phase(torch, port: Port, rec: Record, seed: int):
    """Phase 12, fmi-256m-2048: the index built on the card, then the fmi
    CLI's prepare and three runs of its search, and the checks."""
    cli_fmi, FP, G = port.cli_fmi, port.fmi_pipeline, port.occ_gather
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    codes = synth_reference_codes(FMI_MBP, np.random.default_rng(seed))
    enc_np = synth_reads(codes, FMI_READS, FMI_READ_LEN, np.random.default_rng(seed + 1))
    gen_s = time.perf_counter() - t0

    # set-up: the index, built on the card
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    didx = port.fmi_builder.build_arrays(codes, sa_compression=True, device=DEVICE)
    build_s = time.perf_counter() - t0
    log("fmi-256m-2048 index " + json.dumps(
        {"bases": len(codes), "text_chars": didx.ref_seq_len, "blocks": didx.cp_occ.shape[0],
         "cp_occ_mb": didx.cp_occ.nbytes / 1e6, "generate_s": gen_s, "build_s": build_s,
         "build_peak_gb": torch.cuda.max_memory_allocated() / 1e9}))
    del codes
    torch.cuda.empty_cache()

    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        fq = Path(tmp) / "reads.fq"
        write_fastq(fq, enc_np)

        # the main path: counts to 0 just before, read just after
        port.reset_launches()
        torch.cuda.synchronize()
        pstats: dict = {}
        prep = cli_fmi.prepare(didx, str(fq), DEVICE, stats=pstats)
        runs_s, run_stats, results = [], [], None
        for _ in range(3):
            st: dict = {}
            t0 = time.perf_counter()
            got = cli_fmi.run(prep.index, prep.enc, prep.rl, FMI_BATCH, FMI_MIN_SEED, stats=st)
            runs_s.append(time.perf_counter() - t0)
            run_stats.append(st)
            if results is None:
                results, launches = got, port.launches()
            elif any(smem_tuples(a[0]) != smem_tuples(b[0]) or a[1:] != b[1:]
                     for a, b in zip(got, results)):
                fail("a second run of the fmi main path gave other results")
        if not np.array_equal(prep.enc, enc_np):
            fail("the fmi CLI's prepare encoded other reads than were written")
        med = int(np.argsort(runs_s)[1])
        st = run_stats[med]
        n_phase = [sum(r[i] for r in results) for i in (1, 2, 3)]
        steps = {k: st[k] for k in ("steps1", "steps2", "steps3")}
        total_s = pstats["load_s"] + pstats["encode_s"] + runs_s[med]
        e2e = {"reads": len(prep.rl), "bases": int(prep.rl.sum()), "batches": len(results),
               **pstats, "search_s": st["search_s"], "d2h_unpack_sort_s": st["collect_s"],
               "run_s_all": runs_s, "run_s_median": runs_s[med], "total_s": total_s,
               "reads_per_s_end_to_end": len(prep.rl) / total_s,
               "reads_per_s_search": len(prep.rl) / st["search_s"],
               "smems_phase1": n_phase[0], "smems_phase2": n_phase[1],
               "smems_phase3": n_phase[2], "smems_total": sum(n_phase),
               "overflow_batches": sum(bool(r[4]) for r in results),
               "lockstep_steps": steps, "host_syncs": sum(steps.values()),
               "ms_per_step": st["search_s"] * 1e3 / sum(steps.values()),
               "occ_rows": st["occ_rows"], "launches": launches}
        if not all(n > 0 for n in n_phase) or e2e["overflow_batches"]:
            fail(f"fmi main path: SMEMs per phase {n_phase}, overflow in "
                 f"{e2e['overflow_batches']} batches")

        # the gather bound: the rows this run gathered at the row kernel's
        # rate on this table (random rows, 8 in flight)
        table = prep.index["cp_occ"]
        idx = torch.from_numpy(np.random.default_rng(seed).integers(
            0, table.shape[0], OCC_RATE_IDX).astype(np.int32)).to(DEVICE)
        G.occ_gather_row(table, idx)
        ms, got = time_ms(torch, lambda: G.occ_gather_row(table, idx), 5)
        rec.check("occ_gather_row", max_abs_diff(torch, got, G.occ_gather_row_plain(table, idx)),
                  "fmi-256m-2048's cp_occ")
        ns_row = ms * 1e6 / OCC_RATE_IDX
        e2e.update(gather_ns_per_row=ns_row, gather_bound_s=st["occ_rows"] * ns_row * 1e-9,
                   search_over_gather_bound=st["search_s"] / (st["occ_rows"] * ns_row * 1e-9))
        log("fmi-256m-2048 end to end " + json.dumps(e2e))

        # one batch under the profiler: its trace of the whole run holds
        # ~400k device events, whose post-processing takes minutes
        t0 = time.perf_counter()
        prof = device_profile(torch, lambda: cli_fmi.run(prep.index, prep.enc[:FMI_BATCH],
                                                         prep.rl[:FMI_BATCH], FMI_BATCH,
                                                         FMI_MIN_SEED))
        log("fmi profile, batch 0 " + json.dumps({**prof, "profile_s": time.perf_counter() - t0}))

        # the CLI's --print-output dump for the first reads equals the pooled results
        t0 = time.perf_counter()
        npz, head = Path(tmp) / "index.npz", Path(tmp) / "head.fq"
        hi, lo = port.fmi_index.split_one_hot(didx.cp_occ)
        np.savez(npz, ref_seq_len=didx.ref_seq_len, count=didx.count,
                 sentinel_index=didx.sentinel_index, cp_count=didx.cp_count, one_hot_hi=hi,
                 one_hot_lo=lo)
        write_fastq(head, enc_np[:FMI_CLI_READS])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_fmi.main([str(npz), str(head), str(FMI_BATCH), str(FMI_MIN_SEED),
                               "--print-output"])
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("[") or (ln.endswith(":") and ln[:-1].isdigit())]
        first = {k: v[results[0][0]["rid"] < FMI_CLI_READS] for k, v in results[0][0].items()}
        want = io.StringIO()
        cli_fmi.print_output([(first,)], want)
        if rc != 0 or lines != want.getvalue().splitlines():
            fail(f"fmi CLI dump differs from the pooled results (rc {rc}, {len(lines)} lines)")
        log(f"fmi CLI: the --print-output dump of the first {FMI_CLI_READS} reads "
            f"({len(lines)} lines) equals the pooled results ({time.perf_counter() - t0:.1f} s)")

    # batch 0 through the port on the CPU: the same dump, exactly
    t0 = time.perf_counter()
    cpu = FP.fmi_pipeline_batch(port.fmi_index_from_numpy(didx, "cpu"), prep.enc[:FMI_BATCH],
                                prep.rl[:FMI_BATCH], min_seed_len=FMI_MIN_SEED)
    if cpu[1:] != results[0][1:] or smem_tuples(cpu[0]) != smem_tuples(results[0][0]):
        fail("fmi batch 0 on the card differs from the same batch on the CPU")
    log(f"fmi batch 0: the card's {len(cpu[0]['m'])} SMEMs equal the CPU's "
        f"({time.perf_counter() - t0:.1f} s)")

    # the first reads against the port's oracle over the same index
    t0 = time.perf_counter()
    view = port.fmi_oracle.oracle_view(didx)
    want, *_ = port.fmi_oracle.fmi_pipeline(
        view, [prep.enc[i, : prep.rl[i]].astype(np.int32) for i in range(FMI_ORACLE_READS)],
        min_seed_len=FMI_MIN_SEED)
    have = [t for t in smem_tuples(results[0][0]) if t[0] < FMI_ORACLE_READS]
    if have != [tuple(w[k] for k in ("rid", "m", "n", "k", "l", "s")) for w in want] or not want:
        fail("fmi results differ from the oracle")
    log(f"fmi oracle sample: {FMI_ORACLE_READS}/{FMI_ORACLE_READS} reads exact, {len(want)} "
        f"SMEMs ({time.perf_counter() - t0:.1f} s)")

    # the reference goldens: the index built and searched on the card
    cases = json.loads((HERE / "tests" / "fixtures" / "fmi_golden.json").read_text())["cases"]
    t0 = time.perf_counter()
    good = 0
    for case in cases:
        gidx = port.fmi_builder.build_arrays(port.encode_reads([case["seq"]])[0][0],
                                             sa_compression=True, device=DEVICE)
        index = port.fmi_index_from_numpy(gidx, DEVICE)
        reads, batch = case["reads"], case["batch"]
        counts, got, ovf = [], [], False
        for start in range(0, len(reads), batch):
            enc, rl = port.encode_reads(reads[start : start + batch])
            out, n1, n2, n3, o = FP.fmi_pipeline_batch(index, enc, rl,
                                                       min_seed_len=case["min_seed_len"],
                                                       rid_base=start)
            counts.append([n1, n2, n3])
            got.extend(smem_tuples(out))
            ovf |= o
        wanted = [tuple(w) for w in case["smems"]]
        good += (gidx.count.tolist() == case["count"]
                 and gidx.sentinel_index == case["sentinel_index"]
                 and fmi_index_hashes(gidx) == (case["hash_cp"], case["hash_sa"])
                 and counts == case["batch_counts"] and not ovf
                 and [g[:3] for g in got] == [w[:3] for w in wanted]
                 and sorted(got) == sorted(wanted))
    log(f"fmi goldens fmi_golden.json: {good}/{len(cases)} exact (index hashes, batch counts, "
        f"SMEM dumps; {time.perf_counter() - t0:.1f} s)")
    if good != len(cases):
        fail(f"fmi goldens: {good}/{len(cases)}")


def strip_bound(qe_pad: int, tp: int, b: int):
    """Least time (ms) for the stripped recurrence: the larger of the bytes
    it must move (query codes, target codes, the H/E start in and the
    final H/E out, 4 bytes each) over HBM bandwidth and its int32
    instructions (STRIP_OPS_PER_CELL a cell of qe_pad x tp) over the
    int32 issue rate."""
    t_bytes = 4 * (qe_pad * b + tp * b + 4 * qe_pad * b) / HBM_BYTES_PER_S
    t_ops = STRIP_OPS_PER_CELL * qe_pad * tp * b / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def micro_bound(b: int, n_pad: int, w: int):
    """Least time (ms) for the micro recurrence: the larger of the bytes it
    must move (x, q and qspan in and the score out, 4 bytes each an anchor;
    8 a call) over HBM bandwidth and its int32 operations
    (MICRO_OPS_PER_VISIT a visited predecessor, w an anchor) over the
    int32 issue rate."""
    t_bytes = (16 * b * n_pad + 8 * b) / HBM_BYTES_PER_S
    t_ops = MICRO_OPS_PER_VISIT * b * n_pad * w / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def probe_ms(torch, port: Port, fn, reps: int):
    """(ms, the last result): the best of `reps` means of PROBE_CHAIN calls
    in a row after `tools.warm_up` (CUDA events).  A single call's events
    also take in the host's launch gap, tens of us against the redesigned
    probes' fraction of a millisecond."""
    secs, out = port.tools.time_calls(fn, torch.device(DEVICE), PROBE_CHAIN, reps)
    return secs * 1e3, out


def bsw_roofline_phase(torch, port: Port, rec: Record, seed: int):
    """Phase 13, bsw-roofline-8192: the probe tool on its workload (the
    counted path), then the stripped kernel against its plain version from
    two starts, and the cells each side computes."""
    S, W, tool = port.bsw_stripped, port.W, port.bsw_probe
    port.reset_launches()
    torch.cuda.synchronize()
    with port.tools.SmClock() as clock:
        res = tool.run(DEVICE)
        launches = port.launches()
    log("bsw-roofline-8192 tool " + json.dumps({**res, "launches": launches,
                                                "clock_min_median_max": clock.summary()}))
    mhz = clock.summary()["sm_mhz"][1] if clock.rows else None
    if mhz:
        rec.sm_mhz.append(mhz)
    rec.launched(launches, ("bsw_stripped",))
    if launches["bsw_extend"] <= 0:
        fail("bsw_roofline: the prod side did not launch bsw_extend")

    t0 = time.perf_counter()
    pairs, q_np, t_np = tool.make_workload()
    q, t = torch.from_numpy(q_np).to(DEVICE), torch.from_numpy(t_np).to(DEVICE)
    (qe, b), tp = q.shape, t.shape[0]
    rng = np.random.default_rng(seed)
    starts = {"zero": (torch.zeros_like(q), torch.zeros_like(q)),
              "seeded": tuple(torch.from_numpy(rng.integers(0, hi + 1, (qe, b)).astype(np.int32))
                              .to(DEVICE) for hi in (60, 30))}
    row = {"pairs": b, "qlen": res["qlen"], "tlen": res["tlen"], "qe_pad": qe}
    where = {"zero": "zero start, the tool's own input: H and E stay all zero",
             "seeded": "seeded start, the whole final H and E"}
    for name, (h, e) in starts.items():
        ms, got = probe_ms(torch, port, lambda: S.bsw_stripped(q, t, h, e), 5)
        single_ms, _ = time_ms(torch, lambda: S.bsw_stripped(q, t, h, e), 5)
        plain_ms, want = time_ms(torch, lambda: S.bsw_stripped_plain(q, t, h, e), 1)
        rec.check("bsw_stripped", max_abs_diff(torch, got, want),
                  f"bsw-roofline-8192 ({where[name]})")
        row[f"strip_{name}_ms"] = ms
        row[f"strip_{name}_single_call_ms"] = single_ms
        row[f"plain_{name}_ms"] = plain_ms
        row[f"nonzero_{name}"] = int((got != 0).sum())
    # from H = E = 0 the recurrence never leaves 0, so only the seeded start
    # can tell a wrong kernel from a right one: it gives the kernels line
    if row["nonzero_zero"]:
        fail(f"bsw_roofline: the zero start left {row['nonzero_zero']} nonzero values")
    if not row["nonzero_seeded"]:
        fail("bsw_roofline: the seeded start left H and E all zero")
    strip_ms = row["strip_seeded_ms"]
    row["tool_strip_over_phase"] = res["strip_ms"] / row["strip_zero_ms"]
    row["tool_strip_over_single_call"] = res["strip_ms"] / row["strip_zero_single_call_ms"]
    bms, by = strip_bound(qe, tp, b)

    # the prod side: ksw_extend's band cells, counted by the plain version,
    # whose outputs the kernel's equal
    batch, params = port.bsw_batch_from_numpy(W.prepare_pairs(pairs, q_pad=res["qlen"],
                                                               t_pad=res["tlen"]), DEVICE)
    prod_ms, prod = probe_ms(torch, port,
                             lambda: W.bsw_extend(batch, params, q_max=res["qlen"]), 5)
    prod_single_ms, _ = time_ms(torch, lambda: W.bsw_extend(batch, params, q_max=res["qlen"]), 5)
    st = {}
    rec.check("bsw_extend", max_abs_diff(torch, prod, W.bsw_extend_plain(batch, params, stats=st)),
              "bsw-roofline-8192 (prod side)")
    strip_cells = qe * tp * b
    row["tool_prod_over_phase"] = res["prod_ms"] / prod_ms
    row["tool_prod_over_single_call"] = res["prod_ms"] / prod_single_ms
    row.update(strip_cells=strip_cells, prod_band_cells=st["cells"],
               tool_cells=b * res["qlen"] * res["tlen"], prod_ms=prod_ms,
               prod_single_call_ms=prod_single_ms,
               prod_over_strip_single_call=prod_single_ms / row["strip_seeded_single_call_ms"],
               strip_ns_per_cell=strip_ms * 1e6 / strip_cells,
               prod_ns_per_band_cell=prod_ms * 1e6 / st["cells"],
               strip_gcups_all_cells=strip_cells / (strip_ms * 1e-3) / 1e9,
               prod_gcups_band_cells=st["cells"] / (prod_ms * 1e-3) / 1e9,
               prod_over_strip=prod_ms / strip_ms, bound_ms=bms, bound_by=by,
               bound_share=bms / strip_ms)
    # the slots each layout computes: the stripped kernel's L lanes of K rows
    # on every target row; bsw_extend's lanes of K entries on every row a
    # warp steps (until the last of its pairs stops)
    _, lanes, k = S.layout(qe)
    _, p_lanes, p_k = port.bsw_cuda.layout(res["qlen"])
    per_warp = 32 // p_lanes
    rows = st["pair_rows"]
    warp_rows = np.pad(rows, (0, -len(rows) % per_warp)).reshape(-1, per_warp).max(1)
    strip_slots = lanes * k * tp * b
    prod_slots = int(warp_rows.sum()) * 32 * p_k
    cyc = strip_chain_cycles(lanes, k)
    row.update(strip_lanes=lanes, strip_rows_a_lane=k, strip_padding_share=1 - qe / (lanes * k),
               strip_slots=strip_slots, prod_lanes=p_lanes, prod_entries_a_lane=p_k,
               prod_warp_rows=int(warp_rows.sum()), prod_slots=prod_slots,
               strip_ns_per_slot=strip_ms * 1e6 / strip_slots,
               prod_ns_per_slot=prod_ms * 1e6 / prod_slots,
               prod_over_strip_per_slot=(prod_ms / prod_slots) / (strip_ms / strip_slots),
               sm_mhz=mhz if mhz else "not sampled", strip_chain_cycles_a_row=cyc,
               strip_chain_floor_ms=tp * cyc / (mhz * 1e3) if mhz else "not sampled",
               strip_cycles_a_row=strip_ms * mhz * 1e3 / tp if mhz else "not sampled",
               seconds=time.perf_counter() - t0)
    log("bsw-roofline-8192 kernels vs plain " + json.dumps(row))
    rec.kern["bsw_stripped"].update(ms=strip_ms, plain_ms=row["plain_seeded_ms"],
                                    bound_ms=bms, bound_by=by, library_ms=None)

    # the edge instances, after the timed checks: every start, bit for bit
    t0 = time.perf_counter()
    for qe_pad in STRIP_EDGE_QE:
        q, t, h, e = (torch.from_numpy(a).to(DEVICE) for a in
                      strip_edge_batch(rng, qe_pad, 256, 512))
        got = S.bsw_stripped(q, t, h, e)
        rec.check("bsw_stripped", max_abs_diff(torch, got, S.bsw_stripped_plain(q, t, h, e)),
                  f"edge instance qe_pad {qe_pad} (zero, seeded, INT32_MAX, H near INT32_MAX)")
        if got[:, :, :512].any() or not got[:, :, 512:].any():
            fail(f"bsw_stripped edge qe_pad {qe_pad}: the zero start moved or the rest stayed 0")
    log("bsw-roofline edge instances " + json.dumps(
        {"qe_pad": STRIP_EDGE_QE, "pairs": 4 * 512, "target_rows": 256, "equal_to_plain": True,
         "seconds": time.perf_counter() - t0}))


def chain_roofline_phase(torch, port: Port, rec: Record):
    """Phase 14, chain-roofline-128x4096: the probe tool on its workload (the
    counted path, rng seed 0), then the micro kernel against its plain
    version, and the prod side timed, held to the plain chain version and
    its visits counted."""
    M, C, tool = port.chain_micro, port.C, port.chain_probe
    w, bw = 64, 500
    port.reset_launches()
    torch.cuda.synchronize()
    with port.tools.SmClock() as clock:
        res = tool.run(DEVICE, w=w, bw=bw)
        launches = port.launches()
    log("chain-roofline-128x4096 tool " + json.dumps({**res, "launches": launches,
                                                      "clock_min_median_max": clock.summary()}))
    mhz = clock.summary()["sm_mhz"][1] if clock.rows else None
    if mhz:
        rec.sm_mhz.append(mhz)
    rec.launched(launches, ("chain_micro",))
    if launches["chain_dp"] <= 0:
        fail("chain_roofline: the prod side did not launch chain_dp")

    t0 = time.perf_counter()
    wl = tool.make_workload()
    b, n = wl["x"].shape
    args = [torch.from_numpy(wl[k]).to(DEVICE) for k in ("x", "qi", "qspan", "m_fp", "gap0")]
    ms, got = probe_ms(torch, port, lambda: M.chain_micro(*args, w, bw), 5)
    single_ms, _ = time_ms(torch, lambda: M.chain_micro(*args, w, bw), 5)
    plain_ms, want = time_ms(torch, lambda: M.chain_micro_plain(*args, w, bw), 1)
    rec.check("chain_micro", max_abs_diff(torch, got, want), "chain-roofline-128x4096 (whole output)")
    if int(got.max()) <= 15:
        fail("chain_roofline: no anchor chained")
    bms, by = micro_bound(b, n, w)

    batch, params = tool.prod_batch(wl, w, bw, DEVICE)
    prod_ms, prod = probe_ms(torch, port, lambda: C.chain_dp(batch, params), 3)
    prod_single_ms, _ = time_ms(torch, lambda: C.chain_dp(batch, params), 3)
    st = {}
    rec.check("chain_dp", max_abs_diff(torch, prod, C.chain_dp_plain(batch, params, st)),
              "chain-roofline-128x4096 (prod side)")
    micro_visits = b * n * w
    row = {"calls": b, "anchors": n, "w": w, "bw": bw, "micro_ms": ms, "plain_ms": plain_ms,
           "prod_ms": prod_ms, "micro_visits": micro_visits,
           "prod_visits": st["predecessors"], "prod_scoring_visits": st["eligible"],
           "prod_breaks": st["breaks"], "micro_ns_per_visit": ms * 1e6 / micro_visits,
           "prod_ns_per_visit": prod_ms * 1e6 / st["predecessors"],
           "prod_over_micro": prod_ms / ms, "micro_single_call_ms": single_ms,
           "prod_single_call_ms": prod_single_ms,
           "prod_over_micro_single_call": prod_single_ms / single_ms,
           "bound_ms": bms, "bound_by": by,
           "bound_share": bms / ms, "score_max": int(got.max())}
    # a call's anchors are one chain on each side: ns and cycles an anchor
    row.update(micro_ns_per_anchor=ms * 1e6 / n, prod_ns_per_anchor=prod_ms * 1e6 / n,
               sm_mhz=mhz if mhz else "not sampled",
               micro_cycles_per_anchor=ms * mhz * 1e3 / n if mhz else "not sampled",
               prod_cycles_per_anchor=prod_ms * mhz * 1e3 / n if mhz else "not sampled",
               micro_chain_cycles_an_anchor=MICRO_CHAIN_CYCLES,
               micro_chain_floor_ms=n * MICRO_CHAIN_CYCLES / (mhz * 1e3) if mhz else "not sampled",
               seconds=time.perf_counter() - t0)
    log("chain-roofline-128x4096 kernels vs plain " + json.dumps(row))
    rec.kern["chain_micro"].update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                                   library_ms=None)

    # the edge windows, after the timed checks
    t0 = time.perf_counter()
    calls = [torch.from_numpy(a).to(DEVICE) for a in
             micro_edge_calls(np.random.default_rng(7), 64, 1500)]
    for w_e in MICRO_EDGE_W:
        got = M.chain_micro(*calls, w_e, bw)
        rec.check("chain_micro", max_abs_diff(torch, got, M.chain_micro_plain(*calls, w_e, bw)),
                  f"edge window w {w_e} (phantom predecessors, wrapping slopes)")
        if int(got.max()) <= 30:
            fail(f"chain_micro edge window w {w_e}: no anchor chained")
    log("chain-roofline edge windows " + json.dumps(
        {"w": MICRO_EDGE_W, "calls": 64, "anchors": 1500, "equal_to_plain": True,
         "seconds": time.perf_counter() - t0}))


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

    # 2. build: one nvcc per source (with its wrapper's defines), all
    # started together
    builds = list(dict.fromkeys((k.source, k.defines) for k in port.kernels))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as ex:
        lib_paths = list(ex.map(lambda b: port.build.build(*b), builds))
    for src, defines in builds:
        port.build.load(src, defines)
    log(f"build {', '.join(p.name for p in lib_paths)}: {time.perf_counter() - t0:.2f} s")
    for lib_path in lib_paths:
        for ln in lib_path.with_suffix(".log").read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  ptxas {lib_path.name}: {ln.strip()}")

    rec = Record(port.launches())
    rec.card = smi
    # the fmi engine is launch-bound, and every launch after a torch.profiler
    # trace costs more (PERF.md §6): phases 11-12 run before any profile
    occ_phase(torch, port, rec, args.seed)
    fmi_phase(torch, port, rec, args.seed)
    phmm_phases(torch, port, rec, args.seed)
    bsw_phases(torch, port, rec, args.seed)
    chain_phases(torch, port, rec, args.seed)
    abea_phases(torch, port, rec, args.seed)
    eventalign_phase(torch, port, rec, args.seed)
    kmer_phase(torch, port, rec, args.seed)
    poa_phase(torch, port, rec, args.seed)
    grm_phase(torch, port, rec, args.seed)
    basecall_phase(torch, port, rec, args.seed)
    clair_phase(torch, port, rec, args.seed)
    bsw_roofline_phase(torch, port, rec, args.seed)
    chain_roofline_phase(torch, port, rec)
    abea_chain_lines(rec)

    # 15. the kernels line, the card, the last line
    where = {"phmm_forward_f32": (SOURCE, REPLACES), "phmm_forward_f64": (SOURCE, REPLACES),
             "bsw_extend": (BSW_SOURCE, BSW_REPLACES), "chain_dp": (CHAIN_SOURCE, CHAIN_REPLACES),
             "abea_fill": (ABEA_FILL_SOURCE, ABEA_FILL_REPLACES),
             "abea_walk": (ABEA_WALK_SOURCE, ABEA_WALK_REPLACES),
             "occ_gather_row": (OCC_SOURCE, OCC_ROW_REPLACES),
             "occ_gather_tile": (OCC_SOURCE, OCC_TILE_REPLACES),
             "bsw_stripped": (STRIP_SOURCE, STRIP_REPLACES),
             "chain_micro": (MICRO_SOURCE, MICRO_REPLACES)}
    kernels = []
    for name, k in rec.kern.items():
        kernels.append({"name": name, "route": "cuda", "source": where[name][0],
                        "replaces": where[name][1], "launches": k["launches"],
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
                        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                        "library_ms": k.get("library_ms"),
                        # the gathers: every pick fetched once at the peak rate, and
                        # the same numbers on occ-gather-40m
                        **{key: k[key] for key in ("fetch_floor_ms", "occ_gather_40m",
                                                   "main_path_launch_ms", "eventalign_512")
                           if key in k}})
    log("kernel device seconds over one main-path run (torch.profiler) "
        + json.dumps(rec.device_s))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
