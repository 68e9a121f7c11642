"""Run every CLI driver of the port end to end, each in its own process.

    python -m genomicsbench_palisade_tpu_torch.tools.run_suite [--workdir DIR]
        [--skip a,b] [--device cpu] [--jobs 4]

Counterpart of tools/run_suite.py (the L5 layer: the reference's
scripts/run-cpu.sh:26-76 and run-gpu.sh:25-45 run every benchmark with
fixed arguments).  `gen_inputs` writes the JAX tool's tiny inputs from
default_rng(0), byte for byte; each of the 14 benches is then
`python -m genomicsbench_palisade_tpu_torch.cli.<mod> ...` in a process of
its own, held to the JAX tool's output contract.  `--device` goes to every
CLI that has device work (all but dbg and pileup); without it the CLIs run
on the card, and with no GPU this raises.  A fresh process loads the
kernels and the native library that an earlier build left under build/:
each bench's seconds are printed so that a rebuild shows.  `--jobs` runs
that many benches at once (fmi waits for fmi_build's index), each with its
share of the host's cores as torch's threads; a bench past TIMEOUT_S
seconds (a tiny input takes seconds) is killed and counts as a failure.

Prints one OK/FAIL line a bench, in the list's order, and returns 1 on any
failure.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
PKG = "genomicsbench_palisade_tpu_torch"
HOST_ONLY = ("dbg", "pileup")  # CLIs with no --device: host work only
AFTER = {"fmi": "fmi_build"}  # a bench that reads another's output waits for it
TIMEOUT_S = 120.0


def _run(mod, args, env=None):
    return subprocess.run([sys.executable, "-m", f"{PKG}.cli.{mod}"] + args, cwd=REPO,
                          capture_output=True, text=True, timeout=TIMEOUT_S, env=env)


def gen_inputs(d: pathlib.Path):
    """The JAX tool's inputs, byte for byte, from default_rng(0)."""
    rng = np.random.default_rng(0)
    bases = np.array(list("ACGT"))

    genome = "".join(bases[rng.integers(0, 4, 200_000)])
    (d / "ref.fa").write_text(f">chr1\n{genome}\n")

    with open(d / "reads.fq", "w") as f:
        for i in range(300):
            s = int(rng.integers(0, len(genome) - 101))
            f.write(f"@q{i}\n{genome[s:s+101]}\n+\n{'I'*101}\n")

    # phmm testfile
    def qstr(a):
        return "".join(chr(int(x)) for x in a)
    lines = ["3 2"]
    for _ in range(3):
        n = 30
        lines.append("".join(bases[rng.integers(0, 4, n)]))
        for _ in range(4):
            lines.append(qstr(rng.integers(43, 70, n)))
    for _ in range(2):
        lines.append("".join(bases[rng.integers(0, 4, 40)]))
    (d / "phmm.txt").write_text("\n".join(lines) + "\n")

    # bsw pairs (digit-encoded bases, score\nref\nquery triples)
    lines = []
    for _ in range(64):
        tl, ql = int(rng.integers(30, 80)), int(rng.integers(20, 60))
        lines += [str(int(rng.integers(1, 50))),
                  "".join(rng.choice(list("0123"), tl)),
                  "".join(rng.choice(list("0123"), ql))]
    (d / "pairs.txt").write_text("\n".join(lines) + "\n")

    # chain anchor dump
    lines = []
    for n in (80, 120):
        lines.append(f"{n} 22.5 5000 5000 500 1")
        xs = np.cumsum(rng.integers(1, 40, n)) + 1000
        ys = np.maximum(xs + rng.integers(-200, 200, n), 0)
        lines += [f"{x} {y}" for x, y in zip(xs, ys)]
        lines.append("EOR")
    (d / "chain.txt").write_text("\n".join(lines) + "\n")

    # kmer-cnt reads + config
    with open(d / "kmer.fa", "w") as f:
        for i in range(3):
            f.write(f">r{i}\n" + "".join(bases[rng.integers(0, 4, 6000)]) + "\n")
    (d / "asm.cfg").write_text("kmer_size = 17\nuse_minimizers = 0\n")

    # poa windows (header >0... starts a new batch)
    with open(d / "poa.fa", "w") as f:
        for w in range(3):
            base = "".join(bases[rng.integers(0, 4, 120)])
            for s in range(4):
                seq = list(base)
                for pos in np.nonzero(rng.random(120) < 0.04)[0]:
                    seq[pos] = "ACGT"[rng.integers(0, 4)]
                f.write(f">{0 if s == 0 else s}_{w}\n{''.join(seq)}\n")

    # abea model + signals
    from ..ops.oracle.abea import get_kmer_rank

    lm = rng.normal(90, 12, 4096).astype(np.float32)
    ls = (rng.random(4096) * 2 + 1).astype(np.float32)
    with open(d / "model.tsv", "w") as f:
        f.write("kmer\tlevel_mean\tlevel_stdv\n")
        for r in range(4096):
            km = "".join("ACGT"[(r >> (2 * (5 - j))) & 3] for j in range(6))
            f.write(f"{km}\t{lm[r]:.5f}\t{ls[r]:.5f}\n")
    seq = "".join(bases[rng.integers(0, 4, 150)])
    raw = []
    for i in range(len(seq) - 5):
        r = get_kmer_rank(seq[i:i+6])
        raw.extend(lm[r] + rng.normal(0, 0.4, int(rng.integers(10, 18))))
    (d / "abea_reads.fa").write_text(f">read1\n{seq}\n")
    np.savez(d / "signals.npz", read1=np.array(raw, np.float32))

    # eventalign-mode inputs: a 400 bp read (long enough to recalibrate)
    # embedded exactly in a small contig, with its BAM alignment
    from ..io import bam as B

    ea_seq = "".join(bases[rng.integers(0, 4, 400)])
    ea_ctg = ("".join(bases[rng.integers(0, 4, 300)]) + ea_seq
              + "".join(bases[rng.integers(0, 4, 300)]))
    (d / "ea_genome.fa").write_text(f">ectg\n{ea_ctg}\n")
    (d / "ea_reads.fq").write_text(f"@earead\n{ea_seq}\n+\n{'I' * 400}\n")
    raw = []
    for i in range(len(ea_seq) - 5):
        r = get_kmer_rank(ea_seq[i:i + 6])
        raw.extend(lm[r] + rng.normal(0, 0.4, int(rng.integers(10, 18))))
    np.savez(d / "ea_signals.npz", earead=np.array(raw, np.float32))
    idx16 = {c: i for i, c in enumerate(B.SEQ_NT16_STR)}
    B.write_bam(str(d / "ea.bam"), [("ectg", len(ea_ctg))], [B.BamRecord(
        "earead", 0, 0, 300, 60, [("M", 400)],
        np.array([idx16[ch] for ch in ea_seq], np.uint8),
        np.full(400, 30, np.uint8), {"NM": 0})])

    # BAM for pileup/dbg
    recs = []
    for i in range(50):
        ln = 80
        pos = int(rng.integers(0, 5000))
        recs.append(B.BamRecord(
            f"r{i}", 0, 0, pos, 60, [("M", ln)],
            rng.integers(1, 16, ln).astype(np.uint8),
            rng.integers(20, 40, ln).astype(np.uint8), {}))
    B.write_bam(str(d / "aln.bam"), [("chr1", 200_000)], recs)

    # plink trio
    m, n = 30, 10
    geno = rng.choice([0, 1, 2, 3], size=(m, n), p=[.5, .3, .15, .05]).astype(np.int8)
    with open(d / "p.fam", "w") as f:
        for i in range(n):
            f.write(f"F{i} I{i} 0 0 1 -9\n")
    with open(d / "p.bim", "w") as f:
        for j in range(m):
            f.write(f"1 snp{j} 0 {j+1} A C\n")
    enc = {2: 0, 3: 1, 1: 2, 0: 3}
    bpv = -(-n // 4)
    with open(d / "p.bed", "wb") as f:
        f.write(bytes([0x6C, 0x1B, 0x01]))
        for j in range(m):
            row = bytearray(bpv)
            for k in range(n):
                row[k // 4] |= enc[int(geno[j, k])] << (2 * (k % 4))
            f.write(bytes(row))

    # nn inputs
    np.savez(d / "bc_sigs.npz", r1=rng.normal(500, 40, 5000).astype(np.float32))
    np.savez(d / "cv_in.npz", X=rng.normal(0, 1, (4, 33, 8, 4)).astype(np.float32))


def benches(d: pathlib.Path):
    """(name, cli module, arguments, contract check) of the JAX tool's 14
    benches, with its arguments and checks."""
    return [
        ("fmi_build", "fmi_build", [str(d / "ref.fa"), "-p", str(d / "idx")],
         lambda r: "ref_seq_len" in r.stdout),
        ("fmi", "fmi", [str(d / "idx.npz"), str(d / "reads.fq")],
         lambda r: "totalSmems = " in r.stdout),
        ("phmm", "phmm", ["-f", str(d / "phmm.txt")],
         lambda r: "PairHMM completed" in r.stdout),
        ("bsw", "bsw", ["-pairs", str(d / "pairs.txt")],
         lambda r: "Total Pairs processed: 64" in r.stdout),
        ("chain", "chain", ["-i", str(d / "chain.txt"), "-o", str(d / "chain.out")],
         lambda r: "Time in kernel" in r.stderr + r.stdout),
        ("kmer-cnt", "kmer_cnt", ["--reads", str(d / "kmer.fa"),
                                  "--config", str(d / "asm.cfg")],
         lambda r: "Kernel time" in r.stderr),
        ("poa", "poa", ["-s", str(d / "poa.fa")],
         lambda r: r.returncode == 0),
        ("abea", "abea", ["--reads", str(d / "abea_reads.fa"),
                          "--raw", str(d / "signals.npz"),
                          "--model", str(d / "model.tsv"),
                          "-o", str(d / "events.tsv")],
         lambda r: "Kernel time" in r.stderr),
        ("abea-eventalign", "abea",
         ["-r", str(d / "ea_reads.fq"), "--raw", str(d / "ea_signals.npz"),
          "--model", str(d / "model.tsv"), "-b", str(d / "ea.bam"),
          "-g", str(d / "ea_genome.fa"), "-B", "3.7M",
          "-o", str(d / "events_ref.tsv")],
         lambda r: "total entries: 1" in r.stderr
         and (d / "events_ref.tsv").read_text().count("\n") > 10),
        ("pileup", "pileup", [str(d / "aln.bam"), "chr1:0-2000"],
         lambda r: "Kernel time" in r.stderr + r.stdout),
        ("dbg", "dbg", [str(d / "aln.bam"), "chr1", str(d / "ref.fa")],
         lambda r: r.returncode == 0),
        ("grm", "grm", ["--bfile", str(d / "p"), "--make-grm-bin",
                        "--out", str(d / "g")],
         lambda r: "GRM written" in r.stdout),
        ("nn-base", "basecall", ["random", str(d / "bc_sigs.npz"),
                                 "--chunksize", "2000"],
         lambda r: "> done" in r.stderr),
        ("nn-variant", "call_var", ["--input_fn", str(d / "cv_in.npz"),
                                    "--output_fn", str(d / "cv_out.npz")],
         lambda r: "Time taken" in r.stdout),
    ]


def run_bench(mod, argv, check, env=None):
    """(ok, seconds, the run or None, why it failed or "")."""
    t0 = time.perf_counter()
    try:
        r = _run(mod, argv, env)
    except subprocess.TimeoutExpired:
        return False, time.perf_counter() - t0, None, f"timeout after {TIMEOUT_S:g} s"
    except Exception as e:  # noqa: BLE001 -- reported as the bench's failure
        return False, time.perf_counter() - t0, None, f"{type(e).__name__}: {e}"
    secs = time.perf_counter() - t0
    try:
        ok = r.returncode == 0 and bool(check(r))
    except Exception as e:  # noqa: BLE001 -- a check that raises fails the bench
        return False, secs, r, f"check raised {type(e).__name__}: {e}"
    return ok, secs, r, "" if ok else f"rc={r.returncode}"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="run_suite")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--skip", default="", help="comma list of benchmarks to skip")
    ap.add_argument("--device", default=None,
                    help="passed to every CLI with device work (default: cuda; 'cpu' runs "
                         "their plain versions)")
    ap.add_argument("--jobs", type=int, default=1, help="benches run at once")
    args = ap.parse_args(argv)
    skip = set(filter(None, args.skip.split(",")))
    from .. import default_device

    device = str(default_device(args.device))

    d = pathlib.Path(args.workdir or tempfile.mkdtemp(prefix="gpt_suite_"))
    d.mkdir(parents=True, exist_ok=True)
    print(f"# inputs: {d}", flush=True)
    gen_inputs(d)

    todo = [b for b in benches(d) if b[0] not in skip]
    futures = {}
    # benches run at once share the host's cores: each its share of torch's
    # threads, unless the caller set them
    env = dict(os.environ)
    if args.jobs > 1:
        env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // args.jobs)))

    def job(name, mod, argv2, check):
        if name in AFTER and AFTER[name] in futures:
            futures[AFTER[name]].result()
        if mod not in HOST_ONLY:
            argv2 = argv2 + ["--device", device]
        return run_bench(mod, argv2, check, env)

    failures = 0
    with ThreadPoolExecutor(max(1, args.jobs)) as ex:
        for b in todo:
            futures[b[0]] = ex.submit(job, *b)
        for name, *_ in benches(d):
            if name in skip:
                print(f"SKIP {name}")
                continue
            ok, secs, r, why = futures[name].result()
            if ok:
                print(f"OK   {name} ({secs:.2f} s)", flush=True)
                continue
            failures += 1
            print(f"FAIL {name} ({secs:.2f} s, {why})", flush=True)
            if r is not None:
                for line in (r.stderr or r.stdout).strip().split("\n")[-5:]:
                    print(f"     {line}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
