"""Synthesize a FASTQ of reads sampled from a FASTA reference.

    python -m genomicsbench_palisade_tpu_torch.tools.synth_fastq ref.fa out.fq
        [--reads 1000000] [--read-len 151] [--sub-rate 0.01] [--seed 11]

Counterpart of tools/synth_fastq.py, byte for byte for the same arguments:
the reference's fmi benchmark reads 1 M x 151 bp FASTQ reads against the
hg38+alt index, and this writes that shape of input from any reference so
that `cli.fmi` can be driven at scale (FASTQ parse -> encode -> search ->
metric lines).  The reference is packed by `index.builder.pack_fasta`
(non-ACGT as its seeded random bases); reads start at uniform random
positions on the forward strand with `--sub-rate` substitutions, and every
quality is 'I' (fmi.cpp encodes bases only).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="synth_fastq")
    ap.add_argument("ref_fa")
    ap.add_argument("out_fq")
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--read-len", type=int, default=151)
    ap.add_argument("--sub-rate", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args(argv)

    from ..index.builder import pack_fasta

    t0 = time.perf_counter()
    codes, _names, _lengths = pack_fasta(args.ref_fa)
    rng = np.random.default_rng(args.seed)
    L = args.read_len
    starts = rng.integers(0, len(codes) - L, args.reads)
    # gather all reads in one fancy-index (rows = starts[:,None] + arange)
    enc = codes[starts[:, None] + np.arange(L)].astype(np.uint8)
    sub = rng.random(enc.shape) < args.sub_rate
    enc[sub] = rng.integers(0, 4, int(sub.sum()), dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)[enc]  # [n, L] ASCII

    qual = b"I" * L
    with open(args.out_fq, "wb") as f:
        buf = []
        for i in range(args.reads):
            buf.append(b"@r%d\n%s\n+\n%s\n" % (i, bases[i].tobytes(), qual))
            if len(buf) == 65536:
                f.write(b"".join(buf))
                buf.clear()
        f.write(b"".join(buf))
    print(f"[synth_fastq] {args.reads} x {L} bp -> {args.out_fq} "
          f"in {time.perf_counter() - t0:.0f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
