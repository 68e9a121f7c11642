"""fmi index builder: `python -m genomicsbench_palisade_tpu_torch.cli.fmi_build
<ref.fasta> [-p prefix] [--bwt2bit] [--bntseq] [--device cpu]`.

Mirrors genomicsbench_palisade_tpu/cli/fmi_build.py, `bwa-mem2 index`
(tools/bwa-mem2/src/FMI_search.cpp:358 build_index): packs the FASTA
(non-ACGT -> seeded random base), builds the fwd+revcomp suffix array by
native SA-IS on the host, the BWT, counts and occ rows on `--device`
(CUDA unless `--device cpu`), writes the npz index and optionally the
reference's `.bwt.2bit.64` and `.ann/.amb/.pac`, and prints the same
`*` lines (ref_seq_len, count[], sentinel index).
"""

from __future__ import annotations

import argparse
import sys
import time

from .. import default_device
from ..index.builder import build_from_fasta


def main(argv=None, stats=None):
    ap = argparse.ArgumentParser(prog="fmi_build")
    ap.add_argument("fasta")
    ap.add_argument("-p", "--prefix", default=None,
                    help="output prefix (default: the fasta path)")
    ap.add_argument("--bwt2bit", action="store_true",
                    help="also write the bwa-mem2 .bwt.2bit.64 binary")
    ap.add_argument("--bntseq", action="store_true",
                    help="also write the bwa .ann/.amb/.pac metadata")
    ap.add_argument("--device", default=None,
                    help="torch device for the BWT and occ rows (default: cuda; "
                         "'cpu' runs them on the CPU)")
    args = ap.parse_args(argv)
    device = default_device(args.device)

    prefix = args.prefix or args.fasta
    t0 = time.perf_counter()
    idx, names, lengths = build_from_fasta(args.fasta, prefix, args.bwt2bit,
                                           bntseq=args.bntseq, device=device, stats=stats)
    dt = time.perf_counter() - t0

    print(f"* Index prefix: {prefix}")
    print(f"* Contigs: {len(names)}, total length {int(lengths.sum())}")
    print(f"* ref_seq_len: {idx.ref_seq_len}")
    for i, c in enumerate(idx.count):
        print(f"* count[{i}] = {int(c)}")
    print(f"* sentinel_index: {idx.sentinel_index}")
    print(f"* Build time: {dt:.2f} sec", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
