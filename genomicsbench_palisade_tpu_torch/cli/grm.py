"""grm driver: `python -m genomicsbench_palisade_tpu_torch.cli.grm
--pgen X.pgen --pvar X.pvar --psam X.psam [--maf 0.01] --make-grm-bin
--out O [--block 512] [--device cpu]` (or `--bfile <prefix>`).

Mirrors genomicsbench_palisade_tpu/cli/grm.py, the reference's command
line (scripts/run-cpu.sh:53) and plink2 --make-grm-bin (benchmarks/grm/2.0,
CalcGrm at plink2_matrix_calc.cc:3938): the same flags, the same three
stdout lines and the same .grm.bin/.grm.N.bin/.grm.id.  --maf drops the
variants whose nonmajor allele frequency is below the threshold; the
allele counts it reads also give the GRM's frequencies, so the genotypes
are summed once.  Runs on one device: CUDA unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import sys
import time

from .. import default_device
from ..io.plink import read_bed, read_pgen
from ..ops.grm import allele_counts, allele_freqs, compute_grm, maf_filter, write_grm_bin


def main(argv=None, timings: dict | None = None):
    ap = argparse.ArgumentParser(prog="grm")
    ap.add_argument("--bfile")
    ap.add_argument("--pgen")
    ap.add_argument("--pvar")
    ap.add_argument("--psam")
    ap.add_argument("--maf", type=float, default=None)
    ap.add_argument("--make-grm-bin", action="store_true")
    ap.add_argument("--out", required=True)
    ap.add_argument("--threads", type=int, default=1, help="ignored")
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    timings = {} if timings is None else timings

    t0 = time.perf_counter()
    if args.pgen:
        geno, fam, _bim = read_pgen(args.pgen, args.pvar, args.psam)
    elif args.bfile:
        geno, fam, _bim = read_bed(args.bfile)
    else:
        ap.error("one of --pgen or --bfile is required")
    print(f"{len(geno)} variants, {geno.shape[1]} samples loaded")
    t1 = time.perf_counter()
    alt, nonmiss = allele_counts(geno)
    if args.maf is not None:
        kept = maf_filter(geno, args.maf, (alt, nonmiss))
        print(f"{len(geno) - int(kept.sum())} variants removed due to "
              f"allele frequency threshold(s)")
        if not kept.all():
            geno, alt, nonmiss = geno[kept], alt[kept], nonmiss[kept]
    t2 = time.perf_counter()
    grm, counts = compute_grm(geno, block=args.block, freqs=allele_freqs(alt, nonmiss),
                              device=device, timings=timings)
    dt = time.perf_counter() - t2
    write_grm_bin(args.out, grm, counts, fam)
    timings.update(read_s=t1 - t0, filter_s=t2 - t1, compute_s=dt,
                   write_s=time.perf_counter() - t2 - dt, variants=len(geno),
                   samples=geno.shape[1])
    print(f"GRM written to {args.out}.grm.bin ({dt:.3f} sec kernel)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
