"""Genetic relationship matrix (plink2 --make-grm-bin) as torch ops.

The port's counterpart of genomicsbench_palisade_tpu/ops/grm.py.
Semantics (benchmarks/grm/2.0/plink2_matrix_calc.cc:3231-3279, 3668-3704):
each variant's dosages are centred and scaled, z = (g - 2f) / sqrt(2f(1-f)),
with missing genotypes and degenerate variants (variance <= kSmallEpsilon)
zeroed; GRM = ZᵀZ over all variants, divided per sample pair by the pair's
nonmissing count VᵀV (the .grm.N.bin).

Host side: allele frequencies and the --maf filter come from integer sums
(int64 dosage sums and nonmissing counts) and one float64 division, which
are the numbers the JAX package gets from its float64 copy of the matrix
(sums of small integers are exact in float64), without that copy.  2f and
1/stdev go to the device as float32, as in the JAX package.

Device side (`grm_device`): the int8 genotypes go to the device once; a
block of `block` variants at a time becomes Z and V (0/1) by `where`s, and
`sums += ZᵀZ`, `counts += VᵀV` accumulate in float32.  The last block is
padded with code-3 rows (missing: zero in Z and V), as the JAX scan pads.
Every product runs with TF32 off (`utils.precision.ieee_fp32`) and returns
float32; counts are exact below 2^24 variants.  The JAX precision names
mean, on the H100:
  HIGH (the default; bf16x3 on a TPU), HIGHEST: one IEEE float32 product;
  DEFAULT: one bf16 pass, Z rounded to bf16 and the exact bf16 x bf16
    products summed in float32 (a float32 product of bf16-valued float32
    tensors: never a bf16-typed result);
  "compensated": the split of ops/grm.py:97-115, zh and zl rounded through
    bf16, sums += zhᵀzh + zhᵀzl + (zhᵀzl)ᵀ, zlᵀzl dropped; each product a
    float32 product of bf16-valued float32 tensors.
The products stay `torch.addmm`/`mm`: a plain matrix product that the JAX
package computes outside any Pallas kernel.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import default_device
from ..utils.precision import ieee_fp32

K_SMALL_EPSILON = 2 ** -44  # plink2 kSmallEpsilon
MAF_EPSILON = 0.00000000000005684341886080801486968994140625  # plink2_filter.cc's guard
PRECISIONS = ("DEFAULT", "HIGH", "HIGHEST", "compensated")
COUNT_ROWS = 8192  # variants a pass of allele_counts (bounds its temporaries)


def normalize_block_np(geno: np.ndarray, freqs: np.ndarray | None = None):
    """geno: [M, N] int8 ALT-dosage counts (0/1/2, 3=missing).

    Returns (z [M,N] f32 normalized w/ missing->0, v [M,N] f32 nonmissing,
    freqs [M]).  When freqs is None, alt frequency is estimated from the
    nonmissing genotypes (plink2 uses the loaded/computed allele freqs).
    """
    miss = geno == 3
    g = geno.astype(np.float64)
    g[miss] = 0.0
    nonmiss = (~miss).astype(np.float64)
    if freqs is None:
        denom = np.maximum(nonmiss.sum(1), 1.0)
        freqs = g.sum(1) / (2.0 * denom)
    variance = 2.0 * freqs * (1.0 - freqs)
    ok = variance > K_SMALL_EPSILON
    inv_stdev = np.zeros_like(variance)
    inv_stdev[ok] = 1.0 / np.sqrt(variance[ok])
    z = (g - 2.0 * freqs[:, None]) * inv_stdev[:, None]
    z[miss] = 0.0
    z[~ok] = 0.0
    v = nonmiss.copy()
    v[~ok] = 0.0  # degenerate variants contribute to neither sums nor counts
    return z.astype(np.float32), v.astype(np.float32), freqs


def allele_counts(geno: np.ndarray):
    """(ALT dosage sums, nonmissing counts), int64 [M]: missing (3) counts
    in neither."""
    m, n = geno.shape
    alt = np.empty(m, np.int64)
    nonmiss = np.empty(m, np.int64)
    for s in range(0, m, COUNT_ROWS):
        g = geno[s : s + COUNT_ROWS]
        n_miss = np.count_nonzero(g == 3, axis=1)
        alt[s : s + len(g)] = g.sum(1, dtype=np.int64) - 3 * n_miss
        nonmiss[s : s + len(g)] = n - n_miss
    return alt, nonmiss


def allele_freqs(alt: np.ndarray, nonmiss: np.ndarray) -> np.ndarray:
    """ALT allele frequency a variant, float64 (0 where nothing is observed)."""
    return alt.astype(np.float64) / (2.0 * np.maximum(nonmiss, 1).astype(np.float64))


def maf_filter(geno: np.ndarray, min_maf: float, counts=None) -> np.ndarray:
    """Keep-mask for plink2 --maf (plink2_filter.cc:3918-3956): the
    nonmajor allele frequency from the hardcalls (missing excluded; 0.5
    where none is observed) against min_maf * (1 - kSmallEpsilon).
    `counts` is `allele_counts(geno)` when the caller has it."""
    alt, nonmiss = allele_counts(geno) if counts is None else counts
    obs2 = 2.0 * nonmiss.astype(np.float64)
    af = np.divide(alt.astype(np.float64), obs2, out=np.full(len(alt), 0.5), where=obs2 > 0)
    nonmajor = np.minimum(af, 1.0 - af)
    return nonmajor >= min_maf * (1.0 - MAF_EPSILON)


def _split_bf16(x):
    """x's value rounded to bf16, kept in float32 (an exact bf16 operand)."""
    return x.to(torch.bfloat16).to(torch.float32)


def grm_block_update(grm_sums, grm_counts, z, v):
    """One variant block: (sums + ZᵀZ, counts + VᵀV), IEEE float32."""
    with ieee_fp32():
        return grm_sums + z.T @ z, grm_counts + v.T @ v


def grm_device(geno, two_f, inv_stdev, ok, block: int, precision: str = "HIGH"):
    """Blocked ZᵀZ and VᵀV on geno's device: (sums, counts) [N, N] float32.

    geno: [M, N] int8 tensor; two_f, inv_stdev: [M] float32; ok: [M] bool
    (variance above kSmallEpsilon), all on geno's device."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, not {precision!r}")
    m, n = geno.shape
    dev = geno.device
    sums = torch.zeros((n, n), dtype=torch.float32, device=dev)
    counts = torch.zeros((n, n), dtype=torch.float32, device=dev)
    with ieee_fp32():
        for s in range(0, m, block):
            g8 = geno[s : s + block]
            tf, isd, okb = two_f[s : s + block], inv_stdev[s : s + block], ok[s : s + block]
            if len(g8) < block:  # the last block: code-3 rows, as the JAX scan pads
                pad = block - len(g8)
                g8 = torch.cat([g8, torch.full((pad, n), 3, dtype=torch.int8, device=dev)])
                tf = torch.cat([tf, tf.new_zeros(pad)])
                isd = torch.cat([isd, isd.new_zeros(pad)])
                okb = torch.cat([okb, okb.new_zeros(pad)])
            miss = g8 == 3
            dead = miss | ~okb[:, None]
            g = torch.where(miss, 0.0, g8.to(torch.float32))
            z = torch.where(dead, 0.0, (g - tf[:, None]) * isd[:, None])
            v = torch.where(dead, 0.0, 1.0)
            if precision == "compensated":
                zh = _split_bf16(z)
                zl = _split_bf16(z - zh)
                cross = zh.T @ zl
                sums += zh.T @ zh
                sums += cross
                sums += cross.T
            else:
                zz = _split_bf16(z) if precision == "DEFAULT" else z
                sums.addmm_(zz.T, zz)
            counts.addmm_(v.T, v)
    return sums, counts


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def compute_grm(geno: np.ndarray, block: int = 4096, freqs: np.ndarray | None = None,
                precision: str = "HIGH", device=None, timings: dict | None = None):
    """geno: [M, N] int8 (0/1/2 ALT dosage, 3 missing).

    Returns (grm [N,N] f32, counts [N,N] f32) as numpy: grm[j,k] = Σ z_ij
    z_ik / the pair's nonmissing count (GCTA/plink2 --make-grm-bin).  The
    frequencies come from integer sums on the host unless given; the
    normalisation and products run on `device` (CUDA unless told "cpu").
    `timings` gets h2d_s, products_s and d2h_s (the device waited for)."""
    dev = default_device(device)
    if freqs is None:
        freqs = allele_freqs(*allele_counts(geno))
    variance = 2.0 * freqs * (1.0 - freqs)
    ok = variance > K_SMALL_EPSILON
    inv_stdev = np.zeros_like(variance)
    inv_stdev[ok] = 1.0 / np.sqrt(variance[ok])
    t0 = time.perf_counter()
    geno_t = torch.from_numpy(np.ascontiguousarray(geno, np.int8)).to(dev)
    two_f = torch.from_numpy((2.0 * freqs).astype(np.float32)).to(dev)
    isd = torch.from_numpy(inv_stdev.astype(np.float32)).to(dev)
    ok_t = torch.from_numpy(ok).to(dev)
    _sync(dev)
    t1 = time.perf_counter()
    sums, counts = grm_device(geno_t, two_f, isd, ok_t, block, precision)
    grm = sums / counts.clamp(min=1.0)
    _sync(dev)
    t2 = time.perf_counter()
    grm_np, counts_np = grm.cpu().numpy(), counts.cpu().numpy()
    if timings is not None:
        timings.update(h2d_s=t1 - t0, products_s=t2 - t1, d2h_s=time.perf_counter() - t2)
    return grm_np, counts_np


def write_grm_bin(prefix: str, grm: np.ndarray, counts: np.ndarray, sample_ids):
    """GCTA/plink binary GRM triple: .grm.bin/.grm.N.bin (f32 lower
    triangle, row-major by (j>=k)) + .grm.id."""
    n = grm.shape[0]
    tril = np.tri(n, dtype=bool)  # row-major order of its True cells: (j, k <= j)
    with open(prefix + ".grm.bin", "wb") as f:
        np.asarray(grm, "<f4")[tril].tofile(f)
    with open(prefix + ".grm.N.bin", "wb") as f:
        np.asarray(counts, "<f4")[tril].tofile(f)
    with open(prefix + ".grm.id", "w") as f:
        lines = []
        for sid in sample_ids:
            fid, _, iid = str(sid).partition("\t")
            lines.append(f"{fid}\t{iid or fid}\n")
        f.write("".join(lines))
