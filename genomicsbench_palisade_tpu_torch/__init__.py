"""genomicsbench_palisade_tpu_torch: the PyTorch/CUDA port of the engine.

The JAX package `genomicsbench_palisade_tpu` beside it is the reference;
this package imports neither it nor `jax`.  Ported so far: PairHMM
(`ops.phmm`, kernel `csrc/phmm_forward.cu`, CLI `cli.phmm`), banded
Smith-Waterman extension (`ops.bsw`, kernel `csrc/bsw_extend.cu`, CLI
`cli.bsw`), minimap2 anchor chaining (`ops.chain`, kernel
`csrc/chain_dp.cu`, CLI `cli.chain`) and f5c's adaptive banded event
alignment (`ops.events` host prep, `ops.abea`, kernels `csrc/abea_fill.cu`
and `csrc/abea_walk.cu`, CLI `cli.abea`), in read coordinates and in the
eventalign mode (`io.bam`, `ops.eventalign`: QC, the reference-space
realign and the TSV), Flye's canonical k-mer counter (`ops.kmer`, the
sort-reduce counter and its streamed accumulator as torch ops, CLI
`cli.kmer_cnt`) and spoa's partial-order alignment (`ops.poa`, the convex
graph alignment of many windows in lockstep as torch ops, the graphs on
the host in `ops.oracle.poa`; CLI `cli.poa`), plink2's GRM (`io.plink`,
`ops.grm`: the blocked ZᵀZ as float32 torch products; CLI `cli.grm`) and
the two NN models as torch modules (`models.bonito`, CLI `cli.basecall`;
`models.clair`, CLI `cli.call_var`; flax weights through
`io.flax_msgpack`).

Entry points run on CUDA unless the caller passes `device="cpu"`; with no
GPU and no explicit device they raise.  Kernels are built at first use,
so importing the package needs neither a GPU nor `nvcc`.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` if given, else CUDA.

    Never drops quietly to the CPU: with no GPU and no explicit device
    this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' (--device cpu) to "
            "run the plain PyTorch version on the CPU")
    return torch.device("cuda")
