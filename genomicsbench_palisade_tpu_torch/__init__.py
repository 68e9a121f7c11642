"""genomicsbench_palisade_tpu_torch: the PyTorch/CUDA port of the engine.

The JAX package `genomicsbench_palisade_tpu` beside it is the reference;
this package imports neither it nor `jax`.  Ported so far: PairHMM
(`ops.phmm`, kernel `csrc/phmm_forward.cu`, CLI `cli.phmm`), banded
Smith-Waterman extension (`ops.bsw`, kernel `csrc/bsw_extend.cu`, CLI
`cli.bsw`) and minimap2 anchor chaining (`ops.chain`, kernel
`csrc/chain_dp.cu`, CLI `cli.chain`).

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
