"""IEEE float32 on the card: TF32 off for cuBLAS and cuDNN inside a block.

PyTorch lets cuDNN run float32 convolutions and RNNs in TF32 (10-bit
mantissa) by default (`torch.backends.cudnn.allow_tf32` is True), which is
~5e-4 relative: past the grm (2e-5), Clair (2e-5) and bonito (5e-4)
contracts.  The port's f32 entry points run their products inside
`ieee_fp32()`, which turns TF32 off for cuBLAS and cuDNN and restores both
flags on exit, so the process's own settings are left as they were.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def ieee_fp32():
    """Full float32 matrix products and convolutions inside the block."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
