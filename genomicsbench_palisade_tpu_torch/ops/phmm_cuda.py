"""ctypes wrappers of the PairHMM forward kernel (csrc/phmm_forward.cu).

Counterpart of genomicsbench_palisade_tpu/ops/phmm_pallas.py:
phmm_forward_pallas.  Two instances of one template: `phmm_forward_f32`
(the main pass) and `phmm_forward_f64` (the fallback).  Each checks what
it is given, launches on PyTorch's current stream without synchronising,
raises if the launch was refused, and counts its launches in `launches`.
The library is built at the first call, never at import.
"""

from __future__ import annotations

import ctypes

import torch

from ..convert import INT8_KEYS, INT32_KEYS, TABLE_KEYS
from .kernel import CudaKernel, check_tensor, require_cuda

SOURCE = "phmm_forward"


class PhmmForwardKernel(CudaKernel):
    """One instance (float or double) of the PairHMM forward kernel."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        name = {torch.float32: "phmm_forward_f32", torch.float64: "phmm_forward_f64"}[dtype]
        super().__init__(name, SOURCE,
                         [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                         "phmm_error_string")

    def _check(self, batch, tabs, init_y):
        dev = batch["rs_row"].device
        require_cuda(self.name, dev)
        b, rp = batch["rs_row"].shape
        hp = batch["hap"].shape[1]
        want = {k: (torch.int8, (b, rp)) for k in INT8_KEYS}
        want["hap"] = (torch.int8, (b, hp))
        want.update({k: (torch.int32, (b,)) for k in INT32_KEYS})
        args = dict(batch)
        args["init_y"] = init_y
        want["init_y"] = (self.dtype, (hp + 1,))
        for k in TABLE_KEYS:
            args[k] = tabs[k]
            want[k] = (self.dtype, None)
        for k, (dtype, shape) in want.items():
            check_tensor(self.name, k, args[k], dev, dtype, shape)
        if tabs["ph2pr"].numel() < 128 or tabs["m2m"].numel() < (127 * 128 // 2 + 128):
            raise ValueError(f"{self.name}: lookup tables too short")
        return args, b, rp, hp

    def __call__(self, batch, tabs, init_y) -> torch.Tensor:
        """Raw M+X sums [B] for the compact tensor batch (see ops.phmm)."""
        args, b, rp, hp = self._check(batch, tabs, init_y)
        dev = args["rs_row"].device
        out = torch.empty(b, dtype=self.dtype, device=dev)
        if b == 0:
            return out
        scratch = torch.empty((3, hp, b), dtype=self.dtype, device=dev)
        order = (*INT8_KEYS, *INT32_KEYS, "init_y", *TABLE_KEYS)  # the C signature's
        self.launch(dev, *(args[k].data_ptr() for k in order), scratch.data_ptr(),
                    out.data_ptr(), b, rp, hp)
        return out


phmm_forward_f32 = PhmmForwardKernel(torch.float32)
phmm_forward_f64 = PhmmForwardKernel(torch.float64)
KERNELS = {torch.float32: phmm_forward_f32, torch.float64: phmm_forward_f64}
