"""ctypes wrappers of the PairHMM forward kernel (csrc/phmm_forward.cu).

Counterpart of genomicsbench_palisade_tpu/ops/phmm_pallas.py:
phmm_forward_pallas.  Two instances of one template: `phmm_forward_f32`
(the main pass) and `phmm_forward_f64` (the fallback).  Each checks what
it is given, launches on PyTorch's current stream without synchronising,
raises if the launch was refused, and counts its launches in `launches`.
The library is built at the first call, never at import.

The kernel gives each testcase a group of lanes and has one instance a
row edge, which the batch's r_pad picks (cli/phmm.py passes its bucket's):
nothing is read back.  Rows past an instance's tile are walked in tiles
whose carry stays in shared memory; only where a block's carry would not
fit there does the wrapper allocate a global one (`phmm_forward_scratch`
says how large), which no batch of r_pad <= 513 and h_pad <= 512 needs.
"""

from __future__ import annotations

import ctypes

import torch

from ..convert import INT8_KEYS, INT32_KEYS, TABLE_KEYS
from ..utils import build
from .kernel import CudaKernel, check_tensor, require_cuda

SOURCE = "phmm_forward"


class PhmmForwardKernel(CudaKernel):
    """One instance (float or double) of the PairHMM forward kernel."""

    def __init__(self, dtype: torch.dtype, defines=()):
        self.dtype = dtype
        name = {torch.float32: "phmm_forward_f32", torch.float64: "phmm_forward_f64"}[dtype]
        super().__init__(name, SOURCE,
                         [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                         "phmm_error_string", defines)
        self._scratch_fn = None

    def scratch_elems(self, b: int, rp: int, hp: int) -> int:
        """Elements of the global carry the kernel needs for this shape (0
        for most: one tile, or a carry in shared memory)."""
        if self._scratch_fn is None:
            fn = build.load(self.source, self.defines).phmm_forward_scratch
            fn.argtypes = [ctypes.c_int] * 4
            fn.restype = ctypes.c_longlong
            self._scratch_fn = fn
        return int(self._scratch_fn(int(self.dtype == torch.float64), b, rp, hp))

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
        n_scratch = self.scratch_elems(b, rp, hp)
        scratch = torch.empty(n_scratch, dtype=self.dtype, device=dev) if n_scratch else None
        order = (*INT8_KEYS, *INT32_KEYS, "init_y", *TABLE_KEYS)  # the C signature's
        self.launch(dev, *(args[k].data_ptr() for k in order),
                    scratch.data_ptr() if scratch is not None else None, out.data_ptr(), b, rp, hp)
        return out


phmm_forward_f32 = PhmmForwardKernel(torch.float32)
phmm_forward_f64 = PhmmForwardKernel(torch.float64)
KERNELS = {torch.float32: phmm_forward_f32, torch.float64: phmm_forward_f64}
