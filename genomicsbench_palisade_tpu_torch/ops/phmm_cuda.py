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
from ..utils import build

SOURCE = "phmm_forward"


class PhmmForwardKernel:
    """One instance (float or double) of the PairHMM forward kernel."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.name = {torch.float32: "phmm_forward_f32", torch.float64: "phmm_forward_f64"}[dtype]
        self.launches = 0
        self._fn = None
        self._errstr = None

    def _load(self):
        if self._fn is None:
            lib = build.load(SOURCE)
            fn = getattr(lib, self.name)
            fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            errstr = lib.phmm_error_string
            errstr.argtypes = [ctypes.c_int]
            errstr.restype = ctypes.c_char_p
            self._fn, self._errstr = fn, errstr
        return self._fn

    def _check(self, batch, tabs, init_y):
        dev = batch["rs_row"].device
        if dev.type != "cuda":
            raise ValueError(f"{self.name} runs on CUDA tensors, got {dev}")
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
            t = args[k]
            if t.device != dev:
                raise ValueError(f"{self.name}: {k} is on {t.device}, expected {dev}")
            if t.dtype != dtype:
                raise ValueError(f"{self.name}: {k} has dtype {t.dtype}, expected {dtype}")
            if shape is not None and tuple(t.shape) != shape:
                raise ValueError(f"{self.name}: {k} has shape {tuple(t.shape)}, expected {shape}")
            if not t.is_contiguous():
                raise ValueError(f"{self.name}: {k} is not contiguous")
        if tabs["ph2pr"].numel() < 128 or tabs["m2m"].numel() < (127 * 128 // 2 + 128):
            raise ValueError(f"{self.name}: lookup tables too short")
        return args, b, rp, hp

    def __call__(self, batch, tabs, init_y) -> torch.Tensor:
        """Raw M+X sums [B] for the compact tensor batch (see ops.phmm)."""
        args, b, rp, hp = self._check(batch, tabs, init_y)
        fn = self._load()
        dev = args["rs_row"].device
        out = torch.empty(b, dtype=self.dtype, device=dev)
        if b == 0:
            return out
        scratch = torch.empty((3, hp, b), dtype=self.dtype, device=dev)
        order = (*INT8_KEYS, *INT32_KEYS, "init_y", *TABLE_KEYS)  # the C signature's
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*(args[k].data_ptr() for k in order), scratch.data_ptr(),
                     out.data_ptr(), b, rp, hp, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: {self._errstr(err).decode()}")
        self.launches += 1
        return out


phmm_forward_f32 = PhmmForwardKernel(torch.float32)
phmm_forward_f64 = PhmmForwardKernel(torch.float64)
KERNELS = {torch.float32: phmm_forward_f32, torch.float64: phmm_forward_f64}
