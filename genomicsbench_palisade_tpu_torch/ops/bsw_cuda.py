"""ctypes wrapper of the banded Smith-Waterman kernel (csrc/bsw_extend.cu).

Counterpart of genomicsbench_palisade_tpu/ops/bsw_pallas.py: _bsw_core
and its `_kernel`.  `bsw_extend` checks what it is given, launches on
PyTorch's current stream without synchronising, raises if the launch was
refused, and counts its launches in `launches`.  The library is built at
the first call, never at import.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build

SOURCE = "bsw_extend"
# the batch's tensors, in the order of the C signature, with their dtypes
BATCH_DTYPES = {"codes": torch.int8, "q_off": torch.int64, "q_len": torch.int32,
                "t_off": torch.int64, "t_len": torch.int32, "h0": torch.int32}


class BswExtendKernel:
    """The bsw_extend kernel: per pair the six int32 ksw_extend outputs."""

    name = "bsw_extend"

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._errstr = None

    def _load(self):
        if self._fn is None:
            lib = build.load(SOURCE)
            fn = lib.bsw_extend
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            errstr = lib.bsw_error_string
            errstr.argtypes = [ctypes.c_int]
            errstr.restype = ctypes.c_char_p
            self._fn, self._errstr = fn, errstr
        return self._fn

    def _check(self, batch, params):
        dev = batch["h0"].device
        if dev.type != "cuda":
            raise ValueError(f"{self.name} runs on CUDA tensors, got {dev}")
        b = batch["h0"].shape[0]
        for k, dtype in BATCH_DTYPES.items():
            t = batch[k]
            if t.device != dev:
                raise ValueError(f"{self.name}: {k} is on {t.device}, expected {dev}")
            if t.dtype != dtype:
                raise ValueError(f"{self.name}: {k} has dtype {t.dtype}, expected {dtype}")
            if t.dim() != 1 or (k != "codes" and t.shape[0] != b):
                raise ValueError(f"{self.name}: {k} has shape {tuple(t.shape)}, expected "
                                 f"{'1-D' if k == 'codes' else (b,)}")
            if not t.is_contiguous():
                raise ValueError(f"{self.name}: {k} is not contiguous")
        if len(params) != 10 or not all(isinstance(v, int) for v in params):
            raise ValueError(f"{self.name}: params must be 10 ints (ops.bsw._params_tuple)")
        return dev, b

    def __call__(self, batch, params) -> torch.Tensor:
        """[6, B] int32 (OUT_ORDER rows) for the struct-of-arrays batch
        (see ops.bsw).  Reads the batch's longest query length back to the
        host to size the H/E scratch."""
        dev, b = self._check(batch, params)
        out = torch.empty((6, b), dtype=torch.int32, device=dev)
        if b == 0:
            return out
        fn = self._load()
        qe = int(batch["q_len"].max()) + 1
        scratch = torch.empty((qe, b, 2), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*(batch[k].data_ptr() for k in BATCH_DTYPES), scratch.data_ptr(),
                     out.data_ptr(), b, *params, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: {self._errstr(err).decode()}")
        self.launches += 1
        return out


bsw_extend = BswExtendKernel()
