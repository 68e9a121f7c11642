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

from .kernel import CudaKernel, check_tensor, require_cuda

SOURCE = "bsw_extend"
# the batch's tensors, in the order of the C signature, with their dtypes
BATCH_DTYPES = {"codes": torch.int8, "q_off": torch.int64, "q_len": torch.int32,
                "t_off": torch.int64, "t_len": torch.int32, "h0": torch.int32}


class BswExtendKernel(CudaKernel):
    """The bsw_extend kernel: per pair the six int32 ksw_extend outputs."""

    def __init__(self):
        super().__init__("bsw_extend", SOURCE,
                         [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
                         "bsw_error_string")

    def _check(self, batch, params):
        dev = batch["h0"].device
        require_cuda(self.name, dev)
        b = batch["h0"].shape[0]
        for k, dtype in BATCH_DTYPES.items():
            # codes: the whole 1-D code buffer; the rest: one entry a pair
            want = (batch[k].numel(),) if k == "codes" else (b,)
            check_tensor(self.name, k, batch[k], dev, dtype, want)
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
        qe = int(batch["q_len"].max()) + 1
        scratch = torch.empty((qe, b, 2), dtype=torch.int32, device=dev)
        self.launch(dev, *(batch[k].data_ptr() for k in BATCH_DTYPES), scratch.data_ptr(),
                    out.data_ptr(), b, *params)
        return out


bsw_extend = BswExtendKernel()
