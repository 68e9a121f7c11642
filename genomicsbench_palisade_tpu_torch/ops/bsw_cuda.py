"""ctypes wrapper of the banded Smith-Waterman kernel (csrc/bsw_extend.cu).

Counterpart of genomicsbench_palisade_tpu/ops/bsw_pallas.py: _bsw_core
and its `_kernel`.  `bsw_extend` checks what it is given, launches on
PyTorch's current stream without synchronising, raises if the launch was
refused, and counts its launches in `launches`.  The library is built at
the first call, never at import.

The kernel keeps each pair's H/E row in registers and has one instance a
query edge (32-512), which `q_max` picks: the caller's bucket edge (what
cli/bsw.py passes), or, when the caller does not say, the batch's longest
query, read back to the host (one sync a launch).
"""

from __future__ import annotations

import ctypes

import torch

from .kernel import CudaKernel, check_tensor, require_cuda, with_defaults

SOURCE = "bsw_extend"
MAX_QUERY = 512  # the kernel's widest instance (cli/bsw.py's largest edge)
# lanes a pair for each query edge of the kernel's instances, measured on
# the card (tools/bsw_lanes.py, PERF.md); built as -DBSW_LANES_<edge>
LANES = {32: 8, 64: 8, 128: 32, 256: 32, 512: 32}
# the batch's tensors, in the order of the C signature, with their dtypes
BATCH_DTYPES = {"codes": torch.int8, "q_off": torch.int64, "q_len": torch.int32,
                "t_off": torch.int64, "t_len": torch.int32, "h0": torch.int32}


def layout(q_max: int) -> tuple:
    """(edge, lanes a pair, entries a lane) of the instance that `q_max`
    picks: the first edge at or above it."""
    edge = next(e for e in LANES if e >= q_max)
    return edge, LANES[edge], edge // LANES[edge]


class BswExtendKernel(CudaKernel):
    """The bsw_extend kernel: per pair the six int32 ksw_extend outputs."""

    def __init__(self, defines=()):
        super().__init__("bsw_extend", SOURCE,
                         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
                         "bsw_error_string",
                         with_defaults(((f"BSW_LANES_{e}", n) for e, n in LANES.items()),
                                       defines))

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
        if params[3] < 0:
            raise ValueError(f"{self.name}: e_ins must be >= 0 (the F scan's maps assume it)")
        return dev, b

    def __call__(self, batch, params, q_max=None) -> torch.Tensor:
        """[6, B] int32 (OUT_ORDER rows) for the struct-of-arrays batch
        (see ops.bsw).  `q_max` (at most MAX_QUERY) must be at least every
        q_len of the batch: the kernel trusts it, as it trusts the offsets.
        Without it the batch's longest query is read back to the host."""
        dev, b = self._check(batch, params)
        out = torch.empty((6, b), dtype=torch.int32, device=dev)
        if b == 0:
            return out
        if q_max is None:
            q_max = int(batch["q_len"].max())
        if not 0 <= q_max <= MAX_QUERY:
            raise ValueError(f"{self.name}: queries of up to {MAX_QUERY} bases, got {q_max}")
        self.launch(dev, *(batch[k].data_ptr() for k in BATCH_DTYPES), out.data_ptr(), b,
                    q_max, *params)
        return out


bsw_extend = BswExtendKernel()
