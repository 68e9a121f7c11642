"""ctypes wrapper of the banded Smith-Waterman kernel (csrc/bsw_extend.cu).

Counterpart of genomicsbench_palisade_tpu/ops/bsw_pallas.py: _bsw_core
and its `_kernel`.  `bsw_extend` checks what it is given, launches on
PyTorch's current stream without synchronising, raises if the launch was
refused, and counts its launches in `launches`.  The library is built at
the first call, never at import.

The kernel keeps each pair's H/E row in registers and has one instance a
query edge (32-512), which `q_max` picks: the caller's bucket edge (what
cli/bsw.py passes), or, when the caller does not say, the batch's longest
query, read back to the host (one sync a launch).  Above 512 a second
kernel steps each row over chunks of 512 entries of a row kept in shared
memory, or, past what a block's shared memory holds (a query of more than
28,671 bases), in a scratch that the wrapper allocates, one region a warp
of a grid of `LONG_WARPS_PER_SM` warps an SM.  Each instance has a variant
for e_ins < 0, picked at launch.  No query length and no e_ins is refused.
"""

from __future__ import annotations

import ctypes

import torch

from .kernel import CudaKernel, check_tensor, require_cuda, with_defaults

SOURCE = "bsw_extend"
MAX_REGISTER_QUERY = 512  # the widest register instance (cli/bsw.py's largest edge)
LONG_CHUNK = 512  # entries of a chunk of the long-query kernel
SMEM_BLOCK_BYTES = 232_448  # the shared memory a block may have on the H100 (227 KB)
LONG_WARPS_PER_SM = 8  # the long-query kernel's grid when its rows are in scratch
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


def long_stride(q_max: int) -> int:
    """Entries of H (or E) the long-query kernel keeps a pair: q_max + 1
    rounded up to whole chunks."""
    return (q_max + LONG_CHUNK) // LONG_CHUNK * LONG_CHUNK


def long_in_scratch(q_max: int) -> bool:
    """Whether the long-query kernel keeps its rows in global scratch: its
    H and E rows would pass a block's shared memory."""
    return 8 * long_stride(q_max) > SMEM_BLOCK_BYTES


class BswExtendKernel(CudaKernel):
    """The bsw_extend kernel: per pair the six int32 ksw_extend outputs."""

    def __init__(self, defines=()):
        super().__init__("bsw_extend", SOURCE,
                         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                         + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
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
        return dev, b

    def __call__(self, batch, params, q_max=None) -> torch.Tensor:
        """[6, B] int32 (OUT_ORDER rows) for the struct-of-arrays batch
        (see ops.bsw).  `q_max` must be at least every q_len of the batch:
        the kernel trusts it, as it trusts the offsets.  Without it the
        batch's longest query is read back to the host."""
        dev, b = self._check(batch, params)
        out = torch.empty((6, b), dtype=torch.int32, device=dev)
        if b == 0:
            return out
        if q_max is None:
            q_max = int(batch["q_len"].max())
        if q_max < 0:
            raise ValueError(f"{self.name}: q_max must be >= 0, got {q_max}")
        scratch, warps = None, 0
        if q_max > MAX_REGISTER_QUERY and long_in_scratch(q_max):
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            warps = min(b, LONG_WARPS_PER_SM * sms)
            scratch = torch.empty(2 * long_stride(q_max) * warps, dtype=torch.int32, device=dev)
        self.launch(dev, *(batch[k].data_ptr() for k in BATCH_DTYPES), out.data_ptr(), b,
                    q_max, *params, 0 if scratch is None else scratch.data_ptr(), warps)
        return out


bsw_extend = BswExtendKernel()
