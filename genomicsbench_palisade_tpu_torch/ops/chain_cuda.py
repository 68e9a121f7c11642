"""ctypes wrapper of the anchor-chaining kernel (csrc/chain_dp.cu).

Counterpart of genomicsbench_palisade_tpu/ops/chain_pallas.py:
chain_dp_pallas_batch and its `_kernel`.  `chain_dp` checks what it is
given, launches on PyTorch's current stream without synchronising, raises
if the launch was refused, and counts its launches in `launches`.  The
library is built at the first call, never at import.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build

SOURCE = "chain_dp"
# the flat batch's tensors (ops/chain.py), in the order of the C signature
BATCH_DTYPES = {"x_lo": torch.int32, "qi": torch.int32, "qspan": torch.int32,
                "st_eff": torch.int32, "off": torch.int64, "n": torch.int32,
                "gap_table": torch.int32}
PER_ANCHOR = ("x_lo", "qi", "qspan", "st_eff")


class ChainDpKernel:
    """The chain_dp kernel: per anchor the int32 score, parent and peak."""

    name = "chain_dp"

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._errstr = None

    def _load(self):
        if self._fn is None:
            lib = build.load(SOURCE)
            fn = lib.chain_dp
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int64]
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            errstr = lib.chain_error_string
            errstr.argtypes = [ctypes.c_int]
            errstr.restype = ctypes.c_char_p
            self._fn, self._errstr = fn, errstr
        return self._fn

    def _check(self, batch, params):
        dev = batch["n"].device
        if dev.type != "cuda":
            raise ValueError(f"{self.name} runs on CUDA tensors, got {dev}")
        if len(params) != 3 or not all(isinstance(v, int) for v in params) or params[2] < 0:
            raise ValueError(f"{self.name}: params must be the ints (max_dist_x, max_dist_y, bw)")
        n_total = batch["x_lo"].shape[0]
        c = batch["n"].shape[0]
        want = {**{k: (n_total,) for k in PER_ANCHOR}, "off": (c,), "n": (c,),
                "gap_table": (c, params[2] + 1)}
        for k, dtype in BATCH_DTYPES.items():
            t = batch[k]
            if t.device != dev:
                raise ValueError(f"{self.name}: {k} is on {t.device}, expected {dev}")
            if t.dtype != dtype:
                raise ValueError(f"{self.name}: {k} has dtype {t.dtype}, expected {dtype}")
            if tuple(t.shape) != want[k]:
                raise ValueError(f"{self.name}: {k} has shape {tuple(t.shape)}, expected {want[k]}")
            if not t.is_contiguous():
                raise ValueError(f"{self.name}: {k} is not contiguous")
        return dev, c, n_total

    def __call__(self, batch, params) -> torch.Tensor:
        """[3, N] int32 (scores, call-local parents, peaks) for the flat
        batch (see ops.chain).  The batch's `off` and `n` must describe
        calls that lie inside the N anchors: the kernel trusts them."""
        dev, c, n_total = self._check(batch, params)
        out = torch.empty((3, n_total), dtype=torch.int32, device=dev)
        if c == 0 or n_total == 0:
            return out
        fn = self._load()
        # the oracle's targets start at 0: a leftover value equal to some i
        # would count a false skip and move the max_skip break
        targets = torch.zeros(n_total, dtype=torch.int32, device=dev)
        # a block a call, in order of call length, longest first: the
        # longest chains start first
        order = torch.argsort(batch["n"], descending=True, stable=True).to(torch.int32)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*(batch[k].data_ptr() for k in BATCH_DTYPES), order.data_ptr(),
                     targets.data_ptr(), out.data_ptr(), c, n_total, *params, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: {self._errstr(err).decode()}")
        self.launches += 1
        return out


chain_dp = ChainDpKernel()
