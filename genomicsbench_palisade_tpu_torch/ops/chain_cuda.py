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

from .kernel import CudaKernel, check_tensor, require_cuda

SOURCE = "chain_dp"
# the flat batch's tensors (ops/chain.py), in the order of the C signature
BATCH_DTYPES = {"x_lo": torch.int32, "qi": torch.int32, "qspan": torch.int32,
                "st_eff": torch.int32, "off": torch.int64, "n": torch.int32,
                "gap_table": torch.int32}
PER_ANCHOR = ("x_lo", "qi", "qspan", "st_eff")


class ChainDpKernel(CudaKernel):
    """The chain_dp kernel: per anchor the int32 score, parent and peak."""

    def __init__(self):
        super().__init__("chain_dp", SOURCE,
                         [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int64]
                         + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                         "chain_error_string")

    def _check(self, batch, params):
        dev = batch["n"].device
        require_cuda(self.name, dev)
        if len(params) != 3 or not all(isinstance(v, int) for v in params) or params[2] < 0:
            raise ValueError(f"{self.name}: params must be the ints (max_dist_x, max_dist_y, bw)")
        n_total = batch["x_lo"].shape[0]
        c = batch["n"].shape[0]
        want = {**{k: (n_total,) for k in PER_ANCHOR}, "off": (c,), "n": (c,),
                "gap_table": (c, params[2] + 1)}
        for k, dtype in BATCH_DTYPES.items():
            check_tensor(self.name, k, batch[k], dev, dtype, want[k])
        if "first" in batch:
            check_tensor(self.name, "first", batch["first"], dev, torch.int32, (c,))
        return dev, c, n_total

    def __call__(self, batch, params, out: torch.Tensor | None = None) -> torch.Tensor:
        """[3, N] int32 (scores, call-local parents, peaks) for the flat
        batch (see ops.chain).  The batch's `off` and `n` must describe
        calls that lie inside the N anchors, and st_eff[i] must be at least
        i - MAX_ITER (prepare_call's clamp): the kernel trusts them.  With
        "first" [C] int32 in the batch, `out` must hold each call's preset
        rows [0, first); the kernel writes the rest into it."""
        dev, c, n_total = self._check(batch, params)
        first = batch.get("first")
        if first is None:
            out = torch.empty((3, n_total), dtype=torch.int32, device=dev)
        elif out is None:
            raise ValueError(f"{self.name}: a batch with `first` needs `out` with the preset rows")
        else:
            check_tensor(self.name, "out", out, dev, torch.int32, (3, n_total))
        if c == 0 or n_total == 0:
            return out
        # a warp a call, in order of call length, longest first: the
        # longest chains start first
        order = torch.argsort(batch["n"], descending=True, stable=True).to(torch.int32)
        self.launch(dev, *(batch[k].data_ptr() for k in BATCH_DTYPES),
                    None if first is None else first.data_ptr(), order.data_ptr(),
                    out.data_ptr(), c, n_total, *params)
        return out


chain_dp = ChainDpKernel()
