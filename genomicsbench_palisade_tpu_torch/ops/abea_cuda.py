"""ctypes wrappers of the abea kernels (csrc/abea_fill.cu, csrc/abea_walk.cu).

Counterparts of genomicsbench_palisade_tpu/ops/abea_pallas.py:
abea_fill_bands_pallas with its `_kernel`, and abea_walk_pallas with its
`_walk_kernel`.  Each wrapper checks the flat batch (ops/abea.py) and what
it is given, allocates its outputs, launches on PyTorch's current stream
without synchronising, raises if the launch was refused, and counts its
launches in `launches`.  The libraries are built at the first call, never
at import.  The kernels trust the batch's offsets and counts (reads with
ne >= 1 and nk >= 1, band rows as ops.abea.prepare_batch lays them out).
The walk copies whole blocks of trace rows and bll_e with 16-byte copies,
so it refuses a trace or bll_e that does not start on a 16-byte boundary
(a fresh tensor always does).
"""

from __future__ import annotations

import ctypes

import torch

from .kernel import CudaKernel, check_tensor, require_cuda

FILL_SOURCE = "abea_fill"
WALK_SOURCE = "abea_walk"
BANDWIDTH = 100  # the kernels' band width (ALN_BANDWIDTH)
# the flat batch's tensors (ops/abea.py)
BATCH_DTYPES = {"ev": torch.float32, "gm": torch.float32, "stdv": torch.float32,
                "lstdv": torch.float32, "ev_off": torch.int64, "k_off": torch.int64,
                "band_off": torch.int64, "ne": torch.int32, "nk": torch.int32,
                "lp": torch.float64}
PER_KMER = ("gm", "stdv", "lstdv")
PER_READ = ("ev_off", "k_off", "band_off", "ne", "nk")


def check_batch(name, batch):
    """(device, reads, band rows) of a flat batch; raises on a wrong one."""
    dev = batch["ne"].device
    require_cuda(name, dev)
    b = batch["ne"].shape[0]
    want = {"ev": (batch["ev"].shape[0],), **{k: (batch["gm"].shape[0],) for k in PER_KMER},
            **{k: (b,) for k in PER_READ}, "lp": (b, 4)}
    for k, dtype in BATCH_DTYPES.items():
        check_tensor(name, k, batch[k], dev, dtype, want[k])
    return dev, b, batch["ev"].shape[0] + batch["gm"].shape[0] + 2 * b


def _order(batch):
    """Reads longest first (most bands): the longest start first."""
    nb = batch["ne"] + batch["nk"]
    return torch.argsort(nb, descending=True, stable=True).to(torch.int32)


class AbeaFillKernel(CudaKernel):
    """The band fill: trace, bll_e, last_val and seed (ops/abea.py).
    `defines` build a variant (tools/abea_fill_clock.py's)."""

    def __init__(self, defines=()):
        super().__init__("abea_fill", FILL_SOURCE,
                         [ctypes.c_void_p] * 15 + [ctypes.c_int, ctypes.c_void_p],
                         "abea_error_string", defines)

    def __call__(self, batch) -> dict:
        dev, b, rows = check_batch(self.name, batch)
        out = {"trace": torch.empty((rows, BANDWIDTH), dtype=torch.uint8, device=dev),
               "bll_e": torch.empty(rows, dtype=torch.int32, device=dev),
               "last_val": torch.empty(rows, dtype=torch.float32, device=dev),
               "seed": torch.empty(b, dtype=torch.int32, device=dev)}
        if b == 0:
            return out
        order = _order(batch)
        self.launch(dev, *(batch[k].data_ptr() for k in BATCH_DTYPES), order.data_ptr(),
                     *(out[k].data_ptr() for k in ("trace", "bll_e", "last_val", "seed")), b)
        return out


class AbeaWalkKernel(CudaKernel):
    """The traceback: pairs, n, max_gap and sum_em (ops/abea.py)."""

    FILL_DTYPES = {"trace": torch.uint8, "bll_e": torch.int32, "seed": torch.int32}

    def __init__(self):
        super().__init__("abea_walk", WALK_SOURCE,
                         [ctypes.c_void_p] * 17 + [ctypes.c_int, ctypes.c_void_p],
                         "abea_error_string")

    def __call__(self, batch, fill) -> dict:
        dev, b, rows = check_batch(self.name, batch)
        want = {"trace": (rows, BANDWIDTH), "bll_e": (rows,), "seed": (b,)}
        for k, dtype in self.FILL_DTYPES.items():
            check_tensor(self.name, k, fill[k], dev, dtype, want[k])
        for k in ("trace", "bll_e"):
            if fill[k].data_ptr() % 16:
                raise ValueError(f"{self.name}: {k} does not start on a 16-byte boundary")
        out = {"pairs": torch.zeros((rows, 2), dtype=torch.int32, device=dev),
               "n": torch.empty(b, dtype=torch.int32, device=dev),
               "max_gap": torch.empty(b, dtype=torch.int32, device=dev),
               "sum_em": torch.empty(b, dtype=torch.float64, device=dev)}
        if b == 0:
            return out
        order = _order(batch)
        self.launch(dev, *(fill[k].data_ptr() for k in self.FILL_DTYPES),
                     *(batch[k].data_ptr() for k in ("ev", "gm", "stdv", "lstdv", "ev_off",
                                                     "k_off", "band_off", "ne", "nk")),
                     order.data_ptr(),
                     *(out[k].data_ptr() for k in ("pairs", "n", "max_gap", "sum_em")), b)
        return out


abea_fill = AbeaFillKernel()
abea_walk = AbeaWalkKernel()
KERNELS = (abea_fill, abea_walk)
