"""The banded Smith-Waterman recurrence alone: the stripped side of the bsw
roofline probe.

Counterpart of tools/bsw_roofline.py's Pallas probe `_stripped_kernel`
(wrapper `_stripped`), whose CUDA kernel is csrc/bsw_stripped.cu.  Pairs
are columns, as in the JAX layout: query codes `q_codes` int32 [qe_pad, B]
(rows past the query hold code 5), target codes `target` int32 [tp, B].
From the H and E columns `h_init`, `e_init` int32 [qe_pad, B] it runs every
target row over every query row,

    qsc = q == t[i] ? match : -mismatch;  M = H != 0 ? H + qsc : 0
    c = max(M - oe_ins, 0);  F_j = max(max_{k<j} max(c_k + k*e_ins, NEG)
                                       - (j-1)*e_ins, 0)
    E = max(E - e_del, max(M - oe_del, 0));  H_j = max(M, E, F)_{j-1}, H_0 = 0

in int32 that wraps, and returns the final H and E, int32 [2, qe_pad, B].
The Pallas kernel returned H[:8] and never initialised its H/E scratch, so
its output was whatever the scratch held: interpret mode's
`uninitialized_memory="zero"` is the zero start, and its default `"nan"`
fills int32 scratch with INT32_MAX.  `params` is (o_del, e_del, o_ins,
e_ins, match, mismatch); the probe uses PARAMS.

`bsw_stripped` dispatches on the device: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, whose wrapper (`bsw_stripped_cuda`)
raises on anything else and counts its launches.  The kernel's register
instances cover qe_pad up to MAX_REGISTER_QE_PAD (a query of 512 bases, the
widest register instance of bsw_extend); above it a second kernel steps
each target row over chunks of 512 query rows, so every qe_pad runs.
"""

from __future__ import annotations

import ctypes

import torch

from .kernel import CudaKernel, check_tensor, require_cuda, with_defaults

SOURCE = "bsw_stripped"
NEG = -(1 << 20)
PARAMS = (6, 1, 6, 1, 1, 4)  # tools/bsw_roofline.py's sparams
PAD_CODE = 5  # query rows past the query
# lanes a pair for each qe_pad edge of the kernel's instances, measured on
# the card (tools/probe_lanes.py, PERF.md); built as
# -DBSW_STRIPPED_LANES_<edge>
LANES = {8: 8, 16: 8, 32: 16, 64: 8, 136: 8, 264: 16, 520: 32}
EDGES = tuple(LANES)
MAX_REGISTER_QE_PAD = EDGES[-1]  # qe_pad_of(512)
LONG_CHUNK = 512  # query rows a chunk of the long-column kernel (a warp a pair)


def qe_pad_of(qlen: int) -> int:
    """The padded query rows: qlen + 1 rounded up to a multiple of 8."""
    return -(-(qlen + 1) // 8) * 8


def layout(qe_pad: int) -> tuple:
    """(edge, lanes a pair, rows a lane) of the instance that `qe_pad` picks:
    the first edge at or above it, K = ceil(edge / lanes); past the widest,
    the long-column kernel: (qe_pad rounded up to whole chunks, 32, 16)."""
    if qe_pad > MAX_REGISTER_QE_PAD:
        return -(-qe_pad // LONG_CHUNK) * LONG_CHUNK, 32, LONG_CHUNK // 32
    edge = next(e for e in EDGES if e >= qe_pad)
    return edge, LANES[edge], -(-edge // LANES[edge])


def bsw_stripped_plain(q_codes, target, h_init, e_init, params=PARAMS) -> torch.Tensor:
    """The plain PyTorch version: one step a target row over the [qe_pad, B]
    columns, the F prefix as a `torch.cummax`, as the Pallas kernel."""
    o_del, e_del, o_ins, e_ins, match, mismatch = params
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    j = torch.arange(q_codes.shape[0], dtype=torch.int32, device=q_codes.device)[:, None]
    neg_row = torch.full_like(h_init[:1], NEG)
    zero_row = torch.zeros_like(h_init[:1])
    h, e = h_init.clone(), e_init.clone()
    for i in range(target.shape[0]):
        qsc = torch.where(q_codes == target[i], match, -mismatch).to(torch.int32)
        m = torch.where(h != 0, h + qsc, 0)
        c = torch.clamp(m - oe_ins, min=0)
        gmax = torch.cummax(torch.clamp(c + j * e_ins, min=NEG), 0).values
        f = torch.clamp(torch.cat([neg_row, gmax[:-1]]) - (j - 1) * e_ins, min=0)
        h_row = torch.maximum(torch.maximum(m, e), f)
        e = torch.maximum(e - e_del, torch.clamp(m - oe_del, min=0))
        h = torch.cat([zero_row, h_row[:-1]])
    return torch.stack([h, e])


def _check_params(name, params):
    if len(params) != 6 or not all(isinstance(v, int) for v in params):
        raise ValueError(f"{name}: params must be 6 ints (o_del, e_del, o_ins, e_ins, match, "
                         f"mismatch)")


class BswStrippedKernel(CudaKernel):
    def __init__(self, defines=()):
        super().__init__("bsw_stripped", SOURCE,
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
                         "bsw_stripped_error_string",
                         with_defaults(((f"BSW_STRIPPED_LANES_{e}", n) for e, n in LANES.items()),
                                       defines))

    def __call__(self, q_codes, target, h_init, e_init, params=PARAMS) -> torch.Tensor:
        dev = q_codes.device
        _check_params(self.name, params)
        if q_codes.dim() != 2 or target.dim() != 2:
            raise ValueError(f"{self.name}: q_codes and target must be 2-D [rows, B]")
        qe_pad, b = q_codes.shape
        require_cuda(self.name, dev)
        check_tensor(self.name, "q_codes", q_codes, dev, torch.int32)
        check_tensor(self.name, "target", target, dev, torch.int32, (target.shape[0], b))
        check_tensor(self.name, "h_init", h_init, dev, torch.int32, (qe_pad, b))
        check_tensor(self.name, "e_init", e_init, dev, torch.int32, (qe_pad, b))
        out = torch.empty((2, qe_pad, b), dtype=torch.int32, device=dev)
        if out.numel():
            self.launch(dev, q_codes.data_ptr(), target.data_ptr(), h_init.data_ptr(),
                        e_init.data_ptr(), out.data_ptr(), qe_pad, target.shape[0], b, *params)
        return out


bsw_stripped_cuda = BswStrippedKernel()
KERNELS = (bsw_stripped_cuda,)


def bsw_stripped(q_codes, target, h_init, e_init, params=PARAMS) -> torch.Tensor:
    """int32 [2, qe_pad, B], the final H and E: the kernel for CUDA tensors
    (it launches or raises), the plain version for CPU tensors."""
    if q_codes.device.type == "cpu":
        _check_params("bsw_stripped_plain", params)
        return bsw_stripped_plain(q_codes, target, h_init, e_init, params)
    return bsw_stripped_cuda(q_codes, target, h_init, e_init, params)
