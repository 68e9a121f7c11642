"""The minimap2 chaining recurrence alone: the micro side of the chain
roofline probe.

Counterpart of tools/chain_roofline.py's Pallas probe `_micro_kernel`
(wrapper `micro_batch`), whose CUDA kernel is csrc/chain_micro.cu.  Calls
are rows, as in the JAX layout: `x_lo`, `qi`, `qspan` int32 [B, n_pad],
the Q20 gap slope `m_fp` and the gap offset `gap0` int32 [B].  For each
anchor i and each of the w anchors j before it,

    dr = int32(uint32(x_i) - uint32(x_j)),  dq = q_i - q_j,  dd = |dr - dq|
    eligible: dr != 0, 0 < dq <= MAX_DIST (max_dist_x and _y), dd <= bw
    gap = gap0 + (uint32(dd * m) >> 20) + (#{k in 1..n_log : dd >= 2^k} >> 1)
    sc_i = max(max over eligible j of (min(dq, dr, qspan_i) - gap + sc_j), qspan_i)

in int32 that wraps, with n_log = max(floor(log2 max(bw, 2)), 1); returns sc
int32 [B, n_pad].  Anchors i < w see phantom predecessors at x = q = 0 with
score 0, as the Pallas wrapper's zero halo gave them, and those pass the
eligibility test too.  The Pallas kernel's chunks of nc anchors carried
the last w scores across, so chunking does not show in the result and the
port does not chunk.

`chain_micro` dispatches on the device: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, whose wrapper (`chain_micro_cuda`)
raises on anything else and counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from .kernel import CudaKernel, check_tensor, require_cuda, with_defaults

SOURCE = "chain_micro"
NEG = -(1 << 28)
MAX_DIST = 5000  # max_dist_x and max_dist_y, both fixed to it by micro_batch
# register banks of 32 window slots, measured on the card
# (tools/probe_lanes.py, PERF.md); built as -DCHAIN_MICRO_BANKS
BANKS = 8


def n_log_of(bw: int) -> int:
    """max(floor(log2 max(bw, 2)), 1): the gap's log term counts that many
    powers of two."""
    return max(max(bw, 2).bit_length() - 1, 1)


def chain_micro_plain(x_lo, qi, qspan, m_fp, gap0, w, bw) -> torch.Tensor:
    """The plain PyTorch version: one step an anchor over a [B, w] window of
    the zero-padded arrays, as the Pallas kernel's loop body."""
    b, n = x_lo.shape
    pad = torch.zeros((b, w), dtype=torch.int32, device=x_lo.device)
    xs, qs = torch.cat([pad, x_lo], 1), torch.cat([pad, qi], 1)
    sc = torch.cat([pad, torch.empty_like(x_lo)], 1)
    m, g0 = m_fp[:, None], gap0[:, None]
    powers = [1 << k for k in range(1, n_log_of(bw) + 1)]
    for i in range(n):
        span = qspan[:, i : i + 1]
        dr = xs[:, i + w : i + w + 1] - xs[:, i : i + w]
        dq = qs[:, i + w : i + w + 1] - qs[:, i : i + w]
        dd = (dr - dq).abs()
        eligible = (dr != 0) & (dq > 0) & (dq <= MAX_DIST) & (dd <= bw)
        lin = (dd * m >> 20) & 0xFFF  # the logical shift of the wrapped product
        ilog = sum((dd >= p).to(torch.int32) for p in powers)
        gap = g0 + lin + (ilog >> 1)
        min_d = torch.minimum(torch.minimum(dq, dr), span)
        cand = torch.where(eligible, min_d - gap + sc[:, i : i + w], NEG)
        sc[:, i + w] = torch.maximum(cand.max(1).values, span[:, 0])
    return sc[:, w:].contiguous()


def _check_params(name, w, bw):
    if not (isinstance(w, int) and isinstance(bw, int)) or w < 1:
        raise ValueError(f"{name}: w (>= 1) and bw must be ints")


class ChainMicroKernel(CudaKernel):
    def __init__(self, defines=()):
        super().__init__("chain_micro", SOURCE,
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
                         "chain_micro_error_string",
                         with_defaults((("CHAIN_MICRO_BANKS", BANKS),), defines))

    def __call__(self, x_lo, qi, qspan, m_fp, gap0, w, bw) -> torch.Tensor:
        dev = x_lo.device
        require_cuda(self.name, dev)
        _check_params(self.name, w, bw)
        if x_lo.dim() != 2:
            raise ValueError(f"{self.name}: x_lo must be 2-D [B, n_pad]")
        b, n = x_lo.shape
        for key, t in (("x_lo", x_lo), ("qi", qi), ("qspan", qspan)):
            check_tensor(self.name, key, t, dev, torch.int32, (b, n))
        for key, t in (("m_fp", m_fp), ("gap0", gap0)):
            check_tensor(self.name, key, t, dev, torch.int32, (b,))
        out = torch.empty((b, n), dtype=torch.int32, device=dev)
        if out.numel():
            self.launch(dev, x_lo.data_ptr(), qi.data_ptr(), qspan.data_ptr(), m_fp.data_ptr(),
                        gap0.data_ptr(), out.data_ptr(), b, n, w, MAX_DIST, bw)
        return out


chain_micro_cuda = ChainMicroKernel()
KERNELS = (chain_micro_cuda,)


def chain_micro(x_lo, qi, qspan, m_fp, gap0, w, bw) -> torch.Tensor:
    """sc int32 [B, n_pad]: the kernel for CUDA tensors (it launches or
    raises), the plain version for CPU tensors."""
    if x_lo.device.type == "cpu":
        _check_params("chain_micro_plain", w, bw)
        return chain_micro_plain(x_lo, qi, qspan, m_fp, gap0, w, bw)
    return chain_micro_cuda(x_lo, qi, qspan, m_fp, gap0, w, bw)
