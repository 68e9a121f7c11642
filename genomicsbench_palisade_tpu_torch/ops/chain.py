"""minimap2 anchor-chaining DP (mm_chain_dp semantics, n_segs == 1).

Counterpart of genomicsbench_palisade_tpu/ops/chain.py (`prepare_call`,
the windowed scan `_chain_dp_core` and its batched form) and of its TPU
kernel ops/chain_pallas.py:_kernel.

`prepare_call` does the exact host precomputation in numpy: the window
start st (a searchsorted over the sorted x, clamped to i - MAX_ITER), the
query position qi, the span qspan, the low 32 bits x_lo of x (inside the
window dr = x[i] - x[j] <= max_dist_x, so the u32 difference of the low
words is exact and the whole DP is int32), and the gap cost over dd in
[0, bw] as a float64 table bit-identical to the reference's double
arithmetic.

A batch is flat: calls concatenated along the anchor axis, no padding
(`convert.chain_batch_from_numpy` builds it):

    x_lo, qi, qspan, st_eff  [N] int32   st_eff call-local
    off                      [C] int64   first anchor of each call
    n                        [C] int32   anchors of each call
    gap_table                [C, bw+1] int32
and the ints (max_dist_x, max_dist_y, bw) shared by the batch.

`chain_dp` runs the CUDA kernel (csrc/chain_dp.cu) for CUDA tensors and
the plain PyTorch version for CPU tensors.  Both return [3, N] int32:
scores, call-local parents (-1 for none), peaks.

The plain version is the JAX scan batched over calls: one vectorized step
per anchor index over a [C, w] predecessor window, where the reference's
descending visit order becomes a reversed `torch.cummax` (the exclusive
running max), the `targets[parents[j]] = i` marks a `scatter_reduce`, and
the 0-clamped max_skip counter a reflected walk (`cumsum`, `torch.cummin`)
whose first excess is the break.  Every value is int32, so kernel, plain
version, JAX scan and oracle agree bit for bit.

A batch may carry "first" [C] int32: rows [0, first) of each call are then
preset in the `out` the caller gives (its scores, call-local parents and
peaks) and not recomputed, and the anchors from `first` on are computed
after them.  A shard of one call in the sharded runtime
(parallel/dp.chain_dp_halo_sharded) is the previous shard's last w anchors,
preset, then its own.  `window_clamp` limits each anchor's predecessors to
its last w, as the JAX scan's window does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import default_device
from ..convert import chain_arrays
from . import chain_cuda

MAX_ITER = 5000
MAX_SKIP = 25
NEG = -(1 << 30)
MIN_WINDOW = 16


def prepare_call(x, y, avg_qspan, max_dist_x=5000, max_dist_y=5000, bw=500, n_segs=1):
    """Host-side exact precomputation for one call.

    x, y: uint64 anchor arrays (x must be non-decreasing — minimap2's
    chaining precondition).  Returns a dict of numpy arrays and metadata.
    """
    if n_segs != 1:
        raise ValueError("n_segs > 1 goes to the oracle (cli.chain.run_calls routes it)")
    x = np.asarray(x, dtype=np.uint64)
    y = np.asarray(y, dtype=np.uint64)
    n = len(x)
    if not np.all(x[1:] >= x[:-1]):
        raise ValueError("anchors must be sorted by x (cli.chain.run_calls routes others "
                         "to the oracle)")

    # exact sequential st: advance while ri > x[st]+max_dist_x (monotone x
    # makes the stopping condition monotone, so searchsorted is exact)
    xp = x + np.uint64(max_dist_x)
    s = np.searchsorted(xp, x, side="left").astype(np.int64)
    st = np.minimum(np.maximum.accumulate(s), np.arange(n))
    st_eff = np.maximum(st, np.arange(n) - MAX_ITER).astype(np.int32)

    qi = x_lo_to_i32(y)  # (int32)y
    qspan = ((y >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    x_lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    # exact float64 gap-cost table over dd in [0, bw]
    dd = np.arange(bw + 1, dtype=np.float64)
    c_lin = (dd * 0.01 * np.float64(np.float32(avg_qspan))).astype(np.int64)
    log_dd = np.zeros(bw + 1, dtype=np.int64)
    v = np.arange(bw + 1)
    log_dd[1:] = np.floor(np.log2(v[1:])).astype(np.int64)
    gap = c_lin + (log_dd >> 1)
    # sc -= (int)((double)gap_cost * gap_scale + .499) with gap_scale=1.0
    gap_table = (gap.astype(np.float64) * 1.0 + 0.499).astype(np.int64).astype(np.int32)

    w_need = int(np.max(np.arange(n) - st_eff)) if n else 0
    return {
        "n": n,
        "x_lo": x_lo,
        "qi": qi,
        "qspan": qspan,
        "st_eff": st_eff,
        "gap_table": gap_table,
        "max_dist_x": max_dist_x,
        "max_dist_y": max_dist_y,
        "bw": bw,
        "w_need": w_need,
    }


def x_lo_to_i32(y):
    return (y & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)


def window_clamp(prep: dict, w: int) -> dict:
    """The call with each anchor's predecessors limited to its last w
    (st_eff[i] = max(st_eff[i], i - w)): the JAX scan's window of w
    (`in_win`, genomicsbench_palisade_tpu/ops/chain.py:135).  At
    w >= w_need the call is unchanged."""
    st = np.maximum(np.asarray(prep["st_eff"]), np.arange(prep["n"]) - w).astype(np.int32)
    w_need = int(np.max(np.arange(prep["n"]) - st)) if prep["n"] else 0
    return {**prep, "st_eff": st, "w_need": w_need}


def window_size(w_need: int) -> int:
    """The plain version's window: the next power of two >= w_need, at
    least MIN_WINDOW (the JAX package's rule, ops/chain.py:268-270)."""
    return max(1 << max(int(w_need) - 1, 0).bit_length(), MIN_WINDOW)


def chain_dp_plain(batch, params, stats: dict | None = None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version: [3, N] int32 (scores, call-local parents,
    peaks) on the batch's device.  With "first" in the batch, `out` holds
    the preset rows [0, first) of each call; the rest are written into it.

    Pads the flat batch to [C, n_max] and takes one step per anchor index
    over a [C, w] window.  The padded arrays are kept in reverse anchor
    order, so the window of anchor i is one slice already in the
    reference's visit order: slot t holds j = i-1-t.  `stats`, when given,
    gets added: "predecessors", the predecessors the reference's loop visits
    (from i-1 down to the break, the break included, or to st_eff[i]);
    "eligible", those of them that pass the skip tests and score;
    "breaks", the anchors whose visit ended at the max_skip break;
    "predecessors_max_call", the largest count of one call (the longest
    dependent chain)."""
    max_dist_x, max_dist_y, bw = params
    off, n = batch["off"], batch["n"]
    dev = n.device
    n_total = batch["x_lo"].shape[0]
    first = batch.get("first")
    if first is None:  # no preset rows
        first = torch.zeros_like(n)
        out = torch.zeros((3, n_total), dtype=torch.int32, device=dev)
    elif out is None:
        raise ValueError("a batch with `first` needs `out` with the preset rows")
    c = n.shape[0]
    if c == 0 or n_total == 0:
        return out
    n_max = int(n.max())
    k = torch.arange(n_max, dtype=torch.int64, device=dev)
    valid = k[None, :] < n[:, None]
    idx = torch.where(valid, off[:, None] + k[None, :], 0)

    def pad(a):
        return torch.where(valid, a[idx], 0)

    qspan = pad(batch["qspan"])
    span = torch.where(valid, k[None, :].int() - batch["st_eff"][idx], 0)  # i - st_eff[i]
    w = window_size(int(span.max()))
    gap_table = batch["gap_table"]
    dq_max = min(max_dist_x, max_dist_y)

    # reversed padded layout: anchor i at column n_max-1-i, w zero columns
    # after the first anchor, so the window of anchor i is [n_max-i, n_max-i+w)
    zero_cols = torch.zeros((c, w), dtype=torch.int32, device=dev)
    x_r = torch.cat([pad(batch["x_lo"]).flip(1), zero_cols], dim=1)
    q_r = torch.cat([pad(batch["qi"]).flip(1), zero_cols], dim=1)
    scores = torch.zeros((c, n_max + w), dtype=torch.int32, device=dev)
    parents = torch.full((c, n_max + w), -1, dtype=torch.int32, device=dev)
    peaks = torch.zeros((c, n_max + w), dtype=torch.int32, device=dev)
    # the preset rows, where the window reads them
    first = first.to(torch.int64)
    preset = valid & (k[None, :] < first[:, None])
    for state, row, fill in ((scores, 0, 0), (parents, 1, -1), (peaks, 2, 0)):
        state[:, :n_max] = torch.where(preset, out[row][idx], fill).flip(1)
    i0 = int(first.min())
    t_idx = torch.arange(w, dtype=torch.int32, device=dev)  # slot t: j = i-1-t
    neg_col = torch.full((c, 1), NEG, dtype=torch.int32, device=dev)
    visits = torch.zeros(c, dtype=torch.int64, device=dev)
    eligible_n = torch.zeros((), dtype=torch.int64, device=dev)
    breaks = torch.zeros((), dtype=torch.int64, device=dev)

    for i in range(i0, n_max):
        lo = n_max - i
        win = slice(lo, lo + w)
        qspan_i = qspan[:, i : i + 1]
        span_i = span[:, i : i + 1]

        dr = x_r[:, lo - 1 : lo] - x_r[:, win]  # int32 wrap == u32 wrap of x_lo
        dq = q_r[:, lo - 1 : lo] - q_r[:, win]
        dd = (dr - dq).abs()
        eligible = ((t_idx < span_i) & (dr != 0) & (dq > 0) & (dq <= dq_max) & (dd <= bw))
        min_d = torch.minimum(torch.minimum(dq, dr), qspan_i)
        gap = gap_table.gather(1, dd.clamp(0, bw).long())
        sc = torch.where(eligible, min_d - gap + scores[:, win], NEG)

        # exclusive running max in visit order
        rm = torch.cat([neg_col, torch.cummax(sc, dim=1).values[:, :-1]], dim=1)
        improve = (sc > torch.maximum(rm, qspan_i)) & eligible

        # marks: targets[parents[j]] = i for every eligible j, at the
        # parent's slot i-1-parents[j] (slot w takes the rest)
        par_win = parents[:, win]
        mark_t = (i - 1) - par_win
        do_mark = eligible & (par_win >= 0) & (mark_t < w)
        marked = torch.zeros((c, w + 1), dtype=torch.bool, device=dev).scatter_(
            1, torch.where(do_mark, mark_t, w).long(), True)[:, :w]
        skip = eligible & ~improve & marked

        # n_skip: +1 a skip, -1 an improvement, clamped at 0; the first
        # skip that takes it past MAX_SKIP is the break
        walk = torch.cumsum(skip.int() - improve.int(), dim=1, dtype=torch.int32)
        clamped = walk - torch.clamp(torch.cummin(walk, dim=1).values, max=0)
        brk_t = torch.where(skip & (clamped > MAX_SKIP), t_idx, w).min(dim=1).values

        sc_proc = torch.where(t_idx[None, :] < brk_t[:, None], sc, NEG)
        m = sc_proc.max(dim=1).values
        has = m > qspan_i[:, 0]
        # the first strict improvement in visit order: the largest j of the max
        t_best = torch.where(sc_proc == m[:, None], t_idx, w).min(dim=1).values
        max_f = torch.where(has, m, qspan_i[:, 0])
        max_j = torch.where(has, i - 1 - t_best, -1)
        peak_parent = peaks.gather(1, (n_max - 1 - max_j)[:, None].long())[:, 0]
        peak = torch.where((max_j >= 0) & (peak_parent > max_f), peak_parent, max_f)
        keep = i < first
        for state, new in ((scores, max_f), (parents, max_j), (peaks, peak)):
            state[:, lo - 1] = torch.where(keep, state[:, lo - 1], new)

        if stats is not None:
            live = (i < n) & (i >= first)
            visits += torch.where(live, torch.where(brk_t < w, brk_t + 1, span_i[:, 0]), 0)
            eligible_n += (eligible & (t_idx[None, :] <= brk_t[:, None]) & live[:, None]).sum()
            breaks += (live & (brk_t < w)).sum()

    if stats is not None:
        stats["predecessors"] = stats.get("predecessors", 0) + int(visits.sum())
        stats["eligible"] = stats.get("eligible", 0) + int(eligible_n)
        stats["breaks"] = stats.get("breaks", 0) + int(breaks)
        stats["predecessors_max_call"] = max(stats.get("predecessors_max_call", 0),
                                             int(visits.max()))
    flat = idx[valid]
    for row, state in enumerate((scores, parents, peaks)):
        out[row, flat] = state[:, :n_max].flip(1)[valid]
    return out


def chain_dp(batch, params, out: torch.Tensor | None = None) -> torch.Tensor:
    """[3, N] int32 (scores, call-local parents, peaks) on the batch's
    device: the CUDA kernel for CUDA tensors (it launches or raises), the
    plain version for CPU tensors.  A batch with "first" needs `out`, the
    preset rows, which both write the other rows into."""
    dev = batch["n"].device
    if dev.type == "cuda":
        return chain_cuda.chain_dp(batch, params, out)
    if dev.type == "cpu":
        return chain_dp_plain(batch, params, out=out)
    raise ValueError(f"unsupported device {dev}")


def empty_result():
    z = np.zeros(0, np.int32)
    return z, z.astype(np.int64), z


def chain_calls(preps, device=None, stats: dict | None = None, keep: list | None = None):
    """Run a list of prepare_call dicts; returns (scores, parents int64,
    peaks) numpy tuples in input order.

    Empty calls short-circuit; the rest go as one flat batch per
    (max_dist_x, max_dist_y, bw) group, one launch each.  `stats`, when
    given, accumulates wall seconds per phase: "pack_s" (the flat numpy
    arrays), "h2d_s", "kernel_s" (to the last launch's end) and "d2h_s"
    (results back and split per call).  `keep`, when given, gets one dict
    per launch: "batch" (the tensors it was given), "params" and "out"
    (its [3, N] result on the device)."""
    device = default_device(device)
    stats = {} if stats is None else stats
    for k in ("pack_s", "h2d_s", "kernel_s", "d2h_s"):
        stats.setdefault(k, 0.0)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    results = [None] * len(preps)
    groups: dict = {}
    for i, p in enumerate(preps):
        if p["n"] == 0:
            results[i] = empty_result()
            continue
        groups.setdefault((p["max_dist_x"], p["max_dist_y"], p["bw"]), []).append(i)

    for members in groups.values():
        t0 = time.perf_counter()
        arrays, params = chain_arrays([preps[i] for i in members])
        t1 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        sync()
        t2 = time.perf_counter()
        out = chain_dp(batch, params)
        sync()
        t3 = time.perf_counter()
        res = out.cpu().numpy()
        for i, lo, nn in zip(members, arrays["off"].tolist(), arrays["n"].tolist()):
            results[i] = (res[0, lo : lo + nn], res[1, lo : lo + nn].astype(np.int64),
                          res[2, lo : lo + nn])
        t4 = time.perf_counter()
        if keep is not None:
            keep.append({"batch": batch, "params": params, "out": out})
        stats["pack_s"] += t1 - t0
        stats["h2d_s"] += t2 - t1
        stats["kernel_s"] += t3 - t2
        stats["d2h_s"] += t4 - t3
    return results


def chain_call(prep, device=None):
    """One prepared call: numpy (scores, parents int64, peaks)."""
    return chain_calls([prep], device)[0]
