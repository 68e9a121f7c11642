"""The sharded paths over a torch.distributed group, with explicit collectives.

Counterpart of genomicsbench_palisade_tpu/parallel/dp.py, function for
function, with the mesh first.  Each rank runs the port's single-device
path (its kernel on CUDA, its plain version on the CPU) on its share, and
every function returns, on every rank, what the JAX function returns to
its caller: the global arrays, in the JAX package's row order, or the
replicated scalars.  Inputs are the whole batch on every rank (numpy or
tensors), except `phmm_forward_sharded`, which takes the rows `shard_batch`
gave this rank, as the JAX function takes its sharded batch.

Patterns (the reference's OpenMP loops as data parallelism):
  * phmm, bsw, poa, the abea fill: each rank its contiguous share of the
    batch, the outputs gathered in rank order;
  * kmer: each rank packs and canonicalises its reads, routes each k-mer to
    its owner rank by a mixed hash of the code (the JAX package's murmur3
    fmix32 steps, bit for bit, so every rank's share equals the JAX
    shard's), counts its share by sort-reduce, and the metrics are summed;
  * grm: each rank its variant rows, the two [N, N] sums all-reduced;
  * fmi: the index's cp_occ rows split by block range, every occ lookup
    broadcast by its owner (ops.fmi's ShardAxis route), the reads
    replicated;
  * chain: one call's anchors split into contiguous ranges run in pipeline
    order: rank s receives the last w anchors' results from rank s-1,
    runs one launch of the halo and its own anchors (the kernel's `first`
    entry) and sends its last w to rank s+1.  JAX runs ndev masked rounds
    of every shard instead.

Deliberate differences from the JAX functions' arguments: the port's bsw
and abea batches are flat (codes and offsets; reads concatenated), so they
are sharded by pairs and by reads, not by padded rows, and the bsw result
is the port's [6, B] tensor; the abea fill takes the port's `prepare_batch`
dict, whose per-k-mer levels already hold the model, scales and shifts.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..convert import abea_batch_from_numpy, fmi_index_from_numpy, poa_batch_from_numpy
from ..ops import abea as abea_ops
from ..ops import bsw as bsw_ops
from ..ops import chain as chain_ops
from ..ops import fmi as fmi_ops
from ..ops import fmi_pipeline as FP
from ..ops import grm as grm_ops
from ..ops import kmer as kmer_ops
from ..ops import phmm as phmm_ops
from ..ops import poa as poa_ops
from .mesh import (DP_AXIS, Mesh, all_gather, all_gather_v, all_reduce_sum, all_to_all_v,
                   gather_rows, recv, send)

_U32 = 0xFFFFFFFF
SATURATION = 15  # Flye's 4-bit counter: hash_size counts k-mers seen more often


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """a (numpy, a read-only memory map included, or a tensor) on device."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        if not (a.flags.c_contiguous and a.flags.writeable):
            a = np.array(a, order="C")
        a = torch.from_numpy(a)
    return a.to(device=device, dtype=dtype)


def phmm_forward_sharded(mesh: Mesh, batch: dict, axis: str = DP_AXIS):
    """The f32 forward pass of this rank's rows (`shard_batch`'s), on the
    mesh device: the phmm_forward_f32 kernel on CUDA.  Returns numpy
    (log10, raw, fallback) of every rank's rows in rank order: the padded
    global arrays."""
    log10, raw, fallback = phmm_ops.phmm_forward(batch, device=mesh.device)
    return gather_rows(mesh, log10), gather_rows(mesh, raw), gather_rows(mesh, fallback)


def bsw_batch_sharded(mesh: Mesh, batch: dict, params=bsw_ops.DEFAULT_TUPLE,
                      axis: str = DP_AXIS) -> torch.Tensor:
    """Banded SW extension of a flat pair batch (ops.bsw), each rank its
    share of the pairs through bsw_extend (the kernel on CUDA).  Returns
    the [6, B] int32 outputs (ops.bsw.OUT_ORDER rows) on the mesh device."""
    n = batch["h0"].shape[0]
    rows = mesh.rows(n)
    sub = {k: _tensor(v if k == "codes" else v[rows], mesh.device) for k, v in batch.items()}
    if rows.stop > rows.start:
        out = bsw_ops.bsw_extend(sub, params)
    else:
        out = torch.zeros((6, 0), dtype=torch.int32, device=mesh.device)
    return all_gather_v(mesh, out.T.contiguous()).T.contiguous()


def owner_of(keys: torch.Tensor, n_ranks: int) -> torch.Tensor:
    """The owner rank of each canonical k-mer code: the JAX package's mix of
    the code's u32 halves (hi, lo) (parallel/dp.py:105-111), in u32
    wraparound, mod n_ranks.  A u32 product is taken as two products of 16
    bits, so no int64 product overflows."""
    if n_ranks == 1:
        return torch.zeros_like(keys)

    def mul(x, c):  # x * c mod 2**32
        return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _U32

    x = mul((keys >> 32) & _U32, 0x85EBCA6B) ^ (keys & _U32)
    x ^= x >> 16
    x = mul(x, 0x85EBCA6B)
    x ^= x >> 13
    x = mul(x, 0xC2B2AE35)
    x ^= x >> 16
    return x % n_ranks


def count_kmers_sharded(mesh: Mesh, bases, lengths, k: int = kmer_ops.DEFAULT_K,
                        axis: str = DP_AXIS, return_shard_stats: bool = False):
    """Distributed canonical k-mer counting: each rank packs its reads'
    k-mers, routes them to their owner ranks (`owner_of`; the counts are
    exchanged first, then the codes with split sizes), counts its key range
    by sort-reduce, and the metrics are summed over ranks.

    bases: [B, L] 2-bit codes, lengths: [B].  Returns the dict of ints
    (total_kmers, hash_size, occurrences), equal to ops.kmer's
    count_kmers_device on all reads; with return_shard_stats also
    {"occ", "distinct"} numpy [ranks]: what each rank counted after the
    exchange, the JAX shards' own figures."""
    rows = mesh.rows(len(bases))
    b = _tensor(bases[rows], mesh.device)
    ln = _tensor(lengths[rows], mesh.device)
    code, valid = kmer_ops.pack_kmers(b, ln, k)
    keys = kmer_ops.canonical(code, k)[valid]
    del code
    owner = owner_of(keys, mesh.size)
    order = torch.argsort(owner, stable=True)
    sent = torch.bincount(owner, minlength=mesh.size).tolist()
    mine = all_to_all_v(mesh, keys[order], sent)
    counts = torch.unique_consecutive(torch.sort(mine ^ kmer_ops.SIGN).values,
                                      return_counts=True)[1]
    local = torch.stack([counts.new_tensor(counts.numel()), (counts > SATURATION).sum(),
                         counts.new_tensor(mine.numel())]).to(torch.int64)
    total, over, occ = all_reduce_sum(mesh, local).tolist()
    metrics = {"total_kmers": total, "hash_size": over, "occurrences": occ}
    if return_shard_stats:
        per = all_gather(mesh, local[None, [2, 0]]).cpu().numpy()
        return metrics, {"occ": per[:, 0], "distinct": per[:, 1]}
    return metrics


def _index_arrays(index):
    """(cp_occ, count, sentinel) of a port DeviceFmIndex or an index dict
    (the port's cp_occ, or the JAX package's cp_pack)."""
    if isinstance(index, dict) and "cp_occ" in index:
        return index["cp_occ"], index["count"], int(index["sentinel_index"])
    d = fmi_index_from_numpy(index, "cpu")
    return d["cp_occ"], d["count"], d["sentinel_index"]


def _block_range(mesh: Mesh, cp_occ):
    """(rows, block_start): this rank's block range of the whole index's
    cp_occ, ceil(blocks / ranks) rows a rank, the tail zero-padded."""
    per = -(-cp_occ.shape[0] // mesh.size)
    start = mesh.rank * per
    rows = _tensor(cp_occ[start : start + per], "cpu", torch.int64)
    return torch.cat([rows, rows.new_zeros((per - rows.shape[0], 8))]), start


def _sharded_index(mesh: Mesh, count, sentinel, rows, start) -> dict:
    """This rank's index dict: its cp_occ rows (blocks start ..) and the
    ShardAxis that sends every occ lookup through its owner."""
    return {"cp_occ": _tensor(rows, mesh.device, torch.int64),
            "count": _tensor(count, mesh.device, torch.int64), "sentinel_index": int(sentinel),
            "shard_axis": fmi_ops.ShardAxis(partial(all_reduce_sum, mesh), int(start),
                                            int(rows.shape[0]))}


def fmi_backward_search_sharded(mesh: Mesh, index, enc, lengths, axis: str = DP_AXIS):
    """Exact-match backward search of whole reads over an index split by
    block range across the ranks: each occ lookup gathered by its owner and
    broadcast with one all-reduce; the reads replicated.

    index: a port DeviceFmIndex or an index dict; enc: [B, L] 2-bit codes;
    lengths: [B].  Returns (k, l, s) [B] int64 on the mesh device, as
    repeated backward_ext from the last base's root interval."""
    cp_occ, count, sentinel = _index_arrays(index)
    idx = _sharded_index(mesh, count, sentinel, *_block_range(mesh, cp_occ))
    enc_t = _tensor(enc, mesh.device, torch.int64)
    ln = _tensor(lengths, mesh.device, torch.int64)
    l_max = enc_t.shape[1]
    count = idx["count"]

    def base_at(pos):
        return enc_t.gather(1, pos.clamp(0, l_max - 1)[:, None])[:, 0]

    a0 = base_at(ln - 1)
    k = count[a0.clamp(0, 4)]
    l = count[(3 - a0).clamp(0, 4)]
    s = count[(a0 + 1).clamp(0, 4)] - count[a0.clamp(0, 4)]
    for t in range(l_max - 1):
        a = base_at(ln - 2 - t).clamp(0, 3)
        k2, l2, s2 = fmi_ops.backward_ext(idx, k, l, s, a)
        live = (t < ln - 1) & (s > 0)
        k, l, s = (torch.where(live, new, old) for new, old in ((k2, k), (l2, l), (s2, s)))
    return k, l, s


def grm_sharded(mesh: Mesh, geno_i8, two_f, inv_stdev, ok, block: int = 512,
                axis: str = DP_AXIS):
    """GRM with the variant axis split across the ranks: each rank's blocked
    ZᵀZ and VᵀV over its variant rows (ops.grm.grm_device at its default
    precision, HIGH, as the JAX function's), summed with two all-reduces.  geno_i8: [M, N]; two_f, inv_stdev, ok: [M].  Returns
    (sums, counts) [N, N] float32 on the mesh device."""
    rows = mesh.rows(geno_i8.shape[0])
    sums, counts = grm_ops.grm_device(
        _tensor(geno_i8[rows], mesh.device, torch.int8),
        _tensor(two_f[rows], mesh.device, torch.float32),
        _tensor(inv_stdev[rows], mesh.device, torch.float32),
        _tensor(ok[rows], mesh.device, torch.bool), block)
    return all_reduce_sum(mesh, sums), all_reduce_sum(mesh, counts)


def chain_dp_halo_sharded(mesh: Mesh, call: dict, w: int, axis: str = DP_AXIS):
    """One chain call with its anchor axis split across the ranks, each
    anchor's predecessors limited to its last w (ops.chain.window_clamp,
    the JAX scan's window).  Rank s waits for the results of rank s-1's
    last w anchors (the halo), runs one launch over halo and own anchors
    (the halo preset, `first` = w), and sends its own last w on: minimap2's
    sequential order, equal to the windowed single-device run.

    call: a prepare_call dict.  Returns numpy (scores, parents int64,
    peaks)[:n], on every rank."""
    n = call["n"]
    per = -(-n // mesh.size)
    if per < w:
        raise ValueError(f"each rank's {per} anchors must cover the window of {w}")
    rows = mesh.rows(n)
    lo, hi = rows.start, rows.stop
    h = w if mesh.rank > 0 else 0  # rank 0 has no halo
    a0 = lo - h
    st = chain_ops.window_clamp(call, w)["st_eff"][a0:hi]
    dev = mesh.device
    out = torch.zeros((3, max(hi - a0, 0)), dtype=torch.int32, device=dev)
    if h and hi > lo:
        halo = recv(mesh, torch.zeros((3, w), dtype=torch.int32, device=dev), mesh.rank - 1)
        par = halo[1]
        halo[1] = torch.where(par >= a0, par - a0, -1)  # call-local, in the shard's call
        out[:, :h] = halo
    if hi > lo:
        batch = {
            "x_lo": _tensor(np.asarray(call["x_lo"]).view(np.int32)[a0:hi], dev),
            "qi": _tensor(np.asarray(call["qi"])[a0:hi], dev, torch.int32),
            "qspan": _tensor(np.asarray(call["qspan"])[a0:hi], dev, torch.int32),
            "st_eff": _tensor(np.maximum(st - a0, 0).astype(np.int32), dev),
            "off": torch.zeros(1, dtype=torch.int64, device=dev),
            "n": torch.tensor([hi - a0], dtype=torch.int32, device=dev),
            "gap_table": _tensor(np.asarray(call["gap_table"], np.int32)[None], dev),
            "first": torch.tensor([h], dtype=torch.int32, device=dev),
        }
        params = (call["max_dist_x"], call["max_dist_y"], call["bw"])
        out = chain_ops.chain_dp(batch, params, out=out)
        out[1] = torch.where(out[1] >= 0, out[1] + a0, -1)  # global parents
        if mesh.rank + 1 < mesh.size and hi < n:
            send(mesh, out[:, -w:].contiguous(), mesh.rank + 1)
    own = out[:, h:] if hi > lo else out[:, :0]
    res = all_gather_v(mesh, own.T.contiguous()).cpu().numpy()
    return res[:, 0], res[:, 1].astype(np.int64), res[:, 2]


def fmi_pipeline_index_sharded(mesh: Mesh, index, enc, readlen, min_seed_len: int = 19,
                               m_cap: int = 96, axis: str = DP_AXIS, shard_rows=None):
    """The 3-phase SMEM pipeline (ops.fmi_pipeline) over an index split by
    cp_occ block range: the reads and the small arrays replicated, every occ
    lookup inside the unchanged pipeline resolved by its owner and one
    all-reduce (ops.fmi's ShardAxis route), so the result equals the
    unsharded engine's.

    index: a port DeviceFmIndex or an index dict (with shard_rows, only its
    count and sentinel_index are read); shard_rows: this rank's
    (cp_occ rows, block_start) from its shard file (load_npz_shard), the
    counterpart of the JAX function's cp_pack_global.  Returns
    fmi_pipeline_device's (packed rows, reseed overflow) on every rank:
    unpack with ops.fmi_pipeline.collect."""
    if shard_rows is None:
        cp_occ, count, sentinel = _index_arrays(index)
        idx = _sharded_index(mesh, count, sentinel, *_block_range(mesh, cp_occ))
    else:
        idx = _sharded_index(mesh, index["count"], index["sentinel_index"], *shard_rows)
    return FP.fmi_pipeline_device(
        idx, _tensor(enc, mesh.device, torch.int64), _tensor(readlen, mesh.device, torch.int64),
        min_seed_len, FP.SPLIT_WIDTH, FP.MAX_MEM_INTV, FP.split_len_of(min_seed_len),
        m_cap=m_cap)


def poa_align_sharded(mesh: Mesh, seq_arr, seq_len, garr_stack, params, w_cap: int,
                      a_cap: int, axis: str = DP_AXIS, atype: str = "nw") -> np.ndarray:
    """Window-sharded POA alignment: each rank its share of the windows
    through ops.poa.poa_align_device.  garr_stack: graph_to_arrays dicts
    stacked on a leading window axis; seq_arr [B, w_cap-1], seq_len [B].
    Returns the packed [B, 2*a_cap+1] rows (aln_i, aln_j, count) in window
    order, as numpy."""
    rows = mesh.rows(len(seq_len))
    if rows.stop > rows.start:
        garrs = [{k: np.asarray(v)[i] for k, v in garr_stack.items()}
                 for i in range(rows.start, rows.stop)]
        batch = poa_batch_from_numpy(garrs, np.asarray(seq_arr)[rows],
                                     np.asarray(seq_len)[rows], mesh.device)
        ai, aj, cnt = poa_ops.poa_align_device(batch, tuple(params), w_cap, a_cap, atype)
        packed = np.concatenate([ai, aj, cnt[:, None]], axis=1).astype(np.int32)
    else:
        packed = np.zeros((0, 2 * a_cap + 1), np.int32)
    return gather_rows(mesh, packed)


def abea_fill_sharded(mesh: Mesh, batch: dict, axis: str = DP_AXIS) -> dict:
    """The abea band fill of a flat read batch (ops.abea.prepare_batch's
    numpy dict), each rank its share of the reads through ops.abea's
    abea_fill (the kernel on CUDA).  Returns the fill's dict for the whole
    batch on the mesh device: trace [R, 100], bll_e [R] and last_val [R] in
    band-row order, seed [B]."""
    n = len(batch["ne"])
    rows = mesh.rows(n)
    keys = ("trace", "bll_e", "last_val", "seed")
    if rows.stop > rows.start:
        lo, hi = rows.start, rows.stop
        ev0, k0 = int(batch["ev_off"][lo]), int(batch["k_off"][lo])
        ev1 = int(batch["ev_off"][hi - 1]) + int(batch["ne"][hi - 1])
        k1 = int(batch["k_off"][hi - 1]) + int(batch["nk"][hi - 1])
        sub = {"ev": batch["ev"][ev0:ev1], "gm": batch["gm"][k0:k1],
               "stdv": batch["stdv"][k0:k1], "lstdv": batch["lstdv"][k0:k1],
               "ev_off": batch["ev_off"][rows] - ev0, "k_off": batch["k_off"][rows] - k0,
               "band_off": batch["band_off"][rows] - int(batch["band_off"][lo]),
               "ne": batch["ne"][rows], "nk": batch["nk"][rows], "lp": batch["lp"][rows]}
        fill = abea_ops.abea_fill(abea_batch_from_numpy(sub, mesh.device))
        local = {k: fill[k] for k in keys}
    else:
        local = {"trace": torch.zeros((0, abea_ops.BW), dtype=torch.uint8, device=mesh.device),
                 "bll_e": torch.zeros(0, dtype=torch.int32, device=mesh.device),
                 "last_val": torch.zeros(0, dtype=torch.float32, device=mesh.device),
                 "seed": torch.zeros(0, dtype=torch.int32, device=mesh.device)}
    return {k: all_gather_v(mesh, local[k]) for k in keys}
