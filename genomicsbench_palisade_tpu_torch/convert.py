"""Carry numpy data across into the port's tensors.

PairHMM's parameters are its probability tables, so these are the port's
"weights carried across": `batch_from_numpy` takes a `prepare_batch` dict
(the port's, or the JAX package's, whose `q/i/d/c` are int32 and which may
also hold pre-transposed `*_t` planes for the TPU) and `tables_from_numpy`
takes the numpy lookup tables built by `ops.phmm.tables`.

bsw's are its scoring parameters and the batch: `bsw_batch_from_numpy`
takes a `prepare_pairs` dict (padded [B, pad] query and target rows) and
returns the struct-of-arrays tensors `ops.bsw.bsw_extend` takes, with the
parameters as the kernel's int tuple.

chain's are the anchors and each call's gap table: `chain_batch_from_numpy`
takes a list of `prepare_call` dicts and returns the flat batch
`ops.chain.chain_dp` takes (see ops/chain.py), with (max_dist_x,
max_dist_y, bw).

abea's weights are the pore model: `abea_model_from_numpy` takes a model
dict (`io.signal.load_pore_model`'s, the port's or the JAX package's) and
returns the f32 rank-indexed arrays `ops.abea.prepare_batch` reads.  Its batch is the
flat numpy batch of `ops.abea.prepare_batch`; `abea_batch_from_numpy`
carries it to tensors (see ops/abea.py).

fmi's weights are the FM index: `fmi_index_from_numpy` takes a built index
(`index.fmi_index.DeviceFmIndex`) or the JAX package's device dict
(`DeviceFmIndex.as_device_arrays()`: `cp_pack` u32 [blocks, 16], `count`,
`sentinel_index`) and returns the tensors `ops.fmi` reads.

kmer and poa carry no weights; their batches are data.  kmer's is the int8
code matrix of a batch of reads (`kmer_batch_from_numpy`), poa's the
rank-space graph arrays of `ops.poa.graph_to_arrays` stacked over windows,
with the windows' sequence codes (`poa_batch_from_numpy`).  grm's batch is
its int8 genotype matrix, which `ops.grm.compute_grm` carries itself.

The NN models' weights are the JAX package's flax params (numpy arrays,
e.g. from `io.flax_msgpack`): `bonito_state_from_flax` gives the reference
bonito checkpoint's state dict (the inverse of the JAX
`load_torch_state_dict`, as its `save_torch_state_dict :267-310`), which
`models.bonito.load_reference_state` loads; `clair_state_from_flax` gives
`models.clair.ClairModel`'s.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.bsw import _params_tuple
from .ops.abea_cuda import BATCH_DTYPES as ABEA_DTYPES
from .ops.bsw_cuda import BATCH_DTYPES
from .ops.chain_cuda import BATCH_DTYPES as CHAIN_DTYPES
from .ops.oracle.abea import KMER_SIZE
from .ops.oracle.bsw import DEFAULT_PARAMS

# the compact batch: int8 codes and quals, int32 lengths
INT8_KEYS = ("rs_row", "q", "i", "d", "c", "hap")
INT32_KEYS = ("rslen", "haplen")
TABLE_KEYS = ("ph2pr", "one_m_ph2pr", "ph2pr_div3", "m2m")


def batch_from_numpy(batch_np, device) -> dict:
    """Compact tensors on `device` from a prepare_batch dict of arrays.

    Quals go to int8: they are read `& 127`, which int8's two's complement
    keeps for any integer.  Keys other than the compact batch are dropped.
    """
    out = {}
    for k in INT8_KEYS:
        out[k] = torch.from_numpy(np.ascontiguousarray(np.asarray(batch_np[k]).astype(np.int8)))
    for k in INT32_KEYS:
        out[k] = torch.from_numpy(np.ascontiguousarray(np.asarray(batch_np[k]).astype(np.int32)))
    return {k: v.to(device) for k, v in out.items()}


def tables_from_numpy(tables_np, device) -> dict:
    """Lookup-table tensors on `device`, in the numpy tables' own dtype."""
    return {k: torch.from_numpy(np.ascontiguousarray(tables_np[k])).to(device)
            for k in TABLE_KEYS}


_NP = {torch.bool: np.bool_, torch.int8: np.int8, torch.int32: np.int32, torch.int64: np.int64,
       torch.float32: np.float32, torch.float64: np.float64}
ABEA_MODEL_KEYS = ("level_mean", "level_stdv", "level_log_stdv")


def bsw_batch_from_numpy(batch_np, device, params=DEFAULT_PARAMS):
    """(tensors on `device`, params tuple) from a prepare_pairs dict.

    The padded rows become one flat code buffer, queries first: pair b's
    query at b*q_pad, its target at B*q_pad + b*t_pad.  `params` is a
    BswParams (the port's, or any object with the same fields)."""
    query = np.asarray(batch_np["query"]).astype(np.int8)
    target = np.asarray(batch_np["target"]).astype(np.int8)
    (b, q_pad), t_pad = query.shape, target.shape[1]
    arrays = {
        "codes": np.concatenate([query.ravel(), target.ravel()]),
        "q_off": np.arange(b, dtype=np.int64) * q_pad,
        "q_len": batch_np["qlen"],
        "t_off": b * q_pad + np.arange(b, dtype=np.int64) * t_pad,
        "t_len": batch_np["tlen"],
        "h0": batch_np["h0"],
    }
    out = {k: torch.from_numpy(np.ascontiguousarray(np.asarray(arrays[k]), dtype=_NP[dt])).to(device)
           for k, dt in BATCH_DTYPES.items()}
    return out, _params_tuple(params)


def chain_arrays(preps):
    """(numpy flat batch, (max_dist_x, max_dist_y, bw)) from prepare_call
    dicts that share those three ints: per-anchor arrays concatenated in
    call order, `off`/`n` per call, the gap tables stacked."""
    params = {(p["max_dist_x"], p["max_dist_y"], p["bw"]) for p in preps}
    if len(params) != 1:
        raise ValueError(f"a chain batch needs one (max_dist_x, max_dist_y, bw), got {params}")
    (mdx, mdy, bw), = params
    n = np.array([p["n"] for p in preps], np.int32)
    # 32-bit words as int32 (x_lo is uint32: its bits are kept)
    arrays = {k: np.concatenate([np.asarray(p[k]).view(np.int32) for p in preps])
              for k in ("x_lo", "qi", "qspan", "st_eff")}
    arrays["off"] = np.concatenate(([0], np.cumsum(n[:-1], dtype=np.int64)))
    arrays["n"] = n
    arrays["gap_table"] = np.stack([np.asarray(p["gap_table"], np.int32) for p in preps])
    return arrays, (int(mdx), int(mdy), int(bw))


def chain_batch_from_numpy(preps, device):
    """(tensors on `device`, (max_dist_x, max_dist_y, bw)) from a list of
    prepare_call dicts (the port's, or the JAX package's): the flat batch
    that `ops.chain.chain_dp` takes, with each call's gap table."""
    arrays, params = chain_arrays(preps)
    return {k: torch.from_numpy(arrays[k]).to(device) for k in CHAIN_DTYPES}, params


def abea_model_from_numpy(model_np) -> dict:
    """The pore model as `ops.abea.prepare_batch` reads it: contiguous f32
    `level_mean`, `level_stdv`, `level_log_stdv`, one entry per k-mer rank."""
    n = 4 ** KMER_SIZE
    out = {k: np.ascontiguousarray(np.asarray(model_np[k]), dtype=np.float32)
           for k in ABEA_MODEL_KEYS}
    for k, v in out.items():
        if v.shape != (n,):
            raise ValueError(f"pore model {k} has shape {v.shape}, expected ({n},)")
    return out


def abea_batch_from_numpy(batch_np, device) -> dict:
    """Tensors on `device` from an ops.abea.prepare_batch flat batch, in the
    dtypes the kernels take."""
    return {k: torch.from_numpy(np.ascontiguousarray(np.asarray(batch_np[k]), dtype=_NP[dt]))
            .to(device) for k, dt in ABEA_DTYPES.items()}


def fmi_index_from_numpy(d, device) -> dict:
    """The FM index as `ops.fmi` reads it, on `device`: `cp_occ` int64
    [blocks, 8] (the reference's CP_OCC rows), `count` int64 [5] and
    `sentinel_index` (an int).  `d` is the port's DeviceFmIndex, or a dict
    holding the JAX package's `cp_pack` (u32 [blocks, 16]: count low
    words, count high words, one-hot high halves, one-hot low halves)."""
    if isinstance(d, dict):
        pack = np.asarray(d["cp_pack"]).astype(np.uint64)
        counts = pack[:, 0:4] | (pack[:, 4:8] << np.uint64(32))
        words = (pack[:, 8:12] << np.uint64(32)) | pack[:, 12:16]
        cp_occ = np.concatenate([counts, words], axis=1).view(np.int64)
        count, sentinel = d["count"], d["sentinel_index"]
    else:
        cp_occ, count, sentinel = d.cp_occ, d.count, d.sentinel_index
    return {"cp_occ": torch.from_numpy(np.ascontiguousarray(cp_occ, dtype=np.int64)).to(device),
            "count": torch.from_numpy(np.asarray(count).astype(np.int64)).to(device),
            "sentinel_index": int(sentinel)}


def kmer_batch_from_numpy(bases, lengths, device):
    """(int8 [B, L] codes, int32 [B] lengths) on `device` from
    `ops.kmer.encode_reads_np` / `pad_codes_np`'s padded matrix."""
    return (torch.from_numpy(np.ascontiguousarray(bases, dtype=np.int8)).to(device),
            torch.from_numpy(np.ascontiguousarray(lengths, dtype=np.int32)).to(device))


POA_DTYPES = {"code": torch.int32, "preds": torch.int64, "npreds": torch.int32,
              "out_empty": torch.bool, "n_nodes": torch.int32}


def poa_batch_from_numpy(garrs, seq_arr, seq_len, device, p_slots: int | None = None):
    """The device aligner's batch on `device`: each window's graph arrays
    (`ops.poa.graph_to_arrays` dicts, one a window, stacked on a leading
    window axis), its sequence codes seq_arr [B, w_cap-1] and lengths
    seq_len [B] as int32, and "rows", the largest graph's nodes (an int).
    `p_slots` keeps that many predecessor slots a node (the batch's widest
    in-degree, rounded; slots past a node's in-degree are masked, so fewer
    slots change no output)."""
    out = {}
    for k, dt in POA_DTYPES.items():
        a = np.stack([g[k] for g in garrs])
        if k == "preds" and p_slots is not None:
            a = a[:, :, :p_slots]
        out[k] = torch.from_numpy(np.ascontiguousarray(a, dtype=_NP[dt])).to(device)
    out["seq"] = torch.from_numpy(np.ascontiguousarray(seq_arr, dtype=np.int32)).to(device)
    out["seqlen"] = torch.from_numpy(np.ascontiguousarray(seq_len, dtype=np.int32)).to(device)
    out["rows"] = int(max(g["n_nodes"] for g in garrs))
    return out


def _params(tree):
    """flax's {"params": ..., "batch_stats": ...} or the bare params."""
    return tree.get("params", tree), tree.get("batch_stats", {})


def _conv_w(kernel):  # flax [k, in/groups, out] -> torch [out, in/groups, k]
    return np.ascontiguousarray(np.transpose(np.asarray(kernel, np.float32), (2, 1, 0)))


def bonito_state_from_flax(tree, blocks=None) -> dict:
    """The JAX BonitoModel's params (and batch_stats) as a reference bonito
    state dict of float32 tensors (`encoder.encoder.{i}.conv.{idx}...`,
    BatchNorm at idx + 1, act and dropout between repeats)."""
    from .models.bonito import DNA_R941_BLOCKS

    p, bs = _params(tree)
    out = {}

    def bn(key, scale_bias, stats):
        out[key + ".weight"] = scale_bias["scale"]
        out[key + ".bias"] = scale_bias["bias"]
        out[key + ".running_mean"] = stats["mean"]
        out[key + ".running_var"] = stats["var"]

    for i, (_f, rep, _k, _s, res, sep) in enumerate(blocks or DNA_R941_BLOCKS):
        blk, stats = p[f"block{i}"], bs[f"block{i}"]
        for r in range(rep):
            tcs, idx = blk[f"tcs{r}"], f"encoder.encoder.{i}.conv.{4 * r}"
            for name in (("depthwise", "pointwise") if sep else ("conv",)):
                out[f"{idx}.{name}.weight"] = _conv_w(tcs[name]["kernel"])
            bn(f"encoder.encoder.{i}.conv.{4 * r + 1}", blk[f"bn{r}"], stats[f"bn{r}"])
        if res:
            out[f"encoder.encoder.{i}.residual.0.conv.weight"] = _conv_w(
                blk["res_tcs"]["conv"]["kernel"])
            bn(f"encoder.encoder.{i}.residual.1", blk["res_bn"], stats["res_bn"])
    out["decoder.layers.0.weight"] = _conv_w(p["decoder"]["kernel"])
    out["decoder.layers.0.bias"] = p["decoder"]["bias"]
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


_FLAX_TO_TORCH_GATES = ("i", "f", "g", "o")  # torch's gate order over flax's named denses


def clair_state_from_flax(tree) -> dict:
    """The JAX ClairModel's params as `models.clair.ClairModel`'s state
    dict: flax's OptimizedLSTMCell keeps a bias-free input dense and a
    hidden dense with bias a gate (`ii`, `hi`, ...); torch's LSTM stacks the
    gates (i, f, g, o) in weight_ih/weight_hh, the bias in bias_hh."""
    p, _ = _params(tree)
    out = {}
    for ours in ("lstm1", "lstm2"):
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            cell = p[ours][direction]
            out[f"{ours}.weight_ih_l0{suffix}"] = np.concatenate(
                [np.asarray(cell[f"i{g}"]["kernel"]).T for g in _FLAX_TO_TORCH_GATES])
            out[f"{ours}.weight_hh_l0{suffix}"] = np.concatenate(
                [np.asarray(cell[f"h{g}"]["kernel"]).T for g in _FLAX_TO_TORCH_GATES])
            out[f"{ours}.bias_hh_l0{suffix}"] = np.concatenate(
                [np.asarray(cell[f"h{g}"]["bias"]) for g in _FLAX_TO_TORCH_GATES])
            out[f"{ours}.bias_ih_l0{suffix}"] = np.zeros_like(out[f"{ours}.bias_hh_l0{suffix}"])
    out["l3_kernel"] = p["l3_kernel"]
    out["l3_bias"] = p["l3_bias"]
    for name in ("l4", *(f"{h}_{k}" for h in ("l5", "y") for k in range(1, 5))):
        out[f"{name}.weight"] = np.asarray(p[name]["kernel"]).T
        out[f"{name}.bias"] = p[name]["bias"]
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}
