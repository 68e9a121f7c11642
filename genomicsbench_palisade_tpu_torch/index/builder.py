"""FM-index construction on a device (bwa-mem2 build_index capability).

Port of genomicsbench_palisade_tpu/index/builder.py:35-146 (`pack_fasta`,
`build_arrays`).  The reference builds its `.bwt.2bit.64` index offline
with a SA-IS suffix array over fwd+revcomp and checkpointed occ blocks
(tools/bwa-mem2/src/FMI_search.cpp:176-356 build_fm_index / :358
build_index; bntseq.cpp packs the FASTA).  Here:

  * suffix array: the oracle's prefix doubling (ops/oracle/fmi.py
    `suffix_array`), each round one `torch.sort` of an int64 key on the
    given device.  The suffix array is unique, so it equals SA-IS's.
  * BWT, cumulative counts, the per-64-position cp_occ rows (counts before
    the block, MSB-first one-hot words): torch ops on the same device.
  * ambiguous bases: bwa-mem2 replaces non-ACGT with a random base when
    packing (bntseq.cpp AddSeq lrand48 path); a seeded generator keeps
    builds reproducible.

The file writers (`write_bwt2bit64`, `save_npz_full`, `write_bntseq`,
`build_from_fasta`) are not ported yet (ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..io.fastq import read_sequences
from .fmi_index import CP_SHIFT, DeviceFmIndex

_CODE_TABLE = np.full(256, 255, dtype=np.uint8)
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _CODE_TABLE[ord(_ch)] = _v
    _CODE_TABLE[ord(_ch.lower())] = _v


def pack_fasta(path: str, ambig_seed: int = 11):
    """FASTA -> (codes uint8[L], names, lengths).  Non-ACGT become a
    seeded-random base (bntseq.cpp packing semantics).  (The JAX builder's
    `with_holes` ambiguity runs feed the .amb/.ann writers, which wait for
    `cli/fmi_build`.)"""
    rng = np.random.default_rng(ambig_seed)
    names, lengths, parts = [], [], []
    for name, seq, _q in read_sequences(path):
        codes = _CODE_TABLE[np.frombuffer(seq.encode(), dtype=np.uint8)]
        amb = codes == 255
        if amb.any():
            codes = codes.copy()
            codes[amb] = rng.integers(0, 4, int(amb.sum()), dtype=np.uint8)
        names.append(name)
        lengths.append(len(codes))
        parts.append(codes)
    if not parts:
        raise ValueError(f"no sequences in {path}")
    return np.concatenate(parts), names, np.asarray(lengths, np.int64)


def suffix_array(codes, device=None) -> torch.Tensor:
    """Suffix array by prefix doubling, O(n log^2 n), on `device` (CUDA
    unless given; without a GPU pass device="cpu").

    codes: base codes 0..3 (numpy or a tensor).  Returns int64 positions of
    the sorted suffixes of the text WITHOUT a sentinel (like saisxx over the
    plain text: a suffix that is a prefix of another sorts first).  Each
    round sorts the pairs (rank[i], rank[i+k]) as one int64 key
    rank[i] * M + rank[i+k] + 1, with rank[i+k] = -1 past the end; M
    exceeds every rank + 1, and M * M < 2**63 up to n ~ 3e9."""
    rank = torch.as_tensor(codes).to(device=default_device(device), dtype=torch.int64)
    n = rank.numel()
    sa = torch.argsort(rank, stable=True)
    mult = max(n, 4) + 1
    k = 1
    while k < n:
        key = rank * mult
        key[: n - k] += rank[k:]
        key[: n - k] += 1
        del rank
        key, sa = torch.sort(key, stable=True)
        diff = torch.zeros(n, dtype=torch.int64, device=key.device)
        diff[1:] = key[1:] != key[:-1]
        del key
        rank = torch.empty_like(sa)
        rank[sa] = torch.cumsum(diff, 0)
        last = int(rank[sa[-1]])
        del diff
        if last == n - 1:  # every suffix has its own rank
            break
        k <<= 1
    return sa


def build_arrays(forward_codes, sa_compression: bool = False, device=None) -> DeviceFmIndex:
    """Full fwd+revcomp FM index with SA sample arrays, built on `device`
    (CUDA unless given; without a GPU pass device="cpu").

    sa_compression=True keeps every 8th SA entry (SA_COMPX=3, the
    reference's compressed mode).  The result is host (numpy) arrays."""
    device = default_device(device)
    fwd = torch.as_tensor(np.asarray(forward_codes, dtype=np.uint8)).to(device)
    full = torch.cat([fwd, 3 - fwd.flip(0)])
    del fwd
    pac_len = full.numel()
    ref_seq_len = pac_len + 1

    sa = torch.empty(ref_seq_len, dtype=torch.int64, device=full.device)
    sa[0] = pac_len  # virtual sentinel suffix ranks first
    sa[1:] = suffix_array(full, device)
    sentinel_index = int(torch.argmin(sa))  # the one row whose suffix starts at 0

    # the previous character of each suffix; the sentinel row's is 4
    prev = sa - 1
    prev[sentinel_index] = 0
    bwt = full[prev]
    del prev
    bwt[sentinel_index] = 4

    count_raw = torch.zeros(5, dtype=torch.int64, device=full.device)
    count_raw[1:] = torch.cumsum(torch.stack([(full == c).sum() for c in range(4)]), 0)
    del full

    blocks = (ref_seq_len >> CP_SHIFT) + 1
    tiles = torch.full((blocks * 64,), 5, dtype=torch.uint8, device=bwt.device)
    tiles[:ref_seq_len] = bwt
    del bwt
    tiles = tiles.view(blocks, 64)
    cp_occ = torch.zeros((blocks, 8), dtype=torch.int64, device=tiles.device)
    bit_of = torch.arange(7, -1, -1, dtype=torch.uint8, device=tiles.device)
    for b in range(4):
        mask = tiles == b
        # exclusive cumulative occ at each block start
        cp_occ[1:, b] = torch.cumsum(mask.sum(1), 0)[:-1]
        # MSB-first bytes of the block's word; the word is their big-endian
        # concatenation, so reversed they are its little-endian bytes
        byte = (mask.view(blocks, 8, 8).to(torch.uint8) << bit_of).sum(-1, dtype=torch.uint8)
        cp_occ[:, 4 + b] = byte.flip(-1).contiguous().view(torch.int64)[:, 0]
        del mask, byte

    sa_kept = (sa[::8] if sa_compression else sa).cpu().numpy()
    return DeviceFmIndex(
        ref_seq_len=ref_seq_len,
        count=count_raw.cpu().numpy() + 1,  # sentinel adjustment (FMI_search.cpp:763-768)
        sentinel_index=sentinel_index,
        cp_occ=cp_occ.cpu().numpy(),
        sa_ms_byte=(sa_kept >> 32).astype(np.int8),
        sa_ls_word=(sa_kept & 0xFFFFFFFF).astype(np.uint32),
        sa_compression=sa_compression,
    )
