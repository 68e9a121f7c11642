"""FM-index loading and the port's occ layout.

Port of genomicsbench_palisade_tpu/index/fmi_index.py:32-181 (the sharded
files, `:184-287`, are not ported yet).  Reference index format
`.bwt.2bit.64` (tools/bwa-mem2/src/FMI_search.cpp:176-356 build_fm_index,
:469-588 load_index):
    int64   ref_seq_len              (= 2*L + 1, fwd + revcomp + sentinel)
    int64   count[5]                 (cumulative, pre-sentinel-adjustment)
    CP_OCC  cp_occ[(ref_seq_len>>6)+1]   struct: int64 cp_count[4];
                                          uint64 one_hot_bwt_str[4]
    int8    sa_ms_byte[ref_seq_len]  (or compressed every 8th entry)
    uint32  sa_ls_word[ref_seq_len]
    int64   sentinel_index

The port keeps the reference's CP_OCC record as it is: `cp_occ` is int64
[blocks, 8], one 64-byte row a block of 64 BWT positions, columns 0-3 the
counts of A, C, G, T before the block and 4-7 the four one-hot words (bit
63 - i marks position i of the block) as the bit patterns of uint64.  An
occ lookup is one row.  (The JAX package splits the words into u32 halves,
`cp_pack`, because the TPU has no 64-bit integers.)  The npz format is the
JAX package's (cp_count, one_hot_hi, one_hot_lo), so either package reads
the other's files.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.oracle import fmi as fmi_oracle

CP_SHIFT = 6
CP_MASK = 63


@dataclass
class DeviceFmIndex:
    ref_seq_len: int
    count: np.ndarray  # int64 [5] (sentinel-adjusted, +1)
    sentinel_index: int
    cp_occ: np.ndarray  # int64 [blocks, 8]: cp_count[4], one-hot words[4]
    sa_ms_byte: np.ndarray | None = None
    sa_ls_word: np.ndarray | None = None
    sa_compression: bool = False  # SA sampled every 8th row (SA_COMPX=3)

    @property
    def cp_count(self) -> np.ndarray:
        return self.cp_occ[:, :4]


def pack_cp_occ(cp_count: np.ndarray, one_hot_hi: np.ndarray,
                one_hot_lo: np.ndarray) -> np.ndarray:
    """The CP_OCC rows from counts and the u32 halves of the one-hot words."""
    words = (one_hot_hi.astype(np.uint64) << np.uint64(32)) | one_hot_lo.astype(np.uint64)
    return np.ascontiguousarray(np.concatenate(
        [np.asarray(cp_count).astype(np.int64), words.view(np.int64)], axis=1))


def split_one_hot(cp_occ: np.ndarray):
    """(hi, lo) u32 halves of the one-hot words: hi holds block positions
    0..31, lo 32..63."""
    words = cp_occ[:, 4:].view(np.uint64)
    return ((words >> np.uint64(32)).astype(np.uint32),
            (words & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def from_oracle_index(idx: fmi_oracle.FmIndex) -> DeviceFmIndex:
    """Convert a (tiny, test-sized) oracle index to the port's layout."""
    return DeviceFmIndex(
        ref_seq_len=idx.ref_seq_len,
        count=idx.count.astype(np.int64),  # already sentinel-adjusted by the oracle
        sentinel_index=idx.sentinel_index,
        cp_occ=np.ascontiguousarray(np.concatenate(
            [idx.cp_count.astype(np.int64), idx.one_hot.view(np.int64)], axis=1)),
    )


def build_from_sequence(forward_seq: str) -> DeviceFmIndex:
    return from_oracle_index(fmi_oracle.build_index(forward_seq))


def load_bwt2bit64(path: str, sa_compression: bool = False, load_sa: bool = False) -> DeviceFmIndex:
    """Load the reference's binary `.bwt.2bit.64` index: its 64-byte CP_OCC
    records are the port's cp_occ rows as they are."""
    with open(path, "rb") as f:
        ref_seq_len = int(np.fromfile(f, dtype=np.int64, count=1)[0])
        count = np.fromfile(f, dtype=np.int64, count=5) + 1  # sentinel adj
        blocks = (ref_seq_len >> CP_SHIFT) + 1
        cp_occ = np.fromfile(f, dtype=np.int64, count=blocks * 8).reshape(blocks, 8)
        sa_ms = sa_ls = None
        n_sa = ((ref_seq_len >> 3) + 1) if sa_compression else ref_seq_len
        if load_sa:
            sa_ms = np.fromfile(f, dtype=np.int8, count=n_sa)
            sa_ls = np.fromfile(f, dtype=np.uint32, count=n_sa)
        else:
            f.seek(n_sa * 1 + n_sa * 4, 1)
        sentinel = int(np.fromfile(f, dtype=np.int64, count=1)[0])
    return DeviceFmIndex(ref_seq_len=ref_seq_len, count=count, sentinel_index=sentinel,
                         cp_occ=cp_occ, sa_ms_byte=sa_ms, sa_ls_word=sa_ls,
                         sa_compression=sa_compression)


def save_npz(idx: DeviceFmIndex, path: str):
    hi, lo = split_one_hot(idx.cp_occ)
    np.savez_compressed(
        path,
        ref_seq_len=idx.ref_seq_len,
        count=idx.count,
        sentinel_index=idx.sentinel_index,
        cp_count=idx.cp_count,
        one_hot_hi=hi,
        one_hot_lo=lo,
    )


def load_npz(path: str) -> DeviceFmIndex:
    z = np.load(path, allow_pickle=True)
    sa_ms = z["sa_ms_byte"] if "sa_ms_byte" in z.files and z["sa_ms_byte"].size else None
    sa_ls = z["sa_ls_word"] if "sa_ls_word" in z.files and z["sa_ls_word"].size else None
    return DeviceFmIndex(
        ref_seq_len=int(z["ref_seq_len"]),
        count=z["count"].astype(np.int64),
        sentinel_index=int(z["sentinel_index"]),
        cp_occ=pack_cp_occ(z["cp_count"], z["one_hot_hi"], z["one_hot_lo"]),
        sa_ms_byte=sa_ms,
        sa_ls_word=sa_ls,
        sa_compression=bool(z["sa_compression"])
        if "sa_compression" in z.files
        # legacy archives lack the flag: infer from the SA sample count
        else (sa_ms is not None and len(sa_ms) < int(z["ref_seq_len"])),
    )
