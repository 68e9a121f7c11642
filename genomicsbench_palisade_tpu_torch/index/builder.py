"""FM-index construction on a device (bwa-mem2 build_index capability).

Port of genomicsbench_palisade_tpu/index/builder.py.  The reference
builds its `.bwt.2bit.64` index offline with a SA-IS suffix array over
fwd+revcomp and checkpointed occ blocks (tools/bwa-mem2/src/
FMI_search.cpp:176-356 build_fm_index / :358 build_index; bntseq.cpp packs
the FASTA).  Here:

  * suffix array, two routes (`build_arrays(sa_engine=)`): "device", the
    oracle's prefix doubling (ops/oracle/fmi.py `suffix_array`), each
    round one `torch.sort` of an int64 key on the given device; "sais",
    native SA-IS on the host (native/sais.cpp through `io.native.sais`),
    the route a genome needs (the doubling's keys and sorts outgrow the
    card's memory past ~512 M text characters) and `build_from_fasta`'s.
    The suffix array is unique, so the two are equal.
  * BWT, cumulative counts, the per-64-position cp_occ rows (counts before
    the block, MSB-first one-hot words): torch ops on the given device.
  * ambiguous bases: bwa-mem2 replaces non-ACGT with a random base when
    packing (bntseq.cpp AddSeq lrand48 path); a seeded generator keeps
    builds reproducible.
  * outputs (`build_from_fasta`): the npz (either package reads it), and
    optionally the reference's `.bwt.2bit.64` and its `.ann/.amb/.pac`,
    byte for byte the JAX builder's files.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import default_device
from ..io import native
from ..io.fastq import read_sequences
from .fmi_index import CP_SHIFT, DeviceFmIndex, split_one_hot

_CODE_TABLE = np.full(256, 255, dtype=np.uint8)
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _CODE_TABLE[ord(_ch)] = _v
    _CODE_TABLE[ord(_ch.lower())] = _v


def pack_fasta(path: str, ambig_seed: int = 11, with_holes: bool = False):
    """FASTA -> (codes uint8[L], names, lengths[, holes]).  Non-ACGT become
    a seeded-random base (bntseq.cpp packing semantics); with_holes=True
    also returns the bntseq ambiguity runs [(offset, len, char)] in
    concatenated coordinates (consecutive equal ambiguous chars merge into
    one hole, bntseq.cpp:1640-1665 semantics) for the .amb/.ann writers,
    and the names are whole header lines (.ann keeps the comment)."""
    rng = np.random.default_rng(ambig_seed)
    names, lengths, parts, holes = [], [], [], []
    off = 0
    for name, seq, _q in read_sequences(path, full_names=with_holes):
        raw = np.frombuffer(seq.encode(), dtype=np.uint8)
        codes = _CODE_TABLE[raw]
        amb = codes == 255
        if amb.any():
            codes = codes.copy()
            codes[amb] = rng.integers(0, 4, int(amb.sum()), dtype=np.uint8)
            if with_holes:
                holes.extend(_holes(raw, amb, off))
        names.append(name)
        lengths.append(len(codes))
        parts.append(codes)
        off += len(codes)
    if not parts:
        raise ValueError(f"no sequences in {path}")
    out = (np.concatenate(parts), names, np.asarray(lengths, np.int64))
    return out + (holes,) if with_holes else out


def _holes(raw: np.ndarray, amb: np.ndarray, off: int):
    """The runs of one ambiguous character, as (off + start, length, char):
    a run starts at an ambiguous byte that does not repeat the one before
    it, and ends at the next byte that does not continue it."""
    cont = np.zeros(len(raw), bool)
    cont[1:] = amb[1:] & amb[:-1] & (raw[1:] == raw[:-1])
    starts = np.nonzero(amb & ~cont)[0]
    breaks = np.append(np.nonzero(~cont)[0], len(raw))
    ends = breaks[np.searchsorted(breaks, starts, side="right")]
    return [(off + int(st), int(e - st), chr(raw[st])) for st, e in zip(starts, ends)]


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


SA_ENGINES = ("device", "sais")


def build_arrays(forward_codes, sa_compression: bool = False, device=None,
                 sa_engine: str = "device", stats=None) -> DeviceFmIndex:
    """Full fwd+revcomp FM index with SA sample arrays, built on `device`
    (CUDA unless given; without a GPU pass device="cpu").

    sa_compression=True keeps every 8th SA entry (SA_COMPX=3, the
    reference's compressed mode).  sa_engine "device" sorts the suffixes
    by prefix doubling on `device`; "sais" runs native SA-IS on the host
    and copies the suffix array to `device`.  The result is host (numpy)
    arrays.  `stats` gets sa_s (the suffix array, copy included) and
    rest_s (the BWT, counts and occ rows, back on the host)."""
    if sa_engine not in SA_ENGINES:
        raise ValueError(f"sa_engine must be one of {SA_ENGINES}, not {sa_engine!r}")
    device = default_device(device)
    fwd_np = np.asarray(forward_codes, dtype=np.uint8)
    fwd = torch.as_tensor(fwd_np).to(device)
    full = torch.cat([fwd, 3 - fwd.flip(0)])
    del fwd
    pac_len = full.numel()
    ref_seq_len = pac_len + 1

    t0 = time.perf_counter()
    if sa_engine == "sais":
        sa_np = np.empty(ref_seq_len, dtype=np.int64)
        sa_np[0] = pac_len  # virtual sentinel suffix ranks first
        native.sais(np.concatenate([fwd_np, 3 - fwd_np[::-1]]), out=sa_np[1:])
        sa = torch.from_numpy(sa_np).to(device)
        del sa_np
    else:
        sa = torch.empty(ref_seq_len, dtype=torch.int64, device=full.device)
        sa[0] = pac_len  # virtual sentinel suffix ranks first
        sa[1:] = suffix_array(full, device)
    if sa.is_cuda:
        torch.cuda.synchronize(sa.device)
    t1 = time.perf_counter()
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
    if stats is not None:
        stats.update(sa_s=t1 - t0, rest_s=time.perf_counter() - t1)
    return DeviceFmIndex(
        ref_seq_len=ref_seq_len,
        count=count_raw.cpu().numpy() + 1,  # sentinel adjustment (FMI_search.cpp:763-768)
        sentinel_index=sentinel_index,
        cp_occ=cp_occ.cpu().numpy(),
        sa_ms_byte=(sa_kept >> 32).astype(np.int8),
        sa_ls_word=(sa_kept & 0xFFFFFFFF).astype(np.uint32),
        sa_compression=sa_compression,
    )


def write_bwt2bit64(idx: DeviceFmIndex, path: str):
    """Write the reference's binary format (FMI_search.cpp:300-340; the
    field order is in fmi_index's docstring).  The port's cp_occ rows are
    its 64-byte CP_OCC records as they are."""
    if idx.sa_ms_byte is None or idx.sa_ls_word is None:
        raise ValueError("index was built without SA arrays")
    with open(path, "wb") as f:
        np.int64(idx.ref_seq_len).tofile(f)
        (np.asarray(idx.count, np.int64) - 1).tofile(f)  # stored pre-adjust
        np.ascontiguousarray(idx.cp_occ, np.int64).tofile(f)
        idx.sa_ms_byte.tofile(f)
        idx.sa_ls_word.tofile(f)
        np.int64(idx.sentinel_index).tofile(f)


def save_npz_full(idx: DeviceFmIndex, path: str, names=None, lengths=None,
                  compress: bool = True):
    """The npz index with its SA arrays (and the contigs' names and lengths
    when given), the JAX builder's members, dtypes and order.
    `compress=False` stores the members as they are (a cache: the
    compression is most of the write's time)."""
    extra = {}
    if names is not None:
        extra["contig_names"] = np.asarray(names, dtype=object)
        extra["contig_lengths"] = np.asarray(lengths, np.int64)
    hi, lo = split_one_hot(idx.cp_occ)
    (np.savez_compressed if compress else np.savez)(
        path,
        ref_seq_len=idx.ref_seq_len,
        count=idx.count,
        sentinel_index=idx.sentinel_index,
        cp_count=idx.cp_count,
        one_hot_hi=hi,
        one_hot_lo=lo,
        sa_ms_byte=idx.sa_ms_byte if idx.sa_ms_byte is not None else np.zeros(0, np.int8),
        sa_ls_word=idx.sa_ls_word if idx.sa_ls_word is not None else np.zeros(0, np.uint32),
        sa_compression=np.bool_(idx.sa_compression),
        **extra,
    )


def write_bntseq(prefix: str, codes: np.ndarray, names, lengths, holes, seed: int = 11):
    """Reference-format sequence metadata: <prefix>.ann / .amb / .pac.

    Text formats per bntseq.cpp:85-111 (`l_pac n_seqs seed`, then per
    contig `gi name [comment]` + `offset len n_ambs`; .amb header
    `l_pac n_seqs n_holes` + `offset len char` per ambiguity run); .pac is
    the 2-bit forward pack, base i in bits (~i&3)*2 of byte i>>2, with the
    reference's trailer (bntseq.cpp:1718-1728: a zero pad byte when
    l_pac%4==0, then one byte holding l_pac%4)."""
    l_pac = int(len(codes))
    offs = np.concatenate([[0], np.cumsum(np.asarray(lengths, np.int64))])
    hole_offs = np.array([o for o, _l, _c in holes], np.int64)
    with open(prefix + ".ann", "w") as f:
        f.write(f"{l_pac} {len(names)} {seed}\n")
        for i, name in enumerate(names):
            parts = str(name).split(None, 1)
            head = f"0 {parts[0]}"
            if len(parts) > 1:
                head += f" {parts[1]}"
            n_ambs = int(((hole_offs >= offs[i]) & (hole_offs < offs[i + 1])).sum())
            f.write(f"{head}\n{int(offs[i])} {int(lengths[i])} {n_ambs}\n")
    with open(prefix + ".amb", "w") as f:
        f.write(f"{l_pac} {len(names)} {len(holes)}\n")
        for o, length, ch in holes:
            f.write(f"{o} {length} {ch}\n")
    # pad to a multiple of 4 and combine the columns: O(l_pac) bytes
    quad = np.concatenate([codes.astype(np.uint8),
                           np.zeros((-l_pac) % 4, np.uint8)]).reshape(-1, 4)
    pac = ((quad[:, 0] << 6) | (quad[:, 1] << 4) | (quad[:, 2] << 2) | quad[:, 3]).astype(np.uint8)
    with open(prefix + ".pac", "wb") as f:
        f.write(pac.tobytes())
        if l_pac % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([l_pac % 4]))


def build_from_fasta(fasta_path: str, prefix: str, bwt2bit: bool = False, bntseq: bool = False,
                     device=None, stats=None):
    """Offline index build: <prefix>.npz (+ optional <prefix>.bwt.2bit.64
    and the reference's <prefix>.ann/.amb/.pac), the suffix array by native
    SA-IS on the host, the rest on `device` (CUDA unless given).  Returns
    (DeviceFmIndex, short names, lengths).  `stats` gets pack_s, sa_s,
    rest_s and write_s."""
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    codes, names, lengths, holes = pack_fasta(fasta_path, with_holes=True)
    short = [str(n).split(None, 1)[0] for n in names]
    stats["pack_s"] = time.perf_counter() - t0
    idx = build_arrays(codes, device=device, sa_engine="sais", stats=stats)
    t0 = time.perf_counter()
    save_npz_full(idx, prefix + ".npz", short, lengths)
    if bwt2bit:
        write_bwt2bit64(idx, prefix + ".bwt.2bit.64")
    if bntseq:
        write_bntseq(prefix, codes, names, lengths, holes)
    stats["write_s"] = time.perf_counter() - t0
    return idx, short, lengths
