"""FM-index SMEM-seeding oracle (bwa-mem2 semantics).

The port's own copy of genomicsbench_palisade_tpu/ops/oracle/fmi.py (the
port imports nothing of the JAX package), plus `oracle_view`.  Semantics
source:
  * tools/bwa-mem2/src/FMI_search.cpp:358-452 (build_index: index text is
    forward reference + its reverse complement; saisxx suffix array with a
    virtual sentinel ranked first; BWT with bwt[sa==0]=4 at sentinel_index),
    :109-168 (pac2nt), :180-310 (checkpointed occ every 64 bases, one-hot
    bit-planes MSB-first; cumulative count[5]).
  * FMI_search.h:81-89 (GET_OCC), :91-99 (SMEM {rid,m,n,k,l,s}).
  * FMI_search.cpp:1536-1565 (backwardExt with sentinel offset on l),
    :986-1180 (getSMEMsOnePosOneThread), :1182-1241 (getSMEMsAllPos active
    compaction loop), :1243-1326 (bwtSeedStrategyAllPos / LAST), :1480-1535
    (compare_smem sort: rid asc, m asc, n desc).
  * benchmarks/fmi/fmi.cpp:229-345 (3-phase driver pipeline: all-pos SMEMs,
    reseed at midpoints of long low-occ SMEMs with min_intv=s+1, LAST pass
    with max_intv=20 and minSeedLen+1).

The oracle builds tiny indexes directly from an ACGT string so kernels can
be parity-tested without the 3 GB hg38 index; `oracle_view` lets it search
an index built elsewhere (genome-scale ones included) without its
Python-loop `build_index`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

CP_BLOCK_SIZE = 64
CP_SHIFT = 6
CP_MASK = 63

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (numpy argsort), O(n log^2 n).

    codes: int array (values 0..3).  Returns positions of sorted suffixes
    of the string WITHOUT a sentinel (like saisxx over the plain text).
    """
    n = len(codes)
    rank = codes.astype(np.int64)
    sa = np.argsort(rank, kind="stable")
    tmp = np.empty(n, dtype=np.int64)
    k = 1
    while k < n:
        # sort by (rank[i], rank[i+k]) with -1 beyond the end
        rank2 = np.full(n, -1, dtype=np.int64)
        rank2[: n - k] = rank[k:]
        order = np.lexsort((rank2, rank))
        tmp[order[0]] = 0
        prev = order[0]
        r = 0
        key1 = rank[order]
        key2 = rank2[order]
        diff = np.empty(n, dtype=bool)
        diff[0] = False
        diff[1:] = (key1[1:] != key1[:-1]) | (key2[1:] != key2[:-1])
        tmp[order] = np.cumsum(diff)
        rank = tmp.copy()
        sa = order
        if rank[sa[-1]] == n - 1:
            break
        k <<= 1
        del r, prev
    return sa.astype(np.int64)


@dataclass
class FmIndex:
    ref_seq_len: int  # 2*L + 1 (includes sentinel)
    count: np.ndarray  # int64[5] cumulative: 0, #A, #A+#C, ..., total
    bwt: np.ndarray  # uint8[ref_seq_len], 4 at the sentinel row
    sentinel_index: int
    sa: np.ndarray  # int64[ref_seq_len] suffix array incl. sentinel
    cp_count: np.ndarray  # int64[num_blocks, 4]
    one_hot: np.ndarray  # uint64[num_blocks, 4] MSB-first bit planes

    @property
    def num_blocks(self) -> int:
        return self.cp_count.shape[0]


def build_index(forward_seq: str) -> FmIndex:
    """Build the bidirectional FM index over fwd + revcomp (build_index)."""
    fwd = forward_seq.upper()
    assert set(fwd) <= set("ACGT"), "index text must be ACGT (pac has no N)"
    full = fwd + "".join(_COMP[c] for c in reversed(fwd))
    codes = np.array([_CODE[c] for c in full], dtype=np.int64)
    pac_len = len(codes)

    counts = np.zeros(5, dtype=np.int64)
    for b in range(4):
        counts[b + 1] = np.sum(codes == b)
    # cumulative counts, then the sentinel adjustment applied by load_index
    # (FMI_search.cpp:763-768: count[ii] += 1) so 'A' rows start at SA row 1.
    count = np.cumsum(counts).astype(np.int64) + 1

    sa_plain = suffix_array(codes)
    ref_seq_len = pac_len + 1
    sa = np.empty(ref_seq_len, dtype=np.int64)
    sa[0] = pac_len  # virtual sentinel suffix ranks first
    sa[1:] = sa_plain

    bwt = np.empty(ref_seq_len, dtype=np.uint8)
    sentinel_index = -1
    for i in range(ref_seq_len):
        if sa[i] == 0:
            bwt[i] = 4
            sentinel_index = i
        else:
            bwt[i] = codes[sa[i] - 1]

    num_blocks = (ref_seq_len >> CP_SHIFT) + 1
    cp_count = np.zeros((num_blocks, 4), dtype=np.int64)
    one_hot = np.zeros((num_blocks, 4), dtype=np.uint64)
    running = np.zeros(5, dtype=np.int64)
    for i in range(ref_seq_len):
        if (i & CP_MASK) == 0:
            blk = i >> CP_SHIFT
            cp_count[blk] = running[:4]
        c = bwt[i]
        running[c] += 1
        if c < 4:
            blk = i >> CP_SHIFT
            bit = np.uint64(1) << np.uint64(63 - (i & CP_MASK))
            one_hot[blk, c] |= bit
    return FmIndex(
        ref_seq_len=ref_seq_len,
        count=count,
        bwt=bwt,
        sentinel_index=sentinel_index,
        sa=sa,
        cp_count=cp_count,
        one_hot=one_hot,
    )


def oracle_view(device_index) -> FmIndex:
    """An FmIndex over a built index (`index.fmi_index.DeviceFmIndex`):
    count, sentinel_index and the occ checkpoints (`cp_occ` columns 0-3 as
    cp_count, 4-7 as the uint64 one-hot planes), which are all that `occ`
    and `backward_ext` read.  bwt and sa are left empty."""
    cp_occ = np.asarray(device_index.cp_occ)
    return FmIndex(
        ref_seq_len=int(device_index.ref_seq_len),
        count=np.asarray(device_index.count, np.int64),
        bwt=np.zeros(0, np.uint8),
        sentinel_index=int(device_index.sentinel_index),
        sa=np.zeros(0, np.int64),
        cp_count=cp_occ[:, :4],
        one_hot=cp_occ[:, 4:].view(np.uint64),
    )


def occ(idx: FmIndex, pp: int, c: int) -> int:
    """# of character c in bwt[0:pp] (GET_OCC, FMI_search.h:81-89)."""
    blk = pp >> CP_SHIFT
    y = pp & CP_MASK
    base = int(idx.cp_count[blk, c])
    if y == 0:
        return base
    mask = np.uint64(0xFFFFFFFFFFFFFFFF) << np.uint64(64 - y)
    return base + int(bin(int(idx.one_hot[blk, c] & mask)).count("1"))


# SMEM as a tuple-like dict: rid, m, n, k, l, s
def backward_ext(idx: FmIndex, smem: dict, a: int) -> dict:
    """backwardExt (FMI_search.cpp:1536-1565)."""
    k = [0] * 4
    s = [0] * 4
    sp = int(smem["k"])
    ep = sp + int(smem["s"])
    for b in range(4):
        occ_sp = occ(idx, sp, b)
        occ_ep = occ(idx, ep, b)
        k[b] = int(idx.count[b]) + occ_sp
        s[b] = occ_ep - occ_sp
    sentinel_offset = 1 if (sp <= idx.sentinel_index < ep) else 0
    l = [0] * 4
    l[3] = int(smem["l"]) + sentinel_offset
    l[2] = l[3] + s[3]
    l[1] = l[2] + s[2]
    l[0] = l[1] + s[1]
    out = dict(smem)
    out["k"], out["l"], out["s"] = k[a], l[a], s[a]
    return out


def _forward_ext(idx: FmIndex, smem: dict, a: int) -> dict:
    """Forward extension = backward extension on the reverse complement
    (swap k/l, extend with 3-a, swap back). FMI_search.cpp:1040-1056."""
    sm = dict(smem)
    sm["k"], sm["l"] = smem["l"], smem["k"]
    ext = backward_ext(idx, sm, 3 - a)
    ext["k"], ext["l"] = ext["l"], ext["k"]
    return ext


def get_smems_one_pos(
    idx: FmIndex,
    enc_read: np.ndarray,
    x: int,
    min_intv: int,
    min_seed_len: int,
    rid: int = 0,
):
    """One starting position: forward sweep + backward SMEM collection.

    Mirrors getSMEMsOnePosOneThread's per-read body
    (FMI_search.cpp:1002-1178).  Returns (smems, next_x).
    """
    readlength = len(enc_read)
    matches = []
    a = int(enc_read[x])
    next_x = x + 1
    if a >= 4:
        return matches, next_x

    smem = {
        "rid": rid,
        "m": x,
        "n": x,
        "k": int(idx.count[a]),
        "l": int(idx.count[3 - a]),
        "s": int(idx.count[a + 1] - idx.count[a]),
    }
    prev = []
    for j in range(x + 1, readlength):
        a = int(enc_read[j])
        next_x = j + 1
        if a >= 4:
            break
        new = _forward_ext(idx, smem, a)
        new["n"] = j
        if new["s"] != smem["s"]:
            prev.append(dict(smem))
        if new["s"] < min_intv:
            next_x = j
            break
        smem = new
    else:
        pass
    if smem["s"] >= min_intv:
        prev.append(dict(smem))
    prev.reverse()

    # Backward search over candidate right-maximal intervals
    num_prev = len(prev)
    for j in range(x - 1, -1, -1):
        if num_prev == 0:
            break
        a = int(enc_read[j])
        if a > 3:
            break
        num_curr = 0
        curr_s = -1
        p = 0
        while p < num_prev:
            sm = prev[p]
            new = backward_ext(idx, sm, a)
            new["m"] = j
            if new["s"] < min_intv and (sm["n"] - sm["m"] + 1) >= min_seed_len:
                matches.append(dict(sm))
                break
            if new["s"] >= min_intv and new["s"] != curr_s:
                curr_s = new["s"]
                prev[num_curr] = new
                num_curr += 1
                break
            p += 1
        p += 1
        while p < num_prev:
            sm = prev[p]
            new = backward_ext(idx, sm, a)
            new["m"] = j
            if new["s"] >= min_intv and new["s"] != curr_s:
                curr_s = new["s"]
                prev[num_curr] = new
                num_curr += 1
            p += 1
        num_prev = num_curr
    if num_prev != 0:
        sm = prev[0]
        if (sm["n"] - sm["m"] + 1) >= min_seed_len:
            matches.append(dict(sm))
    return matches, next_x


def get_smems_all_pos(
    idx: FmIndex, enc_read: np.ndarray, min_intv: int, min_seed_len: int, rid: int = 0
):
    """All-position SMEM search for one read (getSMEMsAllPos do-while)."""
    matches = []
    x = 0
    readlength = len(enc_read)
    while x < readlength:
        got, x = get_smems_one_pos(idx, enc_read, x, min_intv, min_seed_len, rid)
        matches.extend(got)
    return matches


def bwt_seed_strategy_one_read(
    idx: FmIndex, enc_read: np.ndarray, max_intv: int, min_seed_len: int, rid: int = 0
):
    """LAST-strategy seeding (bwtSeedStrategyAllPosOneThread)."""
    matches = []
    readlength = len(enc_read)
    x = 0
    while x < readlength:
        next_x = x + 1
        a = int(enc_read[x])
        if a < 4:
            smem = {
                "rid": rid,
                "m": x,
                "n": x,
                "k": int(idx.count[a]),
                "l": int(idx.count[3 - a]),
                "s": int(idx.count[a + 1] - idx.count[a]),
            }
            for j in range(x + 1, readlength):
                next_x = j + 1
                a = int(enc_read[j])
                if a >= 4:
                    break
                new = _forward_ext(idx, smem, a)
                new["n"] = j
                smem = new
                if smem["s"] < max_intv and (smem["n"] - smem["m"] + 1) >= min_seed_len:
                    if smem["s"] > 0:
                        matches.append(dict(smem))
                    break
        x = next_x
    return matches


def sort_smems(smems):
    """compare_smem: rid asc, m asc, n desc (FMI_search.cpp:1480-1519)."""
    return sorted(smems, key=lambda s: (s["rid"], s["m"], -s["n"]))


def fmi_pipeline(
    idx: FmIndex,
    enc_reads,
    min_seed_len: int = 19,
    split_width: int = 10,
    max_mem_intv: int = 20,
    split_factor: float = 1.5,
):
    """Full 3-phase driver pipeline for a batch (fmi.cpp:229-345).

    enc_reads: list of int arrays (0-3, >=4 ambiguous).
    Returns (sorted smems list, num_smem1, num_smem2, num_smem3).
    """
    split_len = int(min_seed_len * split_factor + 0.499)
    all_smems = []
    # Phase 1: all-pos SMEMs, min_intv=1
    smems1 = []
    for rid, read in enumerate(enc_reads):
        smems1.extend(get_smems_all_pos(idx, read, 1, min_seed_len, rid))
    # Phase 2: reseed long low-occurrence SMEMs at their midpoint
    smems2 = []
    for sm in smems1:
        start, end = sm["m"], sm["n"] + 1
        if end - start < split_len or sm["s"] > split_width:
            continue
        x = (end + start) >> 1
        got, _ = get_smems_one_pos(
            idx, enc_reads[sm["rid"]], x, sm["s"] + 1, min_seed_len, sm["rid"]
        )
        smems2.extend(got)
    # Phase 3: LAST strategy
    smems3 = []
    for rid, read in enumerate(enc_reads):
        smems3.extend(
            bwt_seed_strategy_one_read(idx, read, max_mem_intv, min_seed_len + 1, rid)
        )
    all_smems = sort_smems(smems1 + smems2 + smems3)
    return all_smems, len(smems1), len(smems2), len(smems3)


def encode_read(s: str) -> np.ndarray:
    """fmi.cpp:141-177 — A0 C1 G2 T3, others 4."""
    return np.array([_CODE.get(c.upper(), 4) for c in s], dtype=np.int32)
