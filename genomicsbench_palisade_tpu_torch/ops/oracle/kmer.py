"""Canonical k-mer counting oracle (Flye KmerCounter semantics).

The port's own copy of genomicsbench_palisade_tpu/ops/oracle/kmer.py (the
port imports nothing of the JAX package).

Semantics source: benchmarks/kmer-cnt/kmer.h:16-121 (2-bit packing,
reverseComplement via ~x&3, standardForm = min(kmer, revcomp)),
vertex_index.cpp:515-659 (4-bit saturating flat counter + hash spill),
sequence.h:161-193 (A=0 C=1 G=2 T=3; any other char maps to 3 via the
-1 table entry whose low 2 bits are set), kmer_cnt.cpp:220-231 (reads
shorter than max(minReadLength, minOverlap=5000) are dropped).

Parity quirks that must be reproduced:
  * IterKmers yields positions 0..len-k-1 — the k-mer at the final
    position len-k is NOT counted (kmer.h:177-200 end iterator).
  * only forward-strand records are iterated (readId.strand()), i.e.
    each input read contributes its own k-mers once; canonicalization
    covers the reverse complement.
Reported metrics: "Total k-mers" = number of distinct canonical k-mers
observed; "Hash size" = number of distinct k-mers whose occurrence count
exceeded the 4-bit saturation (count > 15).
"""

from __future__ import annotations

from collections import Counter

import numpy as np

MIN_READ_LENGTH = 5000
DEFAULT_K = 17

_CODE = {"A": 0, "a": 0, "C": 1, "c": 1, "G": 2, "g": 2, "T": 3, "t": 3}


def encode_seq(s: str) -> np.ndarray:
    """2-bit codes; non-ACGT behaves as 3 (the -1 table entry's low bits)."""
    return np.array([_CODE.get(ch, 3) for ch in s], dtype=np.uint8)


def kmer_codes(seq_codes: np.ndarray, k: int = DEFAULT_K) -> np.ndarray:
    """Packed 2-bit k-mer codes at positions 0..len-k-1 (last one excluded)."""
    n = len(seq_codes) - k  # NOT n-k+1: reference excludes the final k-mer
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    codes = np.zeros(n, dtype=np.uint64)
    cur = 0
    for i in range(k):
        cur = (cur << 2) | int(seq_codes[i])
    mask = (1 << (2 * k)) - 1
    codes[0] = cur
    for p in range(1, n):
        cur = ((cur << 2) | int(seq_codes[p + k - 1])) & mask
        codes[p] = cur
    return codes


def revcomp_code(code: int, k: int = DEFAULT_K) -> int:
    out = 0
    for _ in range(k):
        out = (out << 2) | ((~code) & 3)
        code >>= 2
    return out


def canonical_codes(codes: np.ndarray, k: int = DEFAULT_K) -> np.ndarray:
    out = np.empty_like(codes)
    for idx, c in enumerate(codes):
        rc = revcomp_code(int(c), k)
        out[idx] = min(int(c), rc)
    return out


def count_kmers(reads, k: int = DEFAULT_K, min_read_length: int = MIN_READ_LENGTH):
    """reads: iterable of DNA strings. Returns dict with parity metrics.

    Returns {"total_kmers": distinct canonical k-mers,
             "hash_size": distinct k-mers with count > 15,
             "counter": Counter of canonical code -> occurrences}
    """
    counter: Counter = Counter()
    for read in reads:
        if len(read) <= min_read_length:  # reference keeps strictly longer
            continue          # reads (sequence_container.cpp:115 `>`)
        codes = kmer_codes(encode_seq(read), k)
        for c in canonical_codes(codes, k):
            counter[int(c)] += 1
    total = len(counter)
    hash_size = sum(1 for v in counter.values() if v > 15)
    return {"total_kmers": total, "hash_size": hash_size, "counter": counter}


# ---------------------------------------------------------------------------
# minimizer indexing (buildIndexMinimizers, vertex_index.cpp:391-489)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def kmer_hash(code: int) -> int:
    """Kmer::hash() (kmer.h:91-98): splitmix64-style mixer of the 2-bit
    representation, uint64 wraparound."""
    z = (code + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def yield_minimizers(seq_codes: np.ndarray, k: int = DEFAULT_K, window: int = 5):
    """yieldMinimizers (kmer.h:208-264): monotone deque over canonical-kmer
    hashes; emits (position, forward_kmer_code) in the reference's exact
    order (including the pre-window-fill ramp and the equal-hash tie pops).
    """
    from collections import deque

    codes = kmer_codes(seq_codes, k)
    if window == 1:
        return [(p, int(c)) for p, c in enumerate(codes)]
    canon = canonical_codes(codes, k)
    q: deque = deque()  # (position, fwd_code, hash)
    out = []
    for pos, (fwd, std) in enumerate(zip(codes, canon)):
        h = kmer_hash(int(std))
        while q and q[-1][2] > h:
            q.pop()
        q.append((pos, int(fwd), h))
        if q[0][0] <= pos - window:
            while q[0][0] <= pos - window:
                q.popleft()
            while len(q) >= 2 and q[0][2] == q[1][2]:
                q.popleft()
        if not out or out[-1][0] != q[0][0]:
            out.append((q[0][0], q[0][1]))
    return out


def build_minimizer_index(reads, k: int = DEFAULT_K, window: int = 5,
                          min_coverage: int = 1, repeat_rate: float = 1.0,
                          min_read_length: int = MIN_READ_LENGTH):
    """buildIndexMinimizers metrics (vertex_index.cpp:391-431 +
    filterFrequentKmers :175-214 + allocateIndexMemory :110-126).

    Returns dict: counter (canonical minimizer -> count), mean_frequency,
    repetitive_frequency, filtered (count of occurrences removed),
    selected_kmers, index_size, mean_index_frequency.
    """
    counter: Counter = Counter()
    for read in reads:
        if len(read) <= min_read_length:  # strict >, sequence_container.cpp:115
            continue
        codes = encode_seq(read)
        for _pos, fwd in yield_minimizers(codes, k, window):
            rc = revcomp_code(fwd, k)
            counter[min(fwd, rc)] += 1
    total = sum(c for c in counter.values() if c >= min_coverage)
    unique = sum(1 for c in counter.values() if c >= min_coverage)
    mean_freq = total / (unique + 1)
    rep_freq = repeat_rate * mean_freq
    filtered = sum(c for c in counter.values() if c > rep_freq)
    kept = {km: c for km, c in counter.items() if not c > rep_freq}
    index_size = sum(kept.values())
    selected = len(kept)
    return {
        "counter": counter,
        "mean_frequency": mean_freq,
        "repetitive_frequency": rep_freq,
        "filtered": filtered,
        "filtered_rate": (filtered / total) if total else 0.0,
        "selected_kmers": selected,
        "index_size": index_size,
        "mean_index_frequency": (index_size / selected) if selected else 0.0,
    }
