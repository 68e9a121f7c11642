"""Parser for the phmm benchmark test-file format.

Format (benchmarks/phmm/PairHMMUnitTest.cpp:118-594 read_batch/read_testfile):
repeated batches of

    num_reads num_haps
    <num_reads x 5 whitespace-separated strings: bases q i d c>
    <num_haps x 1 string: hap bases>

Quality strings are phred+33; q is floored at 6 after decoding
(normalize(q, 6), PairHMMUnitTest.cpp:107-113).  Testcases are the
read x hap cross product in read-major order.

Same results as genomicsbench_palisade_tpu/io/phmm_batch.py; strings are
decoded with byte lookups instead of a per-character loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops.oracle.phmm import AMBIG_CODE, BASE_CODE

# byte -> base code, as oracle.encode_bases maps each character
_BASE_LUT = np.full(256, AMBIG_CODE, dtype=np.int32)
for _ch, _code in BASE_CODE.items():
    _BASE_LUT[ord(_ch)] = _code
    _BASE_LUT[ord(_ch.lower())] = _code


@dataclass
class PhmmBatch:
    id: int
    reads: list = field(default_factory=list)  # dicts: bases,q,i,d,c (arrays)
    haps: list = field(default_factory=list)  # int arrays

    @property
    def num_reads(self):
        return len(self.reads)

    @property
    def num_haps(self):
        return len(self.haps)

    @property
    def pairs(self):
        """Read-major cross product (PairHMMUnitTest.cpp:564-579)."""
        return [(r, h) for r in range(self.num_reads) for h in range(self.num_haps)]


def _bytes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("ascii"), dtype=np.uint8)


def encode_bases(s: str) -> np.ndarray:
    return _BASE_LUT[_bytes(s)]


def _normalize(s: str, min_value: int = 0) -> np.ndarray:
    return np.maximum(_bytes(s).astype(np.int32) - 33, min_value)


def parse_testfile(path_or_file) -> list[PhmmBatch]:
    if hasattr(path_or_file, "read"):
        tokens = path_or_file.read().split()
    else:
        with open(path_or_file) as f:
            tokens = f.read().split()
    pos = 0
    batches = []
    bid = 0
    while pos + 1 < len(tokens):
        num_reads = int(tokens[pos])
        num_haps = int(tokens[pos + 1])
        pos += 2
        batch = PhmmBatch(id=bid)
        for _ in range(num_reads):
            bases, q, i, d, c = tokens[pos : pos + 5]
            pos += 5
            batch.reads.append(
                {
                    "bases": encode_bases(bases),
                    "q": _normalize(q, 6),
                    "i": _normalize(i),
                    "d": _normalize(d),
                    "c": _normalize(c),
                }
            )
        for _ in range(num_haps):
            batch.haps.append(encode_bases(tokens[pos]))
            pos += 1
        batches.append(batch)
        bid += 1
    return batches
