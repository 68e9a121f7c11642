"""Parser for the bsw pair-file format.

Format (benchmarks/bsw/main_banded.cpp:148-202 loadPairs): 3-line records
    <seed score h0>
    <reference string, ASCII-digit base codes ('0'..'4')>
    <query string>
Characters are decoded by subtracting 48 ('0').

The numpy parse of genomicsbench_palisade_tpu/io/pairs.py.  Offsets into
the decoded buffer are int64 throughout: at the reference's bsw_large
scale (10,606,460 pairs, ~3.8 GB) they pass 2^31.
"""

from __future__ import annotations

import numpy as np


def _read_bytes(path_or_file) -> np.ndarray:
    """The file's bytes as a writable uint8 array (one copy)."""
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
        if isinstance(data, str):
            data = data.encode()
        return np.frombuffer(data, np.uint8).copy()
    return np.fromfile(path_or_file, np.uint8)


def _lines(arr):
    """(line starts, line ends) as int64; an unterminated last line ends
    at EOF."""
    nl = np.flatnonzero(arr == 10)
    if len(arr) and (not len(nl) or nl[-1] != len(arr) - 1):
        nl = np.append(nl, len(arr))
    starts = np.empty(len(nl), np.int64)
    if len(nl):
        starts[0] = 0
        starts[1:] = nl[:-1] + 1
    return starts, nl.astype(np.int64)


def _decode(arr) -> np.ndarray:
    """Base codes in place: each byte minus 48, read as int8 (separators
    decode to junk; only sequence slices are used)."""
    arr -= 48
    return arr.view(np.int8)


def parse_pairs(path_or_file, max_pairs: int | None = None):
    """Returns list of (query_codes, target_codes, h0) numpy tuples."""
    arr = _read_bytes(path_or_file)
    starts, nl = _lines(arr)
    n = len(nl) // 3
    if max_pairs is not None:
        n = min(n, max_pairs)
    st, en = starts.tolist(), nl.tolist()
    h0 = [int(arr[st[j] : en[j]].tobytes().partition(b" ")[0]) for j in range(0, 3 * n, 3)]
    codes = _decode(arr)
    return [(codes[st[j + 2] : en[j + 2]], codes[st[j + 1] : en[j + 1]], h0[j // 3])
            for j in range(0, 3 * n, 3)]


def parse_pairs_soa(path_or_file, max_pairs: int | None = None):
    """Struct-of-arrays parse of the same format: no per-record Python.

    Returns a dict with the whole-file decoded code buffer plus per-pair
    offset/length/h0 arrays:
        codes [bytes] int8, q_off/t_off int64, q_len/t_len int32, h0 int32
    The h0 field (an optional '-' then digits, up to a space or the line
    end) is parsed with one vectorized gather per digit position.
    """
    arr = _read_bytes(path_or_file)
    starts, nl = _lines(arr)
    n = len(nl) // 3
    if max_pairs is not None:
        n = min(n, max_pairs)
    s0 = starts[0 : 3 * n : 3]
    e0 = nl[0 : 3 * n : 3]
    neg = arr[s0] == ord("-") if n else np.zeros(0, bool)
    pos = s0 + neg
    h0 = np.zeros(n, np.int64)
    active = np.ones(n, bool)
    guard = len(arr) - 1
    for _ in range(int((e0 - pos).max(initial=0))):
        c = arr[np.minimum(pos, guard)]
        is_dig = active & (pos < e0) & (c >= 48) & (c <= 57)
        h0[is_dig] = h0[is_dig] * 10 + (c[is_dig] - 48)
        active = is_dig
        if not active.any():
            break
        pos = pos + active
    h0[neg] = -h0[neg]
    return {
        "codes": _decode(arr),
        "t_off": starts[1 : 3 * n : 3],
        "t_len": (nl[1 : 3 * n : 3] - starts[1 : 3 * n : 3]).astype(np.int32),
        "q_off": starts[2 : 3 * n : 3],
        "q_len": (nl[2 : 3 * n : 3] - starts[2 : 3 * n : 3]).astype(np.int32),
        "h0": h0.astype(np.int32),
    }
