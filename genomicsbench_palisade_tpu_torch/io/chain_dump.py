"""Parser and writer for the chain benchmark's anchor-dump format.

Counterpart of genomicsbench_palisade_tpu/io/chain_dump.py (same parse,
same bytes written).  Format (benchmarks/chain/src/host_data_io.cpp:40-80):
repeated records
    n avg_qspan max_dist_x max_dist_y bw n_segs
    <n lines: x y (uint64)>
    EOR
and the driver's output (host_data_io.cpp print_return): per call
    n
    <n lines: score<TAB>parent>
    EOR
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ChainCallInput:
    n: int
    avg_qspan: float
    max_dist_x: int
    max_dist_y: int
    bw: int
    n_segs: int
    x: np.ndarray
    y: np.ndarray


def parse_chain_dump(path_or_file) -> list[ChainCallInput]:
    if hasattr(path_or_file, "read"):
        tokens = path_or_file.read().split()
    else:
        with open(path_or_file) as f:
            tokens = f.read().split()
    calls = []
    pos = 0
    while pos + 5 < len(tokens):
        n = int(tokens[pos])
        avg_qspan = float(tokens[pos + 1])
        mdx, mdy, bw, n_segs = (int(t) for t in tokens[pos + 2 : pos + 6])
        pos += 6
        # one C-level parse of the 2n anchor tokens
        flat = np.array(tokens[pos : pos + 2 * n], dtype=np.uint64)
        x = np.ascontiguousarray(flat[0::2])
        y = np.ascontiguousarray(flat[1::2])
        pos += 2 * n
        while pos < len(tokens) and tokens[pos] != "EOR":  # skip_to_EOR
            pos += 1
        pos += 1
        calls.append(ChainCallInput(n, avg_qspan, mdx, mdy, bw, n_segs, x, y))
    return calls


def print_return(f, scores, parents):
    """Write one call's result in host_data_io.cpp's print_return format;
    large calls take one vectorized join (the same bytes)."""
    s = np.asarray(scores)
    if s.size > 256:
        p = np.asarray(parents)
        f.write(f"{s.size}\n")
        f.write("\n".join(f"{a}\t{b}" for a, b in zip(s.astype(np.int64).tolist(),
                                                      p.astype(np.int64).tolist())))
        f.write("\nEOR\n")
        return
    f.write(f"{len(scores)}\n")
    for sc, par in zip(scores, parents):
        f.write(f"{int(sc)}\t{int(par)}\n")
    f.write("EOR\n")
