"""Length bucketing: group testcases into a few padded shapes.

Same buckets as genomicsbench_palisade_tpu/io/bucketing.py.  On the GPU a
bucket bounds the padding of a batch (and so its longest testcase, and for
PairHMM the kernel instance its r_pad picks), not the number of compiles.
"""

from __future__ import annotations

DEFAULT_EDGES = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


def bucket_size(n: int, edges=DEFAULT_EDGES) -> int:
    for e in edges:
        if n <= e:
            return e
    raise ValueError(f"length {n} exceeds the largest bucket {edges[-1]}")


def group_by_buckets(items, size_fn, edges=DEFAULT_EDGES):
    """Group items by their bucketed size(s).

    size_fn(item) -> int or tuple of ints.  Returns dict bucket -> list of
    (original_index, item).
    """
    groups: dict = {}
    for i, item in enumerate(items):
        s = size_fn(item)
        if isinstance(s, tuple):
            key = tuple(bucket_size(v, edges) for v in s)
        else:
            key = bucket_size(s, edges)
        groups.setdefault(key, []).append((i, item))
    return groups
