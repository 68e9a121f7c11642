"""Device-scaling harness: items/s of a sharded kernel at 1..N ranks.

    python -m genomicsbench_palisade_tpu_torch.tools.scaling_bench
        [--kernel phmm|kmer] [--devices 1,2,4] [--batch 512] [--iters 8]
        [--device cpu]

Counterpart of tools/scaling_bench.py.  Each point n runs
`parallel.dp.phmm_forward_sharded` (phmm testcases/s) or
`count_kmers_sharded` (kmer reads/s) on n ranks: one rank is this process
(a mesh with no group), more are spawned by `parallel.mesh.spawn`, a rank a
card (NCCL), ranks past the cards sharing them over gloo, or on the CPU.
Every rank makes the JAX tool's batch from default_rng(0); rank 0 times
`--iters` calls after one warm call, the ranks meeting in a barrier before
and after.  Prints the JAX tool's keys: one JSON line a point (items/s,
the efficiency against n times the first point, the static-shard load
imbalance of `mesh.shard_work_imbalance`, the reference's maxTicks/avgTicks)
and a summary line.  Where ranks share a card or the CPU's cores, a note
on stderr says the efficiency is then no scaling figure: that needs one
card a rank.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import rank_device, shares_cards, spawn_ranks


def _phmm_batch(b, rng, r_pad=128, h_pad=192):
    from ..ops import phmm as P

    reads, haps, pairs = [], [], []
    for i in range(b):
        rl = int(rng.integers(60, r_pad - 1))
        hl = int(rng.integers(rl, h_pad))
        hap = rng.integers(0, 4, hl)
        reads.append({
            "bases": hap[:rl].copy(),
            "q": rng.integers(36, 60, rl),
            "i": rng.integers(36, 60, rl),
            "d": rng.integers(36, 60, rl),
            "c": rng.integers(36, 60, rl),
        })
        haps.append(hap)
        pairs.append((i, i))
    batch = P.prepare_batch(reads, haps, pairs, r_pad=r_pad, h_pad=h_pad)
    work = [(len(r["bases"]) + 1) * len(h) for r, h in zip(reads, haps)]
    return batch, work


def _kmer_batch(b, rng):
    from ..ops.kmer import encode_reads_np

    reads = ["".join(rng.choice(list("ACGT"), 5500)) for _ in range(b // 8)]
    return encode_reads_np(reads)


def _timed(mesh, fn, iters):
    """(the last result, mean seconds of `iters` calls after a warm one)."""
    from ..parallel import mesh as M

    out = fn()
    M.barrier(mesh)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    M.barrier(mesh)
    return out, (time.perf_counter() - t0) / iters


def bench_phmm(mesh, batch, work, iters=8):
    """(testcases/s, load imbalance) of the sharded f32 forward pass; the
    outputs come back to every rank as numpy, so a call has ended when it
    returns."""
    from ..parallel import dp, mesh as M

    rows, n = M.shard_batch(batch, mesh)
    _, dt = _timed(mesh, lambda: dp.phmm_forward_sharded(mesh, rows), iters)
    return n / dt, M.shard_work_imbalance(work, mesh.size)


def bench_kmer(mesh, bases, lengths, iters=8):
    """(reads/s, load imbalance, total k-mers) of the sharded counter; its
    metrics are host ints, so a call has ended when it returns."""
    from ..parallel import dp, mesh as M

    out, dt = _timed(mesh, lambda: dp.count_kmers_sharded(mesh, bases, lengths), iters)
    return len(bases) / dt, M.shard_work_imbalance(lengths, mesh.size), out["total_kmers"]


def point(mesh, kernel: str, batch: int, iters: int):
    """(items/s, load imbalance) of one point on this rank's mesh."""
    rng = np.random.default_rng(0)
    if kernel == "phmm":
        return bench_phmm(mesh, *_phmm_batch(batch, rng), iters)
    bases, lengths = _kmer_batch(batch, rng)
    return bench_kmer(mesh, bases, lengths, iters)[:2]


def point_rank(rank: int, n: int, kernel: str, batch: int, iters: int, device_type: str,
               out: str):
    """A spawned rank of an n-rank point; rank 0 writes (items/s, imbalance)."""
    from ..parallel import mesh as M

    res = point(M.make_mesh(n, device=rank_device(device_type, rank)), kernel, batch, iters)
    if rank == 0:
        Path(out).write_text(json.dumps(res))


def run_point(n: int, kernel: str, batch: int, iters: int, device) -> tuple:
    if n == 1:
        from ..parallel import mesh as M

        return point(M.make_mesh(None, device=device), kernel, batch, iters)
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "point.json")
        spawn_ranks(point_rank, n, device.type, (n, kernel, batch, iters, device.type, out))
        return tuple(json.loads(Path(out).read_text()))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="scaling_bench")
    ap.add_argument("--kernel", default="phmm", choices=("phmm", "kmer"))
    ap.add_argument("--devices", default=None,
                    help="comma list of rank counts, default 1,2,4,... up to the cards")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (default: a rank a card, ranks past the cards sharing them) "
                         "or cpu")
    args = ap.parse_args(argv)
    import torch

    from .. import default_device

    device = default_device(args.device)
    n_local = torch.cuda.device_count() if device.type == "cuda" else 1
    if args.devices:
        points = [int(x) for x in args.devices.split(",")]
    else:
        points, d = [], 1
        while d <= n_local:
            points.append(d)
            d *= 2

    results = [(nd, *run_point(nd, args.kernel, args.batch, args.iters, device))
               for nd in points]

    shared = [nd for nd in points if nd > 1 and (device.type == "cpu"
                                                   or shares_cards(device.type, nd))]
    if shared:
        where = ("the CPU's cores" if device.type == "cpu" else
                 f"{torch.cuda.device_count()} card(s) over gloo")
        print(json.dumps({"note": f"{shared} ranks share {where}, so flat total throughput "
                                  "== ideal; efficiency is only a scaling figure with a "
                                  "card a rank"}), file=sys.stderr)
    base = results[0][1]
    for nd, rps, imb in results:
        eff = rps / (base * nd)
        print(json.dumps({
            "kernel": args.kernel, "devices": nd,
            "items_per_s": round(rps, 1),
            "scaling_efficiency": round(eff, 3),
            "load_imbalance": round(imb, 4),
        }))
    best = results[-1]
    print(json.dumps({
        "metric": f"{args.kernel}_scaling_eff_{best[0]}dev",
        "value": round(best[1] / (base * best[0]), 3),
        "unit": "fraction_of_linear",
        "vs_baseline": round(best[1] / (base * best[0]) / 0.8, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
