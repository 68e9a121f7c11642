"""The sharded k-mer counter at scale, held to the native host counter.

    python -m genomicsbench_palisade_tpu_torch.tools.kmer_sharded_bench
        [--mbp 100] [--devices 8] [--genome-mbp 2.5] [--smoke] [--out FILE]
        [--device cpu]

Counterpart of tools/kmer_sharded_bench.py: `parallel.dp.count_kmers_sharded`
over `--devices` spawned ranks (a rank a card over NCCL, ranks past the
cards sharing them over gloo, or the CPU) at >= 100 Mbp, the KMER_SCALE
coverage regime: 10 kb reads over one genome with 1% substitutions, k 17
(`--smoke`: 0.4 Mbp of 6 kb reads over 50 kb).  The metrics must equal
`ops.kmer.count_kmers_host` (native/kmercnt.cpp) on the same reads; the
port builds native/ on every host, so there is no fallback.  Prints one
JSON line with the JAX tool's keys (`backend` is the device type and
`group_backend` the group's), per-shard occupancy and distinct k-mers
after the exchange; writes it to `--out` only when that is given.

Match: benchmarks/kmer-cnt/vertex_index.cpp:515-659 (atomic shared
counter -> per-shard disjoint key ranges + a summed reduction here).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import pickle
import sys
import tempfile
import time

import numpy as np

from . import append_entry, rank_device, spawn_ranks

SEED = 20260826


def synth_reads(mbp: float, genome_mbp: float, read_len: int):
    """The JAX tool's reads: uniform starts on one random genome, 1%
    substitutions; (reads, total bases)."""
    rng = np.random.default_rng(SEED)
    total = int(mbp * 1e6)
    genome = rng.integers(0, 4, int(genome_mbp * 1e6)).astype(np.uint8)
    n_reads = total // read_len
    starts = rng.integers(0, len(genome) - read_len, n_reads)
    reads = []
    for s in starts:
        r = genome[s:s + read_len].copy()
        mut = rng.random(read_len) < 0.01
        r[mut] = rng.integers(0, 4, int(mut.sum()))
        reads.append(r)
    return reads, total


def count_rank(rank: int, n: int, device_type: str, tmp: str):
    """A rank: the sharded count over the padded reads in `tmp`; rank 0
    pickles the metrics, per-shard stats, seconds and the group's backend."""
    import torch.distributed as dist

    from ..parallel import dp, mesh as M

    mesh = M.make_mesh(n, device=rank_device(device_type, rank))
    bases = np.load(pathlib.Path(tmp) / "bases.npy", mmap_mode="r")
    lengths = np.load(pathlib.Path(tmp) / "lengths.npy")
    M.barrier(mesh)
    t0 = time.perf_counter()
    metrics, shard = dp.count_kmers_sharded(mesh, bases, lengths, return_shard_stats=True)
    M.barrier(mesh)
    secs = time.perf_counter() - t0
    if rank == 0:
        (pathlib.Path(tmp) / "result.pkl").write_bytes(pickle.dumps(
            {"metrics": metrics, "occ": shard["occ"].tolist(),
             "distinct": shard["distinct"].tolist(), "sharded_s": secs,
             "group_backend": dist.get_backend()}))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kmer_sharded_bench")
    ap.add_argument("--mbp", type=float, default=100.0)
    ap.add_argument("--devices", type=int, default=8, help="ranks")
    ap.add_argument("--genome-mbp", type=float, default=2.5)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None, help="append the JSON line to this file's list")
    ap.add_argument("--device", default=None,
                    help="cuda (default: a rank a card, ranks past the cards sharing them) "
                         "or cpu")
    args = ap.parse_args(argv)
    from .. import default_device
    from ..ops import kmer as K

    device = default_device(args.device)
    if args.smoke:
        args.mbp, args.genome_mbp = 0.4, 0.05
    read_len = 10_000 if not args.smoke else 6_000
    reads, total = synth_reads(args.mbp, args.genome_mbp, read_len)
    print(f"[gen] {len(reads)} reads x {read_len} bp = {total/1e6:.0f} Mbp", file=sys.stderr)

    ndev = args.devices
    bases, lengths = K.pad_codes_np(reads)  # pad the read count to a mesh multiple
    pad_rows = (-len(reads)) % ndev
    if pad_rows:
        bases = np.concatenate([bases, np.zeros((pad_rows, bases.shape[1]), bases.dtype)])
        lengths = np.concatenate([lengths, np.zeros(pad_rows, np.int32)])

    with tempfile.TemporaryDirectory() as tmp:
        np.save(pathlib.Path(tmp) / "bases.npy", bases)
        np.save(pathlib.Path(tmp) / "lengths.npy", lengths)
        t0 = time.perf_counter()
        spawn_ranks(count_rank, ndev, device.type, (ndev, device.type, tmp))
        spawn_s = time.perf_counter() - t0
        got = pickle.loads((pathlib.Path(tmp) / "result.pkl").read_bytes())
    metrics = got["metrics"]
    print(f"[sharded] {got['sharded_s']:.1f} s on {ndev} ranks ({spawn_s:.1f} s with the "
          f"spawn): {metrics}", file=sys.stderr)
    print(f"[shards] occ={got['occ']}", file=sys.stderr)

    t0 = time.perf_counter()
    want = K.count_kmers_host(reads, min_read_length=min(5000, read_len - 1))
    host_s = time.perf_counter() - t0
    equal = want == metrics
    print(f"[host] {host_s:.1f} s: {want}  equal={equal}", file=sys.stderr)
    assert equal, (metrics, want)

    occ_arr = np.asarray(got["occ"], np.float64)
    res = {
        "tool": "kmer_sharded_bench",
        "devices": int(ndev),
        "bases": int(total),
        "reads": len(reads),
        "k": 17,
        "metrics": metrics,
        "metrics_equal": bool(equal),
        "per_shard_occupancy": got["occ"],
        "per_shard_distinct": got["distinct"],
        "occupancy_imbalance": round(float(occ_arr.max() / max(occ_arr.mean(), 1)), 4),
        "sharded_s": round(got["sharded_s"], 1),
        "host_engine_s": round(host_s, 1),
        "backend": device.type,
        "group_backend": got["group_backend"],
        "smoke": bool(args.smoke),
    }
    print(json.dumps(res))
    if args.out:
        append_entry(args.out, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
