"""Multi-process runs of the sharded runtime, with a JSON report of the parities.

Counterpart of tools/multiprocess_bench.py (the JAX package's, over
jax.distributed).  Launches N OS processes on localhost, each joining the
group through `parallel.mesh.init_distributed` (a rank a process, its own
device: a card each, ranks beyond the cards sharing them over gloo, or the
CPU), and runs over the N-rank mesh:

  * phmm_forward_sharded: the batch split by rows;
  * count_kmers_sharded: the k-mers routed to their owners (all_to_all);
  * fmi_pipeline_index_sharded over an index saved as one shard file a
    process, each process loading only its own (index.fmi_index
    save_npz_sharded / load_npz_shard).

Rank 0 holds each result to its own single-process run, times the sharded
runs, and the launcher writes the report: {"runs": [{"processes", "ok",
"global_devices", "phmm_parity", "kmer_parity", "fmi_parity", ...}]}.

    python -m genomicsbench_palisade_tpu_torch.tools.multiprocess_bench [--procs 2] \\
        [--device cpu] [--out report.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
ITERS = 5


def _phmm_batch(rng, b):
    from ..ops import phmm as PH

    reads, haps, pairs = [], [], []
    for i in range(b):
        rl, hl = int(rng.integers(10, 40)), int(rng.integers(15, 60))
        reads.append({"bases": rng.integers(0, 4, rl), "q": rng.integers(33, 60, rl),
                      "i": rng.integers(33, 60, rl), "d": rng.integers(33, 60, rl),
                      "c": rng.integers(33, 60, rl)})
        haps.append(rng.integers(0, 4, hl))
        pairs.append((i, i))
    return PH.prepare_batch(reads, haps, pairs)


def worker_main() -> int:
    import torch

    from ..convert import fmi_index_from_numpy
    from ..index import fmi_index as FI
    from ..ops import fmi_pipeline as FP
    from ..ops import kmer as K
    from ..ops import phmm as PH
    from ..ops.oracle import kmer as KO
    from ..parallel import dp, mesh as M

    nproc, pid = int(os.environ["MP_NPROC"]), int(os.environ["MP_PID"])
    device = torch.device(os.environ["MP_DEVICE"])
    if device.type == "cuda":
        device = torch.device("cuda", pid % torch.cuda.device_count())
    torch.set_num_threads(1)
    backend = M.init_distributed(os.environ["MP_COORD"], nproc, pid, device=device.type)
    mesh = M.make_mesh(nproc, device=device)
    report = {"processes": nproc, "global_devices": mesh.size, "backend": backend,
              "device": str(mesh.device)}

    def timed(fn):
        M.barrier(mesh)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = fn()
        M.barrier(mesh)
        return out, (time.perf_counter() - t0) / ITERS

    # phmm: the batch split by rows
    rng = np.random.default_rng(0)
    batch = _phmm_batch(rng, 4 * mesh.size)
    rows, n = M.shard_batch(batch, mesh)
    (log10, _raw, _fb), report["phmm_s_per_batch"] = timed(
        lambda: dp.phmm_forward_sharded(mesh, rows))
    report["phmm_batch"] = n
    if pid == 0:
        want = PH.phmm_forward(batch, device=device)[0]
        report["phmm_parity"] = bool(np.array_equal(log10[:n], want))

    # kmer: key-range all_to_all and summed metrics
    reads = ["".join(rng.choice(list("ACGT"), 120)) for _ in range(2 * mesh.size)]
    bases, lengths = K.encode_reads_np(reads)
    out, report["kmer_s_per_batch"] = timed(
        lambda: dp.count_kmers_sharded(mesh, bases, lengths, k=17))
    if pid == 0:
        want = KO.count_kmers(reads, k=17, min_read_length=0)
        report["kmer_parity"] = out["total_kmers"] == want["total_kmers"]

    # fmi: a shard file a process, each loading only its own
    prefix = os.environ["MP_IDX_PREFIX"]
    man = FI.load_shard_manifest(prefix)
    shard = FI.load_npz_shard(prefix, pid)
    z = np.load(prefix + ".reads.npz")
    enc, ln = z["enc"], z["len"]
    packed, ovf = dp.fmi_pipeline_index_sharded(
        mesh, {"count": man["count"], "sentinel_index": int(man["sentinel_index"])}, enc, ln,
        min_seed_len=15, shard_rows=(shard["cp_occ"], shard["block_start"]))
    got = FP.collect(packed.cpu().numpy(), bool(ovf), len(ln))
    report["fmi_total_smems"] = got[1] + got[2] + got[3]
    if pid == 0:
        full = fmi_index_from_numpy(FI.load_npz_sharded(prefix), device)
        want = FP.fmi_pipeline_batch(full, enc, ln, min_seed_len=15)
        report["fmi_parity"] = bool(want[1:] == got[1:] and all(
            np.array_equal(got[0][k], want[0][k]) for k in want[0]))
        print("PARITY " + json.dumps(report), flush=True)
    M.shutdown()
    return 0


def _prepare_sharded_index(workdir: Path, nproc: int, device: str) -> str:
    """A toy index saved as one shard file a process (and the manifest),
    and 8 reads of its genome."""
    from ..index import fmi_index as FI
    from ..index.builder import build_arrays

    rng = np.random.default_rng(29)
    genome = rng.integers(0, 4, 4096).astype(np.uint8)
    prefix = str(workdir / f"mpidx{nproc}")
    FI.save_npz_sharded(build_arrays(genome, device=device), prefix, nproc)
    b, l_max = 8, 32
    enc = np.full((b, l_max), 4, np.int32)
    ln = np.zeros(b, np.int32)
    for i in range(b):
        n = int(rng.integers(20, l_max + 1))
        s = int(rng.integers(0, len(genome) - n))
        enc[i, :n] = genome[s : s + n]
        ln[i] = n
    np.savez(prefix + ".reads.npz", enc=enc, len=ln)
    return prefix


def run_group(nproc: int, device: str, timeout: float = 900.0) -> dict:
    from ..parallel.mesh import free_port

    with tempfile.TemporaryDirectory() as workdir:
        prefix = _prepare_sharded_index(Path(workdir), nproc, device)
        env = {**os.environ, "MP_ROLE": "worker", "MP_COORD": f"127.0.0.1:{free_port()}",
               "MP_NPROC": str(nproc), "MP_IDX_PREFIX": prefix, "MP_DEVICE": device}
        procs = [subprocess.Popen([sys.executable, "-m", __spec__.name],
                                  env={**env, "MP_PID": str(pid)}, cwd=str(REPO),
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for pid in range(nproc)]
        outs, ok = [], True
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                ok = False
            outs.append((p.returncode, out, err))
            ok = ok and p.returncode == 0
    result = {"processes": nproc, "ok": ok}
    for line in outs[0][1].splitlines():
        if line.startswith("PARITY "):
            result.update(json.loads(line[len("PARITY "):]))
    result["ok"] = ok and all(result.get(k) for k in ("phmm_parity", "kmer_parity",
                                                       "fmi_parity"))
    if not ok:
        result["stderr_tail"] = {f"proc{i}": f"rc={rc} " + err[-2000:]
                                 for i, (rc, _out, err) in enumerate(outs)}
    return result


def main(argv=None) -> int:
    if os.environ.get("MP_ROLE") == "worker":
        return worker_main()
    ap = argparse.ArgumentParser(prog="multiprocess_bench")
    ap.add_argument("--procs", type=int, default=None,
                    help="one N-process run (default: N = 2 and 4)")
    ap.add_argument("--device", default=None,
                    help="cuda (default: a card a process, sharing the cards over gloo "
                         "past their count) or cpu")
    ap.add_argument("--out", default=None, help="write the JSON report here too")
    args = ap.parse_args(argv)
    from .. import default_device

    device = default_device(args.device).type
    results = [run_group(n, device) for n in ([args.procs] if args.procs else [2, 4])]
    report = {"runs": results, "note": f"localhost torch.distributed, a rank a process on "
                                       f"{device}; parity held by rank 0"}
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
