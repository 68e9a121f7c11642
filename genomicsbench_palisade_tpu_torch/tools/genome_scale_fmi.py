"""Genome-scale FM-index rehearsal: both search engines on one index.

    python -m genomicsbench_palisade_tpu_torch.tools.genome_scale_fmi
        [--workdir DIR] [--mbp 256] [--reads 2048] [--read-len 151]
        [--batch 512] [--min-seed-len 19] [--host-only] [--device cpu]

Counterpart of tools/genome_scale_fmi.py:
  1. writes the JAX tool's uniform random reference (default_rng(7), byte
     for byte) as `big_ref.fa`, unless the directory holds one;
  2. builds the index with the compressed SA (every 8th entry, SA_COMPX=3)
     through the port's `index.builder` (`pack_fasta`, `build_arrays` on
     the card, `save_npz_full`) as `big_index.npz`, unless it is there;
  3. samples the JAX tool's reads (default_rng(11): 1% substitutions) and
     runs the native host search (`io.native.fmi_search_native`, after one
     call on 32 reads that builds its packed occ rows) and the device
     pipeline (`ops.fmi_pipeline.fmi_pipeline_batch`, `--batch` reads a
     call, after one warm call) on the same reads;
  4. prints one JSON line with the JAX tool's keys; `dump_parity` says
     whether the two SMEM dumps are the same multiset of (rid, m, n, k, l,
     s), `totals_match` whether their counts are.  Returns 1 unless both.
`--host-only` skips the device pipeline and prints the host's keys only
(the index is still built on the device).  `--device cpu` builds and
searches with torch ops on the CPU.  The reference and the index are
kept in `--workdir` when one is given (and reused, as `tools/
fmi_pack_ab.py` reads them), else written to a temporary directory that
is removed; the host engine writes its packed rows beside the index.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import default_device
from ..convert import fmi_index_from_numpy
from ..index import fmi_index as FI
from ..index.builder import build_arrays, pack_fasta, save_npz_full
from ..io.native import fmi_search_native
from ..ops.fmi_pipeline import fmi_pipeline_batch
from . import work_dir

CHUNK = 1 << 22  # bases drawn (and written) at a time
LINE = 80


def reference_codes(mbp: int, rng) -> np.ndarray:
    """The reference's bases as codes 0-3 (uint8): `mbp` million uniform
    bases, drawn CHUNK at a time from `rng`, as the JAX tool draws them."""
    n = mbp * 1_000_000
    return np.concatenate([rng.integers(0, 4, min(CHUNK, n - s), dtype=np.int8)
                           for s in range(0, n, CHUNK)]).astype(np.uint8)


def synth_reference(path, mbp: int, seed: int = 7):
    """The JAX tool's FASTA: one contig `synth_chr1` of reference_codes,
    80 bases a line, the lines restarting at each CHUNK."""
    codes = reference_codes(mbp, np.random.default_rng(seed))
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        f.write(b">synth_chr1\n")
        for s in range(0, len(codes), CHUNK):
            arr = acgt[codes[s : s + CHUNK]]
            f.write(b"\n".join(arr[i : i + LINE].tobytes() for i in range(0, len(arr), LINE))
                    + b"\n")


def sample_reads(codes, n_reads: int, read_len: int, rng) -> np.ndarray:
    """Reads sampled from the forward reference with 1% substitutions,
    int8 codes [n_reads, read_len]."""
    starts = rng.integers(0, len(codes) - read_len, n_reads)
    enc = np.stack([codes[s : s + read_len] for s in starts]).astype(np.int8)
    sub = rng.random(enc.shape) < 0.01
    enc[sub] = rng.integers(0, 4, int(sub.sum()), dtype=np.int8)
    return enc


def synth_reads(ref_fa, n_reads: int, read_len: int, seed: int = 11) -> np.ndarray:
    """The JAX tool's reads of the FASTA `ref_fa` (packed by the port's
    `pack_fasta`)."""
    codes, _names, _lengths = pack_fasta(str(ref_fa))
    return sample_reads(codes, n_reads, read_len, np.random.default_rng(seed))


def smem_key_set(allm):
    return sorted(zip(allm["rid"].tolist(), allm["m"].tolist(), allm["n"].tolist(),
                      allm["k"].tolist(), allm["l"].tolist(), allm["s"].tolist()))


def build_index(ref, idx_npz, device):
    """Index the FASTA `ref` into `idx_npz` (compressed SA); seconds."""
    t0 = time.perf_counter()
    codes, names, lengths = pack_fasta(str(ref))
    idx = build_arrays(codes, sa_compression=True, device=device)
    save_npz_full(idx, str(idx_npz), [str(n).split(None, 1)[0] for n in names], lengths)
    return time.perf_counter() - t0


def rehearse(wd, args, device) -> tuple:
    ref, idx_npz = wd / "big_ref.fa", wd / "big_index.npz"
    if not ref.exists():
        t0 = time.perf_counter()
        synth_reference(ref, args.mbp)
        print(f"[synth] {args.mbp} Mbp reference in {time.perf_counter() - t0:.0f} s",
              file=sys.stderr)
    build_s = None
    if not idx_npz.exists():
        build_s = build_index(ref, idx_npz, device)
        print(f"[build] index in {build_s:.0f} s", file=sys.stderr)

    t0 = time.perf_counter()
    didx = FI.load_npz(str(idx_npz))
    print(f"[load] index in {time.perf_counter() - t0:.0f} s "
          f"(text {int(didx.ref_seq_len):,} bp)", file=sys.stderr)
    enc = synth_reads(ref, args.reads, args.read_len)
    rl = np.full(args.reads, args.read_len, np.int32)

    # the first call builds the packed occ rows: index loading, not search
    t0 = time.perf_counter()
    fmi_search_native(didx, enc[:32], rl[:32], min_seed_len=args.min_seed_len)
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_m, h1, h2, h3 = fmi_search_native(didx, enc, rl, min_seed_len=args.min_seed_len)
    host_dt = time.perf_counter() - t0
    host_total = h1 + h2 + h3
    if args.host_only:
        return {"tool": "genome_scale_fmi", "mbp": args.mbp, "reads": args.reads,
                "host_reads_per_s": round(args.reads / host_dt, 1),
                "pack_build_s": round(pack_s, 1), "total_smems": int(host_total)}, 0

    index = fmi_index_from_numpy(didx, device)
    fmi_pipeline_batch(index, enc[: args.batch], rl[: args.batch],
                       min_seed_len=args.min_seed_len)
    t0 = time.perf_counter()
    parts, dev_total = [], 0
    for s in range(0, args.reads, args.batch):
        allm, n1, n2, n3, _ovf = fmi_pipeline_batch(
            index, enc[s : s + args.batch], rl[s : s + args.batch],
            min_seed_len=args.min_seed_len, rid_base=s)
        parts.append(allm)
        dev_total += n1 + n2 + n3
    dev_dt = time.perf_counter() - t0
    dev_m = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    parity = smem_key_set(host_m) == smem_key_set(dev_m)
    out = {
        "tool": "genome_scale_fmi",
        "mbp": args.mbp,
        "reads": args.reads,
        "build_s": None if build_s is None else round(build_s, 1),
        "host_reads_per_s": round(args.reads / host_dt, 1),
        "tpu_reads_per_s": round(args.reads / dev_dt, 1),
        "total_smems": int(host_total),
        "totals_match": bool(host_total == dev_total),
        "dump_parity": bool(parity),
    }
    return out, 0 if parity and host_total == dev_total else 1


def main(argv=None):
    ap = argparse.ArgumentParser(prog="genome_scale_fmi")
    ap.add_argument("--workdir", default=None,
                    help="keep (and reuse) big_ref.fa and big_index.npz here (default: a "
                         "temporary directory, removed)")
    ap.add_argument("--mbp", type=int, default=256)
    ap.add_argument("--reads", type=int, default=2048)
    ap.add_argument("--read-len", type=int, default=151)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--min-seed-len", type=int, default=19)
    ap.add_argument("--host-only", action="store_true",
                    help="skip the device pipeline; prints host reads/s and totals only")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (build and search with torch ops on the CPU)")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    with work_dir(args.workdir) as wd:
        out, rc = rehearse(wd, args, device)
    print(json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
