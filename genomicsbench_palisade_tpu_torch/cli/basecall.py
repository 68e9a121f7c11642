"""nn-base driver: `python -m genomicsbench_palisade_tpu_torch.cli.basecall
<model_source> <reads> [--chunksize 4000] [--overlap 0] [--beamsize 5]
[--precision bf16|f32] [--fastq] [--device cpu]`.

Mirrors genomicsbench_palisade_tpu/cli/basecall.py, the bonito driver's
contract (benchmarks/nn-base/bonito/basecall.py:580-646): load the model,
then for each read normalise the raw signal by its noisiest section, chunk
it with overlap, run the CTC model once over the read's chunks, stitch the
posteriors and decode (prefix beam search, or viterbi at --beamsize 1);
FASTA (or FASTQ) on stdout and the `> completed reads / duration / samples
per second` lines on stderr.  `--device` picks the torch device (default:
the card; 'cpu' runs on the CPU).

model_source: 'random' (seeded torch weights, not the JAX package's flax
init), a bonito model directory (weights_<N>.tar), a torch checkpoint
(.tar/.pth/.pt, the reference's parameter names, loaded as they are), or a
flax .msgpack saved from the JAX package's params (read by
`io.flax_msgpack`, no flax needed).  reads: .npz (name -> raw signal), a
.fast5 when h5py imports, or a directory of either.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from datetime import timedelta

import numpy as np
import torch

from .. import default_device
from ..convert import bonito_state_from_flax
from ..io import flax_msgpack
from ..io.signal import load_signals_fast5, load_signals_npz
from ..models import bonito as B

MAX_READ_SIZE = 4e6  # basecall.py:592


def load_model(source: str, dtype=torch.float32, weights: str = "0", device="cpu"):
    """The BonitoModel of a model source, its weights in float32 on `device`,
    computing in `dtype`."""
    if os.path.isdir(source):
        cand = os.path.join(source, f"weights_{weights}.tar")
        if not os.path.exists(cand):
            tars = sorted(f for f in os.listdir(source) if f.endswith(".tar"))
            if not tars:
                raise FileNotFoundError(f"no weights_*.tar in {source}")
            cand = os.path.join(source, tars[0])
        source = cand
    if source != "random" and not source.endswith((".tar", ".pth", ".pt", ".msgpack")):
        raise ValueError(f"unrecognized model source: {source}")
    model = B.init_model(dtype=dtype)
    if source.endswith((".tar", ".pth", ".pt")):
        B.load_reference_state(model, torch.load(source, map_location="cpu", weights_only=False))
    elif source.endswith(".msgpack"):
        B.load_reference_state(model, bonito_state_from_flax(flax_msgpack.load(source),
                                                             model.blocks))
    return model.to(device)


def load_reads(path: str) -> dict:
    def load_one(p):
        return load_signals_fast5(p) if p.endswith(".fast5") else load_signals_npz(p)

    if not os.path.isdir(path):
        return load_one(path)
    signals = {}
    for f in sorted(os.listdir(path)):
        if f.endswith((".fast5", ".npz")):
            signals.update(load_one(os.path.join(path, f)))
    return signals


def call_read(model, raw, chunksize=4000, overlap=0, beamsize=5, timings: dict | None = None):
    """One read's called sequence: normalise, then `models.bonito.basecall_read`.
    `timings` accumulates normalise_s and basecall_read's phases."""
    t0 = time.perf_counter()
    norm = B.norm_by_noisiest_section(raw)
    if timings is not None:
        timings["normalise_s"] = timings.get("normalise_s", 0.0) + time.perf_counter() - t0
    return B.basecall_read(model, norm, chunksize=chunksize, overlap=overlap, beamsize=beamsize,
                           timings=timings)


def main(argv=None, timings: dict | None = None):
    ap = argparse.ArgumentParser(prog="basecall")
    ap.add_argument("model_source",
                    help="'random', torch .tar/.pth, flax .msgpack, or a "
                         "bonito model directory (weights_<N>.tar)")
    ap.add_argument("reads",
                    help=".npz (name->raw signal), .fast5, or a directory of either")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs on the CPU)")
    ap.add_argument("--weights", default="0",
                    help="weights_<N>.tar selector for model directories")
    ap.add_argument("--chunksize", default=4000, type=int)
    ap.add_argument("--overlap", default=0, type=int)
    ap.add_argument("--beamsize", default=5, type=int,
                    help="CTC prefix beam width (reference default 5; 1 = viterbi)")
    ap.add_argument("--fastq", action="store_true",
                    help="FASTQ output (constant Q20 quals — the decoder "
                         "emits sequences, not per-base posteriors)")
    # the reference driver defaults to half precision when the GPU supports
    # it (basecall.py:642): bf16 here, the decoder staying float32
    ap.add_argument("--precision", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--half", action="store_true", help="reference alias for --precision bf16")
    args = ap.parse_args(argv)
    device = default_device(args.device)

    sys.stderr.write("> loading model\n")
    dtype = torch.bfloat16 if (args.precision == "bf16" or args.half) else torch.float32
    model = load_model(args.model_source, dtype=dtype, weights=args.weights, device=device)
    signals = load_reads(args.reads)

    samples = 0
    num_reads = 0
    t0 = time.perf_counter()
    sys.stderr.write("> calling\n")
    for read_id, raw in signals.items():
        if len(raw) > MAX_READ_SIZE:
            sys.stderr.write(f"> skipping long read {read_id} ({len(raw)} samples)\n")
            continue
        num_reads += 1
        samples += len(raw)
        seq = call_read(model, raw, args.chunksize, args.overlap, args.beamsize, timings)
        if args.fastq:
            sys.stdout.write(f"@{read_id}\n{seq}\n+\n{'5' * len(seq)}\n")
        else:
            sys.stdout.write(f">{read_id}\n{seq}\n")
    duration = time.perf_counter() - t0
    if timings is not None:
        timings.update(reads=num_reads, samples=samples, duration_s=duration)

    sys.stderr.write(f"> completed reads: {num_reads}\n")
    sys.stderr.write(f"> duration: {timedelta(seconds=np.round(duration))}\n")
    sys.stderr.write("> samples per second %.1E\n" % (samples / max(duration, 1e-9)))
    sys.stderr.write("> done\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
