"""nn-variant driver: `python -m genomicsbench_palisade_tpu_torch.cli.call_var
--input_fn tensors.{npz,h5} [--output_fn out.npz] [--chkpnt_fn w.msgpack]
[--device cpu]`.

Mirrors genomicsbench_palisade_tpu/cli/call_var.py, the Clair prediction
driver's contract (benchmarks/nn-variant/prediction.py:11-45,71-114): load
batches of pileup tensors [N, 33, 8, 4], run the 2xBiLSTM + slice-dense
forward a batch at a time, collect the four softmax heads (gt21, genotype,
indel length 1 and 2), print `Begin predicting...` / `Time taken: %.4f s`
and write the probabilities to --output_fn (.npz, or .h5/.hdf5).

Inputs: .npz with array `X` (or per-batch arrays, taken in sorted name
order), or an HDF5 file whose 4-d datasets are the batches (needs h5py).
Weights: a flax .msgpack of the JAX package's params (read by
`io.flax_msgpack`), or seeded torch weights when omitted (not the JAX
package's flax init).  `--device` picks the torch device (default: the
card; 'cpu' runs on the CPU).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import default_device
from ..convert import clair_state_from_flax
from ..io import flax_msgpack
from ..models import clair as C

HEADS = ("gt21", "genotype", "indel_length_1", "indel_length_2")


def load_batches(path):
    if path.endswith(".npz"):
        data = np.load(path)
        if "X" in data.files:
            return [np.asarray(data["X"], np.float32)]
        return [np.asarray(data[k], np.float32) for k in sorted(data.files)]
    import h5py

    batches = []
    with h5py.File(path, "r") as f:
        def visit(_name, obj):
            if isinstance(obj, h5py.Dataset) and obj.ndim == 4:
                batches.append(np.asarray(obj, np.float32))
        f.visititems(visit)
    return batches


def load_model(chkpnt_fn: str | None = None, device="cpu") -> C.ClairModel:
    model = C.init_model()
    if chkpnt_fn:
        model.load_state_dict(clair_state_from_flax(flax_msgpack.load(chkpnt_fn)))
    return model.to(device)


def predict(model, batches, device) -> dict:
    """The four heads of every batch, concatenated, as numpy arrays."""
    outputs = {h: [] for h in HEADS}
    with torch.no_grad():
        for x in batches:
            heads = model(torch.from_numpy(np.ascontiguousarray(x)).to(device))
            for name, h in zip(HEADS, heads):
                outputs[name].append(h.cpu().numpy())
    return {k: np.concatenate(v) if v else np.zeros(0) for k, v in outputs.items()}


def main(argv=None, timings: dict | None = None):
    ap = argparse.ArgumentParser(prog="call_var")
    ap.add_argument("--input_fn", default="prediction_input.h5",
                    help="pileup tensor batches (.npz or .h5)")
    ap.add_argument("--output_fn", default="prediction_output.npz")
    ap.add_argument("--chkpnt_fn", default=None, help="flax msgpack weights")
    ap.add_argument("--threads", type=int, default=None, help="ignored")
    # accepted for reference CLI parity (prediction.py:74-110; the
    # reference's Run() only uses input_fn/output_fn/chkpnt_fn/threads)
    ap.add_argument("--sampleName", default="SAMPLE")
    ap.add_argument("--qual", type=int, default=None)
    ap.add_argument("--tensor_fn", default="PIPE")
    ap.add_argument("--call_fn", default=None)
    ap.add_argument("--bam_fn", default="bam.bam")
    ap.add_argument("--ref_fn", default=None)
    ap.add_argument("--showRef", action="store_true")
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    device = default_device(args.device)

    model = load_model(args.chkpnt_fn, device)
    t_load = time.perf_counter()
    batches = load_batches(args.input_fn)
    t_load = time.perf_counter() - t_load
    print("Begin predicting...")
    t0 = time.perf_counter()
    cat = predict(model, batches, device)
    end_time = time.perf_counter() - t0

    t1 = time.perf_counter()
    if args.output_fn.endswith((".h5", ".hdf5")):
        import h5py

        with h5py.File(args.output_fn, "w") as f:
            for k, v in cat.items():
                f.create_dataset(k, data=v)
    else:
        np.savez(args.output_fn, **cat)
    if timings is not None:
        timings.update(load_s=t_load, predict_s=end_time, write_s=time.perf_counter() - t1,
                       tensors=sum(len(x) for x in batches), batches=len(batches))
    print("Time taken: %.4f s" % end_time)
    return 0


if __name__ == "__main__":
    sys.exit(main())
