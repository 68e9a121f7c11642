"""The port's NN drivers (cli/basecall.py, cli/call_var.py) and its flax
msgpack reader (io/flax_msgpack.py) on the CPU, against the JAX CLIs and
flax.

Weights: a `.msgpack` written by `flax.serialization.to_bytes` from the JAX
package's params, read by both CLIs (by flax in the JAX CLI, by the port's
reader in the port's).  Tolerances: basecall's FASTA/FASTQ is equal at
`--precision f32` (the two forwards agree to ~5e-7, far inside any
argmax or beam margin on these posteriors); call_var's heads are within
2e-5 of the JAX CLI's (`tests/test_torch_clair.py`); the reader gives
flax's own tree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from genomicsbench_palisade_tpu.cli import basecall as jbc
from genomicsbench_palisade_tpu.cli import call_var as jcv
from genomicsbench_palisade_tpu.models import bonito as JB
from genomicsbench_palisade_tpu.models import clair as JC
from genomicsbench_palisade_tpu_torch.cli import basecall as bc
from genomicsbench_palisade_tpu_torch.cli import call_var as cv
from genomicsbench_palisade_tpu_torch.io import flax_msgpack
from genomicsbench_palisade_tpu_torch.models import bonito as B

SMALL_BLOCKS = [
    (64, 1, 9, 3, False, False),
    (96, 2, 31, 1, True, True),
    (48, 1, 15, 1, False, False),
]
TOL = 2e-5


def _same_tree(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, (np.ndarray, np.generic, jax.Array)):
        want = np.asarray(want)
        if want.dtype == jnp.bfloat16:
            want = want.astype(np.float32)
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


def test_reader_gives_flax_tree(monkeypatch):
    """Every msgpack type flax writes for a state dict, flax's ext types
    (ndarray, numpy scalar, complex), bf16 arrays, and flax's chunked form
    of large arrays (its chunk limit shrunk to 64 bytes here)."""
    from flax import serialization as S

    rng = np.random.default_rng(0)
    tree = {"f32": rng.normal(0, 1, (3, 4, 5)).astype(np.float32),
            "i8": rng.integers(-128, 127, 33).astype(np.int8),
            "bf16": jnp.asarray(rng.normal(0, 1, 7), jnp.bfloat16),
            "scalar": np.float64(2.5), "i32": np.int32(-7), "flag": True, "off": False,
            "none": None, "text": "ACGT" * 10, "small": 5, "neg": -3, "neg8": -100,
            "big": 2**40, "bigneg": -(2**33), "real": 1.25, "cplx": complex(1.0, -2.0),
            "blob": b"\x00\x01\xff", "nested": {str(i): {"k": np.arange(i + 1)} for i in range(20)},
            "empty": np.zeros((0, 3), np.float32)}
    monkeypatch.setattr(S, "MAX_CHUNK_SIZE", 64)
    data = S.msgpack_serialize(tree)
    _same_tree(flax_msgpack.loads(data), S.msgpack_restore(data))
    assert flax_msgpack.loads(data)["nested"]["19"]["k"].tolist() == list(range(20))
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.loads(data + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(data[:-1])


@pytest.fixture(scope="module")
def bonito_params():
    """The JAX init of the narrow model, with golden-like running
    statistics and a sharper decoder so that reads call bases."""
    _, params = JB.init_model(rng_seed=7, blocks=SMALL_BLOCKS)
    rng = np.random.default_rng(7)

    def stat(path, a):
        v = (rng.normal(0, 0.3, a.shape) if path[-1].key == "mean"
             else rng.uniform(0.5, 2.0, a.shape))
        return jnp.asarray(v.astype(np.float32))

    params["batch_stats"] = jax.tree_util.tree_map_with_path(stat, params["batch_stats"])
    params["params"]["decoder"]["kernel"] = params["params"]["decoder"]["kernel"] * 8.0
    return params


@pytest.fixture(scope="module")
def clair_params():
    return JC.init_model(rng_seed=5)[1]


@pytest.mark.parametrize("which", ["bonito", "clair"])
def test_reader_reads_model_params(tmp_path, which, bonito_params, clair_params):
    path = tmp_path / "w.msgpack"
    path.write_bytes(serialization.to_bytes(bonito_params if which == "bonito" else clair_params))
    _same_tree(flax_msgpack.load(path), serialization.msgpack_restore(path.read_bytes()))


def _small_blocks(monkeypatch):
    """Both packages' CLIs build the narrow model."""
    monkeypatch.setattr(JB, "DNA_R941_BLOCKS", SMALL_BLOCKS)
    monkeypatch.setattr(B, "DNA_R941_BLOCKS", SMALL_BLOCKS)


def _reads(path, seed, lengths, prefix="read"):
    rng = np.random.default_rng(seed)
    np.savez(path, **{f"{prefix}{i}": rng.normal(500, 40, n).astype(np.float32)
                      for i, n in enumerate(lengths)})


def _run(main, argv, capsys):
    assert main(argv) == 0
    cap = capsys.readouterr()
    return cap.out, cap.err


def _err_lines(err):
    return [ln for ln in err.splitlines()
            if not ln.startswith(("> duration", "> samples per second"))]


@pytest.mark.parametrize("beamsize", [1, 5])
def test_basecall_cli_equals_jax_cli(tmp_path, capsys, monkeypatch, beamsize, bonito_params):
    """A flax .msgpack, two reads (one over MAX_READ_SIZE skipped), chunks
    of 1,200 with overlap: the same FASTA and stderr lines (times aside)."""
    from genomicsbench_palisade_tpu.io import native

    monkeypatch.setattr(native, "ctc_beam_native", lambda *a, **k: None)
    monkeypatch.setenv("GENOMICS_TPU_CACHE_DIR", str(tmp_path / "xla"))
    weights = tmp_path / "bonito.msgpack"
    weights.write_bytes(serialization.to_bytes(bonito_params))
    _small_blocks(monkeypatch)
    _reads(tmp_path / "reads.npz", 3, (3000, 5100, 20))
    monkeypatch.setattr(jbc, "MAX_READ_SIZE", 5000)
    monkeypatch.setattr(bc, "MAX_READ_SIZE", 5000)
    args = [str(weights), str(tmp_path / "reads.npz"), "--chunksize", "1200", "--overlap", "120",
            "--beamsize", str(beamsize), "--precision", "f32"]
    want_out, want_err = _run(jbc.main, args, capsys)
    got_out, got_err = _run(bc.main, args + ["--device", "cpu"], capsys)
    assert got_out == want_out
    assert got_out.startswith(">read0\n") and len(got_out.splitlines()[1]) > 100
    assert "> skipping long read read1 (5100 samples)" in got_err
    assert _err_lines(got_err) == _err_lines(want_err)
    assert "> samples per second" in got_err and "> duration: " in got_err


def test_basecall_cli_model_dir_and_fastq(tmp_path, capsys, monkeypatch, bonito_params):
    """The reference's surface (a model directory of weights_<N>.tar with
    `module.`-prefixed names, a reads directory, --fastq): the JAX CLI's
    output; --half runs the bf16 stack."""
    monkeypatch.setenv("GENOMICS_TPU_CACHE_DIR", str(tmp_path / "xla"))
    _small_blocks(monkeypatch)
    model_dir = tmp_path / "bonito_dna_r941"
    model_dir.mkdir()
    state = {f"module.{k}": torch.from_numpy(np.array(v))
             for k, v in JB.save_torch_state_dict(bonito_params).items()}
    torch.save(state, model_dir / "weights_1.tar")
    reads_dir = tmp_path / "reads"
    reads_dir.mkdir()
    _reads(reads_dir / "a.npz", 4, (2500,))
    _reads(reads_dir / "b.npz", 5, (2700, 1500), prefix="b")
    args = [str(model_dir), str(reads_dir), "--weights", "1", "--fastq", "--chunksize", "1200",
            "--beamsize", "1", "--precision", "f32"]
    want_out, _ = _run(jbc.main, args, capsys)
    got_out, got_err = _run(bc.main, args + ["--device", "cpu"], capsys)
    assert got_out == want_out
    recs = got_out.splitlines()
    assert recs[0] == "@read0" and recs[2] == "+" and recs[3] == "5" * len(recs[1])
    assert "> completed reads: 3" in got_err
    half_out, _ = _run(bc.main, [str(model_dir), str(reads_dir), "--weights", "1", "--half",
                                 "--chunksize", "1200", "--beamsize", "1", "--device", "cpu"],
                       capsys)
    assert half_out.count(">") == 3 and set("".join(half_out.splitlines()[1::2])) <= set("ACGT")
    with pytest.raises(ValueError, match="unrecognized"):
        bc.load_model(str(tmp_path / "weights.bin"))
    with pytest.raises(FileNotFoundError):
        bc.load_model(str(reads_dir))


def test_basecall_random_model_runs(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(B, "DNA_R941_BLOCKS", SMALL_BLOCKS)
    _reads(tmp_path / "r.npz", 6, (4000,))
    timings = {}
    assert bc.main(["random", str(tmp_path / "r.npz"), "--chunksize", "1200", "--beamsize", "1",
                    "--device", "cpu"], timings=timings) == 0
    out = capsys.readouterr()
    assert out.out.startswith(">read0\n") and set(out.out.split("\n")[1]) <= set("ACGT")
    assert "> completed reads: 1" in out.err
    assert {"normalise_s", "forward_s", "decode_s", "samples", "duration_s"} <= set(timings)


def _call_var_outputs(main, inp, out_fn, weights, capsys, extra=()):
    stdout, _ = _run(main, ["--input_fn", str(inp), "--output_fn", str(out_fn),
                            "--chkpnt_fn", str(weights), "--sampleName", "chr20",
                            "--threads", "1", *extra], capsys)
    lines = stdout.splitlines()
    assert lines[0] == "Begin predicting..." and lines[1].startswith("Time taken: ")
    if str(out_fn).endswith(".npz"):
        data = np.load(out_fn)
        return {k: data[k] for k in data.files}
    import h5py

    with h5py.File(out_fn) as f:
        return {k: f[k][()] for k in f}


def _call_var_inputs(tmp_path, clair_params):
    rng = np.random.default_rng(8)
    batches = [rng.poisson(2.5, (4, 33, 8, 4)).astype(np.float32) for _ in range(3)]
    np.savez(tmp_path / "tensors.npz", **{f"X{i}": x for i, x in enumerate(batches)})
    weights = tmp_path / "clair.msgpack"
    weights.write_bytes(serialization.to_bytes(clair_params))
    return batches, weights


def test_call_var_cli_equals_jax_cli(tmp_path, capsys, monkeypatch, clair_params):
    """A flax .msgpack and three batches: the heads within 2e-5 of the JAX
    CLI's, the same keys, shapes and printed lines (the time aside)."""
    monkeypatch.setenv("GENOMICS_TPU_CACHE_DIR", str(tmp_path / "xla"))
    _, weights = _call_var_inputs(tmp_path, clair_params)
    want = _call_var_outputs(jcv.main, tmp_path / "tensors.npz", tmp_path / "jax.npz", weights,
                             capsys)
    got = _call_var_outputs(cv.main, tmp_path / "tensors.npz", tmp_path / "port.npz", weights,
                            capsys, ["--device", "cpu"])
    assert set(got) == set(want) == set(cv.HEADS)
    for k in cv.HEADS:
        assert got[k].shape == want[k].shape == (12, want[k].shape[1])
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0, err_msg=k)


def test_call_var_cli_h5(tmp_path, capsys, clair_params):
    """HDF5 batches in (the JAX CLI's visit order) and .h5 out: the heads
    the .npz run gives, exactly."""
    h5py = pytest.importorskip("h5py")
    batches, weights = _call_var_inputs(tmp_path, clair_params)
    with h5py.File(tmp_path / "tensors.h5", "w") as f:
        for i, x in enumerate(batches):
            f.create_dataset(f"batch{i}/X", data=x)
    assert [x.shape for x in cv.load_batches(str(tmp_path / "tensors.h5"))] == [(4, 33, 8, 4)] * 3
    want = _call_var_outputs(cv.main, tmp_path / "tensors.npz", tmp_path / "p.npz", weights,
                             capsys, ["--device", "cpu"])
    got = _call_var_outputs(cv.main, tmp_path / "tensors.h5", tmp_path / "p.h5", weights,
                            capsys, ["--device", "cpu"])
    assert set(got) == set(want)
    for k in cv.HEADS:
        np.testing.assert_array_equal(got[k], want[k])


def test_call_var_random_weights(tmp_path, capsys):
    x = np.random.default_rng(9).normal(0, 1, (6, 33, 8, 4)).astype(np.float32)
    np.savez(tmp_path / "t.npz", X=x)
    timings = {}
    assert cv.main(["--input_fn", str(tmp_path / "t.npz"), "--output_fn",
                    str(tmp_path / "p.npz"), "--device", "cpu"], timings=timings) == 0
    pred = np.load(tmp_path / "p.npz")
    assert [pred[k].shape for k in cv.HEADS] == [(6, 21), (6, 3), (6, 33), (6, 33)]
    for k in pred.files:
        np.testing.assert_allclose(pred[k].sum(-1), 1.0, rtol=1e-5)
    assert timings["tensors"] == 6 and timings["batches"] == 1
    assert "Begin predicting..." in capsys.readouterr().out
