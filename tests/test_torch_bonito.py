"""The port's bonito basecaller (models/bonito.py) on the CPU, against the
reference torch golden and the JAX package.

Tolerances: the reference golden (`fixtures/bonito_golden.npz`, the
reference's own torch Model under seeded weights) at its own atol 5e-4 /
rtol 1e-3 (`tests/test_bonito_golden.py`); the JAX BonitoModel at float32
within 1e-5 (3.6e-7 to 6.0e-7 measured: both run IEEE float32
convolutions, summed in another order); at bfloat16 within 3e-2 of the JAX
bf16 path (7.9e-3 to 9.6e-3 measured over three seeds on the narrow model
below, about the size of bf16 against f32 in either package, 7.1e-3 to
8.2e-3: the two frameworks round the bf16 stack at different places).  The host functions are exact:
chunking, stitching, normalisation and the decoders give the JAX
package's arrays and strings.
"""

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu.models import bonito as JB
from genomicsbench_palisade_tpu_torch.convert import bonito_state_from_flax
from genomicsbench_palisade_tpu_torch.models import bonito as B

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
SMALL_BLOCKS = [
    (64, 1, 9, 3, False, False),
    (96, 2, 31, 1, True, True),
    (48, 1, 15, 1, False, False),
]
F32_TOL = 1e-5
BF16_TOL = 3e-2


def _jax_model(seed, blocks, chunk):
    """The JAX model with seeded params and running statistics that are not
    the identity (so BatchNorm's form shows), drawn as the golden's:
    means N(0, 0.3), variances U(0.5, 2)."""
    model, params = JB.init_model(rng_seed=seed, chunk=chunk, blocks=blocks)
    rng = np.random.default_rng(seed)

    def stat(path, a):
        v = (rng.normal(0, 0.3, a.shape) if path[-1].key == "mean"
             else rng.uniform(0.5, 2.0, a.shape))
        return jnp.asarray(v.astype(np.float32))

    params["batch_stats"] = jax.tree_util.tree_map_with_path(stat, params["batch_stats"])
    return model, params


def _port_model(params, blocks, dtype=torch.float32):
    model = B.BonitoModel(blocks=blocks, dtype=dtype)
    return B.load_reference_state(model, bonito_state_from_flax(params, blocks)).eval()


def test_reference_golden_f32():
    """The reference checkpoint's parameter names load as they are."""
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from generate_fixtures import _bonito_weight_arrays

    data = np.load(FIXTURES / "bonito_golden.npz")
    arrays = _bonito_weight_arrays(json.loads(str(data["names"])))
    model = B.load_reference_state(B.BonitoModel(), {f"module.{k}": v for k, v in arrays.items()})
    assert set(model.state_dict()) == set(arrays)
    with torch.no_grad():
        got = model(torch.from_numpy(data["input"])).numpy()
    assert got.shape == data["logits"].shape
    np.testing.assert_allclose(got, data["logits"], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="missing"):
        B.load_reference_state(B.BonitoModel(), {k: v for k, v in arrays.items()
                                                 if "decoder" not in k})


@pytest.mark.parametrize("which", ["small", "dna_r941"])
def test_equals_jax_model(which):
    """Converted JAX params: float32 within 1e-5, on the narrow model and on
    one chunk through the full DNA_R941 model; bfloat16 within 3e-2 of the
    JAX bf16 path on the narrow model (XLA's bf16 convolutions take ~20 s
    on this CPU at DNA_R941's widths)."""
    blocks, chunk = (SMALL_BLOCKS, 2400) if which == "small" else (JB.DNA_R941_BLOCKS, 1200)
    jm, params = _jax_model(1, blocks, chunk)
    x = np.random.default_rng(2).normal(0, 1, (2, chunk, 1)).astype(np.float32)
    want = np.asarray(jm.apply(params, x))
    model = _port_model(params, blocks)
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 2, 1))).numpy()
    assert got.shape == want.shape == (2, -(-chunk // 3), 5)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    if which != "small":
        return
    want_bf16 = np.asarray(JB.BonitoModel(blocks=tuple(blocks), dtype=jnp.bfloat16).apply(params, x))
    model.dtype = torch.bfloat16
    with torch.no_grad():
        got_bf16 = model(torch.from_numpy(x.transpose(0, 2, 1)))
    assert got_bf16.dtype == torch.float32  # the decoder and log_softmax stay f32
    np.testing.assert_allclose(got_bf16.numpy(), want_bf16, atol=BF16_TOL, rtol=0)
    assert not np.array_equal(got_bf16.numpy(), got)  # the stack really ran in bf16


@pytest.mark.parametrize("n,cs,ov", [(9000, 4000, 400), (12345, 4000, 0), (3999, 4000, 100),
                                     (20000, 3000, 600), (4000, 4000, 0)])
def test_chunk_and_stitch_equal_jax(n, cs, ov):
    raw = np.random.default_rng(n).normal(0, 1, n).astype(np.float32)
    chunks = B.chunk_signal(raw, cs, ov)
    np.testing.assert_array_equal(chunks, JB.chunk_signal(raw, cs, ov))
    preds = np.random.default_rng(1).normal(0, 1, (len(chunks), cs // 3, 5)).astype(np.float32)
    for overlap_out in (0, ov // 3 // 2):
        want = JB.stitch(preds, overlap_out)
        np.testing.assert_array_equal(B.stitch(preds, overlap_out), want)
        np.testing.assert_array_equal(B.stitch(torch.from_numpy(preds), overlap_out).numpy(), want)


def test_norm_by_noisiest_section_equals_jax():
    """Signals with a noisy stretch, one flat, one shorter than a window and
    one of a ragged length: the windows' deviations in one reduction give
    the JAX loop's result exactly."""
    rng = np.random.default_rng(3)
    noisy = np.concatenate([rng.normal(80, 0.5, 3000), rng.normal(90, 15, 5000),
                            rng.normal(85, 0.5, 2050)])
    for sig in (noisy, rng.normal(100, 10, 12_345), np.full(700, 50.0) + rng.normal(0, 1e-3, 700),
                rng.normal(0, 1, 80), (rng.normal(500, 40, 6001)).astype(np.float32)):
        np.testing.assert_array_equal(B.norm_by_noisiest_section(sig),
                                      JB.norm_by_noisiest_section(sig))
    np.testing.assert_array_equal(B.med_mad(noisy), JB.med_mad(noisy))


def _posteriors(seed, t, temp):
    logits = np.random.default_rng(seed).normal(0, temp, (t, 5))
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


def test_viterbi_decode_equals_jax():
    for seed, temp in ((0, 1.0), (1, 4.0), (2, 0.2)):
        lp = _posteriors(seed, 600, temp)
        want = JB.viterbi_decode(jnp.asarray(lp))
        assert B.viterbi_decode(lp) == B.viterbi_decode(torch.from_numpy(lp)) == want
    ties = np.full((7, 5), -5.0, np.float32)
    for t, labs in enumerate([(1, 2), (1,), (0, 3), (3,), (2, 4), (0,), (2,)]):
        ties[t, list(labs)] = 0.0  # argmax takes the first of equals
    assert B.viterbi_decode(ties) == JB.viterbi_decode(jnp.asarray(ties)) == "AGCC"
    assert B.viterbi_decode(np.zeros((0, 5), np.float32)) == ""


def test_beam_search_equals_jax_python_path(monkeypatch):
    """The JAX module's Python walk (its native beam forced off) on seeded
    posteriors at three temperatures and beam sizes, with a step where
    every class is pruned (unnormalised log-probabilities below the
    threshold)."""
    from genomicsbench_palisade_tpu.io import native

    monkeypatch.setattr(native, "ctc_beam_native", lambda *a, **k: None)
    for seed, temp in ((0, 1.0), (1, 3.0), (2, 0.3)):
        lp = _posteriors(seed, 300, temp)
        lp[150] = -20.0  # every class pruned: the beams restart
        for beam in (1, 3, 5):
            want = JB.beam_search_decode(lp, beam_size=beam)
            assert B.beam_search_decode(lp, beam_size=beam) == want, (seed, beam)
            assert B.beam_search_decode(torch.from_numpy(lp), beam_size=beam) == want
            assert B.beam_search_decode(lp, beam_size=beam, use_native=False) == want
    lp2 = np.log(np.array([[0.55, 0.45, 0, 0, 0]] * 2).clip(1e-12))
    assert B.viterbi_decode(lp2) == "" and B.beam_search_decode(lp2) == "A"


@pytest.mark.parametrize("beamsize,overlap", [(1, 0), (1, 300), (5, 300)])
def test_basecall_read_equals_jax(monkeypatch, beamsize, overlap):
    """A normalised read of 4 chunks through both packages' basecall_read
    (the port without the JAX power-of-two padding) gives the same string."""
    from genomicsbench_palisade_tpu.io import native

    monkeypatch.setattr(native, "ctc_beam_native", lambda *a, **k: None)
    jm, params = _jax_model(4, SMALL_BLOCKS, 1200)
    # a sharper decoder, so that the read calls bases
    dec = params["params"]["decoder"]
    dec["kernel"] = dec["kernel"] * 8.0
    model = _port_model(params, SMALL_BLOCKS)
    raw = np.random.default_rng(5).normal(500, 40, 4200).astype(np.float32)
    sig = B.norm_by_noisiest_section(raw)
    want = JB.basecall_read(jm, params, sig, chunksize=1200, overlap=overlap, beamsize=beamsize)
    timings = {}
    got = B.basecall_read(model, sig, chunksize=1200, overlap=overlap, beamsize=beamsize,
                          timings=timings)
    assert got == want and len(got) > 50
    assert set(timings) == {"forward_s", "beam_s" if beamsize > 1 else "decode_s"}
    assert B.basecall(model, sig, chunksize=1200) == JB.basecall(jm, params, sig, chunksize=1200)


def test_init_model_is_seeded():
    a, b = B.init_model(seed=3, blocks=SMALL_BLOCKS), B.init_model(seed=3, blocks=SMALL_BLOCKS)
    c = B.init_model(seed=4, blocks=SMALL_BLOCKS)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["decoder.layers.0.weight"], sc["decoder.layers.0.weight"])
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (1, 1, 999)).astype(np.float32))
    with torch.no_grad():
        out = a(x)
    assert out.shape == (1, 333, 5) and torch.isfinite(out).all()


def test_chip_smoke_recipes_are_the_fixtures():
    """chip_smoke.py's copies (it runs where tests/ is not imported) of the
    golden's weight recipe and the cell's chunk arithmetic."""
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from generate_fixtures import _bonito_weight_arrays

    names = json.loads(str(np.load(FIXTURES / "bonito_golden.npz")["names"]))
    want, got = _bonito_weight_arrays(names), chip_smoke.bonito_weight_arrays(names)
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    for n in (100, 3999, 4000, 4001, 8000, 12345):
        chunks = B.chunk_signal(np.zeros(n, np.float32), 4000, 0)
        assert chip_smoke.basecall_chunks(n) == len(chunks)
        assert chip_smoke.basecall_frames(n) == len(chunks) * -(-chunks.shape[1] // 3)
