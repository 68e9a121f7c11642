"""The port's Clair variant caller (models/clair.py) on the CPU, against the
golden and the JAX package.

Tolerances: the golden (`fixtures/clair_golden.npz`, a float64 numpy
transcription of the reference TF1 graph) at its own 2e-5 / 1e-4
(`tests/test_clair_golden.py`); the JAX ClairModel within 2e-5 on converted
params (3e-8 measured: both run the same float32 LSTM and dense
arithmetic).  The two converters are exact: the TF1 map and the JAX
package's converted params give the same state dict.
"""

import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu.models import clair as JC
from genomicsbench_palisade_tpu_torch.convert import clair_state_from_flax
from genomicsbench_palisade_tpu_torch.models import clair as C

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
TOL = 2e-5
HEADS = ("gt21", "genotype", "indel1", "indel2")


@pytest.fixture(scope="module")
def tf_variables():
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from generate_fixtures import _clair_variables

    return _clair_variables()


def _port(state):
    model = C.ClairModel()
    model.load_state_dict(state)
    return model.eval()


def test_golden_through_load_tf_variables(tf_variables):
    data = np.load(FIXTURES / "clair_golden.npz")
    with torch.no_grad():
        got = _port(C.load_tf_variables(tf_variables))(torch.from_numpy(data["input"]))
    for name, head in zip(HEADS, got):
        assert head.shape == data[name].shape
        np.testing.assert_allclose(head.numpy(), data[name], atol=TOL, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(head.numpy().sum(-1), 1.0, atol=1e-5)


def test_converters_agree(tf_variables):
    """load_tf_variables equals clair_state_from_flax of the JAX package's
    own TF1 conversion, tensor for tensor."""
    ours = C.load_tf_variables(tf_variables)
    via_jax = clair_state_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           JC.load_tf_variables(tf_variables)))
    assert set(ours) == set(via_jax) == set(C.ClairModel().state_dict())
    for k in ours:
        assert torch.equal(ours[k], via_jax[k]), k


@pytest.mark.parametrize("seed", [0, 3])
def test_equals_jax_model(seed):
    """Converted params of the JAX init (flax OptimizedLSTMCell's gate
    denses into torch's stacked LSTM weights) on seeded pileup tensors."""
    jm, params = JC.init_model(rng_seed=seed)
    x = np.random.default_rng(seed).poisson(3.0, (9, 33, 8, 4)).astype(np.float32)
    want = jm.apply(params, x)
    with torch.no_grad():
        got = _port(clair_state_from_flax(jax.tree_util.tree_map(np.asarray, params)))(
            torch.from_numpy(x))
    for g, w, size in zip(got, want, C.HEAD_SIZES):
        assert g.shape == (9, size)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


def test_init_model_is_seeded():
    a, b, c = C.init_model(seed=1), C.init_model(seed=1), C.init_model(seed=2)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["l4.weight"], sc["l4.weight"])
    with torch.no_grad():
        heads = a(torch.ones((2, 33, 8, 4)))
    assert [h.shape[1] for h in heads] == list(C.HEAD_SIZES)
    assert all(torch.allclose(h.sum(-1), torch.ones(2)) for h in heads)


def test_chip_smoke_recipe_is_the_fixtures(tf_variables):
    """chip_smoke.py's copy of the golden's variable recipe."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    got = chip_smoke.clair_variables()
    assert list(got) == list(tf_variables)
    assert all(np.array_equal(got[k], tf_variables[k]) for k in tf_variables)
