"""The port's native host layer on the CPU: its build of native/*.cpp
(utils/native_build.py, the counterpart of native/Makefile) and the
suffix array its ctypes layer binds (io/native.sais) against the port's
doubling build and the JAX oracle's; KernelTimer against the JAX one.
Exact comparisons: the outputs are integers."""

import re
from pathlib import Path

import numpy as np
import pytest

from genomicsbench_palisade_tpu.ops.oracle import fmi as JO
from genomicsbench_palisade_tpu.utils.timing import KernelTimer as JaxKernelTimer
from genomicsbench_palisade_tpu_torch.index import builder as IB
from genomicsbench_palisade_tpu_torch.io import native
from genomicsbench_palisade_tpu_torch.utils import native_build
from genomicsbench_palisade_tpu_torch.utils.timing import KernelTimer

REPO = Path(__file__).resolve().parents[1]


def _make_var(name: str) -> list[str]:
    text = (REPO / "native" / "Makefile").read_text()
    return re.search(rf"^{name}\s*\??=\s*(.*)$", text, re.M).group(1).split()


def test_sources_and_flags_are_the_makefiles():
    assert list(native_build.SRCS) == _make_var("SRCS")
    assert list(native_build.CXXFLAGS) == _make_var("CXXFLAGS")
    assert list(native_build.LDFLAGS) == _make_var("LDFLAGS")
    assert set(native_build.SRCS) == {p.name for p in (REPO / "native").glob("*.cpp")}


def test_library_is_built_beside_the_checkout_not_in_native():
    path = native_build.build()
    assert path.parent == REPO / "build" / "native" and path.exists()
    assert path.with_suffix(".log").read_text().count(" -c ") == len(native_build.SRCS)
    assert not (REPO / "native" / "libgenomics_native.so").exists()


def test_hash_changes_with_flags_and_compiler():
    base = native_build.library_path()
    assert native_build.library_path() == base
    assert native_build.library_path(cxxflags=native_build.CXXFLAGS + ("-g",)) != base
    assert native_build.library_path(ldflags=("-shared",)) != base
    assert native_build.library_path(cxx="false") != base


def test_broken_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="false failed to build native/"):
        native_build.build()
    assert not list(tmp_path.glob("*.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="failed to build native/"):
        native_build.build()


@pytest.mark.parametrize("n,alphabet", [(0, 4), (1, 4), (2, 1), (17, 2), (300, 4), (5000, 4),
                                        (2048, 1), (999, 255)])
def test_sais_equals_doubling_and_jax_oracle(n, alphabet):
    codes = np.random.default_rng(n + alphabet).integers(0, alphabet, n).astype(np.uint8)
    got = native.sais(codes)
    assert got.dtype == np.int64 and got.shape == (n,)
    np.testing.assert_array_equal(got, IB.suffix_array(codes.astype(np.int64), "cpu").numpy())
    np.testing.assert_array_equal(got, JO.suffix_array(codes.astype(np.int64)))
    out = np.full(n + 3, -7, np.int64)
    assert native.sais(codes, out=out[2:-1]) is not None
    np.testing.assert_array_equal(out[2:-1], got)
    assert out[:2].tolist() == [-7, -7] and out[-1] == -7


def test_kernel_timer_equals_jax():
    ours, theirs = KernelTimer("k"), JaxKernelTimer("k")
    assert ours.load_imbalance() == theirs.load_imbalance() == 1.0
    for worker, secs in ((0, 3.0), (1, 1.0), (0, 2.0), (2, 0.5)):
        for t in (ours, theirs):
            t.start()
            t._t0 -= secs
            t.stop(worker)
    assert ours.per_worker.keys() == theirs.per_worker.keys()
    assert ours.load_imbalance() == pytest.approx(theirs.load_imbalance(), rel=1e-6)
    assert ours.report().split(",")[1] == theirs.report().split(",")[1]
