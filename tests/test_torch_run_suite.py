"""The port's suite of the 13 CLIs (genomicsbench_palisade_tpu_torch/tools/
run_suite.py) against the JAX tool's (tools/run_suite.py), on the CPU.

`gen_inputs` must write the JAX tool's files from the same seed: the text
and binary files byte for byte, the npz archives member for member (the
zip headers carry the time they were written).  One module-scoped run of
the port's suite with `--device cpu` runs the 14 benches, each
`python -m genomicsbench_palisade_tpu_torch.cli.<mod>` in a process of its
own, and each case asserts one bench's OK line (the JAX tool's contract
check).  A bench past its time limit is killed and fails the suite.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import zipfile
from pathlib import Path

import pytest

from genomicsbench_palisade_tpu_torch.tools import run_suite as RS

REPO = Path(__file__).resolve().parents[1]
BENCHES = ("fmi_build", "fmi", "phmm", "bsw", "chain", "kmer-cnt", "poa", "abea",
           "abea-eventalign", "pileup", "dbg", "grm", "nn-base", "nn-variant")


def jax_tool(name):
    """tools/<name>.py, the JAX system's tool, as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_gen_inputs_equal_the_jax_tools(tmp_path):
    port, jax = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax.mkdir()
    RS.gen_inputs(port)
    jax_tool("run_suite").gen_inputs(jax)
    names = sorted(p.name for p in jax.iterdir())
    assert sorted(p.name for p in port.iterdir()) == names and len(names) == 21
    for name in names:
        if name.endswith(".npz"):
            assert npz_members(port / name) == npz_members(jax / name), name
        else:
            assert (port / name).read_bytes() == (jax / name).read_bytes(), name


def test_the_benches_are_the_jax_tools(tmp_path):
    """The same 14 benches, CLI modules and arguments as the JAX tool's
    list (tools/run_suite.py:179-220), the port's package in place of the
    JAX one."""
    src = (REPO / "tools" / "run_suite.py").read_text()
    got = RS.benches(tmp_path)
    assert tuple(b[0] for b in got) == BENCHES
    for name, mod, argv, _check in got:
        assert f'("{name}", "{mod}"' in src
        for a in argv:
            a = a.replace(str(tmp_path) + "/", "")
            assert f'"{a}"' in src or f'd / "{a}"' in src, (name, a)


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = RS.main(["--workdir", str(tmp_path_factory.mktemp("suite")), "--device", "cpu",
                      "--jobs", "4"])
    return rc, out.getvalue().splitlines()


@pytest.mark.parametrize("bench", BENCHES)
def test_bench_passes_its_contract(suite, bench):
    rc, lines = suite
    assert [ln for ln in lines if ln.split()[1:2] == [bench]][0].startswith(f"OK   {bench} ("), \
        "\n".join(lines)
    assert rc == 0


def test_a_bench_past_its_time_limit_fails(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(RS, "TIMEOUT_S", 0.01)
    rc = RS.main(["--workdir", str(tmp_path), "--device", "cpu",
                  "--skip", ",".join(b for b in BENCHES if b != "phmm")])
    out = capsys.readouterr().out
    assert rc == 1
    assert "FAIL phmm (" in out and "timeout after 0.01 s" in out
    assert out.count("SKIP ") == len(BENCHES) - 1
