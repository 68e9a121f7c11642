"""tools/probe_lanes.py on the CPU: its candidates, inputs and pick, the
wrappers' measured tables it sweeps, and the helpers the layout sweeps share
(tools/__init__.py); the sweep itself needs a CUDA card."""

import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu_torch import tools
from genomicsbench_palisade_tpu_torch.ops import bsw_cuda
from genomicsbench_palisade_tpu_torch.ops import bsw_stripped as S
from genomicsbench_palisade_tpu_torch.ops import chain_micro as M
from genomicsbench_palisade_tpu_torch.tools import probe_lanes as T

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119bsw_stripped_kernelILi17ELi8EEEvPKiS2_S2_S2_PiiiiNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119bsw_stripped_kernelILi17ELi8EEEvPKiS2_S2_S2_PiiiiNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119bsw_stripped_kernelILi9ELi16EEEvPKiS2_S2_S2_PiiiiNS_6ParamsE' for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, 400 bytes cmem[0]
"""


def test_strip_candidates_cover_each_edge_within_the_row_limit():
    cands = T.strip_candidates()
    for edge in S.EDGES:
        mine = [lanes for e, lanes in cands if e == edge]
        assert mine, edge
        for lanes in mine:
            k = -(-edge // lanes)
            assert lanes in T.LANES and lanes <= edge and 1 <= k <= T.MAX_K
            assert lanes * k >= edge
    # at the probe's qe_pad, all three group sizes
    assert {lanes for e, lanes in cands if e == 136} == {8, 16, 32}
    assert [lanes for e, lanes in cands if e == 520] == [32]


def test_the_sources_defaults_are_candidates():
    """Each qe_pad edge's lane count in the wrapper's table (the sources
    have no defaults of their own) is one the sweep measures, with at most
    MAX_K rows a lane; the register banks likewise."""
    cands = T.strip_candidates()
    assert tuple(S.LANES) == S.EDGES
    for edge in S.EDGES:
        assert (edge, S.LANES[edge]) in cands
    assert M.BANKS in T.BANKS


@pytest.mark.parametrize("kernel, table", [
    (S.BswStrippedKernel, {f"BSW_STRIPPED_LANES_{e}": n for e, n in S.LANES.items()}),
    (bsw_cuda.BswExtendKernel, {f"BSW_LANES_{e}": n for e, n in bsw_cuda.LANES.items()}),
    (M.ChainMicroKernel, {"CHAIN_MICRO_BANKS": M.BANKS})])
def test_a_sweep_build_keeps_the_table_under_its_define(kernel, table):
    """The wrapper's build passes its whole table; a sweep's define
    replaces one entry and keeps the rest."""
    assert dict(kernel().defines) == table
    name = next(iter(table))
    assert dict(kernel(defines=((name, 32),)).defines) == {**table, name: 32}


def test_ptxas_usage_and_instance_usage(tmp_path):
    usage = tools.ptxas_usage(PTXAS_LOG)
    assert list(usage.values()) == [
        {"registers": 96, "spill_stores": 0, "spill_loads": 0},
        {"registers": 255, "spill_stores": 4, "spill_loads": 4}]
    lib = tmp_path / "libbsw_stripped-0.so"
    lib.with_suffix(".log").write_text(PTXAS_LOG)
    assert T.instance_usage(lib, "ILi9ELi16EE")["registers"] == 255
    assert T.instance_usage(lib, "ILi17ELi8EE")["registers"] == 96
    assert T.instance_usage(lib, "ILi5ELi32EE") == {}


def test_strip_inputs_are_the_seeded_start():
    q, t, h, e = T.strip_inputs(np.random.default_rng(0), 136, 64, 40, "cpu")
    assert q.shape == h.shape == e.shape == (136, 64) and t.shape == (40, 64)
    assert q.dtype == torch.int32 and (q[40:] == S.PAD_CODE).all()
    assert 0 <= int(h.min()) and int(h.max()) <= 60 and int(e.max()) <= 30
    # the probe's kind: the query is the target's head, 8% substituted
    same = (q[:40] == t).float().mean().item()
    assert 0.9 < same < 0.97


def test_fastest_picks_the_least_time_per_edge_and_window():
    rows = [{"kernel": "bsw_stripped", "qe_pad": 136, "lanes": 8, "ms": 0.3},
            {"kernel": "bsw_stripped", "qe_pad": 136, "lanes": 16, "ms": 0.2},
            {"kernel": "bsw_stripped", "qe_pad": 520, "lanes": 32, "ms": 1.0},
            {"kernel": "chain_micro", "w": 64, "banks": 2, "ms": 0.5},
            {"kernel": "chain_micro", "w": 64, "banks": 8, "ms": 0.6}]
    assert T.fastest(rows) == {"bsw_stripped_lanes": {136: 16, 520: 32},
                               "chain_micro_banks": {64: 2}}


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        T.run()
