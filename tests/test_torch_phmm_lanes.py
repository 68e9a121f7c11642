"""tools/phmm_lanes.py on the CPU: its candidates, case generator, argument
parsing and ptxas parser (the sweep itself needs a CUDA card)."""

import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu_torch.cli.phmm import PHMM_EDGES
from genomicsbench_palisade_tpu_torch.ops import phmm as P
from genomicsbench_palisade_tpu_torch.tools import phmm_lanes as T

PTXAS_LOG = """\
nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -DPHMM_F32_LANES_512=16
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119phmm_forward_kernelIdLi32ELi8EEEvNS_5BatchENS_6TablesIT_EEPS3_S5_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119phmm_forward_kernelIdLi32ELi8EEEvNS_5BatchENS_6TablesIT_EEPS3_S5_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 202 registers, 488 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119phmm_forward_kernelIfLi16ELi16EEEvNS_5BatchENS_6TablesIT_EEPS3_S5_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119phmm_forward_kernelIfLi16ELi16EEEvNS_5BatchENS_6TablesIT_EEPS3_S5_
    24 bytes stack frame, 20 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, 488 bytes cmem[0]
"""


def test_candidates_cover_each_edge_and_respect_row_limits():
    cands = T.candidates()
    for dt in ("f32", "f64"):
        for e in PHMM_EDGES:
            mine = [c for c in cands if c[:2] == (dt, e)]
            assert mine, (dt, e)
            # one tile, but for double at 512 rows: 16 rows a lane would need
            # 320 registers
            assert any(lanes * rows == e for _, _, lanes, rows in mine) == ((dt, e) != ("f64", 512))
            for _, _, lanes, rows in mine:
                assert lanes in T.LANES and 2 <= rows <= T.MAX_ROWS[dt]
                assert e // 4 <= lanes * rows <= e
    assert ("f64", 512, 32, 16) not in cands and ("f32", 512, 32, 16) in cands
    assert T.defines_of("f64", 128, 16, 8) == (("PHMM_F64_LANES_128", 16),
                                              ("PHMM_F64_ROWS_128", 8))


@pytest.mark.parametrize("edge", PHMM_EDGES)
def test_make_cases_fill_the_bucket(edge):
    reads, haps, pairs = T.make_cases(np.random.default_rng(0), 64, edge)
    assert len(pairs) == 64
    for (r, h) in pairs:
        rl, hl = len(reads[r]["bases"]), len(haps[h])
        assert edge // 2 <= rl < edge and max(rl, 50) <= hl <= T.H_PAD
    batch = P.prepare_batch(reads, haps, pairs, r_pad=edge, h_pad=T.H_PAD)
    assert batch["rs_row"].shape == (64, edge) and batch["hap"].shape == (64, T.H_PAD)
    # the dataset's kind: finite float likelihoods, none sent to the f64 pass
    _, raw, fallback = P.phmm_forward(P.as_device_batch(
        P.prepare_batch(reads[:4], haps[:4], pairs[:4], r_pad=edge, h_pad=T.H_PAD), "cpu"))
    assert np.isfinite(raw).all() and not fallback.any()


def test_parse_args():
    args = T.parse_args([])
    assert (args.cases, args.reps, args.seed) == (16384, 5, 1)
    assert args.dtypes == ("f32", "f64") and args.edges == PHMM_EDGES
    args = T.parse_args(["--cases", "64", "--dtypes", "f64", "--edges", "128,512"])
    assert args.cases == 64 and args.dtypes == ("f64",) and args.edges == (128, 512)
    for bad in (["--dtypes", "f16"], ["--edges", "100"]):
        with pytest.raises(SystemExit):
            T.parse_args(bad)


def test_ptxas_usage_reads_each_instance():
    usage = T.ptxas_usage(PTXAS_LOG)
    assert usage == {("f64", 32, 8): {"registers": 202, "spill_stores": 0, "spill_loads": 0},
                     ("f32", 16, 16): {"registers": 255, "spill_stores": 20, "spill_loads": 16}}


def test_fastest_and_run_needs_a_card(monkeypatch):
    rows = [{"dtype": "f32", "edge": 64, "lanes": 8, "rows": 8, "ms": 2.0},
            {"dtype": "f32", "edge": 64, "lanes": 16, "rows": 4, "ms": 1.0},
            {"dtype": "f64", "edge": 64, "lanes": 32, "rows": 2, "ms": 3.0}]
    assert T.fastest(rows) == {"f32 64": [16, 4], "f64 64": [32, 2]}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.run(cases=4)
