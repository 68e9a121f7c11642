"""tools/gather_lanes.py on the CPU: its depths and builds, the wrapper's
measured depth table it sweeps, the instance names it reads ptxas's usage
under, and its pick; the sweep itself needs a CUDA card."""

import pytest
import torch

from genomicsbench_palisade_tpu_torch.ops import occ_gather as G
from genomicsbench_palisade_tpu_torch.tools import gather_lanes as T


def test_every_candidate_is_in_a_build_and_the_table_is_a_candidate():
    assert T.DEPTHS == tuple(sorted(set(T.DEPTHS)))  # one build a depth
    for name in ("row2", "row8"):
        assert G.LAYOUTS[name] == int(name[3:])  # rows_in_flight is the depth
    assert set(G.LAYOUTS.values()) <= set(T.DEPTHS)
    assert G.LAYOUTS["tile"] <= 32  # a lane reads one index of the warp's step


@pytest.mark.parametrize("layouts", [None, {"tile": 2}])
def test_layout_defines_put_a_sweep_layout_over_the_table(layouts):
    """The build's -D pairs: every launch's depth, the table's unless the
    sweep names it; the row and tile wrappers build one library."""
    defines = dict(G.layout_defines(layouts))
    assert set(defines) == {"OCC_ROW2_DEPTH", "OCC_ROW8_DEPTH", "OCC_TILE_DEPTH"}
    assert defines["OCC_TILE_DEPTH"] == (layouts or G.LAYOUTS)["tile"]
    assert defines["OCC_ROW8_DEPTH"] == 8 and defines["OCC_ROW2_DEPTH"] == 2
    assert G.OccGatherRowKernel(layouts).defines == G.OccGatherTileKernel(layouts).defines


def test_kernel_tag_names_the_instance():
    assert T.kernel_tag("row", 8) == "occ_gather_row_kernelILi8E"
    assert T.kernel_tag("tile", 16) == "occ_gather_tile_kernelILi16E"


def test_fastest_picks_per_table_kernel_and_depth():
    rows = [{"table": t, "kernel": "row", "depth": d, "ms": ms}
            for t in ("a", "b") for d, ms in ((2, 0.6), (8, 0.5), (16, 0.45 if t == "a" else 0.7))]
    rows.append({"table": "a", "kernel": "tile", "depth": 4, "ms": 2.4})
    best = T.fastest(rows)
    assert best == {"a/row": {"depth": 16, "ms": 0.45}, "b/row": {"depth": 8, "ms": 0.5},
                    "a/tile": {"depth": 4, "ms": 2.4}}


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        T.run()
