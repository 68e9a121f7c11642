"""tools/abea_fill_clock.py on the CPU: its read, arguments, refusal without
a card, and its parts against the kernel's counters (the clock build itself
runs only on a CUDA card)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from genomicsbench_palisade_tpu_torch.tools import abea_fill_clock as T

SOURCE = Path(__file__).resolve().parents[1] / "genomicsbench_palisade_tpu_torch" / "csrc" / "abea_fill.cu"


def test_parts_match_the_kernels_counters():
    text = SOURCE.read_text()
    ticks = sorted(int(p) for p in re.findall(r"ABEA_TICK\((\d+)\);", text))
    assert ticks == list(range(len(T.PARTS)))
    assert f"constexpr int kClockParts = {len(T.PARTS)};" in text
    assert T.DEFINES == (("ABEA_FILL_CLOCK", 1),) and "#ifdef ABEA_FILL_CLOCK" in text


def test_synth_read_is_the_scale_bench_recipe():
    seq, events, model = T.synth_read(np.random.default_rng(17), 400)
    assert len(seq) == 400 and set(seq) <= set("ACGT")
    assert 395 <= len(events) <= 2 * 395 and events.dtype == np.float32
    assert model["level_mean"].shape == (4096,) and float(model["level_stdv"].min()) >= 1.0


def test_arguments_and_refusal_without_a_card(monkeypatch):
    args = T.parse_args([])
    assert (args.bases, args.seed, args.reps) == (13450, 17, 3)
    with pytest.raises(SystemExit):
        T.parse_args(["--bases", "10"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        T.run(bases=100)
