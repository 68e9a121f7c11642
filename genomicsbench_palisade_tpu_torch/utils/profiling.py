"""Kernel-region tracing on torch.profiler and NVTX.

Counterpart of genomicsbench_palisade_tpu/utils/profiling.py.  `roi()`
wraps the kernel region in a torch.profiler trace (CPU and, where there is
one, CUDA activity), written as a Chrome trace `<name>.json` under the
trace directory, with an NVTX range of the same name; `annotate()` marks
sub-phases inside it.  Enabled by `roi(trace_dir=...)` or the
GENOMICS_TPU_TRACE_DIR variable; disabled, both are no-ops.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

import torch

ENV_VAR = "GENOMICS_TPU_TRACE_DIR"


@contextlib.contextmanager
def _nvtx(name: str):
    if torch.cuda.is_available():
        with torch.cuda.nvtx.range(name):
            yield
    else:
        yield


@contextlib.contextmanager
def roi(trace_dir: str | None = None, name: str = "kernel"):
    """Region-of-interest bracket: profile everything inside when enabled."""
    trace_dir = trace_dir or os.environ.get(ENV_VAR)
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(name), _nvtx(name):
            yield
    prof.export_chrome_trace(str(Path(trace_dir) / f"{name}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named sub-phase (a profiler record and an NVTX range) when tracing."""
    if not os.environ.get(ENV_VAR):
        yield
        return
    from torch.profiler import record_function

    with record_function(name), _nvtx(name):
        yield
