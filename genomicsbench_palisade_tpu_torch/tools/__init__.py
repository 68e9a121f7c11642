"""Measurement tools of the port (run with `python -m`), and what the
layout sweeps (`bsw_lanes`, `phmm_lanes`, `probe_lanes`) share: their
builds, ptxas's usage and the fastest pick."""

from __future__ import annotations

import re
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..utils import build

WARM_S = 0.1  # seconds of calls before a timing on a card


def warm_up(fn, dev):
    """One call; on a card, calls one after another until WARM_S seconds
    have passed, each waited for, so that the card runs this work at its
    working clock before it is timed.  Returns the last result."""
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < WARM_S:
            out = fn()
            torch.cuda.synchronize(dev)
    return out


def time_calls(fn, dev, iters, reps=1):
    """(the best over `reps` of the mean seconds of `iters` calls in a row,
    after `warm_up`; the last result).  CUDA events on a card, the host
    clock on the CPU."""
    out = warm_up(fn, dev)
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                out = fn()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn()
            dt = time.perf_counter() - t0
        best = min(best, dt / iters)
    return best, out


class SmClock:
    """The card's SM clock (MHz) and power draw (W), sampled by nvidia-smi
    every `period_ms` from the first sample on until `close` (or the end of
    a `with` block).  `rows` holds (host perf_counter seconds, MHz, W);
    without nvidia-smi, or with `enabled` false, it stays empty."""

    def __init__(self, period_ms=20, enabled=True):
        self.rows, self._proc = [], None
        if not enabled:
            return
        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", f"--loop-ms={period_ms}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        t0 = time.perf_counter()
        while not self.rows and self._proc.poll() is None and time.perf_counter() - t0 < 10:
            time.sleep(0.005)

    def _read(self):
        for ln in self._proc.stdout:
            try:
                mhz, watts = (float(v) for v in ln.split(","))
            except ValueError:
                continue
            self.rows.append((time.perf_counter(), mhz, watts))

    def close(self):
        if self._proc is None:
            return
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._reader.join(timeout=10)
        self._proc = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def summary(self, t0=float("-inf"), t1=float("inf")) -> dict:
        """{"samples", "sm_mhz": [min, median, max], "power_w": [...]} over the
        samples taken between host times t0 and t1."""
        rows = [r for r in self.rows if t0 <= r[0] <= t1]
        if not rows:
            return {"samples": 0, "sm_mhz": "not sampled", "power_w": "not sampled"}
        out = {"samples": len(rows)}
        for k, key in ((1, "sm_mhz"), (2, "power_w")):
            vals = sorted(r[k] for r in rows)
            out[key] = [vals[0], vals[len(vals) // 2], vals[-1]]
        return out


def build_all(kernels) -> list:
    """Build each kernel's library (its source with its defines), one nvcc a
    build, all started together; the libraries' paths, in order."""
    kernels = list(kernels)
    with ThreadPoolExecutor(len(kernels)) as ex:
        return list(ex.map(lambda k: build.build(k.source, k.defines), kernels))


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_usage(log: str) -> dict:
    """{mangled entry name: {"registers", "spill_stores", "spill_loads"}} of
    every kernel instance in an nvcc -Xptxas -v log."""
    usage, cur = {}, None
    for ln in log.splitlines():
        m = _ENTRY.search(ln)
        if m:
            cur = usage.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = _USED.search(ln)
        if m:
            cur["registers"] = int(m.group(1))
        m = _SPILL.search(ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
    return usage


def fastest(rows, key, pick) -> dict:
    """{key(row): pick(row)} of the row with the least "ms" for each key."""
    best = {}
    for row in rows:
        k = key(row)
        if k not in best or row["ms"] < best[k]["ms"]:
            best[k] = row
    return {k: pick(r) for k, r in best.items()}
