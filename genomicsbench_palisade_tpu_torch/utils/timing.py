"""Kernel timing and the load-imbalance metric.

The port's copy of genomicsbench_palisade_tpu/utils/timing.py: the
reference drivers' per-worker workTicks with "load imbalance =
maxTicks/avgTicks" (fmi.cpp:362-381, main_banded.cpp:941-952), a worker
being whatever the caller names (a device, a shard).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class KernelTimer:
    name: str = "kernel"
    total: float = 0.0
    per_worker: dict = field(default_factory=dict)
    _t0: float = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, worker=0):
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.per_worker[worker] = self.per_worker.get(worker, 0.0) + dt
        return dt

    def load_imbalance(self) -> float:
        if not self.per_worker:
            return 1.0
        vals = list(self.per_worker.values())
        avg = sum(vals) / len(vals)
        return max(vals) / avg if avg > 0 else 1.0

    def report(self) -> str:
        return f"{self.name}: {self.total:.4f} s, load imbalance = {self.load_imbalance():.4f}"
