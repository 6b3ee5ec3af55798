"""Telemetry: stage timers and throughput counters.

The reference has ms/us wall-clock helpers that are never called
(mytime.c:17-41) and progress via printf (command_dist.c:311). Here every
pipeline stage reports wall time and domain throughput (genomes/s,
Mbp/s, pairs/s).
"""

from __future__ import annotations

import contextlib
import logging
import time

log = logging.getLogger("kssd_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[kssd_torch %(levelname)s] %(message)s"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)


class StageTimer:
    """Accumulates wall time + work units per named stage."""

    def __init__(self):
        self.stages: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, units: float = 0.0, unit_name: str = ""):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            acc = self.stages.setdefault(name, [0.0, 0.0, unit_name])
            acc[0] += dt
            acc[1] += units

    def report(self) -> str:
        lines = []
        for name, (dt, units, unit_name) in self.stages.items():
            rate = f" ({units / dt:.2f} {unit_name}/s)" if units and dt else ""
            lines.append(f"{name}: {dt:.3f}s{rate}")
        return "; ".join(lines)
