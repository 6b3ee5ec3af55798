"""Telemetry: stage timers, throughput counters, optional torch.profiler
trace.

The reference has ms/us wall-clock helpers that are never called
(mytime.c:17-41) and progress via printf (command_dist.c:311). Here every
pipeline stage reports wall time and domain throughput (genomes/s,
Mbp/s, pairs/s), and ``profile_trace`` wraps a block in a torch.profiler
trace (host and, on a CUDA device, the card's kernels and copies) for
timeline inspection in TensorBoard or a Chrome trace viewer.
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


@contextlib.contextmanager
def profile_trace(logdir: str | None, device=None):
    """torch.profiler trace context (no-op when logdir is empty): records
    CPU activity, and CUDA activity too when ``device`` is a CUDA device
    (both together: CUDA alone loses events), and writes
    ``<logdir>/<host>_<pid>.<ms>.pt.trace.json`` at exit. Raises when CUDA
    activity is asked for and the profiler cannot record it. Trace in a
    fresh process, as ``kssd_torch dist --profile`` does: on torch 2.11
    with CUDA 12.8, a session that follows much unprofiled CUDA work in
    the same process records fewer GPU events, down to none."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import (
        ProfilerActivity, profile, supported_activities,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "profile_trace: this torch build cannot record CUDA "
                "activity (no CUPTI)"
            )
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
