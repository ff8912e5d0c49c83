"""Phase timers + optional device profiling (port of ``utils/timers.py``).

Role of the reference's ark_std start_timer/end_timer tracing
(reference src/main.rs:91-102, Cargo.toml:24 print-trace feature).
``phase`` prints wall-clock per phase and accumulates a report; given a
CUDA device it synchronises that device before each clock reading, so a
phase's time covers the device work it enqueued.  ``device_trace`` wraps
a block in a ``torch.profiler`` profile when a directory is given and
writes a Chrome trace (``trace.json``) there.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class PhaseTimers:
    def __init__(self, verbose: bool = True, device=None):
        self.times: dict[str, float] = {}
        self.verbose = verbose
        self.device = None if device is None else torch.device(device)

    def _now(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = self._now()
        try:
            yield
        finally:
            dt = self._now() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            if self.verbose:
                print(f"[{name}] {dt:.3f}s", flush=True)

    def report(self) -> dict:
        return {k: round(v, 4) for k, v in self.times.items()}


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """torch.profiler trace context (CPU activity, and CUDA activity where
    there is a card); no-op when trace_dir is None."""
    if trace_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
