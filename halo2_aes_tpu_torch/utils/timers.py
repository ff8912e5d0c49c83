"""Phase timers, program spans and device profiling (port of
``utils/timers.py``).

Role of the reference's ark_std start_timer/end_timer tracing
(reference src/main.rs:91-102, Cargo.toml:24 print-trace feature).

``span(name, **attrs)`` marks a step of the program.  Off (the default)
it records nothing: no CUDA event, no synchronise, no profiler range, no
device allocation.  It is on while a ``torch.profiler`` profile is active
or inside ``recording()``; then it opens a profiler range (so the step
sits in the profiler's trace beside its kernels) and keeps a ``Span``
record: its name, id, parent, root, attrs (work counts taken
from shapes) and host start and end read by ``time.time_ns()``, the
clock the profiler stamps its events with.  Where CUDA is initialised it
also records a CUDA event pair on the current stream, without a
synchronise; ``spans()`` turns each pair into device-clock start and end
on the host clock through one origin event, recorded with the one
synchronise of a session (one profiler session or ``recording()``
block) at its first span.  On the CPU the device times are the host
times.  The range is a ``_RecordFunctionFast``, which the trace shows as
a host op: a ``record_function`` range is a user annotation, which the
profiler mirrors on the device's timeline as one more device event
lasting the whole span, so that every device interval it covered would
read busy.

``PhaseTimers.phase`` prints wall-clock per phase and accumulates a
report; given a CUDA device it synchronises that device before each
clock reading, so a phase's time covers the device work it enqueued; it
opens a span too.  ``device_trace`` wraps a block in a
``torch.profiler`` profile when a directory is given and writes a
Chrome trace (``trace.json``, the spans beside the kernels) and the
block's span records (``spans.json``) there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import NamedTuple

import torch


@dataclasses.dataclass
class Span:
    """One closed span; times in ns on the profiler's (Unix) clock."""
    name: str
    id: int
    parent: int | None
    root: int
    attrs: dict
    start_ns: int
    end_ns: int = 0
    device_start_ns: int = 0
    device_end_ns: int = 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def device_seconds(self) -> float:
        return (self.device_end_ns - self.device_start_ns) / 1e9


class _State:
    def __init__(self):
        self.depth = 0          # open recording() blocks
        self.on_exit = None     # recording()'s hook
        self.origin = None      # (event, host ns) of the current session
        self.stack = []         # open spans, innermost last
        self.records = []       # every span opened, in start order
        self.events = {}        # span id -> (origin, start event, end event)
        self.next_id = 0


_S = _State()
_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context manager that records the block as a span where tracing
    is on (module docstring) and does nothing where it is off."""
    if _S.depth or torch.autograd._profiler_enabled():
        return _Open(name, attrs)
    _S.origin = None            # off between sessions: the next one syncs anew
    return _OFF


def _origin():
    if _S.origin is None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        torch.cuda.synchronize()
        _S.origin = (ev, time.time_ns())
    return _S.origin


class _Open:
    __slots__ = ("name", "attrs", "rec", "range", "start")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        parent = _S.stack[-1] if _S.stack else None
        i = _S.next_id
        _S.next_id += 1
        self.rec = rec = Span(self.name, i, parent.id if parent else None,
                              parent.root if parent else i, self.attrs,
                              time.time_ns())
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        self.start = None
        if torch.cuda.is_initialized():
            self.start = (_origin(), torch.cuda.Event(enable_timing=True))
            self.start[1].record()
        _S.stack.append(rec)
        _S.records.append(rec)
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _S.events[rec.id] = (*self.start, end)
        self.range.__exit__(*exc)
        rec.end_ns = time.time_ns()
        if self.start is None:
            rec.device_start_ns, rec.device_end_ns = rec.start_ns, rec.end_ns
        _S.stack.pop()
        if _S.on_exit is not None:
            _S.on_exit(rec)
        return False


def spans() -> list:
    """The closed spans recorded so far, in start order, their device
    times resolved (this waits for the device where an event is
    pending)."""
    if _S.events:
        torch.cuda.synchronize()
        by_id = {r.id: r for r in _S.records}
        for i, ((ev0, origin_ns), start, end) in _S.events.items():
            rec = by_id[i]
            rec.device_start_ns = origin_ns + round(ev0.elapsed_time(start) * 1e6)
            rec.device_end_ns = rec.device_start_ns + round(
                start.elapsed_time(end) * 1e6)
        _S.events.clear()
    return [r for r in _S.records if r.end_ns]


def clear():
    """Forget every recorded span."""
    _S.records.clear()
    _S.events.clear()


@contextlib.contextmanager
def recording(on_exit=None):
    """Spans are on inside the block (one session); ``on_exit(span)``, if
    given, is called as each span closes (its device times not yet
    resolved)."""
    prev = _S.on_exit
    if not _S.depth:
        _S.origin = None
    _S.depth += 1
    if on_exit is not None:
        _S.on_exit = on_exit
    try:
        yield
    finally:
        _S.depth -= 1
        _S.on_exit = prev
        if not _S.depth:
            _S.origin = None


class Steps:
    """Consecutive sibling spans: ``step(name)`` closes the open one and
    opens ``name``; leaving the block closes the last."""

    def __init__(self):
        self._open = None

    def __call__(self, name: str, **attrs):
        self.close()
        self._open = span(name, **attrs)
        self._open.__enter__()

    def close(self, *exc):
        if self._open is not None:
            cm, self._open = self._open, None
            cm.__exit__(*(exc or (None, None, None)))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(*exc)
        return False


class Tree(NamedTuple):
    root: Span
    spans: list         # the root's descendants, in start order
    before: list        # the roots closed between the previous such tree and it


def last_tree(name: str = "prove") -> Tree | None:
    """The last closed root span named ``name``, its descendants, and the
    other roots recorded since the root of that name before it (the
    steps that led up to it: a proof's witness)."""
    recs = spans()
    roots = [i for i, r in enumerate(recs) if r.parent is None and r.name == name]
    if not roots:
        return None
    last = roots[-1]
    first = roots[-2] + 1 if len(roots) > 1 else 0
    root = recs[last]
    return Tree(root, [r for r in recs[last + 1:] if r.root == root.id],
                [r for r in recs[first:last] if r.parent is None])


def span_table(records) -> list:
    """[[path, count, host seconds, device seconds]] of ``records``, one
    row per path of names from the root down, in first-seen order."""
    by_id = {r.id: r for r in records}
    paths, rows = {}, {}
    for r in records:
        parent = by_id.get(r.parent)
        path = f"{paths[parent.id]}/{r.name}" if parent is not None else r.name
        paths[r.id] = path
        row = rows.setdefault(path, [path, 0, 0.0, 0.0])
        row[1] += 1
        row[2] += r.seconds
        row[3] += r.device_seconds
    return list(rows.values())


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
            with span(name):
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
    there is a card) writing ``trace.json`` and ``spans.json``; no-op when
    trace_dir is None."""
    if trace_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    first = _S.next_id
    _S.origin = None
    with torch.profiler.profile(activities=activities) as prof:
        yield
    _S.origin = None
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    with open(os.path.join(trace_dir, "spans.json"), "w") as f:
        json.dump([dataclasses.asdict(r) for r in spans() if r.id >= first], f)
