"""What a traced run reads: the prover's phases and one profiled proof.

``phase_prove`` synchronises the device at every Fiat-Shamir challenge
the program's transcript squeezes, so each interval between two
challenges is the prover phase that ends there (host and device time).
``profiled_prove`` runs one proof under ``torch.profiler`` and reduces
its trace: kernels launched, the seconds some kernel ran (the union of
kernel intervals), the wall time, device time by operation, and the idle
gaps between kernels named by the host operation running in each.
"""

from __future__ import annotations

import bisect
import time

# Fiat-Shamir challenges of a SHPLONK proof, in order -> the prover
# phase each closes; a challenge squeezed right after another closes
# nothing
PHASE_AT = {"theta": "advice", "beta": "lookup_permuted", "gamma": None,
            "y": "grand_products", "x": "quotient", "y2": "evals", "v": None,
            "u": "shplonk_h", "finalize": "shplonk_l"}
CHALLENGES = ["theta", "beta", "gamma", "y", "x", "y2", "v", "u"]


def phase_prove(transcript_cls, prove, device) -> dict:
    """Run ``prove()`` with the device synchronised at each challenge of
    ``transcript_cls`` (the program's transcript writer); returns
    {phase: seconds}."""
    import torch

    marks = []
    squeeze, finalize = transcript_cls.squeeze_challenge, transcript_cls.finalize

    def mark(label):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        marks.append((label, time.perf_counter()))

    def hooked_squeeze(self):
        i = len(marks) - 1
        mark(CHALLENGES[i] if i < len(CHALLENGES) else "u")
        return squeeze(self)

    def hooked_finalize(self):
        mark("finalize")
        return finalize(self)

    transcript_cls.squeeze_challenge = hooked_squeeze
    transcript_cls.finalize = hooked_finalize
    try:
        mark("start")
        out = prove()
    finally:
        transcript_cls.squeeze_challenge = squeeze
        transcript_cls.finalize = finalize
    seconds, current = {}, None
    for (_, t_prev), (label, t) in zip(marks, marks[1:]):
        current = PHASE_AT.get(label) or current
        seconds[current] = seconds.get(current, 0.0) + t - t_prev
    return out, seconds


def _union(intervals):
    """Total length and merged list of (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def profiled_prove(prove, device, top: int = 10) -> dict:
    """``prove()`` under torch.profiler; every time in seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        prove()
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    # the profiler's raw events (building its FunctionEvent tree takes
    # minutes for a proof's million host ops)
    busy, host, by_name = [], [], {}
    n_kernels = 0
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e3
        t = s + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            busy.append((s, t))
            by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
            n_kernels += not name.startswith(("Memcpy", "Memset"))
        elif t > s:
            host.append((s, t, e.name()))
    busy_us, merged = _union(busy)
    # idle gaps between device work, named by the innermost host op that
    # spans the gap's middle
    host.sort()
    starts = [h[0] for h in host]
    gaps = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) / 2
        i = bisect.bisect_right(starts, mid) - 1
        label = "host between profiled ops"
        for j in range(i, max(i - 64, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        gaps[label] = gaps.get(label, 0.0) + (s1 - e0) / 1e6
    if merged:
        span = (merged[-1][1] - merged[0][0]) / 1e6
        lead = max(wall - span, 0.0)
        if lead > 0:
            gaps["before the first or after the last kernel"] = (
                gaps.get("before the first or after the last kernel", 0.0) + lead)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_s": wall, "busy_s": busy_us / 1e6, "kernels": n_kernels,
            "device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k[:120], v] for k, v in idle]}
