"""Phase-by-phase timing and the profile of one SHPLONK prove of the
PyTorch port.

Imported by ``profile_torch_flagship.py`` and ``torch_prove_steady.py``
(``--phases``, ``--profile``); not a script of its own.  ``phase_prove``
synchronises the device at every Fiat-Shamir challenge, so each interval
between two challenges is the device time and host time of the prover
phase that ends there; ``profiled_prove`` runs one prove under
``torch.profiler``.  Imports no JAX.
"""

from __future__ import annotations

import time

# Fiat-Shamir challenges of a SHPLONK prove, in order -> the prover phase
# each one closes; a challenge squeezed right after another closes nothing
PHASE_AT = {"theta": "advice", "beta": "lookup_permuted", "gamma": None,
            "y": "grand_products", "x": "quotient", "y2": "evals", "v": None,
            "u": "shplonk_h", "finalize": "shplonk_l"}
CHALLENGES = ["theta", "beta", "gamma", "y", "x", "y2", "v", "u"]


def phase_prove(prove, device) -> tuple[dict, dict]:
    """Run ``prove()`` (a SHPLONK prove) with the device synchronised at
    every transcript challenge.  Returns ({phase: seconds}, {phase: peak
    device bytes allocated within it}); each interval is named after the
    prover phase that ends there."""
    import torch

    from halo2_aes_tpu_torch.backend.transcript import TranscriptWriter

    marks = []
    squeeze, finalize = TranscriptWriter.squeeze_challenge, TranscriptWriter.finalize

    def mark(label):
        torch.cuda.synchronize(device)
        marks.append((label, time.perf_counter(),
                      torch.cuda.max_memory_allocated(device)))
        torch.cuda.reset_peak_memory_stats(device)

    def hooked_squeeze(self):
        mark(CHALLENGES[len(marks) - 1])
        return squeeze(self)

    def hooked_finalize(self):
        mark("finalize")
        return finalize(self)

    TranscriptWriter.squeeze_challenge = hooked_squeeze
    TranscriptWriter.finalize = hooked_finalize
    try:
        mark("start")
        prove()
    finally:
        TranscriptWriter.squeeze_challenge = squeeze
        TranscriptWriter.finalize = finalize
    seconds, peaks, current = {}, {}, None
    for (_, t_prev, _), (label, t, peak) in zip(marks, marks[1:]):
        current = PHASE_AT[label] or current
        seconds[current] = seconds.get(current, 0.0) + t - t_prev
        peaks[current] = max(peaks.get(current, 0), peak)
    return seconds, peaks


def profiled_prove(prove, device) -> dict:
    """``prove()`` under torch.profiler: device time and launches by kernel
    name, all CUDA kernels counted, and device time over the profiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prove()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    return {"profiled_wall_s": wall, "device_s": device_s,
            "device_over_profiled_wall": device_s / wall,
            "device_launches": sum(r[1] for r in rows),
            "top": [{"name": name[:80], "device_ms": us / 1e3, "launches": n}
                    for us, n, name in rows[:25]]}
