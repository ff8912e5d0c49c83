"""Timing on the card: the card's name and power limit, CUDA-event
times of a callable, and the device a command line runs on.  Used by
``chip_smoke.py``, ``prove.py`` and the scripts; nothing here falls
back to the CPU."""

from __future__ import annotations

import statistics
import subprocess


def resolve_device(name: str | None):
    """The device of a command line's ``--device``: the one named, else
    the first CUDA card.  Raises at once where none was named and there
    is no card: an entry point runs on the card unless the caller asks
    for the CPU."""
    import torch

    if name is not None:
        return torch.device(name)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no --device was given and torch.cuda.is_available() is false: "
            "this entry point runs on a CUDA card by default; pass "
            "--device cpu to run on the CPU")
    return torch.device("cuda", 0)


def card_line() -> str:
    """The first card's ``name, power.limit`` as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, windows: int = 5) -> float:
    """Median over ``windows`` CUDA-event windows of ``iters`` calls each,
    in ms per call, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)
