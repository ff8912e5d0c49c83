"""Phase-by-phase timing and the profile of one SHPLONK prove of the
PyTorch port.

Imported by ``profile_torch_flagship.py`` and ``torch_prove_steady.py``
(``--phases``, ``--profile``); not a script of its own.  ``phase_prove``
runs a prove under ``timers.recording()`` and reads the prover's phase
spans (``prover.PHASE_SPANS``, each closed at a Fiat-Shamir challenge):
each phase's device seconds, between its span's two CUDA events, with
no synchronise in the prove; ``profiled_prove`` runs one prove under
``torch.profiler``; ``memory_map`` names, from the allocator's recorded
history, the code that allocated what each phase held when it began and
at its peak.  Imports no JAX.
"""

from __future__ import annotations

import time


def phase_prove(prove, device, log=None) -> tuple[dict, dict, dict]:
    """Run ``prove()`` (a SHPLONK, GWC or IPA prove) with the program's
    spans recording.  Returns ({phase: device seconds}, {phase: peak
    device bytes allocated within it}, {phase: device bytes allocated
    when it began}), the phases of ``prover.PHASE_SPANS`` in the order
    they ran.  ``log(phase, host seconds, peak, allocated)``, if given,
    is called as each phase ends (a run that dies of out-of-memory still
    shows how far it got)."""
    import torch

    from halo2_aes_tpu_torch.backend.prover import PHASE_SPANS
    from halo2_aes_tpu_torch.utils import timers

    peaks, held = {}, {}
    began = [torch.cuda.memory_allocated(device)]
    torch.cuda.reset_peak_memory_stats(device)

    def on_exit(rec):
        if rec.name not in PHASE_SPANS:
            return
        peak = torch.cuda.max_memory_allocated(device)
        allocated = torch.cuda.memory_allocated(device)
        peaks[rec.name] = max(peaks.get(rec.name, 0), peak)
        held.setdefault(rec.name, began[0])
        began[0] = allocated
        torch.cuda.reset_peak_memory_stats(device)
        if log is not None:
            log(rec.name, rec.seconds, peak, allocated)

    with timers.recording(on_exit=on_exit):
        prove()
    tree = timers.last_tree("prove")
    seconds = {r.name: r.device_seconds for r in tree.spans
               if r.parent == tree.root.id and r.name in PHASE_SPANS}
    return seconds, peaks, held


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


def _site(frames) -> str:
    """Where a block was allocated: the innermost frame of the prover (the
    tensor's name there) and the innermost frame of the package below it."""
    ours = [f for f in frames if "halo2_aes_tpu_torch" in f["filename"]]
    if not ours:
        return "(outside the package)"

    def at(f):
        return f"{f['filename'].rsplit('/', 1)[-1]}:{f['line']} {f['name']}"

    prover = next((f for f in ours if f["filename"].endswith("prover.py")), None)
    if prover is None or prover is ours[0]:
        return at(ours[0])
    return f"{at(prover)} < {at(ours[0])}"


def _mark_phase():
    """An allocation the history shows at a phase boundary."""
    import torch

    return torch.empty(1, dtype=torch.uint8, device="cuda")


def memory_map(prove, device, top: int = 12) -> dict:
    """Run ``prove()`` with a marker allocated as it starts and as each
    phase span ends, then replay the allocator's history: for each phase, the
    bytes live when it began and at its peak, each split by the code
    that allocated them (the ``top`` largest sites).  The history must
    have been recording since before the first allocation on the device
    (``torch.cuda.memory._record_memory_history(stacks="python",
    max_entries=...)`` at the start of the process), with room for every
    event since."""
    import torch

    labels = []             # the phase that ended at each marker after the first
    _mark_phase()

    def log(label, *_):
        labels.append(label)
        _mark_phase()

    oom = None
    try:
        phase_prove(prove, device, log)
    except torch.OutOfMemoryError as e:    # map what was live when it failed
        oom = str(e).splitlines()[0]
    trace = torch.cuda.memory._snapshot()["device_traces"][
        torch.device(device).index or 0]
    # phases are consecutive: marker i begins the phase that ends at marker i + 1
    begins = labels + [None]
    live, by_site, current = {}, {}, 0
    order, phases, cur, marks = [], {}, None, 0
    for ev in trace:
        act, addr, size = ev["action"], ev["addr"], ev["size"]
        if act == "alloc":
            frames = ev.get("frames", [])
            if any(f["name"] == "_mark_phase" for f in frames):
                cur = begins[marks] if marks < len(begins) else None
                marks += 1
                if cur is not None and cur not in phases:
                    phases[cur] = {"start_bytes": current, "start": dict(by_site),
                                   "peak_bytes": current, "peak": dict(by_site)}
                    order.append(cur)
                continue
            site = _site(frames)
            live[addr] = (size, site)
            by_site[site] = by_site.get(site, 0) + size
            current += size
            if cur is not None and current > phases[cur]["peak_bytes"]:
                phases[cur]["peak_bytes"] = current
                phases[cur]["peak"] = dict(by_site)
        elif act == "free_completed":
            entry = live.pop(addr, None)
            if entry is not None:
                by_site[entry[1]] -= entry[0]
                current -= entry[0]

    def biggest(sites):
        rows = sorted(((b, s) for s, b in sites.items() if b > 0), reverse=True)
        return [[s, b] for b, s in rows[:top]]

    out = {p: {"start_bytes": phases[p]["start_bytes"],
               "start_top": biggest(phases[p]["start"]),
               "peak_bytes": phases[p]["peak_bytes"],
               "peak_top": biggest(phases[p]["peak"])} for p in order}
    if oom is not None:
        out["out_of_memory"] = oom
    return out
