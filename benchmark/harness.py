"""One run of one cell: set-up, the measured window, the verifier, the
reference's judgement, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name: ``BENCHMARK.json`` names the cell,
its configuration file and its traffic mix (``traffic/<name>.json``);
a per-layer metric is read by ``metrics/<name>.py``.  Nothing here names
a cell.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace


from benchmark import traffic as TR
from benchmark import trace as TRACE
from benchmark.circuits import KINDS

HERE = os.path.dirname(os.path.abspath(__file__))
BANNED = ("jax", "jaxlib", "flax", "halo2_aes_tpu")
CONTROLS = ("packed", "altered")
CHECKED_PROOFS = 1          # of the window's proofs, the reference judges this many


class CellError(ValueError):
    pass


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench: dict, name: str, root: str):
    """(cell, configuration dict) of the workload ``name``; its traffic
    mix is loaded, so a missing or unknown mix fails here."""
    cells = [w for w in bench["workloads"] if w["name"] == name]
    if len(cells) != 1:
        raise CellError(f"no workload named {name!r} in BENCHMARK.json")
    cell = cells[0]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    TR.load(cell["traffic"], os.path.join(root, "benchmark"))
    return cell, config


def metrics_for(bench: dict, cell_name: str, traced: bool) -> list:
    """The cell's metrics of the run's kind: end-to-end, or per-layer."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def load_reader(name: str, root: str = HERE):
    """``metrics/<name>.py`` as a module with ``read(ctx)``."""
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, traced: bool,
             device, t_start: float, root: str, control: str | None = None,
             log=_log) -> dict:
    """One run; returns the result line as a dict (its last key the
    numbers compared, each beside its limit)."""
    import torch

    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.backend import verifier as VF
    from halo2_aes_tpu_torch.backend.transcript import TranscriptWriter

    cell, config = find_cell(bench, cell_name, root)
    kind = KINDS[config["circuit"]]
    gen = TR.Generator(config, seed)
    cuda = device.type == "cuda"
    multiopen, lookup_sort = config["multiopen"], config["lookup_sort"]
    if control not in (None,) + CONTROLS:
        raise CellError(f"unknown control {control!r}")
    prove_sort = "packed" if control == "packed" else lookup_sort

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # ---- set-up: kernels, circuit, SRS, keys, one warm-up request ------
    if cuda:
        from halo2_aes_tpu_torch import native
        from halo2_aes_tpu_torch.ops import _build

        _build.library()
        if native.available():
            native.library()
    layout = kind.program_layout(config)
    srs = SRS.setup(config["k"], device, cache_dir=None)
    pk = KG.keygen(layout, srs)

    def prove(req, phases=None):
        if control == "altered":
            req = TR.Request(req.index, req.key, req.pts.copy(), req.blind_seed)
            req.pts[-1, 0] ^= 1
        values = kind.program_values(layout, req, device)

        def call():
            return PV.prove(pk, values, seed=req.blind_seed, multiopen=multiopen,
                            lookup_sort=prove_sort)

        if phases is None:
            proof = call()
            sync()
        else:
            proof, secs = TRACE.phase_prove(TranscriptWriter, call, device)
            sync()
            phases.append(secs)
        return proof

    try:                    # the window's proofs are the ones judged
        VF.verify(pk.vk, prove(gen.request(TR.WARMUP)), multiopen=multiopen)
    except VF.VerifyError as e:
        log(f"the warm-up proof did not verify: {e}")
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s")

    # ---- the window ------------------------------------------------------
    gc.collect()
    gc.freeze()             # set-up's objects stay out of the collector's passes
    peaks = []
    if cuda:
        peaks.append(torch.cuda.max_memory_allocated(device))
        torch.cuda.reset_peak_memory_stats(device)
    proofs, phases, raised = [], ([] if traced else None), 0
    attempted = 0
    ends = []
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        req = gen.request(attempted)
        attempted += 1
        try:
            proofs.append(prove(req, phases))
            ends.append(time.perf_counter())
        except Exception as e:              # a request that raised fails the run
            log(f"request {req.index} raised {type(e).__name__}: {e}")
            raised += 1
            break
    t1 = time.perf_counter()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    peaks.append(window_peak)
    log(f"window {t1 - t0:.3f} s, {len(proofs)} proofs of {gen.blocks} blocks; "
        f"request seconds {[round(b - a, 3) for a, b in zip([t0] + ends, ends)]}")

    # ---- verify every proof of the window --------------------------------
    unverified, verify_times = set(), []
    for i, proof in enumerate(proofs):
        v0 = time.perf_counter()
        try:
            VF.verify(pk.vk, proof, multiopen=multiopen)
        except VF.VerifyError as e:
            log(f"proof {i} did not verify: {e}")
            unverified.add(i)
        verify_times.append(time.perf_counter() - v0)
    log(f"verify seconds {[round(v, 4) for v in verify_times]}")

    # ---- traced: one profiled proof and the per-layer readers ------------
    values = {}
    device_extra = {}
    breakdown = None
    if traced:
        prof = TRACE.profiled_prove(lambda: prove(gen.request(attempted)), device)
        device_extra = {"busy_s": prof["busy_s"], "window_s": prof["wall_s"]}
        breakdown = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
        ctx = SimpleNamespace(phases=phases, profile=prof, config=config,
                              device=device, seed=seed, log=log)
        for m in metrics_for(bench, cell_name, True):
            v = load_reader(m["name"], root=os.path.join(root, "benchmark")).read(ctx)
            if v is not None:
                values[m["name"]] = v
    if cuda:
        peaks.append(torch.cuda.max_memory_allocated(device))

    if not traced:
        values = {"prove_blocks_per_s": gen.blocks * len(proofs) / (t1 - t0),
                  "prove_peak_gb": window_peak / 1e9,
                  "setup_s": setup_s}

    # ---- the reference judges a sample of the window's proofs ------------
    gc.unfreeze()
    del pk, srs, layout
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)   # the window's peaks are read
    held = torch.cuda.memory_allocated(device) if cuda else 0
    c0 = time.perf_counter()
    from benchmark.reference.check import Reference

    rlayout = kind.reference_layout(config)
    ref = Reference(rlayout, device)
    totals = {"points_mismatched": 0, "scalars_mismatched": 0,
              "quotient_mismatched": 0, "extra_bytes": 0}
    mismatched = set()
    checked = gen.checked_indices(len(proofs), CHECKED_PROOFS)
    for i in checked:
        req = gen.request(i)
        r = ref.check(kind.reference_values(rlayout, req), req.blind_seed, proofs[i],
                      multiopen=multiopen, lookup_sort=lookup_sort)
        for key in totals:
            totals[key] += r[key]
        if any(r[key] for key in totals):
            mismatched.add(i)
            log(f"proof {i}: {r}")
    del ref
    ref_peak = (f", device peak {torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB "
                f"({held / 1e9:.3f} GB held before it)" if cuda else "")
    log(f"reference judged {len(checked)} proof(s) in {time.perf_counter() - c0:.3f} s"
        + ref_peak)

    failed = raised + len(unverified | mismatched)
    compared = {"requests_failed": failed, "proofs_unverified": len(unverified),
                "proofs_checked_missing": 0 if checked else 1, **totals}
    correct = all(v == 0 for v in compared.values())
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    wanted = [m["name"] for m in metrics_for(bench, cell_name, traced)]
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(max(peaks)) if peaks else 0,
           "power_limit_w": power_limit_w() if cuda else None, **device_extra}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": {k: {"value": values[k], "unit": units[k]}
                       for k in wanted if k in values},
           "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = {k: {"value": v, "limit": 0} for k, v in compared.items()}
    return out
