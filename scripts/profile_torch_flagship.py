#!/usr/bin/env python3
"""Time and profile the PyTorch port's flagship prove on one CUDA card.

  python3 scripts/profile_torch_flagship.py [--tree DIR] [--proves N]
      [--variants shplonk,gwc,packed] [--phases] [--profile] [--out FILE]

Builds the flagship (AES-128, k=17, 4 sets, 384 blocks, tagged ops),
runs one warm-up prove per variant, then N rounds of timed proves, each
round one prove of every variant in turn (``shplonk``: the default
prove; ``gwc``: GWC multiopen; ``packed``: packed lookup keys), each
reported with its kernel launch counts.  ``--phases`` times one more
default prove round by round:
the device is synchronised at every Fiat-Shamir challenge, and each
interval is named after the prover phase that ends there.
``--profile`` runs one more prove under ``torch.profiler`` and reports
device time and launches by kernel name, and device time over the
profiled wall.  ``--tree`` imports ``halo2_aes_tpu_torch`` from another
checkout (default: this one), so two trees can be timed on one card in
one session.  Prints one JSON object; ``--out`` also writes it to a
file.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = dict(k=17, n_sets=4, n_blocks=384, tagged_ops=True)

# Fiat-Shamir challenges in prove order -> the phase each one closes;
# a challenge squeezed right after another closes nothing new
PHASE_AT = {"theta": "advice", "beta": "lookup_permuted", "gamma": None,
            "y": "grand_products", "x": "quotient", "y2": "evals", "v": None,
            "u": "shplonk_h", "finalize": "shplonk_l"}
CHALLENGES = ["theta", "beta", "gamma", "y", "x", "y2", "v", "u"]
VARIANTS = {"shplonk": {}, "gwc": {"multiopen": "gwc"},
            "packed": {"lookup_sort": "packed"}}


def launches():
    from halo2_aes_tpu_torch.ops import cuda_curve, cuda_field, cuda_ntt

    return {"K1": cuda_field.LAUNCHES, "K2": cuda_ntt.LAUNCHES,
            "K3": cuda_curve.LAUNCHES}


def timed_prove(PV, pk, values, dev, **opts):
    import torch

    before = launches()
    t0 = time.perf_counter()
    PV.prove(pk, values, **opts)
    torch.cuda.synchronize(dev)
    s = time.perf_counter() - t0
    return s, {k: v - before[k] for k, v in launches().items()}


def phase_prove(PV, pk, values, dev) -> dict:
    """One prove, synchronised and timed at every transcript challenge."""
    import torch

    from halo2_aes_tpu_torch.backend.transcript import TranscriptWriter

    marks = []
    squeeze, finalize = TranscriptWriter.squeeze_challenge, TranscriptWriter.finalize

    def mark(label):
        torch.cuda.synchronize(dev)
        marks.append((label, time.perf_counter()))

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
        PV.prove(pk, values)
    finally:
        TranscriptWriter.squeeze_challenge = squeeze
        TranscriptWriter.finalize = finalize
    phases, current = {}, None
    for (_, t_prev), (label, t) in zip(marks, marks[1:]):
        current = PHASE_AT[label] or current
        phases[current] = phases.get(current, 0.0) + t - t_prev
    return phases


def profiled_prove(PV, pk, values, dev) -> dict:
    """One prove under torch.profiler: device time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        PV.prove(pk, values)
        torch.cuda.synchronize(dev)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tree", default=REPO,
                    help="checkout to import halo2_aes_tpu_torch from")
    ap.add_argument("--proves", type=int, default=3,
                    help="rounds of timed warm proves")
    ap.add_argument("--variants", default="shplonk",
                    help="comma-separated, timed in turns: " + ", ".join(VARIANTS))
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no card")
    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.circuit import witness
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    layout = compile_circuit(AesConfig(**FLAGSHIP))
    pk = KG.keygen(layout, SRS.setup(FLAGSHIP["k"], dev, cache_dir=None))
    rng = np.random.default_rng(0)
    key = torch.as_tensor(rng.integers(0, 256, 16, dtype=np.uint8), device=dev)
    pts = torch.as_tensor(rng.integers(0, 256, (FLAGSHIP["n_blocks"], 16),
                                       dtype=np.uint8), device=dev)
    values = witness.assemble_values(layout, witness.build_pool(key, pts))
    names = args.variants.split(",")
    first = {v: timed_prove(PV, pk, values, dev, **VARIANTS[v])[0] for v in names}
    runs = {v: [] for v in names}
    for _ in range(args.proves):
        for v in names:
            runs[v].append(timed_prove(PV, pk, values, dev, **VARIANTS[v]))
    variants = {v: {"first_prove_s": first[v], "prove_s": [s for s, _ in runs[v]],
                    "median_prove_s": float(np.median([s for s, _ in runs[v]]))
                    if runs[v] else None,
                    "launches_per_prove": runs[v][-1][1] if runs[v] else None}
                for v in names}
    out = {"tree": os.path.relpath(os.path.abspath(args.tree), REPO),
           "card": card, **FLAGSHIP, **variants[names[0]], "variants": variants}
    if args.phases:
        out["phases_s"] = phase_prove(PV, pk, values, dev)
    if args.profile:
        out["profile"] = profiled_prove(PV, pk, values, dev)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
