#!/usr/bin/env python3
"""Witness + vectorized constraint check throughput of the PyTorch port.

  python3 scripts/torch_bench_mock.py [--device cuda] [k] [sets] [blocks]
      [--tagged] [--reps 3] [--profile]

The counterpart of the reference's mock bench (``bench.py`` ``bench_mock``;
defaults are its shape: AES-128, k=17, 2 column sets, 192 blocks, zero key,
counting plaintext bytes).  One step is the witness pool, the column
matrix and ``mock.violation_counts`` on the device; the counts must all be
zero.  After a warm-up step, ``--reps`` steps are timed by the host clock
with the device synchronised before each reading.  ``--profile`` runs
one more step under ``torch.profiler`` (device time and launches by
kernel, device time over the profiled wall).  Prints one JSON object; on a card the line before it is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(device, layout, reps: int = 3, profile: bool = False) -> dict:
    """Time the warm witness + check step of an AES-128 ``layout`` on
    ``device``."""
    import torch

    from halo2_aes_tpu_torch.circuit import mock, witness

    dev = torch.device(device)
    cfg = layout.meta["config"]
    k, n_sets, n_blocks, tagged = cfg.k, cfg.n_sets, cfg.n_blocks, cfg.tagged_ops
    key = torch.zeros(16, dtype=torch.uint8, device=dev)
    plaintexts = (torch.arange(n_blocks * 16, device=dev) % 256).to(
        torch.uint8).reshape(-1, 16)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def step():
        pool = witness.build_pool(key, plaintexts)
        values = witness.assemble_values(layout, pool)
        counts = mock.violation_counts(layout, values)
        sync()
        return counts

    t0 = time.perf_counter()
    counts = {name: int(v) for name, v in step().items()}
    first_s = time.perf_counter() - t0
    if any(counts.values()):
        raise AssertionError(f"the circuit is not satisfied: {counts}")
    held = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)     # the layout's cached tables
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    dt = sum(times) / reps
    extra = {}
    if profile:
        from torch_phases import profiled_prove  # beside this script

        extra["profile"] = profiled_prove(step, dev)
    return {**extra, "metric": f"aes128_witness_plus_constraint_check_blocks_per_sec_k{k}",
            "value": n_blocks / dt, "unit": "blocks/s", "k": k, "n_sets": n_sets,
            "n_blocks": n_blocks, "tagged_ops": tagged, "reps": reps,
            "step_s": times, "first_step_s": first_s, "device": str(dev),
            "held_before_bytes": held,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("k", nargs="?", type=int, default=17)
    ap.add_argument("sets", nargs="?", type=int, default=2)
    ap.add_argument("blocks", nargs="?", type=int, default=192)
    ap.add_argument("--tagged", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; without a card, "
                         "pass --device cpu)")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit
    from halo2_aes_tpu_torch.ops.timing import card_line, resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(card_line(), flush=True)
    layout = compile_circuit(AesConfig(k=args.k, n_sets=args.sets,
                                       n_blocks=args.blocks, tagged_ops=args.tagged))
    if args.profile and dev.type != "cuda":
        raise SystemExit("--profile needs a CUDA device")
    print(json.dumps(run(dev, layout, args.reps, args.profile)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
