#!/usr/bin/env python3
"""Criterion-style statistical prove benchmarks of the PyTorch port.

  python3 scripts/torch_bench_criterion.py [--device cuda] [--k 17]
      [--blocks 16] [--sets 1] [--samples 5] [--key-schedule-only]

The counterpart of ``scripts/bench_criterion.py`` (the role of the
reference's criterion harnesses, benches/aes128.rs:85-119 and
benches/key_schedule.rs:105-137, SAMPLE_SIZE=10): repeated timed proves of
(a) the full AES-128 circuit or (b) with ``--key-schedule-only`` the
key-schedule-only circuit (n_blocks=0), reporting mean/std/min/max over
the samples after a warm-up prove that is verified.  Each sample ends
with the device synchronised.  The SRS and keys are cached in ``ptau/``.
Prints one JSON object; on a card the line before it is the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(device, k: int = 17, blocks: int = 16, n_sets: int = 1,
        samples: int = 5, cache_dir: str | None = "ptau") -> dict:
    """Warm up, verify, then time ``samples`` proves on ``device``;
    ``blocks`` = 0 is the key-schedule-only circuit."""
    import numpy as np
    import torch

    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.backend.keygen import keygen, keygen_cached
    from halo2_aes_tpu_torch.backend.prover import prove
    from halo2_aes_tpu_torch.backend.verifier import verify
    from halo2_aes_tpu_torch.circuit import witness
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit

    dev = torch.device(device)
    layout = compile_circuit(AesConfig(k=k, n_sets=n_sets, n_blocks=blocks))
    srs = SRS.setup(k, dev, cache_dir=cache_dir)
    pk = (keygen(layout, srs) if cache_dir is None
          else keygen_cached(layout, srs, cache_dir=cache_dir))
    rng = np.random.default_rng(0)
    key = torch.as_tensor(rng.integers(0, 256, 16, dtype=np.uint8), device=dev)
    pts = torch.as_tensor(rng.integers(0, 256, (blocks, 16), dtype=np.uint8),
                          device=dev)
    values = witness.assemble_values(layout, witness.build_pool(key, pts))

    proof = prove(pk, values)  # warm-up
    verify(pk.vk, proof)

    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        prove(pk, values)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)

    out = {"bench": "aes128_prove" if blocks else "key_schedule_prove",
           "k": k, "n_sets": n_sets, "blocks_per_proof": blocks,
           "samples": samples, "mean_s": statistics.mean(times),
           "std_s": statistics.pstdev(times), "min_s": min(times),
           "max_s": max(times), "proof_bytes": len(proof), "device": str(dev)}
    if blocks:
        out["blocks_per_sec"] = blocks / statistics.mean(times)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--k", type=int, default=17)
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--samples", type=int, default=5)
    ap.add_argument("--key-schedule-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; without a card, "
                         "pass --device cpu)")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    from halo2_aes_tpu_torch.ops.timing import card_line, resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(card_line(), flush=True)
    print(json.dumps(run(dev, args.k, 0 if args.key_schedule_only else args.blocks,
                         args.sets, args.samples)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
