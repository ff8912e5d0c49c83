"""End-to-end AES-128 prove (+verify) command line for the PyTorch port.

Usage:
  python -m halo2_aes_tpu_torch.prove --k 17 --blocks 384 --sets 4 \
      --tagged --verify --device cuda

Blinding always comes from os.urandom; ``--seed`` seeds only the random
AES key and plaintexts.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def run(k: int, n_sets: int, blocks: int, tagged: bool, do_verify: bool,
        device: str, seed: int = 0, srs_cache: str | None = "ptau") -> dict:
    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.backend import verifier as VF
    from halo2_aes_tpu_torch.circuit import witness
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit

    dev = torch.device(device)
    timings = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings[name] = round(time.perf_counter() - t0, 3)
        print(f"[{name}] {timings[name]}s", flush=True)
        return out

    layout = timed("compile_circuit", compile_circuit,
                   AesConfig(k=k, n_sets=n_sets, n_blocks=blocks,
                             tagged_ops=tagged))
    srs = timed("srs_setup", SRS.setup, k, dev, cache_dir=srs_cache)
    if srs_cache is None:
        pk = timed("keygen", KG.keygen, layout, srs)
    else:
        pk = timed("keygen", KG.keygen_cached, layout, srs, cache_dir=srs_cache)
    rng = np.random.default_rng(seed)
    key = torch.as_tensor(rng.integers(0, 256, 16, dtype=np.uint8), device=dev)
    pts = torch.as_tensor(rng.integers(0, 256, (blocks, 16), dtype=np.uint8),
                          device=dev)
    values = timed("witness", lambda: witness.assemble_values(
        layout, witness.build_pool(key, pts)))
    proof = timed("prove", PV.prove, pk, values)
    result = {"proof_bytes": len(proof), "timings": timings, "blocks": blocks,
              "k": k, "n_sets": n_sets, "tagged_ops": tagged,
              "device": str(dev)}
    if do_verify:
        timed("verify", VF.verify, pk.vk, proof)
        result["verified"] = True
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--k", type=int, default=17)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--tagged", action="store_true",
                    help="tagged-op lookup tables (the flagship layout)")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", required=True,
                    help="torch device to prove on, e.g. cuda or cpu")
    args = ap.parse_args()
    print(json.dumps(run(args.k, args.sets, args.blocks, args.tagged,
                         args.verify, args.device, args.seed)))


if __name__ == "__main__":
    main()
