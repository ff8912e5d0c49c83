#!/usr/bin/env python3
"""What each k >= 23 form of the prover costs below k = 23 and saves
from it, one form at a time, on one device.

  python scripts/torch_rest_forms.py --device cuda K BLOCKS SETS [--tagged]
      [--rounds R] [--cache-dir DIR|none] [--out FILE]

``backend/prover.HOST_REST_FORMS`` names the forms that are a pair
(below ``rest.HOST_REST_MIN_K``, from it): the polys per evaluation
stack on the large path (k >= 19; below it its swap changes nothing and
times the noise); the permuted lookup pairs' form is picked by the
proof's size (``prover.streamed_pairs``) and is not swapped here.  This
script compiles the AES-128 circuit at K, sets up the SRS and keys, builds the witness and
proves once (cold), then proves R rounds in turns: the default forms,
then each form swapped for its other side alone (below k = 23: the
k >= 23 form; from it: the smaller k's form), each with its seconds,
peak device memory, K1-K4 launches and whether it ran out of device
memory, and its bytes against the default proof's (all seeds equal).
From k = 23 it runs the CUDA allocator with expandable segments unless
``PYTORCH_CUDA_ALLOC_CONF`` is set.  Prints one JSON line; ``--out``
also writes it to a file.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def in_turns(PV, prove, reference, side: int, rounds: int) -> dict:
    """``rounds`` rounds of the default forms and of each form of
    ``PV.HOST_REST_FORMS`` swapped alone to its other side (``side``: 0
    below the threshold, 1 from it): variant -> a record per round, with
    its bytes against ``reference``."""
    variants = ["default", *PV.HOST_REST_FORMS]
    out = {name: [] for name in variants}
    for r in range(rounds):
        for name in variants:
            if name != "default":
                pair = getattr(PV, name)
                setattr(PV, name, (pair[1 - side],) * 2)
            try:
                proof, rec = prove()
            finally:
                if name != "default":
                    setattr(PV, name, pair)
            rec["equal_bytes"] = proof == reference if proof is not None else None
            out[name].append(rec)
            print(f"round {r} {name}: {rec['s']:.3f} s, peak "
                  f"{rec.get('peak_bytes', 0) / 1e9:.2f} GB, "
                  f"oom {rec['out_of_memory']}, equal {rec['equal_bytes']}, "
                  f"{rec['launches']}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("k", type=int)
    ap.add_argument("blocks", type=int)
    ap.add_argument("sets", type=int)
    ap.add_argument("--tagged", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; without a card, "
                         "pass --device cpu)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cache-dir", default="ptau",
                    help="SRS and key cache directory; 'none' caches nothing")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.k >= 23:
        # from k=23 (backend/rest.py) large stacks among transients fragment
        # the caching allocator's fixed segments; set before the card is used
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    cache = None if args.cache_dir == "none" else args.cache_dir
    sys.path.insert(0, REPO)

    import numpy as np
    import torch

    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import rest
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.backend.keygen import keygen, keygen_cached
    from halo2_aes_tpu_torch.circuit import witness
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit
    from halo2_aes_tpu_torch.ops import cuda_curve, cuda_field, cuda_ntt, cuda_quotient
    from halo2_aes_tpu_torch.ops.timing import resolve_device

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    out = {"k": args.k, "blocks": args.blocks, "sets": args.sets,
           "tagged": args.tagged, "host_rest": rest.on_host(args.k),
           "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"),
           "device": torch.cuda.get_device_name(dev) if cuda else str(dev)}
    if cuda:
        from halo2_aes_tpu_torch.ops.timing import card_line

        out["card"] = card_line()
    layout = compile_circuit(AesConfig(k=args.k, n_sets=args.sets,
                                       n_blocks=args.blocks,
                                       tagged_ops=args.tagged))
    srs = SRS.setup(args.k, dev, cache_dir=cache)
    pk = (keygen(layout, srs) if cache is None
          else keygen_cached(layout, srs, cache_dir=cache))
    rng = np.random.default_rng(0)
    key = torch.as_tensor(rng.integers(0, 256, 16, dtype=np.uint8), device=dev)
    pts = torch.as_tensor(rng.integers(0, 256, (args.blocks, 16), dtype=np.uint8),
                          device=dev)
    values = witness.assemble_values(layout, witness.build_pool(key, pts))
    out["large_path"] = PV._get_phases(pk).large()

    def launches():
        return {"K1": cuda_field.LAUNCHES, "K2": cuda_ntt.LAUNCHES,
                "K3": cuda_curve.LAUNCHES, "K4": cuda_quotient.LAUNCHES}

    def prove():
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        before = launches()
        t0 = time.perf_counter()
        try:
            proof = PV.prove(pk, values, seed=2)
            if cuda:
                torch.cuda.synchronize(dev)
        except torch.OutOfMemoryError:
            proof = None
        rec = {"s": time.perf_counter() - t0, "out_of_memory": proof is None,
               "launches": {k_: v - before[k_] for k_, v in launches().items()}}
        if cuda:
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            if proof is None:
                torch.cuda.empty_cache()
        return proof, rec

    reference, out["cold"] = prove()
    out["forms"] = {name: list(getattr(PV, name)) for name in PV.HOST_REST_FORMS}
    out["rounds"] = in_turns(PV, prove, reference, int(rest.on_host(args.k)),
                             args.rounds)
    out["median_s"] = {name: float(np.median([r_["s"] for r_ in recs]))
                       for name, recs in out["rounds"].items()}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
