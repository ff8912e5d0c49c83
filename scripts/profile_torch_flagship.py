#!/usr/bin/env python3
"""Time and profile the PyTorch port's flagship prove on one CUDA card.

  python3 scripts/profile_torch_flagship.py [--tree DIR] [--proves N]
      [--variants shplonk,gwc,packed,ipa,mesh] [--phases] [--profile]
      [--out FILE]

Builds the flagship (AES-128, k=17, 4 sets, 384 blocks, tagged ops),
runs one warm-up prove per variant, then N rounds of timed proves, each
round one prove of every variant in turn (``shplonk``: the default
prove; ``gwc``: GWC multiopen; ``packed``: packed lookup keys; ``ipa``:
the IPA proving system, with a pk of its own against the transparent
basis; ``mesh``: the default prove on a world-size-1 NCCL mesh of this
process, ``parallel/``'s sharded transforms and commitments, with its
collective calls and payload bytes), each reported with its kernel
launch counts.  ``--phases`` times
one more prove of the first variant named, phase by phase: the device
seconds of the prover's phase spans (``utils/timers.py``, each closed at
a Fiat-Shamir challenge; no synchronise in the prove), with each
phase's peak device memory.
``--profile`` runs one more such prove under ``torch.profiler`` and reports
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

VARIANTS = {"shplonk": {}, "gwc": {"multiopen": "gwc"},
            "packed": {"lookup_sort": "packed"}, "ipa": {"multiopen": "ipa"},
            "mesh": {}}          # + mesh=, made when the variant is asked for


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
    counts = {k: v - before[k] for k, v in launches().items()}
    if "mesh" in opts:
        from halo2_aes_tpu_torch.parallel import comm

        counts["collectives"] = {"calls": dict(comm.CALLS),
                                 "bytes": dict(comm.BYTES)}
        comm.reset_counts()
    return s, counts


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
    from torch_phases import phase_prove, profiled_prove  # beside this script

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    layout = compile_circuit(AesConfig(**FLAGSHIP))
    names = args.variants.split(",")
    kzg_pk = ipa_pk = None
    if set(names) - {"ipa"}:
        kzg_pk = KG.keygen(layout, SRS.setup(FLAGSHIP["k"], dev, cache_dir=None))
    if "ipa" in names:
        from halo2_aes_tpu_torch.backend import ipa as IPA

        ipa_pk = KG.keygen(layout, IPA.setup(FLAGSHIP["k"], dev, cache_dir=None))
    pks = {v: ipa_pk if v == "ipa" else kzg_pk for v in names}
    opts = {v: dict(VARIANTS[v]) for v in names}
    if "mesh" in names:
        import shutil

        from halo2_aes_tpu_torch.parallel import comm

        store = os.path.join(REPO, "build", "profile_mesh")
        shutil.rmtree(store, ignore_errors=True)
        os.makedirs(store)
        opts["mesh"]["mesh"] = comm.init_mesh("nccl", 0, 1,
                                              f"file://{store}/store", dev)
    rng = np.random.default_rng(0)
    key = torch.as_tensor(rng.integers(0, 256, 16, dtype=np.uint8), device=dev)
    pts = torch.as_tensor(rng.integers(0, 256, (FLAGSHIP["n_blocks"], 16),
                                       dtype=np.uint8), device=dev)
    values = witness.assemble_values(layout, witness.build_pool(key, pts))
    first = {v: timed_prove(PV, pks[v], values, dev, **opts[v])[0] for v in names}
    runs = {v: [] for v in names}
    for _ in range(args.proves):
        for v in names:
            runs[v].append(timed_prove(PV, pks[v], values, dev, **opts[v]))
    variants = {v: {"first_prove_s": first[v], "prove_s": [s for s, _ in runs[v]],
                    "median_prove_s": float(np.median([s for s, _ in runs[v]]))
                    if runs[v] else None,
                    "launches_per_prove": runs[v][-1][1] if runs[v] else None}
                for v in names}
    out = {"tree": os.path.relpath(os.path.abspath(args.tree), REPO),
           "card": card, **FLAGSHIP, **variants[names[0]], "variants": variants}
    def one_more():
        return PV.prove(pks[names[0]], values, **opts[names[0]])

    if args.phases:
        (out["phases_s"], out["phase_peak_bytes"],
         out["phase_held_bytes"]) = phase_prove(one_more, dev)
    if args.profile:
        out["profile"] = profiled_prove(one_more, dev)
    if "mesh" in opts:
        comm.destroy_mesh(opts["mesh"]["mesh"])
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
