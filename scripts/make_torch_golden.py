"""Write the golden K=6 proofs that the PyTorch port must reproduce.

Runs the JAX reference package on the CPU: for each entry of
``GOLDEN_PROOFS`` in ``halo2_aes_tpu_torch/circuit/toys.py`` (the toy,
tagged-toy and instance-toy circuits, built with the reference's
``circuit.ir``, proved with SHPLONK and field-ordered lookups, and the
first two also with GWC and with packed lookup keys) it sets up the dev
SRS, keygens, proves with the circuit's fixed seed and verifies.  The
result, ``halo2_aes_tpu_torch/testdata/golden_k6.json``, holds per
proof the seed, the prove options, the vk digest and the proof bytes as
hex; it is committed so the port's tests never run the slow JAX prover.

Usage:
  JAX_PLATFORMS=cpu python scripts/make_torch_golden.py
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "halo2_aes_tpu_torch", "testdata", "golden_k6.json")


def main() -> None:
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from halo2_aes_tpu.ops import field

    field.set_compact_graphs(True)
    from halo2_aes_tpu.backend import srs as SRS
    from halo2_aes_tpu.backend.keygen import keygen
    from halo2_aes_tpu.backend.prover import prove
    from halo2_aes_tpu.backend.verifier import verify
    from halo2_aes_tpu.circuit import ir
    from halo2_aes_tpu_torch.circuit.toys import GOLDEN_PROOFS, K, TOYS

    srs = SRS.setup(K, cache_dir=None)
    out = {"k": K}
    pks = {}
    for name, (toy, opts) in GOLDEN_PROOFS.items():
        build, seed, instances = TOYS[toy]
        layout, values = build(ir)
        if toy not in pks:
            pks[toy] = keygen(layout, srs)
        pk = pks[toy]
        proof = prove(pk, values, seed=seed, **opts)
        assert verify(pk.vk, proof, instances=instances,
                      multiopen=opts.get("multiopen", "shplonk"))
        out[name] = {"seed": seed, **opts, "vk_digest": hex(pk.vk.digest),
                     "proof": proof.hex()}
        print(f"{name}: {len(proof)} bytes", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
