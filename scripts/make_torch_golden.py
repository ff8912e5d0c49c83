"""Write the golden proofs that the PyTorch port must reproduce.

Runs the JAX reference package on the CPU.  For each entry of
``GOLDEN_PROOFS`` in ``halo2_aes_tpu_torch/circuit/toys.py`` (the toy,
tagged-toy and instance-toy circuits and the one-advice-column circuit
with and without its lookup, built with the reference's ``circuit.ir``,
proved with SHPLONK and field-ordered lookups; the toy and tagged toy
also with GWC and with packed lookup keys, the one-column pair also
with GWC) it sets up the dev
SRS, keygens, proves with the circuit's fixed seed and verifies; for each
entry of ``GOLDEN_IPA_PROOFS`` it does the same with ``multiopen="ipa"``
against the transparent basis ``ipa.setup(K, cache_dir=None)``.  The
result, ``halo2_aes_tpu_torch/testdata/golden_k6.json``, holds per proof
the seed, the prove options, the vk digest and the proof bytes as hex.
``--mini`` writes ``golden_mini_k11.json`` instead: the mini-AES circuit
of ``MINI_CONFIG`` proved with SHPLONK (the slowest entry by far).  Both
files are committed so the port's tests never run the slow JAX prover.
``--only NAME,...`` proves only the named entries and keeps the others
of the existing file (one process compiles every proof, and XLA's CPU
compiler can run out of memory maps after a dozen of them).  The script
imports the reference package on purpose; it is no part of the port.

Usage:
  JAX_PLATFORMS=cpu python scripts/make_torch_golden.py [--mini] [--only NAMES]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "halo2_aes_tpu_torch", "testdata")
OUT = os.path.join(TESTDATA, "golden_k6.json")
OUT_MINI = os.path.join(TESTDATA, "golden_mini_k11.json")


def _dump(path: str, out: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def golden_k6(only=None) -> None:
    from halo2_aes_tpu.backend import ipa as IPA
    from halo2_aes_tpu.backend import srs as SRS
    from halo2_aes_tpu.backend.keygen import keygen
    from halo2_aes_tpu.backend.prover import prove
    from halo2_aes_tpu.backend.verifier import verify
    from halo2_aes_tpu.circuit import ir
    from halo2_aes_tpu_torch.circuit.toys import (GOLDEN_IPA_PROOFS,
                                                  GOLDEN_PROOFS, K, TOYS)

    srs = SRS.setup(K, cache_dir=None)
    out = {"k": K}
    if only:
        with open(OUT) as f:
            out = json.load(f)
    pks = {}
    for name, (toy, opts) in GOLDEN_PROOFS.items():
        if only and name not in only:
            continue
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
    ipa = [name for name in GOLDEN_IPA_PROOFS if not only or name in only]
    basis = IPA.setup(K, cache_dir=None) if ipa else None
    for name in ipa:
        toy = GOLDEN_IPA_PROOFS[name]
        build, seed, instances = TOYS[toy]
        layout, values = build(ir)
        pk = keygen(layout, basis)
        proof = prove(pk, values, seed=seed, multiopen="ipa")
        assert IPA.verify(pk.vk, proof, instances=instances, srs=basis)
        out[name] = {"seed": seed, "multiopen": "ipa",
                     "vk_digest": hex(pk.vk.digest), "proof": proof.hex()}
        print(f"{name}: {len(proof)} bytes", flush=True)
    _dump(OUT, out)


def golden_mini() -> None:
    import jax.numpy as jnp

    from halo2_aes_tpu.backend import srs as SRS
    from halo2_aes_tpu.backend.keygen import keygen
    from halo2_aes_tpu.backend.prover import prove
    from halo2_aes_tpu.backend.verifier import verify
    from halo2_aes_tpu.circuit import witness
    from halo2_aes_tpu.models import aes_mini as MINI
    from halo2_aes_tpu_torch.circuit.toys import (MINI_CONFIG, MINI_PROVE_SEED,
                                                  mini_inputs)

    layout = MINI.compile_mini_circuit(MINI.MiniAesConfig(**MINI_CONFIG))
    key, pts = mini_inputs()
    values = witness.assemble_values(
        layout, MINI.build_pool_mini(jnp.asarray(key), jnp.asarray(pts)))
    pk = keygen(layout, SRS.setup(MINI_CONFIG["k"], cache_dir=None))
    proof = prove(pk, values, seed=MINI_PROVE_SEED)
    assert verify(pk.vk, proof)
    _dump(OUT_MINI, {**MINI_CONFIG, "mini": {
        "seed": MINI_PROVE_SEED, "vk_digest": hex(pk.vk.digest),
        "proof": proof.hex()}})
    print(f"mini: {len(proof)} bytes", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mini", action="store_true",
                    help="write the mini-AES k=11 golden proof instead")
    ap.add_argument("--only", default="",
                    help="comma-separated entries to prove; the file keeps "
                         "the others")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from halo2_aes_tpu.ops import field

    field.set_compact_graphs(True)
    if args.mini:
        golden_mini()
    else:
        golden_k6(set(filter(None, args.only.split(","))))


if __name__ == "__main__":
    main()
