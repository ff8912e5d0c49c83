"""End-to-end AES-128 prove (+verify) command line for the PyTorch port.

Usage:
  python -m halo2_aes_tpu_torch.prove --k 17 --blocks 384 --sets 4 \
      --tagged --verify --device cuda
  python -m halo2_aes_tpu_torch.prove --k 17 --blocks 384 --sets 4 \
      --decrypt --expose-ciphertext --verify --device cuda
  python -m halo2_aes_tpu_torch.prove ... --backend kzg-gwc
  python -m halo2_aes_tpu_torch.prove ... --backend ipa
  python -m halo2_aes_tpu_torch.prove --k 20 --sets 4 --blocks 3082 \
      --tagged --verify --device cuda --checkpoint-dir ckpt
  python -m halo2_aes_tpu_torch.prove --k 20 --sets 4 --blocks 3000 \
      --device cuda --trace-dir trace

``--device`` defaults to the first CUDA card; without a card the command
raises at once unless ``--device cpu`` is given.  Blinding always comes
from os.urandom; ``--seed`` seeds only the random AES key and
plaintexts.  With ``--expose-ciphertext`` the verifier is
given the public bytes (the ciphertext, or with ``--decrypt`` the
recovered plaintext) from an oracle run apart from the witness.
``--checkpoint-dir`` saves each heavy prove phase there, so that a
rerun of a crashed prove resumes at the first incomplete phase.
``--trace-dir DIR`` runs set-up and the prove under ``torch.profiler``
(``utils/timers.device_trace``: ``DIR/trace.json``, a Chrome trace with
the program's spans beside the kernels, and ``DIR/spans.json``) and
prints one row per span path: its count, host seconds and device
seconds.  The
SRS, its MSM window tables (below 2^22 points; there are none from
there on) and the keygen commitments are cached in ``ptau/`` (3.2 GB at
k=20).  From k = 23 on (``backend/rest.py``) the command runs the CUDA
allocator with expandable segments unless ``PYTORCH_CUDA_ALLOC_CONF``
says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def run(k: int, n_sets: int, blocks: int, tagged: bool, do_verify: bool,
        device: str | None = None, seed: int = 0, srs_cache: str | None = "ptau",
        expose_ciphertext: bool = False, decrypt: bool = False,
        backend: str = "kzg-shplonk", checkpoint_dir: str | None = None,
        trace_dir: str | None = None) -> dict:
    from halo2_aes_tpu_torch.backend import get_backend
    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.circuit import witness
    from halo2_aes_tpu_torch.ops import aes
    from halo2_aes_tpu_torch.ops.timing import resolve_device
    from halo2_aes_tpu_torch.utils import timers

    be = get_backend(backend)
    dev = resolve_device(device)
    pt = timers.PhaseTimers(device=dev)
    rng = np.random.default_rng(seed)
    key_np = rng.integers(0, 256, 16, dtype=np.uint8)
    pts_np = rng.integers(0, 256, (blocks, 16), dtype=np.uint8)
    first = len(timers.spans())
    with timers.device_trace(trace_dir):
        if decrypt:
            from halo2_aes_tpu_torch.models.aes128_dec import (
                AesDecConfig, compile_circuit as compile_dec)

            with pt.phase("compile_circuit"):
                layout = compile_dec(AesDecConfig(
                    k=k, n_sets=n_sets, n_blocks=blocks,
                    expose_plaintext=expose_ciphertext))
        else:
            from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit

            with pt.phase("compile_circuit"):
                layout = compile_circuit(AesConfig(
                    k=k, n_sets=n_sets, n_blocks=blocks, tagged_ops=tagged,
                    expose_ciphertext=expose_ciphertext))
        with pt.phase("srs_setup"):
            srs = be.setup_srs(k, dev, cache_dir=srs_cache)
        with pt.phase("keygen"):
            pk = (KG.keygen(layout, srs) if srs_cache is None
                  else be.keygen(layout, srs, cache_dir=srs_cache))
        key = torch.as_tensor(key_np, device=dev)
        pts = torch.as_tensor(pts_np, device=dev)
        with pt.phase("witness"):
            if decrypt:
                # prove knowledge of the DECRYPTION of these ciphertexts
                pool = witness.build_dec_pool(key, aes.encrypt(pts, key))
            else:
                pool = witness.build_pool(key, pts)
            values = witness.assemble_values(layout, pool)
        with pt.phase("prove"):
            proof = be.prove(pk, values, checkpoint_dir=checkpoint_dir)
    if trace_dir is not None:
        print(f"{'span':<64} {'count':>6} {'host_s':>10} {'device_s':>10}")
        for path, count, host_s, dev_s in timers.span_table(timers.spans()[first:]):
            print(f"{path:<64} {count:>6} {host_s:>10.4f} {dev_s:>10.4f}")
    result = {"proof_bytes": len(proof), "blocks": blocks,
              "k": k, "n_sets": n_sets, "tagged_ops": tagged or decrypt,
              "mode": "decrypt" if decrypt else "encrypt",
              "backend": backend, "device": str(dev)}
    if do_verify:
        instances = None
        if expose_ciphertext:
            # the public bytes from an oracle on the host, apart from the
            # witness: the ciphertext, or the plaintext when decrypting
            pub = pts_np if decrypt else aes.encrypt(
                torch.as_tensor(pts_np), torch.as_tensor(key_np)).numpy()
            instances = [[int(v) for v in pub.reshape(-1)]]
        # the IPA verifier recomputes the folded basis point: it needs the basis
        extra = {"srs": srs} if backend == "ipa" else {}
        with pt.phase("verify"):
            be.verify(pk.vk, proof, instances=instances, **extra)
        result["verified"] = True
    result["timings"] = pt.report()
    return result


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--k", type=int, default=17)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--tagged", action="store_true",
                    help="tagged-op lookup tables (the flagship layout)")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; without a card, "
                         "pass --device cpu)")
    ap.add_argument("--expose-ciphertext", action="store_true",
                    help="expose the public bytes as an instance column "
                         "(ciphertext when encrypting, recovered plaintext "
                         "with --decrypt)")
    ap.add_argument("--decrypt", action="store_true",
                    help="prove AES-128 DECRYPTION (models/aes128_dec.py; "
                         "its lookups are always tagged)")
    ap.add_argument("--backend", default="kzg-shplonk",
                    choices=["kzg-shplonk", "kzg-gwc", "ipa"],
                    help="proving system (backend.get_backend): KZG with "
                         "SHPLONK or GWC multiopen, or the transparent "
                         "pairing-free IPA system (backend/ipa.py)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save per-phase prove checkpoints here and resume "
                         "a crashed prove (backend/resume.py)")
    ap.add_argument("--trace-dir", default=None,
                    help="profile set-up and the prove: write trace.json and "
                         "spans.json here and print a row per span "
                         "(utils/timers.py)")
    return ap


def main():
    from halo2_aes_tpu_torch.backend import rest

    args = parser().parse_args()
    if rest.on_host(args.k):
        # large stacks among transients fragment the caching allocator's
        # fixed segments (backend/rest.py); set before the card is touched
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    print(json.dumps(run(args.k, args.sets, args.blocks, args.tagged,
                         args.verify, args.device, args.seed,
                         expose_ciphertext=args.expose_ciphertext,
                         decrypt=args.decrypt, backend=args.backend,
                         checkpoint_dir=args.checkpoint_dir,
                         trace_dir=args.trace_dir)))


if __name__ == "__main__":
    main()
