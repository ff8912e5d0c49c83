"""Sustained AES-CTR proving with the PyTorch port on one device.

  python scripts/torch_ctr_sustained.py --device cuda [n_blocks] [k] [sets] [--tagged]

The counterpart of ``scripts/ctr_sustained.py`` (defaults: 4096 blocks
at k=17, one column set): proves a CTR keystream as a bundle of
full-capacity proofs (the layout exposes the keystream bytes, with
``blocks_per_proof`` the layout's whole capacity), verifies the WHOLE
bundle with one pairing-product check, and prints sustained blocks/s
and a 64K-block extrapolation.  One warm-up chunk is proved first.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_blocks", type=int, nargs="?", default=4096)
    ap.add_argument("k", type=int, nargs="?", default=17)
    ap.add_argument("sets", type=int, nargs="?", default=1)
    ap.add_argument("--tagged", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; without a card, "
                         "pass --device cpu)")
    args = ap.parse_args()

    import numpy as np
    import torch

    from halo2_aes_tpu_torch import ctr
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.backend.keygen import keygen_cached
    from halo2_aes_tpu_torch.models.aes128 import (AesConfig, capacities,
                                                    compile_circuit, configure)
    from halo2_aes_tpu_torch.ops.timing import resolve_device

    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg0 = AesConfig(k=args.k, n_sets=args.sets, n_blocks=1,
                     expose_ciphertext=True, tagged_ops=args.tagged)
    bpp = sum(capacities(cfg0, configure(cfg0)[0]))
    cfg = AesConfig(k=args.k, n_sets=args.sets, n_blocks=bpp,
                    expose_ciphertext=True, tagged_ops=args.tagged)
    print(f"bpp={bpp} chunks={-(-args.n_blocks // bpp)} device={dev}", flush=True)
    layout = compile_circuit(cfg)
    srs = SRS.setup(args.k, dev)
    pk = keygen_cached(layout, srs)

    key = np.frombuffer(bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"), np.uint8)
    nonce = bytes(range(12))

    t0 = time.perf_counter()
    ctr.prove_keystream(pk, key, nonce, n_blocks=1)
    sync()
    print(f"warmup chunk {time.perf_counter() - t0:.1f}s", flush=True)

    done = [0.0]

    def progress(i, total):
        sync()
        now = time.perf_counter() - t0
        print(f"proof {i}/{total} t={now:.1f}s "
              f"({i * bpp / now:.2f} blocks/s sustained)", flush=True)
        done[0] = now

    t0 = time.perf_counter()
    bundle = ctr.prove_keystream(pk, key, nonce, n_blocks=args.n_blocks,
                                 progress=progress)
    prove_s = done[0]
    t0v = time.perf_counter()
    assert ctr.verify_bundle(pk.vk, bundle)
    verify_s = time.perf_counter() - t0v
    bps = args.n_blocks / prove_s
    print(f"SUSTAINED: {args.n_blocks} blocks in {prove_s:.1f}s = "
          f"{bps:.2f} blocks/s; bundle verify ({len(bundle.proofs)} proofs, "
          f"one pairing product) {verify_s:.2f}s", flush=True)
    print(f"64K-block extrapolation: {65536 / bps / 60:.1f} min prove, "
          f"verify ~{verify_s * 65536 / args.n_blocks:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
