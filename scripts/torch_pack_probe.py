"""P2 on the card: Montgomery multiplication on limb-major planes, the
16-bit CIOS (P2a) and the 13-bit delayed-carry CIOS (P2b), against K1.

  python scripts/torch_pack_probe.py --device cuda [log2n] [reps]

The counterpart of ``scripts/pallas_pack_probe.py`` (defaults: 2^17
products, 5 timing windows).  It first checks both probe kernels
(``ops/cuda_probe.py``) on random Fr values, the edges 0, 1, p-1 and
R mod p in the first rows, against their plain versions and against
K1's plain version on the transposed values; then it times chains of 32
applications (out -> a) of each, and of K1 (``cuda_field.mont_mul``) on
the same values in the public (N, 16) layout as the "current" row.
Prints the card's name and power limit, then one JSON line per kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHAIN = 32


def field_planes(n: int, rng, device, edges_first: bool = True):
    """(16, n) int32 planes of canonical Fr limbs, uniform-ish, with the
    edges 0, 1, p-1, R mod p in the first rows (reversed when
    ``edges_first`` is false) and again in rows 4..7."""
    import numpy as np
    import torch

    from halo2_aes_tpu_torch.ops import field as F

    spec = F.FR
    limbs = rng.integers(0, 1 << 16, (n, F.LIMBS), dtype=np.int64)
    limbs[:, -1] = rng.integers(0, int(spec.p_limbs[-1]), n)
    edges = F.ints_to_limbs_fast([0, 1, spec.modulus - 1, spec.r_mod_p])
    limbs[:4] = edges if edges_first else edges[::-1]
    limbs[4:8] = edges
    return torch.as_tensor(np.ascontiguousarray(limbs.T).astype(np.int32),
                           device=device)


def check(a, b) -> int:
    """Both probe kernels against their plain versions and against K1's
    plain version on the transposed values; returns the max abs error."""
    import torch

    from halo2_aes_tpu_torch.ops import cuda_field, cuda_probe
    from halo2_aes_tpu_torch.ops import field as F

    want = cuda_field.mont_mul_plain(F.FR, a.T, b.T).T
    err = 0
    for kernel, plain in ((cuda_probe.mont_mul_planes16,
                           cuda_probe.mont_mul_planes16_plain),
                          (cuda_probe.mont_mul_planes13,
                           cuda_probe.mont_mul_planes13_plain)):
        got = kernel(F.FR, a, b)
        for ref in (plain(F.FR, a, b), want):
            err = max(err, int((got.to(torch.int64) - ref.to(torch.int64))
                               .abs().max().item()))
    return err


def run(device: str, log2n: int = 17, reps: int = 5) -> list:
    import numpy as np
    import torch

    from halo2_aes_tpu_torch.ops import cuda_field, cuda_probe
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops.timing import time_ms

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the probe measures a CUDA card, not {dev}")
    n = 1 << log2n
    rng = np.random.default_rng(0)
    a = field_planes(n, rng, dev)
    b = field_planes(n, rng, dev, edges_first=False)
    err = check(a, b)
    if err:
        raise AssertionError(f"probe kernels differ from their plain versions: {err}")
    rows_a, rows_b = a.T.contiguous(), b.T.contiguous()
    kernels = {
        "packed13": lambda x: cuda_probe.mont_mul_planes13(F.FR, x, b),
        "packed": lambda x: cuda_probe.mont_mul_planes16(F.FR, x, b),
        "current": lambda x: cuda_field.mont_mul(F.FR, x, rows_b),
    }
    out = []
    for name, fn in kernels.items():
        start = rows_a if name == "current" else a

        def chain(fn=fn, start=start):
            cur = start
            for _ in range(CHAIN):
                cur = fn(cur)
            return cur

        ms = time_ms(chain, 5, reps) / CHAIN
        out.append({"name": name, "log2n": log2n, "ms": ms,
                    "mmul_per_s": n / ms / 1e3, "max_abs_err": err})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log2n", type=int, nargs="?", default=17)
    ap.add_argument("reps", type=int, nargs="?", default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; without a card, "
                         "pass --device cpu)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the probe measures the card only")
    from halo2_aes_tpu_torch.ops.timing import card_line, resolve_device

    print(card_line(), flush=True)
    for rec in run(str(resolve_device(args.device)), args.log2n, args.reps):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
