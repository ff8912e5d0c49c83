"""P1 on the card: raw 32-bit multiply throughput of the port's probe kernel.

  python scripts/torch_mul_throughput_probe.py --device cuda [--log2n 17] [--reps 5]

The counterpart of ``scripts/mul_throughput_probe.py``: for k in
{64, 512} products per element, with the operands as they are and
masked to 16 bits, it first checks the kernel (``ops/cuda_probe.py``
``mul_probe``) against its plain PyTorch version, then times chains of
16 applications (out -> a, as the TPU probe chains them) with CUDA
events.  Rates are given on the TPU probe's count, N k / t, and on the
multiplies the compiler actually issued: the register-by-register IMADs
that ``cuobjdump -sass`` finds in each kernel instance (at k = 512 the
(i, j) pairs repeat, and the compiler may fold the repeats).  Prints the
card's name and power limit, then one JSON line per case.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHAIN = 16
CASES = [(k, m) for k in (64, 512) for m in (False, True)]
_FUNC = re.compile(r"Function : \S*mul_probe_kernelILi(\d+)ELb([01])E")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")


def sass_multiplies(lib_path: str) -> dict:
    """(k, mask16) -> {"opcodes": IMAD/IMUL histogram, "reg_products":
    multiplies whose two factors are both registers} per kernel instance,
    from ``cuobjdump -sass`` of the built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = (int(m.group(1)), m.group(2) == "1")
            out[cur] = {"opcodes": {}, "reg_products": 0}
            continue
        if "Function :" in line:
            cur = None
        m = _INSN.search(line)
        if cur is None or not m:
            continue
        op, args = m.group(1), [a.strip() for a in m.group(2).split(",")]
        if not op.startswith(("IMAD", "IMUL")):
            continue
        rec = out[cur]
        rec["opcodes"][op] = rec["opcodes"].get(op, 0) + 1
        if (not op.startswith(("IMAD.MOV", "IMAD.SHL", "IMAD.IADD"))
                and len(args) >= 3
                and all(re.fullmatch(r"-?R\d+(\.reuse)?", a) for a in args[1:3])):
            rec["reg_products"] += 1
    return out


def run(device: str, log2n: int = 17, reps: int = 5) -> list:
    """Check and time every case on ``device`` (a CUDA device); returns
    one record per case."""
    import numpy as np
    import torch

    from halo2_aes_tpu_torch.ops import _build, cuda_probe
    from halo2_aes_tpu_torch.ops.timing import time_ms

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the probe measures a CUDA card, not {dev}")
    n = 1 << log2n
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.integers(0, 1 << 16, (16, n), dtype=np.int32), device=dev)
    b = torch.as_tensor(rng.integers(0, 1 << 16, (16, n), dtype=np.int32), device=dev)
    counts = sass_multiplies(_build.build()[0])
    out = []
    for k, mask16 in CASES:
        got = cuda_probe.mul_probe(a, b, k, mask16)
        want = cuda_probe.mul_probe_plain(a, b, k, mask16)
        if not torch.equal(got, want):
            raise AssertionError(f"mul_probe k={k} mask16={mask16} differs "
                                 "from its plain version")

        def chain(k=k, mask16=mask16):
            cur = a
            for _ in range(CHAIN):
                cur = cuda_probe.mul_probe(cur, b, k, mask16)
            return cur

        ms = time_ms(chain, 10, reps) / CHAIN
        sass = counts[(k, mask16)]
        out.append({"k": k, "mask16": mask16, "n": n, "ms": ms,
                    "gmul_per_s": n * k / ms / 1e6,
                    "issued_per_element": sass["reg_products"],
                    "gmul_issued_per_s": n * sass["reg_products"] / ms / 1e6,
                    "sass": sass["opcodes"]})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; without a card, "
                         "pass --device cpu)")
    ap.add_argument("--log2n", type=int, default=17)
    ap.add_argument("--reps", type=int, default=5)
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
