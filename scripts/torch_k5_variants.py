"""What K5's time is made of: the nibble-product kernel built in variants
with one part of its work taken out, timed at the probe's shapes.

  python scripts/torch_k5_variants.py [log2n] [reps]

Each variant is ``csrc/nibble_mma.cu`` with a text substitution, built by
nvcc into its own library under ``build/k5_variants/`` (all at once):
  base            the kernel as it is (checked against the plain version)
  no_b_fill       the B bytes are not loaded; shared memory gets a pattern
  no_x_loads      the limbs of x are not loaded; the A fragments are made
                  from the indices
  no_mma          the tensor-core products are replaced by two XORs
  skeleton        no_b_fill and no_x_loads together
  one_block_sm    ``__launch_bounds__(256, 1)``: more registers, half the
                  resident warps
Only ``base`` computes the product; the others show which part of the
work the time follows.  Prints the card line, each variant's ptxas
registers, then one JSON line per variant with its ms at each shape
(CUDA-event medians).  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LOAD_B = "word |= (uint32_t)(uint8_t)__ldg(bcol + (int64_t)k * M) << (8 * r);"
LOAD_X = "xa[s][0] = load_limb(xg, ra, rows, l0, L);"
MMA = "mma_s8(acc[nt], a, col[0], col[4]);"
BOUNDS = "__launch_bounds__(THREADS, 2)"
SUBS = {
    "no_b_fill": [(LOAD_B, "word |= (uint32_t)(k + fcol) << (8 * r);")],
    "no_x_loads": [
        (LOAD_X, "xa[s][0] = nibble_word(l0 + (uint32_t)ra);"),
        ("xa[s][1] = load_limb(xg, rb, rows, l0, L);",
         "xa[s][1] = nibble_word(3u * l0 + (uint32_t)rb);"),
        ("xa[s][2] = load_limb(xg, ra, rows, l1, L);",
         "xa[s][2] = nibble_word(l1 + 7u);"),
        ("xa[s][3] = load_limb(xg, rb, rows, l1, L);",
         "xa[s][3] = nibble_word(l1 ^ (uint32_t)ra);")],
    "no_mma": [(MMA, "acc[nt][0] += a[0] ^ col[0]; acc[nt][1] += a[1] ^ col[4];")],
    "one_block_sm": [(BOUNDS, "__launch_bounds__(THREADS, 1)")],
}
SUBS["skeleton"] = SUBS["no_b_fill"] + SUBS["no_x_loads"]
SHAPES = ("fixed_64x127", "dft16_1024x2032", "ntt256_stage2_16x1024x2032")


def build(out_dir: str) -> dict:
    """Variant name -> (library path, ptxas register lines)."""
    from halo2_aes_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, "nibble_mma.cu")) as f:
        src = f.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in {"base": [], **SUBS}.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the kernel no longer contains {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.COMPILE_FLAGS, "-shared", "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        out[name] = (lib, [ln.strip() for ln in log.splitlines() if "registers" in ln])
    return out


def run(log2n: int = 17, reps: int = 5) -> list:
    import importlib.util

    import numpy as np
    import torch

    from halo2_aes_tpu_torch.ops import _build, cuda_nibble
    from halo2_aes_tpu_torch.ops.timing import time_ms

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the variants run on the card only")
    spec = importlib.util.spec_from_file_location(
        "torch_mxu_probe", os.path.join(ROOT, "scripts", "torch_mxu_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    libs = build(os.path.join(ROOT, "build", "k5_variants"))
    cases = probe.k5_cases(log2n, np.random.default_rng(3), "cuda")
    rows = []
    for name, (path, regs) in libs.items():
        fn = ctypes.CDLL(path).nibble_mma_launch
        fn.argtypes = _build.SIGNATURES["nibble_mma_launch"]
        fn.restype = ctypes.c_int
        row = {"variant": name, "ptxas": regs, "log2n": log2n}
        for shape in SHAPES:
            x, B, block = cases[shape]
            g, n, limbs = x.shape
            m = B.shape[-1]
            block = block or m
            out = torch.empty((g, n, cuda_nibble.out_limbs(m, block)),
                              dtype=torch.int32, device=x.device)
            stream = _build.stream_of(out)

            def call():
                _build.check(fn(out.data_ptr(), x.data_ptr(), B.data_ptr(), g, n,
                                limbs, m, block, stream), name)

            call()
            if name == "base" and not torch.equal(
                    out, cuda_nibble.nibble_product_plain(x, B, block)):
                raise AssertionError(f"base variant differs at {shape}")
            row[shape] = time_ms(call, 50, reps)
        rows.append(row)
    return rows


def main() -> int:
    log2n = int(sys.argv[1]) if len(sys.argv) > 1 else 17
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    from halo2_aes_tpu_torch.ops.timing import card_line

    rows = run(log2n, reps)
    print(card_line(), flush=True)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
