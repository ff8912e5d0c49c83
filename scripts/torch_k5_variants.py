"""What K5's time is made of: the nibble-product kernel built in variants
with one part of its work taken out or resized, timed at the probe's
shapes.

  python scripts/torch_k5_variants.py [log2n] [reps]

Each variant is ``csrc/nibble_mma.cu`` with a text substitution, built by
nvcc into its own library under ``build/k5_variants/`` (all at once):
  base            the kernel as it is (checked against the plain versions)
  no_b_copy       the producer copies no B (each stage's barrier completes
                  on the x copies; the products read whatever the ring holds)
  no_x_copy       the producer copies no rows of x (the A fragments are
                  made from whatever the ring holds)
  no_mma          the tensor-core products are left out (the A fragments
                  are still made)
  no_normalize    the epilogue's carry copies the limbs instead (no
                  ripple, no addend)
  dense_mma       every chunk multiplied, kept or not (the skip's worth)
  skeleton        no_b_copy and no_x_copy together
  bare            skeleton and no_mma together: what is left is the
                  loop, the barriers, the epilogue and the launch
  depth_2/3/6     a ring of 2, 3 or 6 slots (4 as built)
  stage_1/stage_4 1 or 4 k-steps a ring stage (2 as built); 4 also with 2
                  slots
  two_blocks_sm   2 resident blocks an SM (3 as built)
  eight_warps_2_blocks  two consumer warpgroups (128 rows) a block, 2
                  blocks an SM (one warpgroup, 64 rows, 3 blocks as built)
Only ``base`` computes the product; the others show which part of the
work the time follows.  Every variant runs the fold-only entry at the
five product shapes and the normalize entry at the DftMatmul(16) and
FixedMul carry sites.  Prints the card line, each variant's ptxas
registers and spills, then one JSON line per variant with its ms at each
shape (CUDA-event medians).  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

COPY = "        if (bytes) bulk_copy(sb, packed + (int64_t)first * FRAG, bytes, &full[slot]);"
EXPECT = "mbar_expect_tx(&full[slot], bytes);"
X_COPIES = """        if (x16) copy_rows<4>(sx, xg, row0, rows, L, ks0 * 8, lane);
        else copy_rows<1>(sx, xg, row0, rows, L, ks0 * 8, lane);"""
# the products skipped, the A fragments still made (an impossible test
# keeps them live)
PRODUCTS = "      if (any) {"
NO_PRODUCTS = "      if (any && a[0][0] == 0x01020304u && a[KS_STAGE - 1][3] == 0x0F0E0D0Cu) {"
CHUNK_TEST = "            if ((m[h] >> c) & 1u) {"
LAST_CHUNK_TEST = "          if ((m[h] >> (NCH - 1)) & 1u)"
RIPPLE = """        c += j < olb ? v[j] : 0u;
        c += j < addend_limbs ? (uint32_t)__ldg(ad + j) & 0xFFFFu : 0u;
        w[j] = (uint32_t)c & 0xFFFFu;
        c >>= 16;"""
BLOCKS = "constexpr int BLOCKS_SM = 3;"
WARPS = "constexpr int CWARPS = 4;"
DEPTH = "constexpr int DEPTH = 4;"
STAGE = "constexpr int KS_STAGE = 2;"
SUBS = {
    "no_b_copy": [(EXPECT, "mbar_expect_tx(&full[slot], 0u);"),
                  (COPY, "        (void)first;")],
    "no_x_copy": [(X_COPIES, "        (void)sx;")],
    "no_mma": [(PRODUCTS, NO_PRODUCTS)],
    "no_normalize": [(RIPPLE, "        w[j] = j < olb ? v[j] : 0u; (void)ad; (void)c;")],
    "dense_mma": [(CHUNK_TEST, "            if (CHUNK * c < ntc) {"),
                  (LAST_CHUNK_TEST, "          if (CHUNK * (NCH - 1) < ntc)")],
    "depth_2": [(DEPTH, "constexpr int DEPTH = 2;")],
    "depth_6": [(DEPTH, "constexpr int DEPTH = 6;")],
    "stage_1": [(STAGE, "constexpr int KS_STAGE = 1;")],
    "stage_4": [(STAGE, "constexpr int KS_STAGE = 4;")],
    "depth_3": [(DEPTH, "constexpr int DEPTH = 3;")],
    "stage_4_depth_2": [(STAGE, "constexpr int KS_STAGE = 4;"),
                        (DEPTH, "constexpr int DEPTH = 2;")],

    "two_blocks_sm": [(BLOCKS, "constexpr int BLOCKS_SM = 2;")],
    "eight_warps_2_blocks": [(WARPS, "constexpr int CWARPS = 8;"),
                             (BLOCKS, "constexpr int BLOCKS_SM = 2;")],
}
SUBS["skeleton"] = SUBS["no_b_copy"] + SUBS["no_x_copy"]
SUBS["bare"] = SUBS["skeleton"] + SUBS["no_mma"]
NORMALIZE = ("fixed_64x127_w32", "dft16_1024x2032_w33")


def build(out_dir: str) -> dict:
    """Variant name -> (library path, ptxas register and spill lines)."""
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
        out[name] = (lib, [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln])
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
    rng = np.random.default_rng(3)
    cases = {name: (x, B, block, 0, None)
             for name, (x, B, block) in probe.k5_cases(log2n, rng, "cuda").items()}
    norm = probe.k5_normalize_cases(log2n, rng, "cuda")
    cases.update({f"normalize_{name}": norm[name] for name in NORMALIZE})
    packed = {name: cuda_nibble.pack(c[1], c[2]) for name, c in cases.items()}
    rows = []
    for name, (path, regs) in libs.items():
        fn = ctypes.CDLL(path).nibble_mma_launch
        fn.argtypes = _build.SIGNATURES["nibble_mma_launch"]
        fn.restype = ctypes.c_int
        row = {"variant": name, "ptxas": regs, "log2n": log2n}
        for shape, (x, B, block, width, add) in cases.items():
            pk = packed[shape]
            g, n, limbs = x.shape
            n_out = (B.shape[-1] // pk.block) * width if width else pk.nlimbs
            out = torch.empty((g, n, n_out), dtype=torch.int32, device=x.device)
            stream = _build.stream_of(out)

            def call():
                _build.check(fn(out.data_ptr(), x.data_ptr(), pk.data.data_ptr(),
                                pk.offsets.data_ptr(), pk.masks.data_ptr(),
                                None if add is None else add.data_ptr(), g, n, limbs,
                                pk.ksteps, pk.tiles, pk.tile_limbs, pk.olb, pk.nlimbs,
                                width, 0 if add is None else add.shape[2], stream), name)

            call()
            if name == "base":
                want = (cuda_nibble.nibble_normalize_plain(x, B, block, width, add)
                        if width else cuda_nibble.nibble_product_plain(x, B, block))
                if not torch.equal(out, want):
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
