#!/usr/bin/env python3
"""K4 (an interpreter of the term program) against the same program
generated as straight-line CUDA source, on one CUDA card.

  python3 scripts/torch_k4_generated.py [--k 20] [--out FILE]

The quotient's constraint terms of the benchmark cell's circuit
(AES-128, 4 sets, upstream's layout) are lowered once
(``backend/term_program.py``); this script writes that program as one
kernel with every instruction a statement and every slot an array of
registers (constants read from the launch's table at their use), builds
it with nvcc into ``build/k4_generated/<source hash>/``, holds it
against K4 bit for bit on random stacks of one 2^k sub-coset, and
prints one JSON line: nvcc seconds, ptxas registers and spills, and
CUDA-event times of both.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))


def source(prog, n_static: int) -> str:
    """The program as one straight-line kernel (the first ``n_static``
    polys are the static stack's)."""
    from halo2_aes_tpu_torch.ops import cuda_quotient as CQ

    def opnd(a, tmp):
        if a >= 0:
            return f"s[{a}]", ""
        return tmp, f"fe_load(table + {~a} * 16, {tmp}); "

    body = []
    for op, d, a, b in prog.code.tolist():
        if op == CQ.LOAD:
            base, p = ("stat", a) if a < n_static else ("dyn", a - n_static)
            body.append(f"fe_load({base} + ({p}LL * n + ((row + {b}LL) & mask)) * 16, s[{d}]);")
        elif op == CQ.OMEGA:
            body.append(f"fe_load(omega + row * 16, s[{d}]);")
        elif op in (CQ.ADD, CQ.SUB, CQ.MUL):
            xa, la = opnd(a, "ta")
            xb, lb = opnd(b, "tb")
            fn = {CQ.ADD: "fe_add", CQ.SUB: "fe_sub", CQ.MUL: "fe_mont_mul"}[op]
            body.append(f"{la}{lb}{fn}(s[{d}], {xa}, {xb}, m);")
        elif op == CQ.NEG:
            xa, la = opnd(a, "ta")
            body.append(f"{la}fe_sub(s[{d}], zero, {xa}, m);")
        elif op == CQ.FIRST:
            xa, la = opnd(a, "ta")
            body.append(f"{la}for (int w = 0; w < 8; ++w) acc[w] = {xa}[w];")
        elif op == CQ.FOLD:
            xa, la = opnd(a, "ta")
            body.append(f"{la}fe_mont_mul(tb, acc, y, m); fe_add(acc, tb, {xa}, m);")
    lines = "\n    ".join(body)
    return f"""#include "field.cuh"
__global__ void k4_generated(int32_t* __restrict__ out, const int32_t* __restrict__ stat,
    const int32_t* __restrict__ dyn, const int32_t* __restrict__ omega,
    const int32_t* __restrict__ table, int64_t n, int64_t row0, int64_t rows, Modulus m) {{
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const int64_t row = row0 + i, mask = n - 1;
  uint32_t s[{max(prog.slots, 1)}][8], acc[8], ta[8], tb[8], y[8], zero[8] = {{0}};
  fe_load(table + {CQ.TABLE_Y} * 16, y);
  {lines}
  fe_load(table + {CQ.TABLE_ZH_INV} * 16, ta);
  fe_mont_mul(tb, acc, ta, m);
  fe_store(out + i * 16, tb);
}}
extern "C" int k4_generated_launch(void* out, const void* stat, const void* dyn,
    const void* omega, const void* table, int64_t n, int64_t row0, int64_t rows,
    const uint32_t* p, uint32_t n0, void* stream) {{
  Modulus m = make_modulus(p, n0);
  k4_generated<<<(unsigned)((rows + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)stat, (const int32_t*)dyn, (const int32_t*)omega,
      (const int32_t*)table, n, row0, rows, m);
  return (int)cudaGetLastError();
}}
"""


def build(src: str):
    from halo2_aes_tpu_torch.ops import _build

    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    out_dir = os.path.join(REPO, "build", "k4_generated", tag)
    lib = os.path.join(out_dir, "libk4gen.so")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "k4gen.cu")
    with open(cu, "w") as f:
        f.write(src)
    t0 = time.perf_counter()
    run = subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS, "-shared", "-I",
                          _build.CSRC, "-o", lib, cu], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if run.returncode:
        raise RuntimeError(f"nvcc failed:\n{run.stdout}{run.stderr}")
    log = run.stdout + run.stderr
    loaded = ctypes.CDLL(lib)
    fn = loaded.k4_generated_launch
    P, I = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [P] * 5 + [I] * 3 + [P, ctypes.c_uint32, P]
    fn.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in log.splitlines()
             if "k4_generated" in ln or re.search(r"registers|spill", ln)]
    return loaded, fn, seconds, ptxas


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no card")
    from torch_kernel_times import cell_phases, random_stack

    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.ops import _build
    from halo2_aes_tpu_torch.ops import cuda_quotient as CQ
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops.timing import card_line, time_ms

    dev = torch.device("cuda", 0)
    k = args.k
    ph = cell_phases(dev, k)
    n = ph.n
    loaded, fn, nvcc_s, ptxas = build(source(ph.terms, len(ph.q_static_keys)))

    gen = torch.Generator(device=dev)
    gen.manual_seed(k)
    static = random_stack(F, len(ph.q_static_keys), n, gen, dev)
    dyn = random_stack(F, len(ph.q_dyn_keys), n, gen, dev)
    shift, zh_inv = PV._subcoset_tables(k, ph.ext_k, 1, dev)
    theta, beta, gamma, y = (F.encode(F.FR, v, dev) for v in (3, 5, 7, 11))
    table = CQ.constant_table(ph._terms_consts, y, zh_inv, theta, beta, gamma,
                              F.mont_mul(F.FR, ph._delta_pows, shift[1]))
    omega = ph.dom.omega_powers(dev)
    words, n0 = _build.modulus_args(F.FR.modulus)
    got = torch.empty((n, F.LIMBS), dtype=torch.int32, device=dev)
    want = torch.empty_like(got)

    def generated():
        code = fn(got.data_ptr(), static.data_ptr(), dyn.data_ptr(), omega.data_ptr(),
                  table.data_ptr(), n, 0, n, ctypes.addressof(words), n0,
                  _build.stream_of(got))
        _build.check(code, "k4_generated")

    def interpreter():
        CQ.quotient_terms(ph._terms_code, ph.terms.slots, table, static, dyn, omega,
                          0, want)

    generated()
    interpreter()
    if not torch.equal(got, want):
        raise AssertionError("the generated kernel differs from K4")
    out = {"card": card_line(), "k": k, "instructions": int(ph.terms.code.shape[0]),
           "slots": ph.terms.slots, "nvcc_s": nvcc_s, "ptxas": ptxas,
           "bit_exact": True, "k4_ms": time_ms(interpreter, 5),
           "generated_ms": time_ms(generated, 5)}
    out["k4_over_generated"] = out["k4_ms"] / out["generated_ms"]
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
