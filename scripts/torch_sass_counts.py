#!/usr/bin/env python3
"""Instruction counts of the port's CUDA kernels, from the built library's
SASS, with each kernel's registers and spills from ``-Xptxas -v``.

  python3 scripts/torch_sass_counts.py [--tree DIR] [--out FILE]

Builds (or loads) the kernel library of the tree's ``halo2_aes_tpu_torch``
(``--tree``, default this checkout, so a parent unpacked under ``build/``
can be counted beside it), runs ``cuobjdump -sass`` over it and counts, a
kernel: ``IMAD.WIDE`` (signed), ``IMAD.WIDE.U32`` (the multiply-adds of the
field products), ``IMAD.MOV`` and ``MOV`` (register moves; ``IMAD.MOV``
issues on the multiply pipe), ``IMAD.X``, local loads and stores (``LDL``,
``STL``: spills) and every instruction but ``NOP``; ``opcodes`` is the
whole histogram.  It counts the kernels that carry the field product:
K1 ``mont_mul_kernel``, K2 ``ntt_fused_kernel``, K3's ``curve_*``
kernels, K4 ``quotient_terms_kernel``, K6's ``grand_*`` kernels and K7's
``msm_accumulate_kernel``, ``msm_merge_kernel`` and
``msm_reduce_kernel``.  Prints one JSON line; needs the CUDA toolkit's
``nvcc`` and ``cuobjdump``, not a card.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCT_KERNELS = ("mont_mul_kernel", "ntt_fused_kernel", "curve_",
                   "quotient_terms_kernel", "grand_", "msm_accumulate_kernel",
                   "msm_merge_kernel", "msm_reduce_kernel")
_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*[^;]*;")
_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for) '?([\w$]+)")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
# summary name -> test on an opcode
CLASSES = {
    "IMAD.WIDE": lambda op: op.startswith("IMAD.WIDE") and not op.startswith(
        "IMAD.WIDE.U32"),
    "IMAD.WIDE.U32": lambda op: op.startswith("IMAD.WIDE.U32"),
    "IMAD.MOV": lambda op: op.startswith("IMAD.MOV"),
    "MOV": lambda op: op == "MOV" or op.startswith("MOV."),
    "IMAD.X": lambda op: op.startswith("IMAD.X"),
    "LDL": lambda op: op.startswith("LDL"),
    "STL": lambda op: op.startswith("STL"),
}


def kernel_name(mangled: str) -> str:
    """The plain name of a mangled kernel (``_Z21msm_accumulate_kernelPi...``
    -> ``msm_accumulate_kernel``; in a namespace, the anonymous one too,
    ``_ZN12_GLOBAL__N_119grand_reduce_kernelI...`` -> ``grand_reduce_kernel``);
    an unmangled name as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while (m := re.match(r"\d+", mangled[pos:])):
        pos += m.end()
        name = mangled[pos:pos + int(m.group())]
        pos += int(m.group())
        if not mangled.startswith("_ZN"):
            break
    return name


def ptxas_lines(log: str) -> dict:
    """mangled kernel -> {"registers", "stack_bytes", "spill_stores",
    "spill_loads"} from ``-Xptxas -v`` output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            out[cur].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def sass_counts(lib_path: str) -> dict:
    """mangled kernel -> {"opcodes": histogram, class: count, "total"}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), {"opcodes": {}})
            continue
        m = _INSN.search(line)
        if cur is None or not m or m.group(1) == "NOP":
            continue
        op = m.group(1)
        cur["opcodes"][op] = cur["opcodes"].get(op, 0) + 1
    for rec in out.values():
        ops = rec["opcodes"]
        for name, test in CLASSES.items():
            rec[name] = sum(n for op, n in ops.items() if test(op))
        rec["moves"] = rec["IMAD.MOV"] + rec["MOV"]
        rec["total"] = sum(ops.values())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    from halo2_aes_tpu_torch.ops import _build

    lib, seconds, log = _build.build()
    ptxas = ptxas_lines(log)
    kernels = {}
    for mangled, rec in sorted(sass_counts(lib).items()):
        name = kernel_name(mangled)
        if not name.startswith(PRODUCT_KERNELS):
            continue
        key = name if name not in kernels else mangled
        kernels[key] = {**ptxas.get(mangled, {}), **rec}
    out = {"tree": os.path.relpath(os.path.abspath(args.tree), REPO),
           "library": os.path.relpath(lib, REPO), "build_s": seconds,
           "kernels": kernels}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
