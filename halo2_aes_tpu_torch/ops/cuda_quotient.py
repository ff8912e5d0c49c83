"""K4: the quotient's constraint terms over the rows of one sub-coset,
CUDA kernel + plain PyTorch version.

Replaces no TPU kernel: the reference's compiler fused the eager field
ops of ``protocol.constraint_terms``; the port evaluated them one int64
torch op at a time.  K4 (``csrc/quotient_terms.cu``) runs the term
program of ``backend/term_program.py`` (the terms lowered once per
proving key) one row a thread in one launch: each term folded into the
accumulator with y as it is made, then the Z_H division; rotations are
index arithmetic on the sub-coset's stacks, nothing is copied or
widened.  What bounds it and how: see the source.

The prover runs the program on every device
(``prover._Phases.quotient_subcoset``): ``quotient_terms`` launches K4
for CUDA tensors and runs ``quotient_terms_plain``, the same
instructions with the field's tensor ops, for CPU tensors.  The eager
fold (``prover._Phases.quotient_subcoset_eager``) gives the same bits
and stays as the reference: the tests hold the plain version against
it, and ``chip_smoke.py`` holds K4 against it on the card.
"""

from __future__ import annotations

import ctypes

import torch

from halo2_aes_tpu_torch.ops import _build
from halo2_aes_tpu_torch.ops import field as F

FR = F.FR
# The instruction set (``csrc/quotient_terms.cu`` has the same numbers).
# An instruction is four int32 (op, dst, a, b); ``dst`` is a value slot;
# an operand ``a`` / ``b`` is a slot where it is >= 0, else row ~a of the
# launch's constant table (``constant_table``).
#   LOAD  dst, p, r   poly p of the sub-coset's stacks (the static
#                     stack's polys, then the dynamic stack's) at row
#                     (row + r) mod n
#   OMEGA dst         omega^row
#   ADD / SUB / MUL dst, a, b  (MUL: Montgomery product)
#   NEG   dst, a
#   FIRST a           acc = a
#   FOLD  a           acc = acc * y + a
# After the last instruction a row's result is acc * zh_inv.
LOAD, OMEGA, ADD, SUB, MUL, NEG, FIRST, FOLD = range(8)
TABLE_Y, TABLE_ZH_INV, TABLE_THETA, TABLE_BETA, TABLE_GAMMA = range(5)
TABLE_FIXED = 5          # rows before the permutation's delta^i * shift
LAUNCHES = 0      # kernel launches since the last reset (chip_smoke reads it)
SOURCE = "halo2_aes_tpu_torch/csrc/quotient_terms.cu"
REPLACES = ("none: the eager constraint-term fold, "
            "backend/prover._Phases.quotient_subcoset_eager")
THREADS = 128
SMEM_BYTES = 232448        # the most dynamic shared memory a block may take


def constant_table(consts, y, zh_inv, theta, beta, gamma, dshift):
    """A launch's constant table: the rows ``TABLE_*`` name,
    delta^i * shift for each permutation column (``dshift`` (m, 16)),
    then the program's constants (``consts`` (C, 16), Montgomery)."""
    head = torch.stack([t.reshape(F.LIMBS) for t in (y, zh_inv, theta, beta, gamma)])
    return torch.cat([head, dshift.reshape(-1, F.LIMBS), consts.reshape(-1, F.LIMBS)])


def quotient_terms_plain(code, table, static, dyn, omega, row0: int, rows: int):
    """The term program's rows [row0, row0 + rows) with the field's
    tensor ops, any device: (rows, 16)."""
    n = omega.shape[0]
    n_static = static.shape[0] // n
    idx = torch.arange(row0, row0 + rows, device=omega.device)
    slots = {}

    def get(a):
        return slots[a] if a >= 0 else table[~a]

    acc = None
    for op, d, a, b in code.tolist():
        if op == LOAD:
            src, p = (static, a) if a < n_static else (dyn, a - n_static)
            slots[d] = src[p * n + (idx + b) % n]
        elif op == OMEGA:
            slots[d] = omega[idx]
        elif op == ADD:
            slots[d] = F.add(FR, get(a), get(b))
        elif op == SUB:
            slots[d] = F.sub(FR, get(a), get(b))
        elif op == MUL:
            slots[d] = F.mont_mul(FR, get(a), get(b))
        elif op == NEG:
            slots[d] = F.neg(FR, get(a))
        elif op == FIRST:
            acc = get(a).expand(rows, F.LIMBS)
        elif op == FOLD:
            acc = F.add(FR, F.mont_mul(FR, acc, table[TABLE_Y]), get(a))
        else:
            raise ValueError(f"term program: unknown op {op}")
    return F.mont_mul(FR, acc, table[TABLE_ZH_INV])


def threads_for(table_rows: int, slots: int) -> int:
    """Threads a block: THREADS, halved while the block's table and slots
    would not fit its shared memory."""
    threads = THREADS
    while (table_rows + slots * threads) * 32 > SMEM_BYTES:
        if threads == 32:
            raise ValueError(f"term program: {slots} slots do not fit a block")
        threads //= 2
    return threads


def quotient_terms(code, slots: int, table, static, dyn, omega, row0: int, out):
    """Rows [row0, row0 + len(out)) of the term program ``code`` ((N, 4)
    int32, ``slots`` value slots) over a sub-coset's stacks ``static``
    and ``dyn`` (whole polys of n = len(omega) rows each) into ``out``.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise)."""
    rows = out.shape[0]
    if out.device.type == "cpu":
        out.copy_(quotient_terms_plain(code, table, static, dyn, omega, row0, rows))
        return out
    n = omega.shape[0]
    tensors = (out, code, table, static, dyn, omega)
    if any(t.device != out.device for t in tensors):
        raise ValueError("quotient_terms: operands on more than one device")
    if any(t.dtype != torch.int32 or not t.is_contiguous() for t in tensors):
        raise TypeError("quotient_terms: operands must be contiguous int32")
    if (code.dim() != 2 or code.shape[1] != 4 or code.shape[0] == 0
            or n & (n - 1) or static.shape[0] % n or dyn.shape[0] % n
            or not 0 <= row0 <= row0 + rows <= n):
        raise ValueError("quotient_terms: bad shapes")
    if rows == 0:
        return out
    threads = threads_for(table.shape[0], slots)
    words, n0 = _build.modulus_args(FR.modulus)
    global LAUNCHES
    LAUNCHES += 1
    code_ = _build.library().quotient_terms_launch(
        out.data_ptr(), static.data_ptr(), dyn.data_ptr(), omega.data_ptr(),
        code.data_ptr(), code.shape[0], table.data_ptr(), table.shape[0],
        static.shape[0] // n, n, row0, rows, slots, threads,
        ctypes.addressof(words), n0, _build.stream_of(out))
    _build.check(code_, "quotient_terms")
    return out
