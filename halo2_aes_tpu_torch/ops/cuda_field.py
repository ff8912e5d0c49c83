"""K1: Montgomery multiplication, CUDA kernel + plain PyTorch version.

Replaces the Pallas kernel of ``halo2_aes_tpu/ops/pallas_field.py``
(``_fn`` :158, body ``_make_kernel`` :144 -> ``mont_mul_rows`` :102),
which the reference enters through ``field.mont_mul_fast``.  Here every
``field.mont_mul`` on a CUDA tensor launches it.

Kernel (``csrc/mont_mul.cu``): one thread per element, the operands as
8 x 32-bit words in registers (two 16-bit limbs per word on load and
store), CIOS with 64-bit partial products, one conditional subtraction.
p and -p^-1 mod 2^32 are kernel arguments, so one kernel serves Fr and
Fq.  Broadcasting is by row index modulo each operand's row count: a
scalar (1 row) or a tiled table (n rows against count*n) is read in
place, never materialised.

What bounds it on an H100: 64 bytes of int32 limbs per operand and per
result (the reference layout) against ~150 integer multiply-adds, so a
large batch is bound by memory traffic (~192 B per product), not by
the multiplier.  The design keeps the public layout and reads it with
16-byte vector loads; a packed 32-byte layout is later work.

The reference's 13-bit repacking and its R' = 2^260 shift exist only for
the TPU's 32-bit multiplier and have no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from halo2_aes_tpu_torch.ops import _build
from halo2_aes_tpu_torch.ops import field as F

LAUNCHES = 0      # kernel launches since the last reset (chip_smoke reads it)
SOURCE = "halo2_aes_tpu_torch/csrc/mont_mul.cu"
REPLACES = "halo2_aes_tpu/ops/pallas_field.py:158"


def mont_mul_plain(spec: F.FieldSpec, a, b):
    """Plain PyTorch CIOS in int64 on 16-bit limbs, any device.

    Schoolbook product into 33 redundant columns (each < 2^37), then 16
    reduction steps m = acc[i] * n0 mod 2^16, acc += m * p << 16i,
    carry acc[i] up; the top 17 columns normalise to a value < 2p."""
    a64 = a.to(torch.int64)
    b64 = b.to(torch.int64)
    shape = torch.broadcast_shapes(a64.shape[:-1], b64.shape[:-1])
    a64 = a64.expand(*shape, F.LIMBS)
    b64 = b64.expand(*shape, F.LIMBS)
    acc = torch.zeros((*shape, 2 * F.LIMBS + 1), dtype=torch.int64,
                      device=a.device)
    for i in range(F.LIMBS):
        acc[..., i:i + F.LIMBS] += a64[..., i:i + 1] * b64
    p = F.const(spec, "p", a.device).to(torch.int64)
    for i in range(F.LIMBS):
        m = (acc[..., i] * spec.n0inv) & F.LIMB_MASK
        acc[..., i:i + F.LIMBS] += m[..., None] * p
        acc[..., i + 1] += acc[..., i] >> F.LIMB_BITS
    r = F.normalize(acc[..., F.LIMBS:], F.LIMBS)
    return F._cond_sub_p(spec, r).to(torch.int32)


def edge_operands(spec: F.FieldSpec) -> list:
    """The product's edge operands, as ints: 0, 1, p-1, p-2, R mod p,
    R^2 mod p, and values with the largest top word below p (p's top word
    over zero words, over half of p's lower words, and one less over
    all-ones words).  The card's smoke holds K1 to its plain version on
    every ordered pair of them; the CPU tests replay the kernel's carry
    schedule on them."""
    p = spec.modulus
    top, low = p >> 224, p & ((1 << 224) - 1)
    return [0, 1, p - 1, p - 2, spec.r_mod_p, spec.r2_mod_p, top << 224,
            (top << 224) | (low >> 1), ((top - 1) << 224) | ((1 << 224) - 1)]


def _rows_mod(x, out_shape) -> tuple:
    """(contiguous operand, its row count) for a kernel that reads row
    i of the output's operand at x[i % rows]; materialises any other
    broadcast."""
    batch = out_shape[:-1]
    xb = x.shape[:-1]
    while len(xb) and xb[0] == 1:
        xb = xb[1:]
    if tuple(xb) == tuple(batch[len(batch) - len(xb):]):
        rows = 1
        for d in xb:
            rows *= d
        return x.reshape(rows, F.LIMBS).contiguous(), rows
    full = x.expand(out_shape).contiguous()
    return full.reshape(-1, F.LIMBS), full.numel() // F.LIMBS


def mont_mul(spec: F.FieldSpec, a, b):
    """a * b * 2^-256 mod p, broadcast over leading axes.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"mont_mul: operands on {a.device} and {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul: limb tensors must be int32")
    if a.shape[-1] != F.LIMBS or b.shape[-1] != F.LIMBS:
        raise ValueError(f"mont_mul: bad limb shapes {a.shape} {b.shape}")
    out_shape = torch.broadcast_shapes(a.shape, b.shape)
    out = torch.empty(out_shape, dtype=torch.int32, device=a.device)
    n = out.numel() // F.LIMBS
    if n == 0:
        return out
    a2, a_rows = _rows_mod(a, out_shape)
    b2, b_rows = _rows_mod(b, out_shape)
    words, n0 = _build.modulus_args(spec.modulus)
    global LAUNCHES
    LAUNCHES += 1
    code = _build.library().mont_mul_launch(
        out.data_ptr(), a2.data_ptr(), b2.data_ptr(), n, a_rows, b_rows,
        ctypes.addressof(words), n0, _build.stream_of(out))
    _build.check(code, "mont_mul")
    return out
