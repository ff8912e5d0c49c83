"""K3: complete G1 point addition, CUDA kernel + plain PyTorch version.

Replaces the Pallas kernel of ``halo2_aes_tpu/ops/pallas_curve.py``
(``_fn`` :146, body ``_make_kernel`` :99), which the reference enters
through ``curve.add`` from the MSM reduction trees and SRS generation.
Here every ``curve.add`` on CUDA tensors launches it.

The addition is Renes-Costello-Batina 2015/1060 algorithm 7 for a = 0
(b3 = 9) in homogeneous projective coordinates over Fq: 12 Montgomery
multiplies plus add/sub chains, with no branch on identity, doubling or
negation.

Kernel (``csrc/curve_add.cu``): one thread per point pair; the six Fq
input coordinates in registers as 8 x 32-bit words, the multiplies
inlined from the shared ``field.cuh`` CIOS.  What bounds it on an H100:
~12 x 150 integer multiply-adds per pair against 576 bytes of int32-limb
traffic, so it is compute-bound on the integer pipes; keeping the whole
formula in registers means nothing between the multiplies touches
device memory.
"""

from __future__ import annotations

import ctypes

import torch

from halo2_aes_tpu_torch.ops import _build
from halo2_aes_tpu_torch.ops import cuda_field as CF
from halo2_aes_tpu_torch.ops import field as F

LAUNCHES = 0
SOURCE = "halo2_aes_tpu_torch/csrc/curve_add.cu"
REPLACES = "halo2_aes_tpu/ops/pallas_curve.py:146"
FQ = F.FQ


def _bmul_plain(pairs):
    a = torch.stack([x for x, _ in pairs])
    b = torch.stack([y for _, y in pairs])
    out = CF.mont_mul_plain(FQ, a, b)
    return [out[i] for i in range(len(pairs))]


def _mul_b3(a):
    a2 = F.add(FQ, a, a)
    a4 = F.add(FQ, a2, a2)
    a8 = F.add(FQ, a4, a4)
    return F.add(FQ, a8, a)


def add_plain(p, q):
    """Plain PyTorch RCB complete addition of equal-shape coordinate
    triples (the reference's ``curve.add`` XLA path), any device."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q

    def fadd(a, b):
        return F.add(FQ, a, b)

    def fsub(a, b):
        return F.sub(FQ, a, b)

    t0, t1, t2, A, B, C = _bmul_plain([
        (X1, X2), (Y1, Y2), (Z1, Z2),
        (fadd(X1, Y1), fadd(X2, Y2)),
        (fadd(Y1, Z1), fadd(Y2, Z2)),
        (fadd(X1, Z1), fadd(X2, Z2)),
    ])
    t3 = fsub(fsub(A, t0), t1)
    t4 = fsub(fsub(B, t1), t2)
    xz = fsub(fsub(C, t0), t2)
    t0_3 = fadd(fadd(t0, t0), t0)
    t2_b = _mul_b3(t2)
    z3t = fadd(t1, t2_b)
    t1m = fsub(t1, t2_b)
    y3b = _mul_b3(xz)
    X3a, X3b, Y3a, Y3b, Z3a, Z3b = _bmul_plain([
        (t4, y3b), (t3, t1m), (y3b, t0_3), (t1m, z3t), (z3t, t4), (t0_3, t3),
    ])
    return (fsub(X3b, X3a), fadd(Y3b, Y3a), fadd(Z3a, Z3b))


def add(p, q):
    """Complete addition of coordinate triples (each (..., 16) Fq
    Montgomery limbs; p and q broadcast against each other).  CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    coords = (*p, *q)
    shape = torch.broadcast_shapes(*(c.shape for c in coords))
    coords = [c.expand(shape) for c in coords]
    if all(c.device.type == "cpu" for c in coords):
        return add_plain(coords[:3], coords[3:])
    dev = coords[0].device
    if dev.type != "cuda" or any(c.device != dev for c in coords):
        raise ValueError("curve add: coordinates on mixed or non-CUDA devices")
    if any(c.dtype != torch.int32 for c in coords):
        raise TypeError("curve add: limb tensors must be int32")
    if shape[-1] != F.LIMBS:
        raise ValueError(f"curve add: bad limb shape {shape}")
    ins = [c.contiguous() for c in coords]
    outs = [torch.empty(shape, dtype=torch.int32, device=dev) for _ in range(3)]
    n = outs[0].numel() // F.LIMBS
    if n == 0:
        return tuple(outs)
    words, n0 = _build.modulus_args(FQ.modulus)
    global LAUNCHES
    LAUNCHES += 1
    code = _build.library().curve_add_launch(
        *(t.data_ptr() for t in outs), *(t.data_ptr() for t in ins), n,
        ctypes.addressof(words), n0, _build.stream_of(outs[0]))
    _build.check(code, "curve_add")
    return tuple(outs)
