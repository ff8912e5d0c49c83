"""K2: one pass of the four-step NTT, CUDA kernel + plain PyTorch version.

Replaces the Pallas kernel of ``halo2_aes_tpu/ops/pallas_ntt.py``
(``_pass_fn`` :273, body ``_make_kernel`` :253 -> ``_stages`` :232): on a
batch of rows of length T = 2^lt <= 2048, all lt radix-2 DIF stages,
output bit-reversed along the row.  The code around it (the mid
twiddle, the transposes, the final reorder) is ``ops/ntt.py``.

Kernel (``csrc/ntt.cu``): one block per row, the row resident in shared
memory as 8 x 32-bit words per element (64 KB at T = 2048, above the
48 KB default, so the launch raises the dynamic shared-memory limit).
Twiddles come from the reference's own host-built stage tables.

What bounds it on an H100: the row is read and written once (128 B per
element in the int32 limb layout) while each stage costs one add, one
sub and one CIOS multiply per butterfly pair in shared memory; at
T = 512 (k = 17's first pass) the lt = 9 stages make it compute-bound
on the multiplies.  A block per row keeps every stage on chip; fusing
the mid-twiddle multiply and the reorder into the pass is later work.
"""

from __future__ import annotations

import ctypes

import torch

from halo2_aes_tpu_torch.ops import _build
from halo2_aes_tpu_torch.ops import cuda_field as CF
from halo2_aes_tpu_torch.ops import field as F

LAUNCHES = 0
SOURCE = "halo2_aes_tpu_torch/csrc/ntt.cu"
REPLACES = "halo2_aes_tpu/ops/pallas_ntt.py:273"
MAX_LT = 11


def ntt_pass_plain(spec: F.FieldSpec, x, tw):
    """Plain PyTorch DIF pass: x (rows, T, 16), tw (lt*16, T) int32."""
    rows, T, _ = x.shape
    lt = T.bit_length() - 1
    for s in range(lt):
        h = T >> (s + 1)
        xv = x.reshape(rows, T // (2 * h), 2, h, F.LIMBS)
        u, v = xv[:, :, 0], xv[:, :, 1]
        tw_hi = tw[s * F.LIMBS:(s + 1) * F.LIMBS].T.reshape(
            T // (2 * h), 2, h, F.LIMBS)[:, 1]
        a = F.add(spec, u, v)
        r = CF.mont_mul_plain(spec, F.sub(spec, u, v), tw_hi)
        x = torch.stack([a, r], dim=2).reshape(rows, T, F.LIMBS)
    return x


def ntt_pass(spec: F.FieldSpec, x, tw):
    """All DIF stages along each row of x (rows, T, 16); tw is the
    (lt*16, T) stage table on x's device.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu" and tw.device.type == "cpu":
        return ntt_pass_plain(spec, x, tw)
    if x.device.type != "cuda" or tw.device != x.device:
        raise ValueError(f"ntt_pass: tensors on {x.device} and {tw.device}")
    if x.dtype != torch.int32 or tw.dtype != torch.int32:
        raise TypeError("ntt_pass: limb tensors must be int32")
    if x.dim() != 3 or x.shape[2] != F.LIMBS:
        raise ValueError(f"ntt_pass: x must be (rows, T, 16), got {x.shape}")
    rows, T, _ = x.shape
    lt = T.bit_length() - 1
    if T != 1 << lt or not 1 <= lt <= MAX_LT:
        raise ValueError(f"ntt_pass: row length {T} not a power of two <= 2048")
    if tw.shape != (lt * F.LIMBS, T) or not tw.is_contiguous():
        raise ValueError(f"ntt_pass: stage table {tw.shape} for T={T}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if rows == 0:
        return out
    words, n0 = _build.modulus_args(spec.modulus)
    global LAUNCHES
    LAUNCHES += 1
    code = _build.library().ntt_pass_launch(
        out.data_ptr(), x.data_ptr(), tw.data_ptr(), rows, lt,
        ctypes.addressof(words), n0, _build.stream_of(out))
    _build.check(code, "ntt_pass")
    return out
