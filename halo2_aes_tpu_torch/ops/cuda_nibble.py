"""K5: nibble products on the int8 tensor cores, CUDA kernel + plain
PyTorch version.

Replaces the int8 products of ``halo2_aes_tpu/ops/mxu_field.py``:
``_dot_i8`` (:174, a bf16 ``dot_general`` with f32 sums) and the raw int8
``dot_general`` of ``BatchedDftMatmul`` (:311).  Those are XLA products on
the TPU's matrix unit, not Pallas kernels; every int8 product of the
port's ``ops/mxu_field.py`` goes through ``nibble_product`` here.

    out[g, r, b*olb + j] = sum_{s<4} conv[g, r, b*blk + 4j + s] << 4s
    conv[g, r, :]        = nibbles(x[g, r, :L]) @ B[g]

``x`` is int32 (G, rows, L) 16-bit limbs, ``B`` int8 (G, 4L, M) with
entries 0..15, ``block`` (blk) divides M, and ``out`` is int32 (G, rows,
(M / blk) * ceil(blk / 4)): each block of blk product columns folds into
its own redundant 16-bit limbs (a DFT's n outputs of 127 columns each).
Every limb is below 225 * 4L * 4369, which is below 2^31 for
4L <= ``MAX_NIBBLES``.

Kernel (``csrc/nibble_mma.cu``): ``mma.sync`` m16n8k32 s8 x s8 -> s32,
the nibbles made in registers as the limbs are loaded (no int8 copy of x
in device memory), B staged through shared memory, K and M padded to the
tile inside the kernel, the fold in the epilogue.  What bounds it on an
H100: the bytes of x, B and out over 3.35 TB/s, or the band's non-zero
multiply-adds over the int8 tensor cores' dense 989.5e12/s; the first
kernel also multiplies the band's zeros.

CPU tensors take ``nibble_product_plain``; CUDA tensors launch K5 or
raise.  The plain version multiplies in float64, which is exact here:
every partial sum is an integer below 2^53.
"""

from __future__ import annotations

import torch

from halo2_aes_tpu_torch.ops import _build

LAUNCHES = 0      # kernel launches since the last reset (chip_smoke reads it)
SOURCE = "halo2_aes_tpu_torch/csrc/nibble_mma.cu"
REPLACES = "halo2_aes_tpu/ops/mxu_field.py:174,311"

FOLD = (1, 16, 256, 4096)
# the most nibble rows for which every folded limb stays below 2^31
MAX_NIBBLES = ((1 << 31) - 1) // (225 * sum(FOLD))


def nibbles(x, dtype=torch.int8):
    """(..., L) 16-bit limbs -> (..., 4L) nibbles (0..15), lowest first."""
    shifts = torch.tensor([0, 4, 8, 12], dtype=torch.int32, device=x.device)
    nib = (x.to(torch.int32)[..., None] >> shifts) & 0xF
    return nib.reshape(*x.shape[:-1], x.shape[-1] * 4).to(dtype)


def fold(conv, block: int):
    """int64 (G, rows, M) product columns -> int32 (G, rows, (M / block) *
    ceil(block / 4)) limbs, each column block folded on its own."""
    g, rows, m = conv.shape
    olb = -(-block // 4)
    c = conv.reshape(g, rows, m // block, block)
    c = torch.nn.functional.pad(c, (0, 4 * olb - block))
    w = torch.tensor(FOLD, dtype=torch.int64, device=conv.device)
    limbs = (c.reshape(g, rows, m // block, olb, 4) * w).sum(-1)
    return limbs.reshape(g, rows, -1).to(torch.int32)


def out_limbs(m: int, block: int) -> int:
    return (m // block) * -(-block // 4)


def nibble_product_plain(x, B, block: int | None = None):
    """The same function in plain PyTorch on any device: float64 product
    (exact, see the module note), int64 fold."""
    m = B.shape[-1]
    conv = torch.bmm(nibbles(x, torch.float64), B.to(torch.float64))
    return fold(conv.to(torch.int64), block or m)


def _check(x, B, block):
    if x.dtype != torch.int32:
        raise TypeError(f"nibble_product: x must be int32 limbs, not {x.dtype}")
    if B.dtype != torch.int8:
        raise TypeError(f"nibble_product: B must be int8, not {B.dtype}")
    if x.dim() != 3 or B.dim() != 3:
        raise ValueError(f"nibble_product: want x (G, rows, L), B (G, 4L, M); "
                         f"got {tuple(x.shape)} {tuple(B.shape)}")
    g, rows, limbs = x.shape
    m = B.shape[2]
    block = block or m
    if B.shape[0] != g or B.shape[1] != 4 * limbs or m == 0 or m % block:
        raise ValueError(f"nibble_product: x {tuple(x.shape)}, B {tuple(B.shape)} "
                         f"and block {block} do not fit")
    if 4 * limbs > MAX_NIBBLES:
        raise ValueError(f"nibble_product: {4 * limbs} nibble rows exceed "
                         f"{MAX_NIBBLES}, the int32 bound of a folded limb")
    if x.device != B.device:
        raise ValueError(f"nibble_product: x on {x.device}, B on {B.device}")
    if not (x.is_contiguous() and B.is_contiguous()):
        raise ValueError("nibble_product: x and B must be contiguous")
    return g, rows, limbs, m, block


def nibble_product(x, B, block: int | None = None):
    """Nibble product plus fold (module note).  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    g, rows, limbs, m, block = _check(x, B, block)
    if x.device.type == "cpu":
        return nibble_product_plain(x, B, block)
    if x.device.type != "cuda":
        raise ValueError(f"nibble_product: no kernel for {x.device}")
    out = torch.empty((g, rows, out_limbs(m, block)), dtype=torch.int32,
                      device=x.device)
    if out.numel() == 0:
        return out
    global LAUNCHES
    LAUNCHES += 1
    code = _build.library().nibble_mma_launch(
        out.data_ptr(), x.data_ptr(), B.data_ptr(), g, rows, limbs, m, block,
        _build.stream_of(out))
    _build.check(code, "nibble_product")
    return out
