"""K2: one fused pass of the four-step NTT, CUDA kernel + plain versions.

Replaces the Pallas kernel of ``halo2_aes_tpu/ops/pallas_ntt.py``
(``_pass_fn`` :273, body ``_make_kernel`` :253 -> ``_stages`` :232): all lt
radix-2 DIF stages over rows of length T = 2^lt <= 4096.  A transform of
n = 2^k points is n / T interleaved rows per poly (row ``col`` holds the
elements ``i * ncols + col``), and ``ntt_fused`` is the whole step around
them: strided read from the flat stack, an optional multiply on load
(the coset shift), the stages, an optional multiply in the epilogue (the
mid twiddle, or the scalar n^-1), and a store at an output stride that
undoes the stages' bit reversal into the layout the next pass reads.
``ops/ntt.py`` composes ceil(k / ROW_CAP) such launches into a transform
of any length the field allows.

Kernel (``csrc/ntt.cu``).  What bounds a pass on an H100: 128 B per
element of int32-limb traffic against lt/2 butterflies of an add, a sub
and a CIOS product; at lt = 10 the multiplier and the memory system are
within 2x of each other, so any further walk over the stack (a
transpose copy, a separate twiddle multiply, a gather) costs as much as
the pass.  The kernel therefore does all of them itself: four walks per
two-pass transform instead of fourteen.  Twiddles are one (T/2, 16)
powers table kept in shared memory as 8 words an entry; a thread holds 8
elements and runs three stages in registers between exchanges through
shared memory; blocks are persistent and take W adjacent columns a tile.

``ntt_fused_plain`` is the plain PyTorch version of the kernel, and with
it the CPU route of ``ops/ntt.ntt_flat``; ``ntt_pass_plain`` (the stages
alone, bit-reversed output, from the reference's stage tables) is the
pass of ``ops/ntt.ntt_flat_plain``, the two-pass composition the tests
hold the composed one against.
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
MAX_LT = 12          # the longest row a pass takes: 2^12 points


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


def _brev_index(lt: int, device) -> torch.Tensor:
    idx = torch.arange(1 << lt, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(lt):
        rev |= ((idx >> b) & 1) << (lt - 1 - b)
    return rev


def _store_index(k: int, lt: int, stride: int, device) -> torch.Tensor:
    """(n,) flat position of (column col, frequency j), in (col, j) order:
    ((col // B) * T + j) * B + col % B for the output stride B."""
    ncols, T = 1 << (k - lt), 1 << lt
    col = torch.arange(ncols, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(T, dtype=torch.int64, device=device)[None, :]
    return (((col // stride) * T + j) * stride + col % stride).reshape(-1)


def ntt_fused_plain(spec: F.FieldSpec, x, count: int, k: int, lt: int, tw,
                    stride: int, mul_in=None, mul_out=None, in_place: bool = False):
    """Plain PyTorch version of ``ntt_fused`` (same arguments; ``in_place``
    is accepted and the result is always a new tensor), any device."""
    n, T = 1 << k, 1 << lt
    ncols = n >> lt

    def times(stack, table):      # 2^20 elements a call: bounded int64 temporaries
        step = max(1, (1 << 20) >> k)
        return torch.cat([CF.mont_mul_plain(spec, stack[i:i + step], table)
                          for i in range(0, count, step)])

    x = x.reshape(count, n, F.LIMBS)
    if mul_in is not None:
        x = times(x, mul_in)
    rows = x.reshape(count, T, ncols, F.LIMBS).transpose(1, 2).reshape(
        count * ncols, T, F.LIMBS)
    for s in range(lt):
        h = T >> (s + 1)
        xv = rows.reshape(-1, T // (2 * h), 2, h, F.LIMBS)
        u, v = xv[:, :, 0], xv[:, :, 1]
        tws = tw[torch.arange(h, device=tw.device) << s]
        a = F.add(spec, u, v)
        r = CF.mont_mul_plain(spec, F.sub(spec, u, v), tws)
        rows = torch.stack([a, r], dim=2).reshape(-1, T, F.LIMBS)
    rows = rows.reshape(count, n, F.LIMBS)          # (pc, col, position p)
    if mul_out is not None:
        table = mul_out.reshape(-1, F.LIMBS)
        if table.shape[0] > 1:                      # row (col // B) * T + p
            table = table.reshape(ncols // stride, 1, T, F.LIMBS).expand(
                -1, stride, -1, -1).reshape(n, F.LIMBS)
        rows = times(rows, table)
    rows = rows.reshape(count, ncols, T, F.LIMBS).index_select(
        2, _brev_index(lt, x.device)).reshape(count, n, F.LIMBS)
    out = torch.empty_like(rows)                    # (pc, col, frequency j)
    out[:, _store_index(k, lt, stride, x.device)] = rows
    return out.reshape(count * n, F.LIMBS)


def ntt_fused(spec: F.FieldSpec, x, count: int, k: int, lt: int, tw,
              stride: int, mul_in=None, mul_out=None, in_place: bool = False):
    """One fused pass over a FLAT (count * 2^k, 16) stack.

    Poly pc's row ``col`` (of ncols = 2^(k - lt)) is the elements
    pc*n + i*ncols + col, i < T = 2^lt.  Each element is multiplied by
    ``mul_in[i*ncols + col]`` (an (n, 16) table) if given; every row runs
    its lt DIF stages with twiddles ``tw`` ((T/2, 16): the powers of the
    primitive T-th root); position p of row col is multiplied by
    ``mul_out[(col // stride) * T + p]`` (an (n / stride, 16) table in
    that order, or one (16,) element for all) if given; and its frequency
    j = brev(p) is stored at pc*n + ((col // stride) * T + j) * stride +
    col % stride.  ``stride`` (a power of two dividing ncols) is 1 for
    the first pass of a composed transform, ncols for the last (natural
    order), and between them for a middle pass.  ``in_place`` (only with
    stride ncols) lets a CUDA launch overwrite ``x`` and return it: a tile
    is stored where it was read.
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    n, T = 1 << k, 1 << lt
    tensors = [t for t in (x, tw, mul_in, mul_out) if t is not None]
    if not 1 <= lt <= MAX_LT or lt > k or count < 1:
        raise ValueError(f"ntt_fused: bad sizes count={count} k={k} lt={lt}")
    ncols = n >> lt
    if stride < 1 or stride & (stride - 1) or ncols % stride:
        raise ValueError(f"ntt_fused: stride {stride} is no power of two "
                         f"dividing {ncols} columns")
    if in_place and stride != ncols:
        raise ValueError("ntt_fused: only a natural-order pass runs in place")
    if x.shape != (count * n, F.LIMBS):
        raise ValueError(f"ntt_fused: x must be ({count * n}, 16), got {tuple(x.shape)}")
    if tw.shape != (T // 2, F.LIMBS):
        raise ValueError(f"ntt_fused: twiddles {tuple(tw.shape)} for T={T}")
    if mul_in is not None and mul_in.shape != (n, F.LIMBS):
        raise ValueError(f"ntt_fused: mul_in {tuple(mul_in.shape)} for n={n}")
    if mul_out is not None and mul_out.shape not in ((n // stride, F.LIMBS),
                                                     (F.LIMBS,)):
        raise ValueError(f"ntt_fused: mul_out {tuple(mul_out.shape)} for "
                         f"n={n}, stride {stride}")
    if all(t.device.type == "cpu" for t in tensors):
        return ntt_fused_plain(spec, x, count, k, lt, tw, stride, mul_in, mul_out)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("ntt_fused: tensors on mixed or non-CUDA devices")
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError("ntt_fused: limb tensors must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ntt_fused: tensors must be contiguous")
    out = x if in_place else torch.empty_like(x)
    words, n0 = _build.modulus_args(spec.modulus)
    global LAUNCHES
    LAUNCHES += 1
    code = _build.library().ntt_fused_launch(
        out.data_ptr(), x.data_ptr(), tw.data_ptr(),
        None if mul_in is None else mul_in.data_ptr(),
        None if mul_out is None else mul_out.data_ptr(),
        0 if mul_out is None else mul_out.numel() // F.LIMBS,
        count, k, lt, stride.bit_length() - 1, ctypes.addressof(words), n0,
        _build.stream_of(out))
    _build.check(code, "ntt_fused")
    return out
