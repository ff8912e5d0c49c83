"""Montgomery products against a FIXED operand, and whole small DFTs, as
int8 matrix products on the tensor cores: the port of ``ops/mxu_field.py``.

The reference's construction, kept exactly:

  * an Fr element is 64 nibbles (4-bit limbs), so every partial product
    a_i * b_j <= 225 is exact in an int8 x int8 -> int32 product;
  * multiplying a batch ``a`` by a fixed ``b`` is the nibble convolution
    ``a_nib @ banded(b)``, one [rows, 64] @ [64, 127] product;
  * an N-point DFT is one [rows, 64N] @ [64N, 127N] product against the
    block-banded twiddle matrix, with one reduction per OUTPUT;
  * the reduction is full-word Montgomery with R' = 2^272: m = (t mod R')
    * (-p^-1 mod R') mod R' and u = (t + m*p) / R' are two more products
    against fixed banded matrices.  Any t < p * R' reduces to < 2p.

Every int8 product goes through K5's normalize entry
(``cuda_nibble.nibble_normalize``): on a CUDA tensor the hand-written
tensor-core kernel, which makes the nibbles in registers, folds the
nibble columns into 16-bit limbs and carries each column block (plus an
addend row) into canonical limbs in its epilogue, so no carry pass runs
in PyTorch; on a CPU tensor its plain version.  No float route: the
reference's bf16 product is exact only below 2^24, and a bf16 matmul on
the card may reduce in lower precision.  The conditional subtraction and
the reshapes are plain PyTorch.  ``carry_norm_ks`` stays as the
reference's carry pass, the function the epilogue computes.

Tensors keep the port's layout: ``(..., 16)`` canonical 16-bit limbs as
``torch.int32``.  The matrices are built on the host (numpy int8, cached
per field and operand) and moved to a device once per device, where a
CUDA device also gets K5's packed form of each (``cuda_nibble.pack``).

Overflow audit: a product column receives at most 64 nibble products per
operand pair, each <= 225, times N pairs, so <= 225 * 64 * N; the fold
multiplies by at most 4369.  At N = 32 a limb reaches ~2.01e9 < 2^31
(K5 states the same bound), so ``DFT_MAX_N = 32``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from halo2_aes_tpu_torch.ops import cuda_nibble
from halo2_aes_tpu_torch.ops import field as F

NIB_BITS = 4
NIB_MASK = 0xF
NIBS = F.LIMBS * (F.LIMB_BITS // NIB_BITS)  # 64 nibbles per 256-bit element

# Widened full-word Montgomery radix R' = 2^272 (17 limbs, 68 nibbles):
# u = (t + m*p)/R' < t/R' + p, so t < p*R' gives u < 2p.
RP_LIMBS = 17
RP_NIBS = RP_LIMBS * 4  # 68
RP_BITS = RP_LIMBS * F.LIMB_BITS  # 272

# Max N for the DFT block product before a folded limb can reach 2^31.
DFT_MAX_N = 32

_COLS = 2 * NIBS - 1          # 127 product columns of one element pair


# --------------------------------------------------------------------------
# host-side matrices (numpy, cached per (field, operand))
# --------------------------------------------------------------------------

def _int_to_nibbles(x: int, n: int) -> np.ndarray:
    return np.array([(x >> (NIB_BITS * i)) & NIB_MASK for i in range(n)],
                    dtype=np.int8)


def banded(value: int, in_nibs: int, out_nibs: int) -> np.ndarray:
    """int8[in_nibs, out_nibs] with B[i, k] = nibble_{k-i}(value).

    ``a_nib @ B`` is then the nibble convolution of a (in_nibs wide) with
    ``value``: the un-carried product in nibble weights."""
    nib = _int_to_nibbles(value, out_nibs)  # zero beyond value's nibbles
    B = np.zeros((in_nibs, out_nibs), dtype=np.int8)
    for i in range(in_nibs):
        B[i, i:] = nib[:out_nibs - i]
    return B


@functools.lru_cache(maxsize=8)
def _reducer_mats(modulus: int):
    """Fixed matrices for the R' = 2^272 full-word Montgomery reduction."""
    rp = 1 << RP_BITS
    np_inv = (-pow(modulus, -1, rp)) % rp  # N' = -p^-1 mod R'
    # m = (t mod R') * N' mod R': columns >= 68 only touch bits >= 272
    NP = banded(np_inv, RP_NIBS, RP_NIBS)
    # m * p: 68 by 64 nibbles -> 131 product columns
    P = banded(modulus, RP_NIBS, RP_NIBS + NIBS - 1)
    return NP, P


def _dft_blocks(spec: F.FieldSpec, ws) -> np.ndarray:
    """int8 (G, 64n, 127n): block (k, j) of group g is
    ``banded(ws[g][j][k] * 2^272 mod p, 64, 127)``, so the R' division
    cancels and Montgomery inputs give Montgomery outputs."""
    g, n = len(ws), len(ws[0])
    vals = [(int(ws[gi][j][k]) << RP_BITS) % spec.modulus
            for gi in range(g) for j in range(n) for k in range(n)]
    raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals),
                        dtype=np.uint8).reshape(g, n, n, 32)
    nib = np.stack([raw & NIB_MASK, raw >> NIB_BITS], -1).reshape(g, n, n, NIBS)
    d = np.arange(_COLS)[None, :] - np.arange(NIBS)[:, None]   # (64, 127)
    band = np.where((d >= 0) & (d < NIBS), nib[..., np.clip(d, 0, NIBS - 1)], 0)
    # band[g, j, k, i, c] -> big[g, k*64 + i, j*127 + c]
    return np.ascontiguousarray(band.astype(np.int8).transpose(0, 2, 3, 1, 4)
                                .reshape(g, n * NIBS, n * _COLS))


def _operand(host: np.ndarray, device, block: int | None = None):
    """(``host`` as an int8 tensor on ``device``, its K5 packed form on a
    CUDA device, else None)."""
    B = torch.from_numpy(host).to(device)
    return B, (cuda_nibble.pack(B, block) if B.device.type == "cuda" else None)


def _on(cache: dict, host: np.ndarray, device, block: int | None = None):
    """``_operand`` of ``host``, made once per device (a cache serves one
    matrix, always packed with the same ``block``)."""
    key = str(device)
    if key not in cache:
        cache[key] = _operand(host, device, block)
    return cache[key]


@functools.lru_cache(maxsize=None)
def _reducer_dev(modulus: int, device: str):
    return tuple(_operand(m[None], device) for m in _reducer_mats(modulus))


# --------------------------------------------------------------------------
# device-side primitives
# --------------------------------------------------------------------------

def nibbles_from_limbs(a) -> torch.Tensor:
    """int32 (..., L) 16-bit limbs -> int8 (..., 4L) nibbles (0..15)."""
    return cuda_nibble.nibbles(a, torch.int8)


def _normalize(x, op, width: int, block: int | None = None,
               addend=None) -> torch.Tensor:
    """(..., L) limbs times one (1, 4L, M) operand (``_on``) through K5's
    normalize entry -> int32 (..., (M / block) * width): each column
    block's limbs, plus ``addend`` (..., A), carried into ``width``
    canonical limbs, the top carry dropped."""
    B, packed = op

    def rows(t):
        return t.reshape(1, -1, t.shape[-1]).contiguous()

    out = cuda_nibble.nibble_normalize(
        rows(x), B, block, width, None if addend is None else rows(addend),
        packed)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def carry_norm_ks(acc, out_limbs: int) -> torch.Tensor:
    """Carry normalization of redundant 16-bit limbs.

    ``acc``: (..., m) non-negative limbs, each < 2^31.  Two split-add
    passes leave every limb <= 0x10000 (residue + at most one carry
    bit); the remaining ripple is a generate/propagate prefix (g = limb >
    0xFFFF, p = limb == 0xFFFF), resolved at once by one integer addition
    over the two m-bit masks (``field._resolve``), as the reference's
    Kogge-Stone scan resolves it in log m steps.  The carry out of the
    top limb is dropped; returns int32 (..., out_limbs)."""
    v = acc.to(torch.int64)
    m = v.shape[-1]
    for _ in range(2):
        c = v >> F.LIMB_BITS
        v = (v & F.LIMB_MASK) + torch.nn.functional.pad(c[..., :-1], (1, 0))
    cin = F._resolve(v > F.LIMB_MASK, v == F.LIMB_MASK)[..., :m]
    return ((v + cin) & F.LIMB_MASK)[..., :out_limbs].to(torch.int32)


def reduce_wide(spec: F.FieldSpec, t_norm) -> torch.Tensor:
    """Full-word Montgomery reduction by R' = 2^272 via two K5 products,
    each carried in K5's epilogue.

    ``t_norm``: int32 (..., T) canonical 16-bit limbs, value < p * 2^272.
    Returns int32 (..., 16) canonical limbs of t * 2^-272 mod p."""
    NP, P = _reducer_dev(spec.modulus, str(t_norm.device))
    # m = (t mod R') * N' mod R'
    m = _normalize(t_norm[..., :RP_LIMBS], NP, RP_LIMBS)
    # u = (t + m*p) / R': m*p's 33 limbs plus t, carried into width limbs
    width = max(t_norm.shape[-1], RP_LIMBS + F.LIMBS) + 1
    u = _normalize(m, P, width, addend=t_norm)
    r = u[..., RP_LIMBS:RP_LIMBS + F.LIMBS]                # exact /R'
    return F._cond_sub_p(spec, r.to(torch.int64)).to(torch.int32)


_DFT_WIDTH = 2 * F.LIMBS + 1   # limbs of one carried DFT output


def _reduce_outputs(spec: F.FieldSpec, t, n: int) -> torch.Tensor:
    """(..., n * 33) carried limbs of n DFT outputs -> (..., n, 16).

    t = sum_k x_k * w'_jk < N * p^2 can exceed 2^512 for N > 16, so K5
    carries each output into 33 limbs."""
    return reduce_wide(spec, t.reshape(*t.shape[:-1], n, _DFT_WIDTH))


# --------------------------------------------------------------------------
# public ops
# --------------------------------------------------------------------------

class FixedMul:
    """Montgomery multiply of a batch by ONE fixed operand, through K5.

    ``FixedMul(spec, b_limb_value)(a) == mont_mul(spec, a, b)`` for the
    same 16-limb value of b (a*b*2^-256: the banded matrix bakes in the
    2^16 bridge between R = 2^256 and R' = 2^272)."""

    def __init__(self, spec: F.FieldSpec, b_value: int):
        self.spec = spec
        b_scaled = (b_value << (RP_BITS - F.NBITS)) % spec.modulus
        self._B = banded(b_scaled, NIBS, _COLS)[None]
        self._dev = {}

    def __call__(self, a) -> torch.Tensor:
        t = _normalize(a, _on(self._dev, self._B, a.device), 2 * F.LIMBS)
        return reduce_wide(self.spec, t)


class DftMatmul:
    """N-point DFT over Fr as ONE K5 product + one reduction per output.

    ``w`` is the N x N plain-int matrix (w[j][k] multiplies input k into
    output j).  Inputs and outputs are int32 (..., N, 16) limbs in one
    consistent form (Montgomery in -> Montgomery out)."""

    def __init__(self, spec: F.FieldSpec, w: "list[list[int]]"):
        n = len(w)
        assert n <= DFT_MAX_N, f"int32 accumulator bound: N <= {DFT_MAX_N}"
        self.spec = spec
        self.n = n
        self._W = _dft_blocks(spec, [w])
        self._dev = {}

    def __call__(self, x) -> torch.Tensor:
        n = self.n
        assert x.shape[-2] == n
        flat = x.reshape(*x.shape[:-2], n * F.LIMBS)
        t = _normalize(flat, _on(self._dev, self._W, x.device, _COLS),
                       _DFT_WIDTH, _COLS)
        return _reduce_outputs(self.spec, t, n)


class BatchedDftMatmul:
    """G independent N-point linear maps, one batched K5 product.

    ``ws[g][j][k]`` multiplies input k into output j within group g.
    Input and output shape (..., G, N, 16).  This is the second four-step
    stage with its inter-stage twiddles folded into the per-group
    matrices (``ntt256``)."""

    def __init__(self, spec: F.FieldSpec, ws):
        g, n = len(ws), len(ws[0])
        assert n <= DFT_MAX_N, f"int32 accumulator bound: N <= {DFT_MAX_N}"
        self.spec, self.g, self.n = spec, g, n
        self._W = _dft_blocks(spec, ws)
        self._dev = {}

    def __call__(self, x) -> torch.Tensor:
        g, n = self.g, self.n
        assert x.shape[-3] == g and x.shape[-2] == n
        lead = x.shape[:-3]
        # group-major rows for K5: (G, batch, N*16)
        xg = x.reshape(-1, g, n * F.LIMBS).transpose(0, 1).contiguous()
        W, packed = _on(self._dev, self._W, x.device, _COLS)
        t = cuda_nibble.nibble_normalize(xg, W, _COLS, _DFT_WIDTH, packed=packed)
        out = _reduce_outputs(self.spec, t, n)              # (G, batch, N, 16)
        return out.transpose(0, 1).reshape(*lead, g, n, F.LIMBS)


@functools.lru_cache(maxsize=4)
def _ntt256_stages(spec: F.FieldSpec):
    p = spec.modulus
    omega = pow(spec.generator, (p - 1) // 256, p)  # 256th root
    w16 = pow(omega, 16, p)
    stage1 = [[pow(w16, j * k, p) for k in range(16)] for j in range(16)]
    # group = k1 (first-stage output index); out[k2] = sum_{n2}
    # omega^{n2*k1} * w16^{n2*k2} * in[n2]
    stage2 = [[[(pow(omega, n2 * k1, p) * pow(w16, n2 * k2, p)) % p
                for n2 in range(16)] for k2 in range(16)]
              for k1 in range(16)]
    return DftMatmul(spec, stage1), BatchedDftMatmul(spec, stage2)


def ntt256(spec: F.FieldSpec, x) -> torch.Tensor:
    """256-point NTT, natural order: two K5 products, no butterflies.

    ``x``: int32 (..., 256, 16) (Montgomery form).  Four-step with n =
    16*n1 + n2, k = k1 + 16*k2; the inter-stage twiddle omega^(n2*k1) is
    folded into the 16 second-stage matrices, so the transform is two
    products and two Montgomery reductions."""
    d1, d2 = _ntt256_stages(spec)
    lead = x.shape[:-2]
    v = x.reshape(*lead, 16, 16, F.LIMBS)        # (n1, n2)
    a = d1(v.transpose(-3, -2))                  # (n2, k1): DFT over n1
    b = d2(a.transpose(-3, -2))                  # (k1, k2): twiddled DFT
    return b.transpose(-3, -2).reshape(*lead, 256, F.LIMBS)
