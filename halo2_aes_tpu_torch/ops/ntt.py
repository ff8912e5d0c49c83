"""Number-theoretic transform over BN254 Fr: the port of ``ops/ntt.py``.

Every batched transform runs the four-step decomposition of the
reference's ``pallas_ntt.ntt_flat`` (pallas_ntt.py:350), on every
device and at every k:

  k <= 11: one pass of length n per poly, output un-bit-reversed (and
           times n^-1 for the inverse);
  k  > 11: n = n1 * n2 with k1 = ceil(k/2): pass of length n1 over the
           (i2 row, i1 lane) transpose, the mid twiddle w^(i2*k1)
           (n^-1 folded in for the inverse), pass of length n2 over the
           transpose back, natural order out.

On a CUDA tensor that is K2 (``cuda_ntt.ntt_fused``) and nothing else:
one launch for k <= 11, two above.  A transform is bound by its walks
over device memory (128 B an element and walk), so the coset shift, both
transposes, the mid twiddle, the output reorder and n^-1 all happen
inside the two launches: four walks of the stack, where separate
multiplies, transpose copies and a gather made fourteen.  On a CPU
tensor the same steps are plain PyTorch ops around
``cuda_ntt.ntt_pass_plain``.  The NTT is an exact function of its input,
so the result equals the reference's ``ntt``/``ntt_many`` bit for bit
whichever path computed it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from halo2_aes_tpu_torch.ops import cuda_ntt
from halo2_aes_tpu_torch.ops import field as F

LIMBS = F.LIMBS


def _bitrev(k: int) -> np.ndarray:
    n = 1 << k
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def _root(spec: F.FieldSpec, k: int, inverse: bool) -> int:
    w = pow(spec.root_of_unity(), 1 << (spec.two_adicity - k), spec.modulus)
    return pow(w, -1, spec.modulus) if inverse else w


@functools.lru_cache(maxsize=None)
def _stage_tables(spec: F.FieldSpec, lt: int, inverse: bool) -> np.ndarray:
    """(lt*LIMBS, T) Montgomery twiddles: stage s at rows [s*16,(s+1)*16);
    lane i holds 1 in the lower butterfly half, w^(j*2^s) in the upper
    (pallas_ntt._stage_tables)."""
    T = 1 << lt
    w = _root(spec, lt, inverse)
    p = spec.modulus
    rows = []
    for s in range(lt):
        h = T >> (s + 1)
        step = pow(w, 1 << s, p)
        vals = [1] * T
        acc = 1
        for j in range(h):
            for blk in range(T // (2 * h)):
                vals[blk * 2 * h + h + j] = acc
            acc = (acc * step) % p
        rows.append(spec.encode(vals))
    arr = np.stack(rows)
    return np.ascontiguousarray(arr.transpose(0, 2, 1).reshape(lt * LIMBS, T))


@functools.lru_cache(maxsize=None)
def _mid_table(spec: F.FieldSpec, k: int, k1: int, inverse: bool,
               device) -> torch.Tensor:
    """(n, 16) Montgomery table w^(i2*k1) in pass-1 output order (i2 row,
    bit-reversed k1 lane) on ``device``; the inverse folds in n^-1
    (pallas_ntt._mid_table, limbs last).  Gathered from one powers table
    of w, since w^(i2*j) = w^(i2*j mod n)."""
    n = 1 << k
    idx = (np.arange(n >> k1)[:, None] * _bitrev(k1)[None, :]) % n
    device = torch.device(device)
    out = _powers_table(spec, _root(spec, k, inverse), n, device)[
        torch.from_numpy(idx.reshape(-1)).to(device)]
    if inverse:
        out = F.mont_mul(spec, out, F.encode(spec, pow(n, -1, spec.modulus), device))
    return out


@functools.lru_cache(maxsize=None)
def _out_perm(k: int, k1: int) -> np.ndarray:
    """(n,) natural-order output k2*n1+k1 gathered from the
    (bit-reversed k1 row, bit-reversed k2 lane) layout after pass 2."""
    k2 = k - k1
    n2 = 1 << k2
    pos1 = np.argsort(_bitrev(k1))
    pos2 = np.argsort(_bitrev(k2))
    return (pos1[None, :] * n2 + pos2[:, None]).reshape(-1)


@functools.lru_cache(maxsize=None)
def _dev_limbs(fn, args, device):
    return F.limbs(fn(*args), device)


_powers_table = functools.lru_cache(maxsize=None)(F.powers_table)


@functools.lru_cache(maxsize=None)
def _dev_index(fn, args, device):
    return torch.from_numpy(np.asarray(fn(*args), dtype=np.int64)).to(device)


class Domain:
    """Multiplicative subgroup of order 2^k (host constants; device
    tables are built per device on first use)."""

    def __init__(self, spec: F.FieldSpec, k: int):
        assert k <= spec.two_adicity
        self.spec = spec
        self.k = k
        self.n = 1 << k
        p = spec.modulus
        self.omega = pow(spec.root_of_unity(), 1 << (spec.two_adicity - k), p)
        self.omega_inv = pow(self.omega, -1, p)
        self.n_inv = pow(self.n, -1, p)

    def omega_powers(self, device, count=None, inverse: bool = False):
        """[1, w, w^2, ...] table (count defaults to n) on ``device``."""
        base = self.omega_inv if inverse else self.omega
        return _powers_table(self.spec, base, count or self.n, torch.device(device))


@functools.lru_cache(maxsize=None)
def domain(spec: F.FieldSpec, k: int) -> Domain:
    return Domain(spec, k)


def _pass(spec, x, lt: int, inverse: bool):
    tw = _dev_limbs(_stage_tables, (spec, lt, inverse), x.device)
    return cuda_ntt.ntt_pass_plain(spec, x, tw)


def _twiddles(spec, lt: int, inverse: bool, device):
    """(T/2, 16) powers of the primitive 2^lt-th root: K2's twiddles."""
    return _powers_table(spec, _root(spec, lt, inverse), max(1, 1 << (lt - 1)),
                         device)


def _ntt_flat_cuda(dom: Domain, flat, count: int, inverse: bool, shift_pows):
    """The four-step transform as fused K2 launches: one for k <= 11 (the
    bit reversal and n^-1 inside it), two above (shift on load and mid
    twiddle in the first, natural-order store in the second)."""
    spec, k, dev = dom.spec, dom.k, flat.device
    if k <= cuda_ntt.MAX_LT:
        n_inv = F.encode(spec, dom.n_inv, dev) if inverse else None
        return cuda_ntt.ntt_fused(spec, flat, count, k, k,
                                  _twiddles(spec, k, inverse, dev), False,
                                  mul_in=shift_pows, mul_out=n_inv)
    k1 = (k + 1) // 2
    x = cuda_ntt.ntt_fused(spec, flat, count, k, k1,
                           _twiddles(spec, k1, inverse, dev), True,
                           mul_in=shift_pows,
                           mul_out=_mid_table(spec, k, k1, inverse, dev))
    return cuda_ntt.ntt_fused(spec, x, count, k, k - k1,
                              _twiddles(spec, k - k1, inverse, dev), False,
                              in_place=True)


def ntt_flat(dom: Domain, flat, count: int, inverse: bool = False,
             shift_pows=None):
    """``count`` size-n transforms over a FLAT (count*n, 16) tensor
    (poly i at rows [i*n, (i+1)*n)), natural order in and out;
    ``shift_pows`` (n, 16) first multiplies every poly.  A CUDA tensor
    goes through K2 alone; a CPU tensor through the plain composition
    (multiply, transposes, plain passes, gather)."""
    spec, k, n = dom.spec, dom.k, dom.n
    assert flat.shape == (count * n, LIMBS), flat.shape
    dev = flat.device
    if dev.type != "cpu":
        return _ntt_flat_cuda(dom, flat.contiguous(), count, inverse, shift_pows)
    if shift_pows is not None:
        flat = F.mont_mul(spec, flat.reshape(count, n, LIMBS),
                          shift_pows).reshape(count * n, LIMBS)
    if k <= cuda_ntt.MAX_LT:
        x = _pass(spec, flat.reshape(count, n, LIMBS), k, inverse)
        x = x.index_select(1, _dev_index(_bitrev, (k,), dev))
        if inverse:
            x = F.mont_mul(spec, x, F.encode(spec, dom.n_inv, dev))
        return x.reshape(count * n, LIMBS)
    k1 = (k + 1) // 2
    k2 = k - k1
    n1, n2 = 1 << k1, 1 << k2
    x = flat.reshape(count, n1, n2, LIMBS).transpose(1, 2).reshape(
        count * n2, n1, LIMBS)
    x = _pass(spec, x, k1, inverse)
    mid = _mid_table(spec, k, k1, inverse, dev)
    x = F.mont_mul(spec, x.reshape(count, n, LIMBS), mid)
    x = x.reshape(count, n2, n1, LIMBS).transpose(1, 2).reshape(
        count * n1, n2, LIMBS)
    x = _pass(spec, x, k2, inverse)
    x = x.reshape(count, n, LIMBS).index_select(
        1, _dev_index(_out_perm, (k, k1), dev))
    return x.reshape(count * n, LIMBS)


def ntt(dom: Domain, x, inverse: bool = False):
    """In-order NTT of x (n, 16) along axis 0."""
    return ntt_flat(dom, x, 1, inverse)


def ntt_many(dom: Domain, flat, count: int, inverse: bool = False,
             shift_pows=None):
    """``count`` batched size-n transforms over a FLAT (count*n, 16)
    tensor; ``shift_pows`` (n, 16) first multiplies every poly onto a
    coset (read in place for all polys, never tiled)."""
    return ntt_flat(dom, flat, count, inverse, shift_pows)


def coset_ntt(dom: Domain, coeffs, shift_powers):
    """Evaluate coeffs on the coset {shift * w^i}: distribute then NTT."""
    return ntt_flat(dom, coeffs, 1, shift_pows=shift_powers)


def coset_intt(dom: Domain, evals, shift_inv_powers):
    """Inverse of coset_ntt."""
    return F.mont_mul(dom.spec, ntt(dom, evals, inverse=True), shift_inv_powers)
