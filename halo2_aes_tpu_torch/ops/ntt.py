"""Number-theoretic transform over BN254 Fr: the port of ``ops/ntt.py``.

Every batched transform runs the four-step decomposition of the
reference's ``pallas_ntt.ntt_flat`` (pallas_ntt.py:350), applied
recursively, on every device and at every k up to the field's
two-adicity: a transform of n = 2^k points is m = ceil(k / ROW_CAP)
fused passes of lt_1 + ... + lt_m = k (balanced, the longer first).
Pass t reads rows of T = 2^lt_t points at stride n / T, multiplies on
load by the coset shift (first pass only), runs its DIF stages,
multiplies in its epilogue by the mid twiddle of the sub-transform it
belongs to (of N_t = 2^(lt_t + ... + lt_m) points: w_N^(c * j), with
n^-1 folded into the first pass's table for the inverse; the last pass
takes no table, or n^-1 where it is the only pass), and stores at the
output stride B_t = 2^(lt_1 + ... + lt_(t-1)), so that sub-transform b of
the next pass finds its element c at c * B_(t+1) + b and the last pass
(B_m = n / T_m) writes natural order.  k <= ROW_CAP is one pass, k <=
2 * ROW_CAP two (the split of earlier versions), and so on.

On a CUDA tensor every pass is K2 (``cuda_ntt.ntt_fused``) and nothing
else.  A transform is bound by its walks over device memory (128 B an
element and walk), so the coset shift, the transposes, the mid twiddles,
the output reorder and n^-1 all happen inside the launches.  On a CPU
tensor the same composition runs through the kernel's plain version
(``cuda_ntt.ntt_fused_plain``), so tier-1 tests run the card's
composition; ``ntt_flat_plain`` (shift, transposes, plain passes, a
gather; at most two passes) is the older composition the tests hold it
against.  The NTT is an exact function of its input, so the result
equals the reference's ``ntt``/``ntt_many`` bit for bit whichever path
computed it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from halo2_aes_tpu_torch.ops import cuda_ntt
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.utils import timers

LIMBS = F.LIMBS
# the longest row a composed transform's pass takes is 2^ROW_CAP points
# (tests lower it to run three and four passes on toy sizes).  At 12 a
# 2^23 or 2^24 transform is two passes: 45 x 2^23 with a shift took
# 191 ms against 223 ms in three passes of rows of at most 2^11, and one
# stack less (PERF.md, scripts/torch_kernel_times.py --split-lg 23);
# k <= 22 splits as at 11, but k = 12 is now one pass
ROW_CAP = 12


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
               device, scaled: bool = True) -> torch.Tensor:
    """(n, 16) Montgomery table w^(i2*k1) in pass-1 output order (i2 row,
    bit-reversed k1 lane) on ``device``; the inverse folds in n^-1 where
    ``scaled`` (pallas_ntt._mid_table, limbs last).  Gathered from one
    powers table of w, since w^(i2*j) = w^(i2*j mod n)."""
    n = 1 << k
    idx = (np.arange(n >> k1)[:, None] * _bitrev(k1)[None, :]) % n
    device = torch.device(device)
    out = _powers_table(spec, _root(spec, k, inverse), n, device)[
        torch.from_numpy(idx.reshape(-1)).to(device)]
    if inverse and scaled:
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

    @property
    def bitrev(self) -> torch.Tensor:
        """The bit-reversal permutation of 0..n-1 (CPU int64)."""
        return torch.from_numpy(_bitrev(self.k))

    def bitrev_flat(self, count: int) -> torch.Tensor:
        """Bit-reversal gather indices for ``count`` polys stored FLAT
        (count*n rows): the per-poly table offset by each poly's base."""
        one = self.bitrev
        return (one.repeat(count)
                + torch.arange(count).repeat_interleave(self.n) * self.n)

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


def pass_lengths(k: int, cap: int | None = None) -> list:
    """The passes' log row lengths of a 2^k transform: ceil(k / cap)
    parts, balanced, the longer first."""
    cap = ROW_CAP if cap is None else cap
    m = max(1, -(-k // cap))
    return [k // m + (i < k % m) for i in range(m)]


def _ntt_flat_composed(dom: Domain, flat, count: int, inverse: bool,
                       shift_pows, fused=cuda_ntt.ntt_fused):
    """The recursive four-step transform as ``pass_lengths(k)`` fused passes
    (module docstring): the shift on load of the first, the mid twiddles
    in the epilogues, natural order out of the last, which runs in place
    on the previous pass's output.  ``fused`` is K2's wrapper, or its
    plain version for the plain composition on the same device."""
    spec, k, dev = dom.spec, dom.k, flat.device
    lts = pass_lengths(k)
    x, done = flat, 0
    for t, lt in enumerate(lts):
        last = t == len(lts) - 1
        if not last:       # n^-1 folds into the first table only
            mid = (spec, k - done, lt, inverse, dev)
            mul_out = _mid_table(*mid) if t == 0 else _mid_table(*mid, False)
        elif inverse and t == 0:
            mul_out = F.encode(spec, dom.n_inv, dev)
        else:
            mul_out = None
        x = fused(spec, x, count, k, lt, _twiddles(spec, lt, inverse, dev),
                  1 << done, mul_in=shift_pows if t == 0 else None,
                  mul_out=mul_out, in_place=last and t > 0)
        done += lt
    return x


def ntt_flat(dom: Domain, flat, count: int, inverse: bool = False,
             shift_pows=None):
    """``count`` size-n transforms over a FLAT (count*n, 16) tensor
    (poly i at rows [i*n, (i+1)*n)), natural order in and out;
    ``shift_pows`` (n, 16) first multiplies every poly.  A CUDA tensor
    goes through K2 alone; a CPU tensor through the same composition of
    the kernel's plain version.  Every transform of the package comes
    here once, in an ``ntt`` span (utils/timers.py) of its shape."""
    assert flat.shape == (count * dom.n, LIMBS), flat.shape
    with timers.span("ntt", count=count, log_n=dom.k,
                     shifted=shift_pows is not None, inverse=inverse):
        return _ntt_flat_composed(dom, flat.contiguous(), count, inverse,
                                  shift_pows)


def ntt_flat_plain(dom: Domain, flat, count: int, inverse: bool = False,
                   shift_pows=None):
    """The older plain composition, the tests' second witness (k <= 2 *
    the longest row): shift, transposes, one or two plain passes of the
    reference's stage tables, the mid twiddle, a gather."""
    spec, k, n = dom.spec, dom.k, dom.n
    assert flat.shape == (count * n, LIMBS), flat.shape
    dev = flat.device
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
    if k1 > cuda_ntt.MAX_LT:
        raise ValueError(f"ntt_flat_plain: k={k} needs more than two passes")
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


def eval_poly(spec: F.FieldSpec, coeffs, x):
    """Evaluate a coefficient-form poly at the point x ((16,) Montgomery)."""
    return F.dot(spec, coeffs, F.powers(spec, x, coeffs.shape[0]))


def coset_intt(dom: Domain, evals, shift_inv_powers):
    """Inverse of coset_ntt."""
    return F.mont_mul(dom.spec, ntt(dom, evals, inverse=True), shift_inv_powers)
