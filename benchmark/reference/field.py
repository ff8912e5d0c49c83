"""Plain PyTorch arithmetic in BN254's scalar field, for the reference.

Elements are int64 tensors (..., 16) of 16-bit limbs.  "mont" tensors
hold a * 2^256 mod p (Montgomery form, the form the blinding stream is
drawn in); "std" tensors hold the canonical value.  Every op is a few
elementwise torch calls on whatever device the tensors are on; there is
no kernel of the program here.
"""

from __future__ import annotations

import numpy as np
import torch

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
LIMBS = 16
MASK = (1 << 16) - 1
R = 1 << 256
R_INV = pow(R, -1, P)
N0 = (-pow(P, -1, 1 << 16)) % (1 << 16)
# Montgomery products are taken in pieces of at most this many elements
_CHUNK = 1 << 21


def to_limbs(xs) -> np.ndarray:
    """Python ints -> (len, 16) int64 limbs of each int as it is."""
    raw = b"".join(int(x).to_bytes(32, "little") for x in xs)
    return np.frombuffer(raw, dtype="<u2").reshape(-1, LIMBS).astype(np.int64)


def from_limbs(a) -> list:
    """(..., 16) limbs (array or tensor) -> Python ints, flattened."""
    arr = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    arr = arr.reshape(-1, LIMBS).astype("<u2")
    raw = arr.tobytes()
    return [int.from_bytes(raw[i:i + 32], "little") for i in range(0, len(raw), 32)]


def tensor(xs, device) -> torch.Tensor:
    return torch.as_tensor(to_limbs(xs), device=device)


def mont(xs, device) -> torch.Tensor:
    """Python ints -> Montgomery tensor."""
    return tensor([x % P * R % P for x in xs], device)


def decode(a) -> list:
    """Montgomery tensor -> Python ints."""
    return [v * R_INV % P for v in from_limbs(a)]


def _p(device):
    return torch.as_tensor(to_limbs([P])[0], device=device)


def _carry(acc):
    """Non-negative redundant limbs -> canonical limbs (one carry ripple,
    the top carry dropped)."""
    out = acc.clone()
    for i in range(out.shape[-1] - 1):
        out[..., i + 1] += out[..., i] >> 16
        out[..., i] &= MASK
    return out


def _ge_p(a):
    """a >= p, for canonical limbs a (..., 16)."""
    p = _p(a.device)
    gt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    lt = torch.zeros_like(gt)
    for i in range(LIMBS - 1, -1, -1):
        gt |= ~lt & (a[..., i] > p[i])
        lt |= ~gt & (a[..., i] < p[i])
    return ~lt


def _sub_p_if(a, cond):
    """a - p where cond, with the borrow rippled (a >= p there)."""
    d = a - torch.where(cond[..., None], _p(a.device), torch.zeros_like(a))
    for i in range(LIMBS - 1):
        borrow = (d[..., i] < 0).to(torch.int64)
        d[..., i] += borrow << 16
        d[..., i + 1] -= borrow
    return d


def reduce(a):
    """Canonical limbs of a value below 2p -> the value mod p."""
    return _sub_p_if(a, _ge_p(a))


def add(a, b):
    a, b = torch.broadcast_tensors(a, b)
    s = _carry(torch.nn.functional.pad(a + b, (0, 1)))
    over = s[..., LIMBS] > 0
    return _sub_p_if(s[..., :LIMBS], over | _ge_p(s[..., :LIMBS]))


def neg(a):
    p = _p(a.device)
    d = p - a
    for i in range(LIMBS - 1):
        borrow = (d[..., i] < 0).to(torch.int64)
        d[..., i] += borrow << 16
        d[..., i + 1] -= borrow
    zero = (a == 0).all(-1, keepdim=True)
    return torch.where(zero, torch.zeros_like(d), d)


def sub(a, b):
    return add(a, neg(b))


def _mul_flat(a, b):
    """CIOS Montgomery product of two (N, 16) int64 limb tensors."""
    p = _p(a.device)
    acc = torch.zeros((a.shape[0], 2 * LIMBS + 1), dtype=torch.int64,
                      device=a.device)
    for i in range(LIMBS):
        acc[:, i:i + LIMBS] += a[:, i:i + 1] * b
    for i in range(LIMBS):
        m = (acc[:, i] * N0) & MASK
        acc[:, i:i + LIMBS] += m[:, None] * p
        acc[:, i + 1] += acc[:, i] >> 16
    # the top 17 columns (each below 2^40) hold a value below 2p
    return reduce(_carry(acc[:, LIMBS:])[:, :LIMBS])


def mul(a, b):
    """Montgomery product a * b / 2^256 mod p, broadcast over leading axes."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    af = a.expand(shape).reshape(-1, LIMBS)
    bf = b.expand(shape).reshape(-1, LIMBS)
    n = af.shape[0]
    if n <= _CHUNK:
        return _mul_flat(af, bf).reshape(shape)
    return torch.cat([_mul_flat(af[i:i + _CHUNK], bf[i:i + _CHUNK])
                      for i in range(0, n, _CHUNK)]).reshape(shape)


def to_mont(a_std):
    return mul(a_std, tensor([R * R % P], a_std.device)[0])


def from_mont(a):
    one = torch.zeros(LIMBS, dtype=torch.int64, device=a.device)
    one[0] = 1
    return mul(a, one)


def small_to_mont(v):
    """Integer tensor (...,) with values in [0, 2^16) -> Montgomery limbs."""
    plain = torch.zeros((*v.shape, LIMBS), dtype=torch.int64, device=v.device)
    plain[..., 0] = v.to(torch.int64)
    return to_mont(plain)


def one(device):
    return mont([1], device)[0]


def powers(base: int, count: int, device):
    """[1, base, ..., base^(count-1)] as a Montgomery tensor (count, 16)."""
    out = mont([1], device)
    cur = mont([base], device)[0]
    while out.shape[0] < count:
        out = torch.cat([out, mul(out, cur)])
        cur = mul(cur, cur)
    return out[:count]


def scan(x):
    """Inclusive product scan of (S, n, 16) Montgomery tensors along the
    rows: blocks of up to 32 rows in sequence, then the block prefixes by
    log-step doubling."""
    S, n = x.shape[:2]
    C = min(n, 32)
    while n % C:
        C //= 2
    B = n // C
    xb = x.reshape(S, B, C, LIMBS).clone()
    for j in range(1, C):
        xb[:, :, j] = mul(xb[:, :, j], xb[:, :, j - 1])
    if B > 1:
        tot = xb[:, :, -1]
        d = 1
        while d < B:
            tot = torch.cat([tot[:, :d], mul(tot[:, d:], tot[:, :B - d])], dim=1)
            d <<= 1
        excl = torch.cat([one(x.device).expand(S, 1, LIMBS), tot[:, :-1]], dim=1)
        xb = mul(xb, excl[:, :, None])
    return xb.reshape(S, n, LIMBS)


def batch_inv(x):
    """Elementwise inverse of (S, n, 16) Montgomery tensors with no zero
    entry: prefix and suffix products and one inversion per row."""
    S, n = x.shape[:2]
    pre = scan(x)
    suf = scan(x.flip(1)).flip(1)
    totals = decode(pre[:, -1])
    if any(t == 0 for t in totals):
        raise ZeroDivisionError("batch_inv of a zero element")
    tinv = mont([pow(t, -1, P) for t in totals], x.device)       # (S, 16)
    o = one(x.device).expand(S, 1, LIMBS)
    left = torch.cat([o, pre[:, :-1]], dim=1)
    right = torch.cat([suf[:, 1:], o], dim=1)
    return mul(mul(left, right), tinv[:, None])


def dot_bases(polys, bases):
    """sum_i poly[i] * base[i] mod p for every pair: polys (Q, n, 16) and
    bases (B, n, 16), both canonical standard-form limbs.  Each 16 x 16
    block of limb products is one float64 matrix product, exact while
    its sums stay below 2^53 (rows are taken 2^20 at a time).
    Returns a Q x B list of Python ints."""
    Q, n = polys.shape[:2]
    Bn = bases.shape[0]
    acc = None
    step = 1 << 20
    for lo in range(0, n, step):
        pv = polys[:, lo:lo + step].permute(0, 2, 1).reshape(Q * LIMBS, -1).double()
        bv = bases[:, lo:lo + step].permute(1, 0, 2).reshape(-1, Bn * LIMBS).double()
        part = (pv @ bv).to(torch.int64)
        acc = part if acc is None else acc + part
    m = acc.cpu().numpy().reshape(Q, LIMBS, Bn, LIMBS)
    out = []
    for q in range(Q):
        row = []
        for b in range(Bn):
            blk = m[q, :, b, :]
            total = 0
            for s in range(2 * LIMBS - 1):
                lo_a, hi_a = max(0, s - LIMBS + 1), min(s, LIMBS - 1)
                col = sum(int(blk[a, s - a]) for a in range(lo_a, hi_a + 1))
                total += col << (16 * s)
            row.append(total % P)
        out.append(row)
    return out
