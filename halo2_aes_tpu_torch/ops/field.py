"""Prime-field arithmetic on limb tensors: the port of ``ops/field.py``.

A field element is a little-endian vector of 16 limbs x 16 bits in
Montgomery form (R = 2^256), shape ``(..., 16)``, stored as
``torch.int32`` (values < 2^16, so the sign bit is never set).  The
host codecs (``FieldSpec``, ``int_to_limbs`` ...) are the reference's,
numpy in and out.

Tensor math runs in ``int64``.  Carry chains are resolved without a
16-step loop: after a limbwise add (or subtract) every limb generates a
carry (borrow) or propagates one, and one integer addition over the two
16-bit masks resolves the whole chain (``_resolve``), so an add is ~15
tensor ops whatever the device.

``mont_mul`` routes through ``ops/cuda_field.py``: the CUDA kernel on a
CUDA tensor, its plain PyTorch version on a CPU tensor.  The scans
(``cumprod``, ``cumprod_segmented``, ``batch_inv``) are log-step
doubling scans in plain torch; field multiplication is exact, so they
equal the reference's ``associative_scan`` values bit for bit.

Unless stated otherwise every function takes and returns canonical
Montgomery values in [0, p).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

LIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
NBITS = LIMBS * LIMB_BITS  # 256


# ---------------------------------------------------------------------------
# host-side helpers (python ints <-> numpy limb arrays)
# ---------------------------------------------------------------------------

def int_to_limbs(x: int) -> np.ndarray:
    """Python int -> uint32[16] little-endian 16-bit limbs (plain form)."""
    assert 0 <= x < (1 << NBITS)
    return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(LIMBS)],
                    dtype=np.uint32)


def ints_to_limbs(xs) -> np.ndarray:
    """Iterable of python ints -> uint32[n, 16]."""
    return np.stack([int_to_limbs(int(x)) for x in xs])


def ints_to_limbs_fast(xs) -> np.ndarray:
    """Bulk python ints -> uint32[n,16] via bytes (no per-limb loop)."""
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    u16 = np.frombuffer(buf, dtype="<u2").reshape(len(xs), LIMBS)
    return u16.astype(np.uint32)


def limbs_to_int(a) -> int:
    """uint32[16] -> python int."""
    a = np.asarray(a, dtype=np.uint64)
    return sum(int(a[i]) << (LIMB_BITS * i) for i in range(LIMBS))


def limbs_to_ints(a) -> list:
    """(..., 16) limbs (numpy or tensor) -> list of python ints."""
    flat = to_numpy(a).reshape(-1, LIMBS)
    return [int.from_bytes(row.astype("<u2").tobytes(), "little")
            for row in flat]


def to_numpy(a) -> np.ndarray:
    """Limb tensor (any device) or array -> numpy uint32."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a).astype(np.uint32)


def limbs(a, device) -> torch.Tensor:
    """numpy uint32 limb array -> int32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, dtype=np.uint32).astype(np.int32))).to(device)


# ---------------------------------------------------------------------------
# Field specification (host constants; identical to the reference's)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FieldSpec:
    """All host-precomputed constants for one prime field."""

    name: str
    modulus: int
    generator: int = 0
    two_adicity: int = 0

    p_limbs: np.ndarray = field(init=False, repr=False, compare=False)
    r_mod_p: int = field(init=False, compare=False)   # R mod p (Montgomery ONE)
    r2_mod_p: int = field(init=False, compare=False)  # R^2 mod p
    n0inv: int = field(init=False, compare=False)     # -p^-1 mod 2^16
    one_mont: np.ndarray = field(init=False, repr=False, compare=False)
    r2_limbs: np.ndarray = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        p = self.modulus
        R = 1 << NBITS
        object.__setattr__(self, "p_limbs", int_to_limbs(p))
        object.__setattr__(self, "r_mod_p", R % p)
        object.__setattr__(self, "r2_mod_p", (R * R) % p)
        object.__setattr__(self, "n0inv", (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS))
        object.__setattr__(self, "one_mont", int_to_limbs(R % p))
        object.__setattr__(self, "r2_limbs", int_to_limbs((R * R) % p))

    def to_mont_host(self, x: int) -> int:
        return (x << NBITS) % self.modulus

    def from_mont_host(self, x: int) -> int:
        return (x * pow(1 << NBITS, -1, self.modulus)) % self.modulus

    def encode(self, xs) -> np.ndarray:
        """Python ints (plain) -> numpy limb array in Montgomery form."""
        if isinstance(xs, int):
            return int_to_limbs(self.to_mont_host(xs % self.modulus))
        return ints_to_limbs_fast([self.to_mont_host(int(x) % self.modulus) for x in xs])

    def host_powers(self, base: int, count: int) -> np.ndarray:
        """uint32[count,16] Montgomery powers table (python bigints)."""
        p = self.modulus
        out = []
        acc = 1
        bm = base % p
        for _ in range(count):
            out.append(self.to_mont_host(acc))
            acc = (acc * bm) % p
        return ints_to_limbs_fast(out)

    def decode(self, a) -> list:
        """Limb array or tensor (Montgomery form) -> list of plain ints."""
        return [self.from_mont_host(v) for v in limbs_to_ints(a)]

    def root_of_unity(self) -> int:
        """Primitive 2^two_adicity-th root of unity (plain int)."""
        assert self.two_adicity > 0
        return pow(self.generator, (self.modulus - 1) >> self.two_adicity, self.modulus)


FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617
FQ_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583

FR = FieldSpec("bn254_fr", FR_MODULUS, generator=7, two_adicity=28)
FQ = FieldSpec("bn254_fq", FQ_MODULUS)


@functools.lru_cache(maxsize=None)
def const(spec: FieldSpec, name: str, device) -> torch.Tensor:
    """Cached device copy of a spec constant ("p", "one", "r2") as int32."""
    arr = {"p": spec.p_limbs, "one": spec.one_mont, "r2": spec.r2_limbs}[name]
    return limbs(arr, torch.device(device))


def encode(spec: FieldSpec, xs, device) -> torch.Tensor:
    """Python int(s) -> Montgomery limb tensor on ``device``."""
    return limbs(spec.encode(xs), device)


# ---------------------------------------------------------------------------
# carry resolution (int64 limb math)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bit_tables(device):
    pow2 = torch.tensor([1 << i for i in range(LIMBS)], dtype=torch.int64,
                        device=device)
    shifts = torch.arange(LIMBS + 1, dtype=torch.int64, device=device)
    return pow2, shifts


def _resolve(gen, prop):
    """Carries into each limb from generate/propagate flags (bool
    (..., 16), never both set on one limb).  Returns int64 (..., 17):
    entry i is the carry into limb i, entry 16 the carry out.

    With G, P the flag bitmasks, (G << 1) + P ripples every generated
    carry through the run of propagating limbs above it; XOR with P
    leaves exactly the carry-in bits."""
    pow2, shifts = _bit_tables(gen.device)
    G = (gen.to(torch.int64) * pow2).sum(-1, keepdim=True)
    P = (prop.to(torch.int64) * pow2).sum(-1, keepdim=True)
    return (((G << 1) + P) ^ P) >> shifts & 1


def _add_raw(a, b):
    """(a + b) over 16 int64 limbs -> (sum limbs, carry out (...,))."""
    s = a + b
    low = s & LIMB_MASK
    c = _resolve(s > LIMB_MASK, low == LIMB_MASK)
    return (low + c[..., :LIMBS]) & LIMB_MASK, c[..., LIMBS]


def _sub_raw(a, b):
    """(a - b) over 16 int64 limbs -> (difference limbs, borrow out)."""
    d = a - b
    low = d & LIMB_MASK
    c = _resolve(d < 0, low == 0)
    return (low - c[..., :LIMBS]) & LIMB_MASK, c[..., LIMBS]


def _p64(spec: FieldSpec, device):
    return const(spec, "p", device).to(torch.int64)


def _cond_sub_p(spec: FieldSpec, a):
    """a mod p for int64 limbs a in [0, 2p)."""
    d, borrow = _sub_raw(a, _p64(spec, a.device))
    return torch.where((borrow == 0)[..., None], d, a)


def normalize(acc, out_limbs: int = LIMBS):
    """Redundant int64 limbs (each < 2^62, non-negative) -> canonical
    16-bit limbs, truncated to ``out_limbs``: three carry-save passes
    bring every carry to 0/1, then one resolve."""
    for _ in range(3):
        hi = acc >> LIMB_BITS
        acc = (acc & LIMB_MASK) + torch.nn.functional.pad(hi[..., :-1], (1, 0))
    acc = acc[..., :LIMBS] if acc.shape[-1] >= LIMBS else acc
    low = acc & LIMB_MASK
    c = _resolve(acc > LIMB_MASK, low == LIMB_MASK)
    return ((low + c[..., :LIMBS]) & LIMB_MASK)[..., :out_limbs]


# ---------------------------------------------------------------------------
# public modular ops (int32 in, int32 out)
# ---------------------------------------------------------------------------

def add(spec: FieldSpec, a, b):
    """Canonical modular addition."""
    s, _ = _add_raw(a.to(torch.int64), b.to(torch.int64))
    return _cond_sub_p(spec, s).to(torch.int32)


def sub(spec: FieldSpec, a, b):
    """Canonical modular subtraction."""
    d, borrow = _sub_raw(a.to(torch.int64), b.to(torch.int64))
    dp, _ = _add_raw(d, _p64(spec, d.device))
    return torch.where((borrow == 1)[..., None], dp, d).to(torch.int32)


def neg(spec: FieldSpec, a):
    d, _ = _sub_raw(_p64(spec, a.device), a.to(torch.int64))
    zero = (a == 0).all(-1, keepdim=True)
    return torch.where(zero, torch.zeros_like(d), d).to(torch.int32)


def mont_mul(spec: FieldSpec, a, b):
    """a * b * R^-1 mod p with broadcasting (CUDA kernel on CUDA
    tensors, the plain version on CPU tensors; ops/cuda_field.py)."""
    return _cf.mont_mul(spec, a, b)


mul = mont_mul


def square(spec: FieldSpec, a):
    return mont_mul(spec, a, a)


def to_mont(spec: FieldSpec, a_plain):
    return mont_mul(spec, a_plain, const(spec, "r2", a_plain.device))


def from_mont(spec: FieldSpec, a):
    one = torch.zeros(LIMBS, dtype=torch.int32, device=a.device)
    one[0] = 1
    return mont_mul(spec, a, one)


def pow_const(spec: FieldSpec, a, e: int):
    """a ** e for a fixed python-int exponent (square and multiply)."""
    if e == 0:
        return const(spec, "one", a.device).expand(a.shape).clone()
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else mont_mul(spec, result, base)
        e >>= 1
        if e:
            base = square(spec, base)
    return result


def inv(spec: FieldSpec, a):
    """Batched Fermat inversion a^(p-2). inv(0) = 0."""
    return pow_const(spec, a, spec.modulus - 2)


def _scan(spec: FieldSpec, x, dim: int):
    """Inclusive product scan along ``dim`` by log-step doubling
    (Hillis-Steele): step d multiplies every element by the partial
    product d places before it."""
    n = x.shape[dim]
    d = 1
    while d < n:
        head = x.narrow(dim, 0, d)
        tail = mont_mul(spec, x.narrow(dim, d, n - d), x.narrow(dim, 0, n - d))
        x = torch.cat([head, tail], dim=dim)
        d <<= 1
    return x


def cumprod(spec: FieldSpec, a):
    """Inclusive cumulative product along axis 0."""
    return _scan(spec, a, 0)


def cumprod_segmented(spec: FieldSpec, a, seg_len: int):
    """Per-segment inclusive cumulative product of flat (S*seg_len, 16):
    segment s occupies rows [s*seg_len, (s+1)*seg_len)."""
    m = a.shape[0]
    assert m % seg_len == 0
    return _scan(spec, a.reshape(m // seg_len, seg_len, LIMBS), 1).reshape(m, LIMBS)


def batch_inv(spec: FieldSpec, a):
    """Invert a batch (n, 16) with one field inversion + O(n) muls
    (Montgomery's trick over two scans).  Zero entries map to zero."""
    one = const(spec, "one", a.device)
    is_zero = (a == 0).all(-1, keepdim=True)
    a_safe = torch.where(is_zero, one, a)
    fwd = cumprod(spec, a_safe)
    rev = cumprod(spec, a_safe.flip(0)).flip(0)
    total_inv = inv(spec, fwd[-1])
    p_prev = torch.cat([one[None], fwd[:-1]])
    s_next = torch.cat([rev[1:], one[None]])
    out = mont_mul(spec, mont_mul(spec, p_prev, s_next), total_inv)
    return torch.where(is_zero, torch.zeros_like(out), out)


def powers(spec: FieldSpec, base, count: int):
    """[1, base, ..., base^(count-1)] (count, 16) via log-depth doubling."""
    arr = const(spec, "one", base.device)[None]
    cur = base
    while arr.shape[0] < count:
        arr = torch.cat([arr, mont_mul(spec, arr, cur[None])])
        cur = square(spec, cur)
    return arr[:count]


def powers_table(spec: FieldSpec, base: int, count: int, device) -> torch.Tensor:
    """[1, base, ..., base^(count-1)] as Montgomery limbs on ``device``,
    by ``powers`` (log-depth doubling through K1 on a CUDA device, ~20
    launches for 2^20 entries).  Field products are exact, so this
    equals the host loop ``spec.host_powers``."""
    return powers(spec, encode(spec, base, torch.device(device)), count)


def tree_sum(spec: FieldSpec, a, axis: int = 0):
    """Modular sum along an axis via log-depth pairwise folding."""
    a = a.movedim(axis, 0)
    n = a.shape[0]
    while n > 1:
        half = n // 2
        a = torch.cat([add(spec, a[:half], a[half:2 * half]), a[2 * half:]])
        n = a.shape[0]
    return a[0]


def dot(spec: FieldSpec, a, b):
    """Field inner product along the leading axis."""
    return tree_sum(spec, mont_mul(spec, a, b), axis=0)


def zeros(shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros((*shape, LIMBS), dtype=torch.int32, device=device)


def eq(a, b):
    return (a == b).all(dim=-1)


def is_zero(a):
    return (a == 0).all(dim=-1)


def select(cond, a, b):
    """cond broadcastable over batch shape (no limb axis)."""
    return torch.where(cond[..., None], a, b)


# ---------------------------------------------------------------------------
# byte / u16 embedding (AES witness lift)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _byte_mont_table(spec: FieldSpec, device) -> torch.Tensor:
    return limbs(ints_to_limbs([spec.to_mont_host(v) for v in range(256)]),
                 device)


def bytes_to_field(spec: FieldSpec, b):
    """Integer tensor (...,) of byte values -> Montgomery limbs (..., 16)."""
    return _byte_mont_table(spec, b.device)[b.to(torch.int64)]


def u16_to_field(spec: FieldSpec, v):
    """Integer tensor with values < 2^16 -> Montgomery form: the plain
    limb vector [v, 0, ...] times R^2."""
    plain = torch.zeros((*v.shape, LIMBS), dtype=torch.int32, device=v.device)
    plain[..., 0] = v.to(torch.int32)
    return to_mont(spec, plain)


from halo2_aes_tpu_torch.ops import cuda_field as _cf  # noqa: E402
