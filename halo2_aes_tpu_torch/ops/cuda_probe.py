"""P1, P2a, P2b: the probe kernels, CUDA + plain PyTorch versions.

Replaces the Pallas kernels of the two TPU probe scripts:
  * P1 ``mul_probe`` <- ``scripts/mul_throughput_probe.py`` (``_fn`` :48,
    body ``_mk_kernel`` :27): raw 32-bit multiply throughput, k products
    per element into 33 accumulators (``csrc/mul_probe.cu``);
  * P2a ``mont_mul_planes16`` <- ``scripts/pallas_pack_probe.py``
    (``_fn_packed`` :71, body ``_kernel_packed`` :33): Montgomery
    product with a 16-bit-limb CIOS (``csrc/mont_mul_probe.cu``);
  * P2b ``mont_mul_planes13`` <- the same script (``_fn13`` :197, body
    ``_kernel13`` :156): the 13-bit delayed-carry CIOS with in-register
    repacking and the 2^260 compensation (``csrc/mont_mul_probe.cu``).

All three take (16, N) int32 limb-major planes (limb i of element e at
[i, e]; the TPU probes' (16*8, N/8) arrays are the same bytes) and work
elementwise, one CUDA thread per element.  The Montgomery probes give
a * b * 2^-256 mod p for canonical a, b, exactly
``cuda_field.mont_mul_plain(spec, a.T, b.T).T``.  CPU tensors take the
plain versions; CUDA tensors launch the kernel or raise.

What bounds them on an H100: every kernel moves 3 x 64 bytes per
element (two operands in, one result out).  P1 at k = 64 is bound by
that memory traffic; at k = 512 by its multiply-adds, of which the
compiler may fold the repeated (i, j) pairs (the probe script counts
the IMADs actually compiled).  P2a issues 528 32-bit multiplies per
product, each followed by a mask, a shift and two adds, and P2b 820
multiply-adds plus its repacking: both are bound by integer issue,
where K1 (64-bit partial products on 8 x 32-bit words, 128 wide
multiply-adds) is bound by memory.  The probes exist to measure that
trade against K1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from halo2_aes_tpu_torch.ops import _build
from halo2_aes_tpu_torch.ops import field as F

KERNELS = ("mul_probe", "mont_mul_planes16", "mont_mul_planes13")
LAUNCHES = dict.fromkeys(KERNELS, 0)   # launches since the last reset
SOURCE = {"mul_probe": "halo2_aes_tpu_torch/csrc/mul_probe.cu",
          "mont_mul_planes16": "halo2_aes_tpu_torch/csrc/mont_mul_probe.cu",
          "mont_mul_planes13": "halo2_aes_tpu_torch/csrc/mont_mul_probe.cu"}
REPLACES = {"mul_probe": "scripts/mul_throughput_probe.py:48",
            "mont_mul_planes16": "scripts/pallas_pack_probe.py:71",
            "mont_mul_planes13": "scripts/pallas_pack_probe.py:197"}
MUL_PROBE_K = (64, 512)

M32 = 0xFFFFFFFF
MASK16 = 0xFFFF
D13 = 13
DLIMBS = 20
DMASK = (1 << D13) - 1


def reset_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _to_i32(x):
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _mul_lo32(x, y):
    """Low 32 bits of x * y for x, y in [0, 2^32), without int64 overflow."""
    xl, xh = x & MASK16, x >> 16
    yl, yh = y & MASK16, y >> 16
    return (xl * yl + (((xh * yl + xl * yh) & MASK16) << 16)) & M32


# -- P1 ------------------------------------------------------------------

def mul_probe_plain(a, b, k: int, mask16: bool = False):
    """Plain PyTorch P1 in int64, any device: for each element,
    sum over t < k of a[t % 16] * b[(t // 16) % 16] mod 2^32 (the 33
    accumulators' total), written to all 16 rows of an int32 (16, N)."""
    x = a.to(torch.int64) & M32
    y = b.to(torch.int64) & M32
    if mask16:
        x, y = x & MASK16, y & MASK16
    acc = torch.zeros(x.shape[1:], dtype=torch.int64, device=a.device)
    for t in range(k):
        acc = (acc + _mul_lo32(x[t % 16], y[(t // 16) % 16])) & M32
    return _to_i32(acc).expand(16, *acc.shape).contiguous()


def _check_planes(name: str, a, b):
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"{name}: planes must be int32")
    if a.dim() != 2 or a.shape[0] != F.LIMBS or a.shape != b.shape:
        raise ValueError(f"{name}: bad plane shapes {a.shape} {b.shape}")
    return a.contiguous(), b.contiguous()


def mul_probe(a, b, k: int, mask16: bool = False):
    """P1 on (16, N) int32 planes.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    if k not in MUL_PROBE_K:
        raise ValueError(f"mul_probe: k={k} not in {MUL_PROBE_K}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mul_probe_plain(a, b, k, mask16)
    a, b = _check_planes("mul_probe", a, b)
    out = torch.empty_like(a)
    n = a.shape[1]
    if n == 0:
        return out
    LAUNCHES["mul_probe"] += 1
    code = _build.library().mul_probe_launch(
        out.data_ptr(), a.data_ptr(), b.data_ptr(), n, k, int(mask16),
        _build.stream_of(out))
    _build.check(code, "mul_probe")
    return out


# -- P2a -----------------------------------------------------------------

def mont_mul_planes16_plain(spec: F.FieldSpec, a, b):
    """Plain PyTorch P2a in int64, any device: the 16-bit-limb CIOS of
    the TPU probe on (16, N) planes, each 32-bit product split into its
    low and high 16 bits as it is added; one conditional subtraction."""
    x = a.to(torch.int64)
    y = b.to(torch.int64)
    p = torch.as_tensor(spec.p_limbs.astype("int64"), device=a.device)[:, None]
    acc = torch.zeros((2 * F.LIMBS + 1, x.shape[1]), dtype=torch.int64,
                      device=a.device)
    for i in range(F.LIMBS):
        t = x[i] * y
        acc[i:i + F.LIMBS] += t & MASK16
        acc[i + 1:i + F.LIMBS + 1] += t >> 16
        m = (acc[i] * spec.n0inv) & MASK16
        q = m * p
        acc[i:i + F.LIMBS] += q & MASK16
        acc[i + 1:i + F.LIMBS + 1] += q >> 16
        acc[i + 1] += acc[i] >> 16
    limbs = []
    carry = torch.zeros_like(acc[0])
    for i in range(F.LIMBS):
        v = acc[F.LIMBS + i] + carry
        limbs.append(v & MASK16)
        carry = v >> 16
    return _cond_sub(limbs, [int(v) for v in spec.p_limbs], 16)


def _cond_sub(limbs, p_limbs, bits: int):
    """limbs - p if that does not borrow, else limbs (a borrow chain in
    ``bits``-bit limbs, as the kernels run it) -> int32 (L, N)."""
    mask = (1 << bits) - 1
    borrow = torch.zeros_like(limbs[0])
    diff = []
    for li, pi in zip(limbs, p_limbs):
        v = li + (1 << bits) - pi - borrow
        diff.append(v & mask)
        borrow = 1 - (v >> bits)
    ge = borrow == 0
    return torch.stack([torch.where(ge, d, l) for d, l in zip(diff, limbs)]
                       ).to(torch.int32)


# -- P2b -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _limb_args(modulus: int, bits: int):
    """(p as 16 16-bit or 20 13-bit limbs in a ctypes u32 array,
    -p^-1 mod 2^bits): the kernels' modulus arguments."""
    count = F.LIMBS if bits == 16 else DLIMBS
    mask = (1 << bits) - 1
    words = (ctypes.c_uint32 * count)(*[(modulus >> (bits * i)) & mask
                                        for i in range(count)])
    return words, (-pow(modulus, -1, 1 << bits)) % (1 << bits)


def _repack13(limbs16, shift: int):
    """(16, N) 16-bit limbs -> (20, N) 13-bit limbs of the value << shift;
    limb j covers source bits [13j - shift, 13j - shift + 13)."""
    out = []
    for j in range(DLIMBS):
        lo = D13 * j - shift
        v = torch.zeros_like(limbs16[0])
        for i in range(F.LIMBS):
            base = 16 * i
            if base + 16 <= lo or base >= lo + D13:
                continue
            off = lo - base
            v = v | (limbs16[i] >> off if off >= 0 else limbs16[i] << -off)
        out.append(v & DMASK)
    return torch.stack(out)


def mont_mul_planes13_plain(spec: F.FieldSpec, a, b, col_max: bool = False):
    """Plain PyTorch P2b in int64, any device: repack to 20 x 13-bit
    limbs (a shifted by 4: R' = 2^260 against R = 2^256), delayed-carry
    CIOS, one conditional subtraction, repack to 16-bit limbs.

    The int64 columns never wrap, so they equal the kernel's uint32
    columns exactly when those stay below 2^32; ``col_max=True`` also
    returns the largest column value reached, to show that bound."""
    words, n0 = _limb_args(spec.modulus, D13)
    p13 = list(words)
    x = _repack13(a.to(torch.int64), 4)
    y = _repack13(b.to(torch.int64), 0)
    p = torch.as_tensor(p13, dtype=torch.int64, device=a.device)[:, None]
    acc = torch.zeros((2 * DLIMBS + 1, x.shape[1]), dtype=torch.int64,
                      device=a.device)
    for i in range(DLIMBS):
        acc[i:i + DLIMBS] += x[i] * y
        m = (acc[i] * n0) & DMASK
        acc[i:i + DLIMBS] += m * p
        acc[i + 1] += acc[i] >> D13
    limbs = []
    carry = torch.zeros_like(acc[0])
    top = acc.max()
    for i in range(DLIMBS):
        v = acc[DLIMBS + i] + carry
        top = torch.maximum(top, v.max())
        limbs.append(v & DMASK)
        carry = v >> D13
    res = _cond_sub(limbs, p13, D13).to(torch.int64)
    out = []
    for i in range(F.LIMBS):
        lo = 16 * i
        v = torch.zeros_like(res[0])
        for j in range(DLIMBS):
            base = D13 * j
            if base + D13 <= lo or base >= lo + 16:
                continue
            off = base - lo
            v = v + (res[j] << off if off >= 0 else res[j] >> -off)
        out.append(v & MASK16)
    out = torch.stack(out).to(torch.int32)
    return (out, int(top)) if col_max else out


# -- P2a / P2b kernel wrappers -------------------------------------------

def _mont_planes(name: str, bits: int, spec: F.FieldSpec, a, b):
    a, b = _check_planes(name, a, b)
    out = torch.empty_like(a)
    n = a.shape[1]
    if n == 0:
        return out
    words, n0 = _limb_args(spec.modulus, bits)
    LAUNCHES[name] += 1
    code = getattr(_build.library(), f"{name}_launch")(
        out.data_ptr(), a.data_ptr(), b.data_ptr(), n,
        ctypes.addressof(words), n0, _build.stream_of(out))
    _build.check(code, name)
    return out


def mont_mul_planes16(spec: F.FieldSpec, a, b):
    """P2a on (16, N) int32 limb-major planes of canonical Montgomery
    values.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_planes16_plain(spec, a, b)
    return _mont_planes("mont_mul_planes16", 16, spec, a, b)


def mont_mul_planes13(spec: F.FieldSpec, a, b):
    """P2b on (16, N) int32 limb-major planes of canonical Montgomery
    values.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_planes13_plain(spec, a, b)
    return _mont_planes("mont_mul_planes13", 13, spec, a, b)
