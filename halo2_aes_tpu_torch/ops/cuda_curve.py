"""K3: complete G1 point arithmetic, CUDA kernels + plain PyTorch versions.

Replaces the Pallas kernel of ``halo2_aes_tpu/ops/pallas_curve.py``
(``_fn`` :146, body ``_make_kernel`` :99), which the reference enters
through ``curve.add`` from the MSM reduction trees and SRS generation.

The arithmetic is Renes-Costello-Batina 2015/1060 for a = 0 (b3 = 9) in
homogeneous projective coordinates over Fq: algorithm 7 (addition, 12
Montgomery products) and algorithm 9 (doubling, 8), with no branch on
identity, doubling or negation.

Kernels (``csrc/curve_add.cu``), one thread per output point, the whole
formula in registers.  What bounds them on an H100: ~1,540 32-bit
multiply-adds per addition against 576 bytes of int32-limb traffic, so
the integer multiplier binds (about 2:1 over memory).  The MSM's cost
was never the adder but what its first interface forced around it, so
the entries are the shapes ``ops/msm.py`` needs, each one launch:

  ``add``         operands read in place by (rows, inner, outer) strides:
                  a slice of a level, a broadcast point or identity is
                  never copied or materialised;
  ``fold``        the pairing tree (node i with node i + m/2 of each of G
                  groups), two levels a launch where m divides by 4: four
                  leaves in, three nodes out, every level kept;
  ``masked_add``  p + (mask ? q[index] : identity): one Fenwick level;
  ``double_n``    ``times`` doublings of every point.

Each has its plain PyTorch version beside it (the composition of torch
ops it replaces), taken only for CPU tensors; a CUDA tensor launches the
kernel or raises.  ``LAUNCHES`` counts every K3 launch, ``ENTRY_LAUNCHES``
the same by entry.
"""

from __future__ import annotations

import ctypes

import torch

from halo2_aes_tpu_torch.ops import _build
from halo2_aes_tpu_torch.ops import cuda_field as CF
from halo2_aes_tpu_torch.ops import field as F

LAUNCHES = 0
ENTRY_LAUNCHES = {"add": 0, "fold": 0, "masked_add": 0, "double_n": 0}
SOURCE = "halo2_aes_tpu_torch/csrc/curve_add.cu"
REPLACES = "halo2_aes_tpu/ops/pallas_curve.py:146"
FQ = F.FQ
# ``fold`` takes two levels a launch up to this many rows in the level it
# starts from: measured on an H100, the two-level kernel is faster or equal
# up to 2^20 rows (fewer launches) and 5% slower than two one-level
# launches at 2^22 (its extra live point costs occupancy)
FOLD2_MAX_ROWS = 1 << 21


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


def double_plain(p):
    """Plain PyTorch RCB complete doubling (alg. 9, a=0, b3=9), any
    device.  Identity-safe."""
    X, Y, Z = p

    def fadd(a, b):
        return F.add(FQ, a, b)

    t0, t1, t2, t3 = _bmul_plain([(Y, Y), (Y, Z), (Z, Z), (X, Y)])
    z8 = fadd(t0, t0)
    z8 = fadd(z8, z8)
    z8 = fadd(z8, z8)
    t2b = _mul_b3(t2)
    y3s = fadd(t0, t2b)
    t2b3 = fadd(fadd(t2b, t2b), t2b)
    t0m = F.sub(FQ, t0, t2b3)
    X3a, Z3, Y3a, X3b = _bmul_plain([(t2b, z8), (t1, z8), (t0m, y3s), (t0m, t3)])
    return (fadd(X3b, X3b), fadd(X3a, Y3a), Z3)


def double_n_plain(p, times: int):
    for _ in range(times):
        p = double_plain(p)
    return p


def fold_plain(level, groups: int, m: int, depth: int):
    """``depth`` rounds of: node i of each group plus node i + m/2."""
    out = []
    for _ in range(depth):
        half = m // 2
        v = [t.reshape(groups, m, F.LIMBS) for t in level]
        level = tuple(t.reshape(groups * half, F.LIMBS) for t in add_plain(
            [t[:, :half] for t in v], [t[:, half:] for t in v]))
        out.append(level)
        m = half
    return out


def masked_add_plain(p, q, index, mask):
    """p + (mask ? q[index] : identity), broadcasting p.  With Q the
    identity (0 : 1 : 0) the complete formula reduces to (X*Y, Y*Y, Y*Z)
    (every other term is a product with 0 or 1), so rows with a clear
    mask take those three products and only the others the whole
    formula: the same limbs as adding the identity, which the kernel
    does."""
    shape = (*index.shape, F.LIMBS)
    X, Y, Z = (t.expand(shape) for t in p)
    out = [t.clone() for t in _bmul_plain([(X, Y), (Y, Y), (Y, Z)])]
    rows = torch.nonzero(mask.reshape(-1)).reshape(-1)
    if rows.numel():
        flat = [t.reshape(-1, F.LIMBS) for t in (X, Y, Z)]
        full = add_plain([t[rows] for t in flat],
                         [t[index.reshape(-1)[rows]] for t in q])
        for o, f in zip(out, full):
            o.reshape(-1, F.LIMBS)[rows] = f
    return tuple(out)


def _check(name: str, tensors) -> torch.device:
    """Every tensor an int32 limb tensor on one CUDA device, or raise."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"curve {name}: coordinates on mixed or non-CUDA devices")
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError(f"curve {name}: limb tensors must be int32")
    if any(t.shape[-1] != F.LIMBS for t in tensors):
        raise ValueError(f"curve {name}: bad limb shape")
    return dev


def _all_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _launch(entry: str, fn, outs, *args):
    global LAUNCHES
    LAUNCHES += 1
    ENTRY_LAUNCHES[entry] += 1
    words, n0 = _build.modulus_args(FQ.modulus)
    code = fn(*(t.data_ptr() for t in outs), *args, ctypes.addressof(words), n0,
              _build.stream_of(outs[0]))
    _build.check(code, f"curve_{entry}")


def _outputs(n: int, dev):
    return tuple(torch.empty((n, F.LIMBS), dtype=torch.int32, device=dev)
                 for _ in range(3))


def _strides(t):
    """(rows, inner, outer) of a (..., 16) view the adder can read in
    place: row r at (r // inner) * outer + r % inner elements past its
    first; None when the view has no such description."""
    if t.stride(-1) != 1 or t.storage_offset() % 4:
        return None
    dims = [(s, st) for s, st in zip(t.shape[:-1], t.stride()[:-1]) if s != 1]
    if all(st == 0 for _, st in dims):
        return 1, 1, 0
    merged = []                 # innermost first, contiguous runs merged
    for size, st in reversed(dims):
        if merged and st == merged[-1][0] * merged[-1][1]:
            merged[-1][0] *= size
        else:
            merged.append([size, st])
    if merged[-1][1] == 0 and len(merged) > 1:
        merged.pop()            # tiled along the outer axes: row i % rows
    if merged[0][1] != F.LIMBS:
        merged.insert(0, [1, F.LIMBS])      # single rows, strided apart
    if len(merged) > 2:
        return None
    if len(merged) == 1:
        return merged[0][0], merged[0][0], 0
    (inner, _), (outer_n, outer_st) = merged
    if outer_st % F.LIMBS or outer_st == 0:
        return None
    return inner * outer_n, inner, outer_st // F.LIMBS


def _operand(coords, shape, n: int):
    """One point operand (x, y, z broadcastable to ``shape``) as launch
    arguments; a view the kernel cannot read in place is copied."""
    if all(c.shape == shape and c.is_contiguous() for c in coords):
        return coords, (*(c.data_ptr() for c in coords), n, n, 0)
    coords = [c.expand(shape) for c in coords]
    desc = {_strides(c) for c in coords}
    if len(desc) != 1 or None in desc:
        coords = [c.contiguous() for c in coords]
        desc = {(n, n, 0)}
    return coords, (*(c.data_ptr() for c in coords), *desc.pop())


def add(p, q):
    """Complete addition of coordinate triples (each (..., 16) Fq
    Montgomery limbs; p and q broadcast against each other).  CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise), reading strided and broadcast views in place."""
    coords = (*p, *q)
    shape = torch.broadcast_shapes(*(c.shape for c in coords))
    if _all_cpu(coords):
        coords = [c.expand(shape) for c in coords]
        return add_plain(coords[:3], coords[3:])
    dev = _check("add", coords)
    outs = tuple(torch.empty(shape, dtype=torch.int32, device=dev)
                 for _ in range(3))
    n = outs[0].numel() // F.LIMBS
    if n == 0:
        return outs
    keep_p, args_p = _operand(coords[:3], shape, n)
    keep_q, args_q = _operand(coords[3:], shape, n)
    _launch("add", _build.library().curve_add_launch, outs, *args_p, *args_q, n)
    del keep_p, keep_q          # alive until the launch was queued
    return outs


def fold(level, groups: int, m: int, depth: int):
    """The pairing tree on a level of ``groups`` x ``m`` points (each
    coordinate a contiguous (groups*m, 16) tensor): ``depth`` times, node
    i of every group becomes node i + node i + m/2.  Returns the list of
    the ``depth`` new levels.  On CUDA tensors two levels go in one
    launch wherever the width divides by 4."""
    if m % (1 << depth) or any(t.shape != (groups * m, F.LIMBS) for t in level):
        raise ValueError(f"curve fold: {groups} x {m} by {depth} levels on "
                         f"{[tuple(t.shape) for t in level]}")
    if _all_cpu(level):
        return fold_plain(level, groups, m, depth)
    dev = _check("fold", level)
    if not all(t.is_contiguous() for t in level):
        raise ValueError("curve fold: level tensors must be contiguous")
    lib = _build.library()
    out = []
    while depth:
        if depth >= 2 and groups * m <= FOLD2_MAX_ROWS:
            l1 = _outputs(groups * m // 2, dev)
            l2 = _outputs(groups * m // 4, dev)
            _launch("fold", lib.curve_fold2_launch, (*l1, *l2),
                    *(t.data_ptr() for t in level), groups, m)
            out += [l1, l2]
            level, m, depth = l2, m // 4, depth - 2
        else:
            half = m // 2
            l1 = _outputs(groups * half, dev)
            lo = (*(t.data_ptr() for t in level), groups * half, half, m)
            hi = (*(t.data_ptr() + half * F.LIMBS * 4 for t in level),
                  groups * half, half, m)
            _launch("fold", lib.curve_add_launch, l1, *lo, *hi, groups * half)
            out.append(l1)
            level, m, depth = l1, half, depth - 1
    return out


def masked_add(p, q, index, mask):
    """p + (mask ? q[index] : identity) for n = len(index) rows: p is a
    triple of (n, 16) tensors or of (16,) ones (broadcast), q a triple of
    (rows, 16) tensors, index int64 (n,), mask bool (n,)."""
    n = index.shape[0]
    if index.shape != (n,) or mask.shape != (n,) or index.dtype != torch.int64 \
            or mask.dtype != torch.bool:
        raise ValueError("curve masked_add: index int64 (n,), mask bool (n,)")
    if any(t.shape not in ((n, F.LIMBS), (F.LIMBS,)) for t in p) \
            or len({t.shape for t in p}) != 1 or any(t.dim() != 2 for t in q):
        raise ValueError("curve masked_add: bad operand shapes")
    if _all_cpu((*p, *q, index, mask)):
        return masked_add_plain(p, q, index, mask)
    dev = _check("masked_add", (*p, *q))
    if index.device != dev or mask.device != dev:
        raise ValueError("curve masked_add: index or mask on another device")
    if not all(t.is_contiguous() for t in (*p, *q, index, mask)):
        raise ValueError("curve masked_add: tensors must be contiguous")
    outs = _outputs(n, dev)
    if n == 0:
        return outs
    _launch("masked_add", _build.library().curve_add_masked_launch, outs,
            *(t.data_ptr() for t in p),
            p[0].numel() // F.LIMBS, *(t.data_ptr() for t in q),
            index.data_ptr(), mask.data_ptr(),
            F.const(FQ, "one", dev).data_ptr(), n)
    return outs


def double_n(p, times: int):
    """2^times * p for a coordinate triple of equal-shape tensors: CPU
    tensors take the plain version, CUDA tensors one kernel launch."""
    if times < 0 or len({t.shape for t in p}) != 1:
        raise ValueError("curve double_n: times >= 0 and equal shapes")
    if _all_cpu(p):
        return double_n_plain(p, times)
    dev = _check("double_n", p)
    ins = [t.contiguous() for t in p]
    outs = tuple(torch.empty_like(t) for t in ins)
    n = ins[0].numel() // F.LIMBS
    if n == 0:
        return outs
    _launch("double_n", _build.library().curve_double_launch, outs,
            *(t.data_ptr() for t in ins), n, times)
    return outs
