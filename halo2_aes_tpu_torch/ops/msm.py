"""Multi-scalar multiplication: the port of ``ops/msm.py``.

``msm`` and ``msm_many`` are Pippenger bucket sums (K7,
``ops/cuda_msm.py``): with the 2^(cw)-shifted window tables of
``build_tables`` each commitment is ONE bucket set over all of its
windows (row w*n + i into bucket d_{w,i}; the commitment is
sum_b b * B_b), with no window fold; without tables (from
``TABLELESS_MIN_N`` points) each window is a set over the bare points and
the window sums fold by Horner doublings.  K7 on a card, its plain
version on the CPU.

The reference's dyadic-tree + Fenwick algorithm stays as ``msm_tree`` /
``msm_many_tree``, the tests' and the smoke's reference (no prove path
calls it): per window, sort (digit, index) keys, fold the digit-sorted
points up a binary tree of complete adds (``curve.fold``: two levels of
all windows a K3 launch), assemble every bucket prefix C_b from <=
log2(n)+1 tree nodes (``curve.masked_add``: one launch a level), and
telescope sum_b b * D_b = (B-1) * C_{B-1} - sum_{b<B-1} C_b.  Affine
results are unique, so both give the same commitments.

Scalars are PLAIN (non-Montgomery) Fr limbs; points are affine
Montgomery Fq limb tensors (no identities).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from halo2_aes_tpu_torch.ops import cuda_msm as CM
from halo2_aes_tpu_torch.ops import curve as CV
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.utils import timers

SCALAR_BITS = CM.SCALAR_BITS


# Max gathered rows (windows x points) per window group.  The reference
# drops to 2^20 rows above 2^17 points for its chip's 16 GB; each group
# pays a fixed ~100 ms of small host-launched ops (the bucket reduction's
# doublings of its roots), so one group per window made a 2^20-point
# commitment 9.7x slower than 2^23-row groups, whose msm_many of 8 polys
# peaks at 11.0 GB on the H100.  Grouping does not change the result.
_GROUP_ROWS = 1 << 23

# From this many points on, commitments run without window tables: the
# SRS builds none (``backend/srs.SRS.warm_tables``) and each MSM folds its
# window sums by Horner doublings over the bare points, one commitment
# at a time.  At 2^22 points the 26 windows' tables would hold 14.0 GB
# of the card and their build a multiple of that; the doubling tail is
# 26 x 2 small launches a commitment.  Affine results are unique, so the
# commitments do not depend on the switch.  Tests lower it.
TABLELESS_MIN_N = 1 << 22


def default_window(n: int) -> int:
    """Window size minimizing W*(n + B*(log2 n + 2)) tree+extract adds."""
    lg = max(1, int(np.ceil(np.log2(max(n, 2)))))
    best, best_cost = 8, None
    for c in range(6, 17):
        if c + lg > 32:
            continue
        cost = CM.windows(c) * (n + (1 << c) * (lg + 2))
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def digit_matrix(scalars, c: int):
    """(n, 16) plain limbs -> (windows, n) int64 window digits, LSB first."""
    return CM.digits_plain(scalars, 1, c)[0]


def _tree_add(pts):
    """Fold a stacked point triple (m, ..., 16) down axis 0: node i plus
    node i + m // 2, an odd last node carried to the next level."""
    m = pts[0].shape[0]
    tail = pts[0].shape[1:]
    cur = tuple(t.reshape(m, -1, F.LIMBS).contiguous() for t in pts)
    width = cur[0].shape[1]
    while m > 1:
        even = m - (m & 1)
        depth = 1 if m & 1 else (m & -m).bit_length() - 1
        s = CV.fold(tuple(t[:even].reshape(even * width, F.LIMBS) for t in cur),
                    1, even * width, depth)[-1]
        s = tuple(t.reshape(even >> depth, width, F.LIMBS) for t in s)
        cur = tuple(torch.cat([a, t[even:]]) for a, t in zip(s, cur)) if m & 1 else s
        m = cur[0].shape[0]
    return tuple(t.reshape(tail) for t in cur)


@functools.lru_cache(maxsize=None)
def _bitrev_np(lg: int) -> np.ndarray:
    n = 1 << lg
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(lg):
        rev |= ((idx >> b) & 1) << (lg - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _bitrev(lg: int, device) -> torch.Tensor:
    return torch.from_numpy(_bitrev_np(lg)).to(device)


def _window_sums(px, py, digs, c: int, n_real: int, tables=None, tbase=None):
    """Per-window bucket-weighted sums S_w = sum_b b * bucket_b.

    px/py: (n_pad, 16) affine points shared by every window, or
    ``tables`` (W*n, 32) per-window affine rows with ``tbase`` (G,)
    window indices.  digs: (G, n_pad) digits (padding rows carry digit
    0 and are masked to the identity).  Returns (x, y, z) each (G, 16)."""
    G, n_pad = digs.shape
    lg = n_pad.bit_length() - 1
    assert 1 << lg == n_pad
    dev = digs.device
    buckets = 1 << c
    one = F.const(CV.FQ, "one", dev)
    ident = CV.identity(device=dev)

    iota = torch.arange(n_pad, dtype=torch.int64, device=dev)
    keys = torch.sort((digs << lg) | iota[None, :], dim=1).values
    ds = (keys >> lg).contiguous()
    order = keys & (n_pad - 1)
    order_br = order[:, _bitrev(lg, dev)]

    if tables is None:
        sxy = torch.cat([px, py], dim=1)[order_br.reshape(-1)]
    else:
        t3 = tables.reshape(-1, n_pad, 2 * F.LIMBS)
        sxy = t3[tbase[:, None], order_br].reshape(G * n_pad, 2 * F.LIMBS)
    live = (order_br < n_real).reshape(-1, 1)
    sx = torch.where(live, sxy[:, :F.LIMBS], 0)
    sy = torch.where(live, sxy[:, F.LIMBS:], one)
    sz = torch.where(live, one, 0)

    # up-sweep: level l holds G * (n_pad >> l) nodes in bit-reversed order
    levels = [(sx, sy, sz)] + CV.fold((sx, sy, sz), G, n_pad, lg)
    root = levels[-1]

    # Fenwick extraction of C_b = sum of the first m_b sorted points: bucket
    # b takes node ((m_b >> (l+1)) << 1) of level l where bit l of m_b is set
    bvals = torch.arange(buckets, dtype=torch.int64, device=dev)
    mcounts = torch.searchsorted(ds, bvals.expand(G, buckets).contiguous(),
                                 right=True).reshape(1, G * buckets)
    lv = torch.arange(lg + 1, dtype=torch.int64, device=dev)[:, None]
    bits = ((mcounts >> lv) & 1) == 1
    idx = torch.minimum(((mcounts >> (lv + 1)) << 1), (n_pad >> lv) - 1)
    idx = _bitrev(lg, dev)[idx] >> lv          # bit reversal on lg - l bits
    gofs = torch.arange(G, dtype=torch.int64, device=dev).repeat_interleave(buckets)
    flat = gofs[None, :] * (n_pad >> lv) + idx
    acc = ident
    for lvl in range(lg + 1):
        acc = CV.masked_add(acc, levels[lvl], flat[lvl], bits[lvl])

    # sum_b b*D_b = (B-1)*C_{B-1} - sum_{b<B-1} C_b ; C_{B-1} = root
    last = (torch.arange(G * buckets, device=dev) % buckets) == buckets - 1
    cur = tuple(F.select(last, i, a).contiguous() for a, i in zip(acc, ident))
    cur = CV.fold(cur, G, buckets, c)[-1]
    scaled = CV.add(CV.double_n(root, c), CV.neg(root))
    return CV.add(scaled, CV.neg(cur))


def msm_host(points, scalars):
    """Host oracle: sum of scalar multiples of affine int points, one
    double-and-add each (python ints; for tests)."""
    acc = None
    for p, s in zip(points, scalars):
        acc = CV.py_add(acc, CV.py_mul(p, int(s)))
    return acc


def build_tables(points, c: int):
    """Affine window tables T[w][i] = 2^{cw} * P_i as ONE interleaved
    (W*n, 32) int32 tensor (x limbs in [0,16), y in [16,32); window w at
    rows [w*n, (w+1)*n)), on the points' device.  One batched inversion
    normalises every window (affine coordinates are unique, so this
    equals the reference's per-window normalisation)."""
    px, py = points
    n = px.shape[0]
    W = CM.windows(c)
    cur = CV.affine_to_proj((px, py))
    xs, ys, zs = [], [], []
    for w in range(W):
        if w:
            cur = CV.double_n(cur, c)
        xs.append(cur[0])
        ys.append(cur[1])
        zs.append(cur[2])
    zinv = F.batch_inv(CV.FQ, torch.cat(zs))
    ax = F.mont_mul(CV.FQ, torch.cat(xs), zinv)
    ay = F.mont_mul(CV.FQ, torch.cat(ys), zinv)
    assert ax.shape[0] == W * n
    return torch.cat([ax, ay], dim=1)


def msm(points, scalars, c: int | None = None, tables=None):
    """sum_i scalars[i] * points[i] -> projective (3 x (16,)) Montgomery.

    points: (x, y) affine Montgomery limb tensors, each (n, 16);
    scalars: (n, 16) PLAIN Fr limbs; tables: optional ``build_tables``
    output: windows come pre-scaled, one bucket set, no Horner fold.
    Without tables one set a window and the Horner doublings, under one
    ``msm.horner`` span (utils/timers.py: ``windows``, ``c``)."""
    n = points[0].shape[0]
    if c is None:
        c = default_window(n)
    s = CM.bucket_sums(points, scalars, 1, c, tables)
    if tables is not None:
        return tuple(t[0] for t in s)
    W = s[0].shape[0]
    with timers.span("msm.horner", windows=W, c=c):
        acc = CV.identity(device=points[0].device)
        for w in range(W - 1, -1, -1):
            acc = CV.add(CV.double_n(acc, c), (s[0][w], s[1][w], s[2][w]))
    return acc


def msm_tree(points, scalars, c: int | None = None, tables=None):
    """``msm`` by the reference's sorted-prefix tree (tests' reference):
    tables need a power-of-two n; without them n is padded."""
    px, py = points
    n = px.shape[0]
    if c is None:
        c = default_window(n)
    n_pad = max(2, 1 << (n - 1).bit_length())
    digs = digit_matrix(scalars, c)
    W = digs.shape[0]
    if n_pad != n:
        assert tables is None, "tables require power-of-two n"
        px = torch.nn.functional.pad(px, (0, 0, 0, n_pad - n))
        py = torch.nn.functional.pad(py, (0, 0, 0, n_pad - n))
        digs = torch.nn.functional.pad(digs, (0, n_pad - n))
    if tables is not None:
        assert tables.shape == (W * n, 2 * F.LIMBS)

    group = max(1, min(W, _GROUP_ROWS // n_pad))
    n_groups = -(-W // group)
    group = -(-W // n_groups)
    if n_groups * group != W:
        digs = torch.nn.functional.pad(digs, (0, 0, 0, n_groups * group - W))
    wbase = torch.arange(n_groups * group, device=digs.device).clamp(0, W - 1)
    sums = [_window_sums(px, py, digs[g * group:(g + 1) * group], c, n,
                         tables=tables,
                         tbase=wbase[g * group:(g + 1) * group])
            for g in range(n_groups)]
    sx, sy, sz = (torch.cat([s[i] for s in sums]) for i in range(3))
    if tables is not None:
        return _tree_add((sx, sy, sz))
    acc = CV.identity(device=px.device)
    for i in range(W):
        w = W - 1 - i
        acc = CV.add(CV.double_n(acc, c), (sx[w], sy[w], sz[w]))
    return acc


def msm_many(points, scalars_flat, count: int, c: int, tables):
    """``count`` MSMs over the SAME points in one pass: scalars_flat is
    FLAT (count*n, 16) plain Fr limbs (commitment i at rows
    [i*n, (i+1)*n)).  With the shifted window ``tables`` one K7 pass,
    one bucket set a commitment; with ``tables`` None (from
    ``TABLELESS_MIN_N`` points on) each commitment is one ``msm``
    without them.  Returns a projective triple of (count, 16) tensors."""
    if tables is not None:
        return CM.bucket_sums(points, scalars_flat, count, c, tables)
    n = points[0].shape[0]
    sums = [msm(points, scalars_flat[i * n:(i + 1) * n], c)
            for i in range(count)]
    return tuple(torch.stack([s[j] for s in sums]) for j in range(3))


def msm_many_tree(points, scalars_flat, count: int, c: int, tables):
    """``msm_many`` by the reference's sorted-prefix tree (tests'
    reference): every commitment's windows join one window axis, so each
    tree level is one batched add for all of them; power-of-two n."""
    px, py = points
    n = px.shape[0]
    assert n & (n - 1) == 0, "tables require power-of-two n"
    if tables is None:
        sums = [msm_tree(points, scalars_flat[i * n:(i + 1) * n], c)
                for i in range(count)]
        return tuple(torch.stack([s[j] for s in sums]) for j in range(3))
    W = CM.windows(c)
    assert tables.shape == (W * n, 2 * F.LIMBS)
    digs = CM.digits_plain(scalars_flat, count, c).reshape(count * W, n)
    total = count * W
    group = max(1, min(total, _GROUP_ROWS // n))
    n_groups = -(-total // group)
    group = -(-total // n_groups)
    if n_groups * group != total:
        digs = torch.nn.functional.pad(digs, (0, 0, 0, n_groups * group - total))
    wbase = torch.arange(n_groups * group, device=digs.device) % W
    sums = [_window_sums(px, py, digs[g * group:(g + 1) * group], c, n,
                         tables=tables, tbase=wbase[g * group:(g + 1) * group])
            for g in range(n_groups)]
    # (count*W,) window sums, commit-major -> fold each commit's W windows
    return _tree_add(tuple(
        torch.cat([s[i] for s in sums])[:total].reshape(count, W, F.LIMBS)
        .transpose(0, 1) for i in range(3)))
