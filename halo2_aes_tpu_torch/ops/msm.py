"""Multi-scalar multiplication: the port of ``ops/msm.py``.

The reference's dyadic-tree + Fenwick algorithm, kept so its pieces can
be held against the reference: per window, sort (digit, index) keys,
fold the digit-sorted points up a binary tree of complete adds
(``curve.fold``: two levels of all windows a K3 launch), assemble every
bucket prefix C_b from <= log2(n)+1 tree nodes (``curve.masked_add``: one
launch a level), and telescope
sum_b b * D_b = (B-1) * C_{B-1} - sum_{b<B-1} C_b.  With the
2^(cw)-shifted window tables of ``build_tables`` the windows need no
Horner doubling chain.  Affine results are unique, so a bucket
Pippenger can replace this later without changing any proof byte.

Scalars are PLAIN (non-Montgomery) Fr limbs; points are affine
Montgomery Fq limb tensors (no identities).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from halo2_aes_tpu_torch.ops import curve as CV
from halo2_aes_tpu_torch.ops import field as F

SCALAR_BITS = 254


# Max gathered rows (windows x points) per window group.  The reference
# drops to 2^20 rows above 2^17 points for its chip's 16 GB; each group
# pays a fixed ~100 ms of small host-launched ops (the bucket reduction's
# doublings of its roots), so one group per window made a 2^20-point
# commitment 9.7x slower than 2^23-row groups, whose msm_many of 8 polys
# peaks at 11.0 GB on the H100.  Grouping does not change the result.
_GROUP_ROWS = 1 << 23


def default_window(n: int) -> int:
    """Window size minimizing W*(n + B*(log2 n + 2)) tree+extract adds."""
    lg = max(1, int(np.ceil(np.log2(max(n, 2)))))
    best, best_cost = 8, None
    for c in range(6, 17):
        if c + lg > 32:
            continue
        w = -(-SCALAR_BITS // c)
        cost = w * (n + (1 << c) * (lg + 2))
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def digit_matrix(scalars, c: int):
    """(n, 16) plain limbs -> (windows, n) int64 window digits, LSB first."""
    s = scalars.to(torch.int64)
    windows = -(-SCALAR_BITS // c)
    mask = (1 << c) - 1
    rows = []
    for w in range(windows):
        start = w * c
        l, off = divmod(start, F.LIMB_BITS)
        v = s[..., l] >> off
        got = F.LIMB_BITS - off
        while got < c and l + 1 < F.LIMBS:
            l += 1
            v = v | (s[..., l] << got)
            got += F.LIMB_BITS
        rows.append(v & mask)
    return torch.stack(rows)


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
    W = -(-SCALAR_BITS // c)
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
    output (n a power of two): windows come pre-scaled, no Horner fold."""
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
    [i*n, (i+1)*n)).  Every commitment's windows join one window axis,
    so each tree level is one batched add for all of them.  Requires
    the shifted window ``tables`` and power-of-two n.  Returns a
    projective triple of (count, 16) tensors."""
    px, py = points
    n = px.shape[0]
    assert n & (n - 1) == 0, "tables require power-of-two n"
    W = -(-SCALAR_BITS // c)
    assert tables.shape == (W * n, 2 * F.LIMBS)
    digs = torch.cat([digit_matrix(scalars_flat[i * n:(i + 1) * n], c)
                      for i in range(count)])                 # (count*W, n)
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
