"""K7: Pippenger bucket accumulation for the MSM, CUDA kernels + plain
PyTorch versions.

Replaces no TPU kernel: the reference's ``ops/msm.py`` folds a sorted
prefix tree with XLA ops (no ``pallas_call``), and the port ran the same
tree through K3 (``msm.msm_tree``: per window group an int64 digit sort,
a gathered copy of every table row, leaf masks, lg fold levels, lg + 1
Fenwick masked adds and a bucket fold, ~200 launches).  K7
(``csrc/msm_buckets.cu``) keeps one bucket set per commitment across all
of its 2^(cw)-shifted windows: table row w*n + i goes into bucket
d_{w,i} of its set, and the commitment is sum_b b * B_b, with no window
fold.  Without window tables each window is a set of its own over the
bare points, and ``msm.msm`` folds the window sums by Horner doublings.

A pass is four steps, the same on both devices:

  ``digits``   the W digits of c bits of every plain Fr scalar, as a
               (sets, R) matrix: set = commitment and row r = w*n + i
               with tables; set = window and r = i without;
  ``sort``     each (set, bucket)'s rows with a nonzero digit, ascending,
               as one int32 list with the buckets' starts (on the card two
               stable scatter passes of about c/2 bits each, ``torch.sort``
               here);
  ``accumulate`` the list cut into slices of ``slice_len`` places, one a
               thread, each summed by the mixed addition (RCB algorithm 8)
               into its buckets, and the pieces of a bucket cut by slice
               ends added in slice order (K3's complete addition);
  ``reduce``   sum_b b * B_b a set by segment-local running sums on two
               levels.

Every order of addition is fixed by the data and ``slice_len``, so the
plain version's projective limbs equal the kernel's bit for bit at the
same ``slice_len`` (the card's default differs from the CPU's, the
affine result does not).  CPU tensors take the plain versions; CUDA
tensors launch the kernels or raise.  ``LAUNCHES`` counts every K7
launch, ``ENTRY_LAUNCHES`` the same by kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from halo2_aes_tpu_torch.ops import _build
from halo2_aes_tpu_torch.ops import cuda_curve as CC
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.utils import timers

LAUNCHES = 0
ENTRY_LAUNCHES = {"digits": 0, "histogram": 0, "starts": 0, "tilescan": 0,
                  "pass1": 0, "histogram2": 0, "pass2": 0, "accumulate": 0,
                  "merge": 0, "reduce": 0}
SOURCE = "halo2_aes_tpu_torch/csrc/msm_buckets.cu"
REPLACES = ("none: ops/msm.py's sorted-prefix tree (msm_tree, _window_sums; "
            "the reference's msm.py leaves it to XLA)")
SCALAR_BITS = 254
FQ = F.FQ
LIMBS = F.LIMBS
MAX_WINDOW = 13           # the card's histogram keeps 2^c counters in 48 KB
MIN_SLICE = 32            # places a slice at least
TILE_ROWS = 8192          # places a block of the card's sort walks


def windows(c: int) -> int:
    return -(-SCALAR_BITS // c)


def _split(c: int) -> tuple[int, int]:
    """log2 of the reduction's segments on its two levels: L = 2^(c // 3)
    buckets a first-level segment, L2 = 2^((c - log2 L) // 2) segments a
    second-level one."""
    lo = c // 3
    return lo, (c - lo) // 2


def slice_len(places: int, buckets: int, device) -> int:
    """Places a slice.  The card: one slice a thread it holds at once, so
    the accumulation runs as one wave.  The CPU, where each place of a
    slice is one vectorised step: about the square root of a bucket's
    size, which balances the steps of the accumulation against those of
    the merge."""
    device = torch.device(device)
    if device.type == "cuda":
        return max(MIN_SLICE, -(-places // _resident(device.index or 0)))
    return max(1, math.isqrt(max(1, places // max(1, buckets))))


@functools.lru_cache(maxsize=None)
def _resident(index: int) -> int:
    """The accumulation threads card ``index`` holds at once."""
    out = ctypes.c_int64(0)
    with torch.cuda.device(index):
        _build.check(_build.library().msm_accumulate_threads(ctypes.addressof(out)),
                     "msm_accumulate_threads")
    return out.value


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def digits_plain(scalars, count: int, c: int):
    """(count*n, 16) plain limbs -> (count, W, n) int64 window digits,
    LSB first (also the digit matrix of the sorted-prefix tree and of the
    SRS's setup)."""
    s = scalars.to(torch.int64).reshape(count, -1, LIMBS)
    mask = (1 << c) - 1
    out = []
    for w in range(windows(c)):
        limb, off = divmod(w * c, F.LIMB_BITS)
        v = s[..., limb] >> off
        got = F.LIMB_BITS - off
        while got < c and limb + 1 < LIMBS:
            limb += 1
            v = v | (s[..., limb] << got)
            got += F.LIMB_BITS
        out.append(v & mask)
    return torch.stack(out, 1)


def sort_plain(digs, c: int):
    """(sets, R) digits -> (rows int32 (sets*R,), starts int32
    (sets*2^c + 1,)): bucket g = s*2^c + d lists the rows r of set s with
    digit d != 0 at [starts[g], starts[g+1]), ascending; past
    starts[-1] the rows are unused."""
    sets, R = digs.shape
    B = 1 << c
    flat = (digs.to(torch.int64)
            + (torch.arange(sets, device=digs.device) * B)[:, None]).reshape(-1)
    live = torch.nonzero(digs.reshape(-1) != 0).reshape(-1)
    keys = flat[live]
    order = torch.sort(keys, stable=True).indices
    rows = torch.zeros(sets * R, dtype=torch.int32, device=digs.device)
    rows[:live.numel()] = (live[order] % R).to(torch.int32)
    starts = torch.zeros(sets * B + 1, dtype=torch.int64, device=digs.device)
    starts[1:] = torch.cumsum(torch.bincount(keys, minlength=sets * B), 0)
    return rows, starts.to(torch.int32)


def madd_plain(p, x2, y2):
    """p + (x2, y2, 1) by RCB algorithm 8 (a = 0, b3 = 9): complete for
    an affine point that is not the identity; the kernel's expression."""
    X1, Y1, Z1 = p

    def fadd(a, b):
        return F.add(FQ, a, b)

    def fsub(a, b):
        return F.sub(FQ, a, b)

    t0, t1, t3, t4, y3 = CC._bmul_plain([
        (X1, x2), (Y1, y2), (fadd(x2, y2), fadd(X1, Y1)), (y2, Z1), (x2, Z1)])
    t3 = fsub(t3, fadd(t0, t1))
    t4 = fadd(t4, Y1)
    y3 = fadd(y3, X1)
    t0 = fadd(fadd(t0, t0), t0)
    t2 = CC._mul_b3(Z1)
    z3 = fadd(t1, t2)
    t1 = fsub(t1, t2)
    y3 = CC._mul_b3(y3)
    a, b, d, e, f, g = CC._bmul_plain([
        (t4, y3), (t3, t1), (y3, t0), (t1, z3), (t0, t3), (z3, t4)])
    return (fsub(b, a), fadd(e, d), fadd(g, f))


def _identity(shape, dev):
    """(0 : 1 : 0) of ``shape`` points, three separate tensors (written in
    place by index)."""
    one = F.const(FQ, "one", dev)
    z = torch.zeros((*shape, LIMBS), dtype=torch.int32, device=dev)
    return [z, one.expand(*shape, LIMBS).clone(), z.clone()]


def accumulate_plain(px, py, rows, starts, slice: int):
    """The buckets' sums, (x, y, z) each (sets*2^c, 16): the kernels'
    slices run in lockstep, one vectorised step a place of a slice."""
    dev = px.device
    st = starts.to(torch.int64)
    nb = st.numel() - 1
    total = int(st[-1])
    bucket = _identity((nb,), dev)
    if total == 0:
        return tuple(bucket)
    threads = -(-total // slice)
    p0 = torch.arange(threads, device=dev) * slice
    p1 = torch.clamp(p0 + slice, max=total)
    at = torch.repeat_interleave(torch.arange(nb, device=dev), st[1:] - st[:-1])
    r = rows[:total].to(torch.int64)
    first, last = _identity((threads,), dev), _identity((threads,), dev)
    one = F.const(FQ, "one", dev)
    acc = [px[r[p0]], py[r[p0]], one.expand(threads, LIMBS).clone()]
    seg, cur = p0.clone(), at[p0]

    def flush(ts, end):
        """Write the accumulators of threads ``ts``, whose segment ends at
        ``end``: a whole bucket, else the slice's first or last piece."""
        g = cur[ts]
        whole = (seg[ts] == st[g]) & (st[g + 1] <= end)
        firsts = ~whole & (seg[ts] == p0[ts])
        for dest, idx, sel in ((bucket, g, whole), (first, ts, firsts),
                               (last, ts, ~whole & ~firsts)):
            for d, a in zip(dest, acc):
                d[idx[sel]] = a[ts[sel]]

    for k in range(1, slice):
        ts = torch.nonzero(p0 + k < p1).reshape(-1)
        if ts.numel() == 0:
            break
        pos = p0[ts] + k
        g = at[pos]
        new = g != cur[ts]
        if bool(new.any()):
            flush(ts[new], pos[new])
            seg[ts[new]] = pos[new]
            cur[ts[new]] = g[new]
        x2, y2 = px[r[pos]], py[r[pos]]
        old, fresh = ts[~new], ts[new]
        summed = madd_plain([a[old] for a in acc], x2[~new], y2[~new])
        for a, v, x in zip(acc, summed, (x2[new], y2[new], one)):
            a[old] = v
            a[fresh] = x
    flush(torch.arange(threads, device=dev), p1)
    _merge_plain(bucket, first, last, st, slice)
    return tuple(bucket)


def _merge_plain(bucket, first, last, st, slice: int):
    """A bucket cut by slice ends: its first slice's piece plus the next
    slices' first pieces, in slice order, all buckets in lockstep."""
    s0, e = st[:-1], st[1:]
    t0, t1 = s0 // slice, torch.clamp(e - 1, min=0) // slice
    g = torch.nonzero((e > s0) & (t1 > t0)).reshape(-1)
    if g.numel() == 0:
        return
    head = (s0[g] == t0[g] * slice)[:, None]
    acc = [torch.where(head, f[t0[g]], l[t0[g]]) for f, l in zip(first, last)]
    span = t1[g] - t0[g]
    for step in range(1, int(span.max()) + 1):
        live = torch.nonzero(span >= step).reshape(-1)
        piece = [f[t0[g[live]] + step] for f in first]
        summed = CC.add_plain([a[live] for a in acc], piece)
        for a, v in zip(acc, summed):
            a[live] = v
    for b, a in zip(bucket, acc):
        b[g] = a


def _segment_sums(points, L: int):
    """S = sum_j j P_j and T = sum_j P_j over each run of L points along
    the second-to-last axis, by running sums from the top (L = 1: S is
    the identity)."""
    p = [t.reshape(*t.shape[:-2], -1, L, LIMBS) for t in points]
    T = [t[..., L - 1, :] for t in p]
    if L == 1:
        return _identity(T[0].shape[:-1], T[0].device), T
    S = T
    for j in range(L - 2, 0, -1):
        T = CC.add_plain(T, [t[..., j, :] for t in p])
        S = CC.add_plain(S, T)
    return S, CC.add_plain(T, [t[..., 0, :] for t in p])


def _tree_sum(points):
    """Point 0 + point w of each pair w apart, halving, to one point."""
    while points[0].shape[-2] > 1:
        w = points[0].shape[-2] // 2
        points = CC.add_plain([t[..., :w, :] for t in points],
                              [t[..., w:2 * w, :] for t in points])
    return [t[..., 0, :] for t in points]


def reduce_plain(bucket, sets: int, c: int):
    """sum_b b * B_b of each set, (x, y, z) each (sets, 16), by the
    kernel's two levels: segments of L buckets give S_s = sum (b - sL)
    B_b and T_s = sum B_b; segments of L2 of the T_s give S2_q and T2_q;
    running sums give V = sum q T2_q; the result is sum S_s +
    L (sum S2_q + L2 V), the sums of S by a fixed tree."""
    lo, lo2 = _split(c)
    S, T = _segment_sums([t.reshape(sets, 1 << c, LIMBS) for t in bucket], 1 << lo)
    total = _tree_sum(S)
    S2, T2 = _segment_sums(T, 1 << lo2)
    G2 = T2[0].shape[-2]
    U = [t[:, G2 - 1] for t in T2]
    V = U
    for j in range(G2 - 2, 0, -1):
        U = CC.add_plain(U, [t[:, j] for t in T2])
        V = CC.add_plain(V, U)
    V = CC.add_plain(_tree_sum(S2), CC.double_n_plain(V, lo2))
    return tuple(CC.add_plain(total, CC.double_n_plain(V, lo)))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _launch(entries, fn, *args):
    global LAUNCHES
    LAUNCHES += len(entries)
    for e in entries:
        ENTRY_LAUNCHES[e] += 1
    _build.check(fn(*args), "msm_" + entries[0])


def digits(scalars, count: int, c: int):
    """(count*n, 16) plain limbs -> (count, W, n) digits: int64 on the
    CPU, uint16 bits in an int16 tensor on a card."""
    if scalars.device.type == "cpu":
        return digits_plain(scalars, count, c)
    if scalars.dtype != torch.int32 or not scalars.is_contiguous() \
            or scalars.shape[-1] != LIMBS or scalars.shape[0] % count:
        raise ValueError("msm digits: scalars must be contiguous int32 (count*n, 16)")
    n = scalars.shape[0] // count
    out = torch.empty((count, windows(c), n), dtype=torch.int16,
                      device=scalars.device)
    _launch(["digits"], _build.library().msm_digits_launch, out.data_ptr(),
            scalars.data_ptr(), count * n, n, c, windows(c),
            _build.stream_of(out))
    return out


def _low_bits(c: int) -> int:
    """The card's sort: bits of a digit its first pass places by."""
    return c - c // 2


def sort(digs, c: int):
    """(sets, R) digits -> (rows, starts) as ``sort_plain`` states."""
    if digs.device.type == "cpu":
        return sort_plain(digs, c)
    sets, R = digs.shape
    B, lb = 1 << c, _low_bits(c)
    if digs.dtype != torch.int16 or not digs.is_contiguous() or c > MAX_WINDOW:
        raise ValueError(f"msm sort: contiguous int16 digits and c <= {MAX_WINDOW}")
    if sets * R >= 1 << 31 or R > 1 << (32 - (c - lb)):
        raise ValueError(f"msm sort: {sets} x {R} rows overflow the sort's words")
    tiles1 = -(-R // TILE_ROWS)
    tiles2 = -(-(sets * R) // TILE_ROWS)
    dev = digs.device
    rows = torch.empty(sets * R, dtype=torch.int32, device=dev)
    starts = torch.empty(sets * B + 1, dtype=torch.int32, device=dev)
    list1 = torch.empty(sets * R, dtype=torch.int32, device=dev)
    scratch = torch.empty(sets * (B + (tiles1 << lb) + (tiles2 << (c - lb))),
                          dtype=torch.int32, device=dev)
    _launch(["histogram", "starts", "tilescan", "pass1", "histogram2", "tilescan",
             "pass2"], _build.library().msm_sort_launch, rows.data_ptr(),
            starts.data_ptr(), list1.data_ptr(), scratch.data_ptr(), digs.data_ptr(),
            sets, R, c, lb, tiles1, TILE_ROWS, tiles2, TILE_ROWS,
            _build.stream_of(rows))
    return rows, starts


def _xy_operand(px, py):
    """Base pointers and the row stride (int32 words) of the points: the
    halves of a (rows, 32) table or two (n, 16) tensors."""
    stride = px.stride(0)
    if px.stride(-1) != 1 or py.stride(0) != stride or stride % 4 \
            or px.storage_offset() % 4 or py.storage_offset() % 4:
        raise ValueError("msm accumulate: points must be rows of 16 limbs")
    return px.data_ptr(), py.data_ptr(), stride


def accumulate(px, py, rows, starts, slice: int):
    """The buckets' sums (x, y, z) each (nb, 16) over the points
    (px[r], py[r]) of every listed row r."""
    if px.device.type == "cpu":
        return accumulate_plain(px, py, rows, starts, slice)
    dev = px.device
    nb = starts.numel() - 1
    threads = max(1, -(-rows.numel() // slice))
    bucket = [torch.empty((nb, LIMBS), dtype=torch.int32, device=dev) for _ in range(3)]
    pieces = [torch.empty((threads, LIMBS), dtype=torch.int32, device=dev)
              for _ in range(6)]
    words, n0 = _build.modulus_args(FQ.modulus)
    _launch(["accumulate", "merge"], _build.library().msm_accumulate_launch,
            *(t.data_ptr() for t in bucket), *(t.data_ptr() for t in pieces),
            rows.data_ptr(), starts.data_ptr(), nb, *_xy_operand(px, py), slice,
            threads, F.const(FQ, "one", dev).data_ptr(), ctypes.addressof(words),
            n0, _build.stream_of(rows))
    return tuple(bucket)


def reduce(bucket, sets: int, c: int):
    """sum_b b * B_b of each set: (x, y, z) each (sets, 16)."""
    if bucket[0].device.type == "cpu":
        return reduce_plain(bucket, sets, c)
    dev = bucket[0].device
    out = CC._outputs(sets, dev)
    words, n0 = _build.modulus_args(FQ.modulus)
    _launch(["reduce"], _build.library().msm_reduce_launch,
            *(t.data_ptr() for t in out), *(t.data_ptr() for t in bucket),
            F.const(FQ, "one", dev).data_ptr(), sets, c, *_split(c),
            ctypes.addressof(words), n0, _build.stream_of(out[0]))
    return out


def bucket_sums(points, scalars, count: int, c: int, tables=None,
                slice: int | None = None):
    """One pass: with ``tables`` ((W*n, 32), window w at rows [w*n,
    (w+1)*n)) the ``count`` commitments sum_i s_i P_i, one set each;
    without, the window sums sum_b b * B_{w,b} of one commitment
    (count 1), one set a window.  ``scalars`` (count*n, 16) PLAIN Fr
    limbs.  Returns (x, y, z) each (sets, 16).  One ``msm.buckets`` span
    (utils/timers.py): ``fused`` (1: K7), ``sets``, ``buckets`` (2^c),
    ``rows`` (table or point rows the pass sorts), ``windows``,
    ``points`` (n)."""
    px, py = points
    n = px.shape[0]
    W = windows(c)
    if c < 2 or scalars.shape != (count * n, LIMBS):
        raise ValueError(f"msm buckets: c = {c}, scalars {tuple(scalars.shape)} "
                         f"for {count} x {n}")
    if tables is not None:
        if tables.shape != (W * n, 2 * LIMBS):
            raise ValueError("msm buckets: tables must be (W*n, 32)")
        px, py = tables[:, :LIMBS], tables[:, LIMBS:]
        sets, R = count, W * n
    elif count != 1:
        raise ValueError("msm buckets: without tables one commitment a pass")
    else:
        sets, R = W, n
    fused = int(scalars.device.type == "cuda")
    with timers.span("msm.buckets", fused=fused, sets=sets, buckets=1 << c,
                     rows=sets * R, windows=W, points=n):
        digs = digits(scalars, count, c).reshape(sets, R)
        rows, starts = sort(digs, c)
        del digs
        if slice is None:
            slice = slice_len(sets * R, sets << c, scalars.device)
        bucket = accumulate(px, py, rows, starts, slice)
        del rows
        return reduce(bucket, sets, c)
