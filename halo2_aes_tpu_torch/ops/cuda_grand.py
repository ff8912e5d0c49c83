"""K6: one grand-product column (a lookup's z or a permutation chunk's z)
from its input columns, CUDA kernel + plain PyTorch version.

Replaces no TPU kernel: the reference builds the columns from eager field
ops (``F.batch_inv``'s two log-step scans and one Fermat inversion, then
``F.cumprod``) and leaves the fusion to XLA; the port ran the same ops
eagerly (``lookup.grand_product_eager``,
``permutation.grand_products_eager``).  K6 (``csrc/grand_product.cu``)
writes the finished column in three launches whatever its length, with
one inversion a column:

    z[j] = init * D^-1 * prod_{r<j} num_r * prod_{r>=j} den_r

(D the product of every row's denominator), as tile products, the tile
offsets with the inversion, then the rows of each tile.  Rows from
``usable`` on take the ratio 1, a zero denominator the ratio 0 (as
``F.batch_inv`` maps 0 to 0), and the last ``bf`` rows the blinding.
What bounds it and how: see the source.

CPU tensors take ``grand_product_plain``, which repeats the kernel's
decomposition with the field's tensor ops over tiles of ``tile`` rows
(the tests force several tiles and a ragged last one); CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from halo2_aes_tpu_torch.ops import _build
from halo2_aes_tpu_torch.ops import field as F

FR = F.FR
LIMBS = F.LIMBS
LAUNCHES = 0      # kernel launches since the last reset (chip_smoke reads it)
SOURCE = "halo2_aes_tpu_torch/csrc/grand_product.cu"
REPLACES = ("none: the eager batch_inv / cumprod columns of "
            "backend/lookup.py and backend/permutation.py")
TILE = 512        # rows a block (THREADS * ROWS in the source)
MAX_COLS = 16     # columns of a permutation chunk the kernel takes
LOOKUP, PERM = 0, 1


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def lookup_factors(a, s, a_perm, s_perm, table):
    """A lookup's row factors: (A+beta)(S+gamma), (A'+beta)(S'+gamma);
    ``table`` rows beta, gamma."""
    beta, gamma = table[0], table[1]
    num = F.mont_mul(FR, F.add(FR, a, beta), F.add(FR, s, gamma))
    den = F.mont_mul(FR, F.add(FR, a_perm, beta), F.add(FR, s_perm, gamma))
    return num, den


def perm_factors(fld, n: int, cols, map_col, map_row, omega, table):
    """A permutation chunk's row factors: prod_i (v_i + beta delta^i
    omega^row + gamma) and prod_i (v_i + beta sigma_i(row) + gamma) over
    ``cols`` = [(column of ``fld``, permutation column i)]; ``table`` rows
    gamma, then beta delta^i for every permutation column."""
    num = den = None
    for col, i in cols:
        v = F.add(FR, fld[col * n:(col + 1) * n], table[0])
        x = F.add(FR, F.mont_mul(FR, table[1 + i], omega), v)
        y = F.add(FR, F.mont_mul(FR, table[1 + map_col[i]], omega[map_row[i]]), v)
        num = x if num is None else F.mont_mul(FR, num, x)
        den = y if den is None else F.mont_mul(FR, den, y)
    return num, den


def _exclusive(incl, dim: int, one):
    """An inclusive product scan along ``dim`` made exclusive."""
    head = one.expand(*incl.shape[:dim], 1, *incl.shape[dim + 1:])
    return torch.cat([head, incl.narrow(dim, 0, incl.shape[dim] - 1)], dim)


def grand_product_plain(num, den, n: int, usable: int, init, blinding,
                        tile: int = TILE):
    """The z columns of S segments of n rows (FLAT (S*n, 16) factors;
    ``init`` (S, 16); ``blinding`` (S, bf, 16)) by K6's decomposition:
    the tiles' products, each tile's offset K_t = init * D^-1 *
    prod_{s<t} N_s * prod_{s>t} D_s with one inversion a segment, then
    inside each tile the numerators' exclusive prefix and the
    denominators' inclusive suffix."""
    S, bf = blinding.shape[:2]
    dev = num.device
    one = F.const(FR, "one", dev)
    live = torch.arange(S * n, device=dev) % n < usable
    zero = F.is_zero(den)
    num = F.select(live & ~zero, num, F.select(live, torch.zeros_like(one), one))
    den = F.select(live & ~zero, den, one)
    tile = min(tile, n)
    tiles = -(-n // tile)
    pad = tiles * tile - n

    def tiled(x):
        x = x.reshape(S, n, LIMBS)
        if pad:
            x = torch.cat([x, one.expand(S, pad, LIMBS)], 1)
        return x.reshape(S, tiles, tile, LIMBS)

    num, den = tiled(num), tiled(den)
    # reduce: each tile's products N_t, D_t
    pn_incl = F._scan(FR, num, 2)
    sd = F._scan(FR, den.flip(2), 2).flip(2)          # prod_{r>=j} in the tile
    n_t, d_t = pn_incl[:, :, -1], sd[:, :, 0]
    # middle: the tiles' offsets, one inversion a segment
    pn_t = _exclusive(F._scan(FR, n_t, 1), 1, one)
    sd_t = F._scan(FR, d_t.flip(1), 1).flip(1)        # prod_{s>=t}
    scale = F.mont_mul(FR, F.inv(FR, sd_t[:, 0]), init)
    sd_t = torch.cat([sd_t[:, 1:], one.expand(S, 1, LIMBS)], 1)
    k_t = F.mont_mul(FR, F.mont_mul(FR, pn_t, sd_t), scale[:, None])
    # finish: the rows of each tile
    z = F.mont_mul(FR, F.mont_mul(FR, _exclusive(pn_incl, 2, one), sd),
                   k_t[:, :, None])
    z = z.reshape(S, tiles * tile, LIMBS)[:, :n].clone()
    z[:, n - bf:] = blinding
    return z.reshape(S * n, LIMBS)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _check(n: int, usable: int, bf: int) -> None:
    if not 0 <= bf < n or not 0 < usable < n - bf:
        raise ValueError(f"grand_product: usable {usable} and {bf} blinding "
                         f"rows do not fit {n} rows")


@functools.lru_cache(maxsize=None)
def _words(power: int):
    """R^power mod p as 8 little-endian u32 words in a ctypes array."""
    r = pow(1 << F.NBITS, power, FR.modulus)
    return (ctypes.c_uint32 * 8)(*[(r >> (32 * i)) & 0xFFFFFFFF for i in range(8)])


def _launch(kind: int, out, ins, table, init, blinding, n: int, usable: int,
            segments: int, cols=()):
    limbs = (out, *([ins[0], ins[3]] if kind == PERM else ins), table, init,
             blinding)
    maps = ins[1:3] if kind == PERM else ()
    if any(t.device != out.device for t in (*limbs, *maps)):
        raise ValueError("grand_product: operands on more than one device")
    if any(t.dtype != torch.int32 or not t.is_contiguous() for t in limbs):
        raise TypeError("grand_product: limb operands must be contiguous int32")
    if any(t.dtype != torch.int64 or not t.is_contiguous() for t in maps):
        raise TypeError("grand_product: sigma maps must be contiguous int64")
    if kind == LOOKUP:
        bad = any(t.shape != out.shape for t in ins) or out.shape[0] != segments * n
    else:
        m = maps[0].shape[0]
        bad = (not 1 <= len(cols) <= MAX_COLS or out.shape[0] != n
               or ins[0].shape[0] % n or ins[3].shape[0] < n
               or any(t.shape != (m, n) for t in maps) or table.shape[0] != 1 + m
               or any(not 0 <= c < ins[0].shape[0] // n or not 0 <= i < m
                      for c, i in cols))
    if bad:
        raise ValueError("grand_product: bad shapes")
    words, n0 = _build.modulus_args(FR.modulus)
    tiles = -(-n // TILE)
    scratch = torch.empty((3 * segments * tiles * 8,), dtype=torch.int32,
                          device=out.device)
    col = (ctypes.c_int64 * max(1, len(cols)))(*[c for c, _ in cols])
    idx = (ctypes.c_int32 * max(1, len(cols)))(*[i for _, i in cols])
    global LAUNCHES
    LAUNCHES += 3
    code = _build.library().grand_product_launch(
        kind, out.data_ptr(), scratch.data_ptr(),
        *(t.data_ptr() for t in ins), table.data_ptr(), init.data_ptr(),
        blinding.data_ptr(), n, usable, blinding.shape[-2],
        segments, len(cols), ctypes.addressof(col), ctypes.addressof(idx),
        ctypes.addressof(words), n0, ctypes.addressof(_words(1)),
        ctypes.addressof(_words(3)), _build.stream_of(out))
    _build.check(code, "grand_product")
    return out


def lookup_z(a, s, a_perm, s_perm, usable: int, beta_m, gamma_m, blinding,
             tile: int = TILE):
    """The z columns of L lookups over FLAT (L*n, 16) columns A, S, A',
    S' (lookup l at rows [l*n, (l+1)*n)); ``blinding`` (L, bf, 16):
    z[0] = 1, z[j+1] = z[j] (A+beta)(S+gamma) / ((A'+beta)(S'+gamma))
    below ``usable``, then the blinding rows.  One launch sequence for
    all L.  ``tile``: the plain version's tile rows (the kernel's are
    ``TILE``)."""
    L = blinding.shape[0]
    n = a.shape[0] // L
    _check(n, usable, blinding.shape[1])
    table = torch.stack([beta_m.reshape(LIMBS), gamma_m.reshape(LIMBS)])
    one = F.const(FR, "one", a.device)
    if a.device.type == "cpu":
        return grand_product_plain(*lookup_factors(a, s, a_perm, s_perm, table),
                                   n, usable, one.expand(L, LIMBS), blinding, tile)
    out = torch.empty_like(a)
    return _launch(LOOKUP, out, (a, s, a_perm, s_perm), table, one,
                   blinding.contiguous(), n, usable, L)


def perm_table(beta_m, gamma_m, delta_pows):
    """A permutation argument's constants: gamma, then beta delta^i."""
    return torch.cat([gamma_m.reshape(1, LIMBS),
                      F.mont_mul(FR, beta_m.reshape(LIMBS), delta_pows)])


def perm_z(fld, cols, map_col, map_row, omega, table, usable: int, init,
           blinding, out, tile: int = TILE):
    """One permutation chunk's z column into ``out`` (n, 16): z[0] =
    ``init`` (one element: 1, or the previous chunk's z at ``usable``),
    z[j+1] = z[j] prod_i (v_i + beta delta^i omega^j + gamma) /
    prod_i (v_i + beta sigma_i(j) + gamma) below ``usable``, then the
    ``blinding`` rows (bf, 16).  ``fld``: the columns' evaluations, n
    rows each; ``cols``: [(column of ``fld``, permutation column i)];
    ``map_col`` / ``map_row`` (m, n): sigma's column and row; ``omega``
    (n, 16); ``table``: ``perm_table``; ``tile`` as in ``lookup_z``."""
    n = out.shape[0]
    _check(n, usable, blinding.shape[0])
    if out.device.type == "cpu":
        out.copy_(grand_product_plain(
            *perm_factors(fld, n, cols, map_col, map_row, omega, table),
            n, usable, init.reshape(1, LIMBS), blinding[None], tile))
        return out
    return _launch(PERM, out, (fld, map_col, map_row, omega), table, init,
                   blinding.contiguous(), n, usable, 1, cols)
