"""K5: nibble products on the int8 tensor cores, CUDA kernel + plain
PyTorch versions.

Replaces the int8 products of ``halo2_aes_tpu/ops/mxu_field.py``:
``_dot_i8`` (:174, a bf16 ``dot_general`` with f32 sums) and the raw int8
``dot_general`` of ``BatchedDftMatmul`` (:311).  Those are XLA products on
the TPU's matrix unit, not Pallas kernels; every int8 product of the
port's ``ops/mxu_field.py`` goes through this module.

    out[g, r, b*olb + j] = sum_{s<4} conv[g, r, b*blk + 4j + s] << 4s
    conv[g, r, :]        = nibbles(x[g, r, :L]) @ B[g]

``x`` is int32 (G, rows, L) 16-bit limbs, ``B`` int8 (G, 4L, M) with
entries 0..15, ``block`` (blk) divides M, and ``out`` is int32 (G, rows,
(M / blk) * ceil(blk / 4)): each block of blk product columns folds into
its own redundant 16-bit limbs (a DFT's n outputs of 127 columns each).
Every limb is below 225 * 4L * 4369, which is below 2^31 for
4L <= ``MAX_NIBBLES``.

Two entries:

  * ``nibble_product(x, B, block, packed=)``: the folded limbs above;
  * ``nibble_normalize(x, B, block, width, addend=, packed=)``: each
    column block's limbs plus an optional int32 addend row (G, rows, A),
    A <= width, carried into ``width`` canonical 16-bit limbs with the
    carry out of the top limb dropped: ``mxu_field.carry_norm_ks`` of
    (fold + addend) per block.  Out: int32 (G, rows, (M / blk) * width).
    The addend is canonical 16-bit limbs (0 <= a < 2^16); both devices
    take each entry mod 2^16.

On the card B is read in a layout made once per operand (``pack``,
``PackedB``, which keeps the B it was packed from: the entries take it
only with that same B): per column tile and k-step (32 nibble rows) the tile's
chunks of four 8-column n-tiles that hold a non-zero entry, each n-tile
256 bytes in the core-matrix order of wgmma's K-major B (k 0-15 of its 8
columns, a 16-byte row a column, then k 16-31), with a bit mask of the
chunks kept and an offset table.  A column tile holds whole column
blocks where a block fits (``tile_limbs``), so the kernel can carry a
block in its epilogue; its padded columns (127 -> 128, 131 -> 132) are
zeros in the packed data.

Kernel (``csrc/nibble_mma.cu``): ``wgmma.mma_async`` m64nNk32 s8 x s8 ->
s32 with A from registers (the nibbles made from the limbs) and B from
shared memory, one wgmma a kept chunk; B and the rows of x streamed
into a ring in shared memory (``cp.async.bulk`` and ``cp.async`` on
``mbarrier``s) by a producer warp; no copy and no product for a zero
chunk; the fold and (``nibble_normalize``) the carry in the epilogue.
What bounds it on an H100: the bytes of x, B and out over 3.35 TB/s, or
the band's non-zero multiply-adds over the int8 tensor cores' dense
989.5e12/s.

CPU tensors take the plain versions; CUDA tensors launch K5 or raise.
The plain product multiplies in float64, which is exact here: every
partial sum is an integer below 2^53.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from halo2_aes_tpu_torch.ops import _build

LAUNCHES = 0      # kernel launches since the last reset (chip_smoke reads it)
ENTRY_LAUNCHES = {"product": 0, "normalize": 0}   # the same, by entry
SOURCE = "halo2_aes_tpu_torch/csrc/nibble_mma.cu"
REPLACES = "halo2_aes_tpu/ops/mxu_field.py:174,311"

FOLD = (1, 16, 256, 4096)
# the most nibble rows for which every folded limb stays below 2^31
MAX_NIBBLES = ((1 << 31) - 1) // (225 * sum(FOLD))
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

KSTEP = 32           # nibble rows of one k-step (m64nNk32)
NTILE = 8            # product columns of one n-tile (two limbs)
FRAG = 256           # bytes of one packed (k-step, n-tile) B fragment
CHUNK = 4            # n-tiles a chunk: the kernel's unit of skipping
MAX_TILE_LIMBS = 34  # limbs of one column tile (17 n-tiles; the kernel's NT)
MAX_WIDTH = 64       # most limbs ``nibble_normalize`` writes a block


def nibbles(x, dtype=torch.int8):
    """(..., L) 16-bit limbs -> (..., 4L) nibbles (0..15), lowest first."""
    shifts = torch.tensor([0, 4, 8, 12], dtype=torch.int32, device=x.device)
    nib = (x.to(torch.int32)[..., None] >> shifts) & 0xF
    return nib.reshape(*x.shape[:-1], x.shape[-1] * 4).to(dtype)


def fold(conv, block: int):
    """int64 (G, rows, M) product columns -> int32 (G, rows, (M / block) *
    ceil(block / 4)) limbs, each column block folded on its own."""
    g, rows, m = conv.shape
    olb = -(-block // 4)
    c = conv.reshape(g, rows, m // block, block)
    c = torch.nn.functional.pad(c, (0, 4 * olb - block))
    w = torch.tensor(FOLD, dtype=torch.int64, device=conv.device)
    limbs = (c.reshape(g, rows, m // block, olb, 4) * w).sum(-1)
    return limbs.reshape(g, rows, -1).to(torch.int32)


def out_limbs(m: int, block: int) -> int:
    return (m // block) * -(-block // 4)


def nibble_product_plain(x, B, block: int | None = None):
    """The same function in plain PyTorch on any device: float64 product
    (exact, see the module note), int64 fold."""
    m = B.shape[-1]
    conv = torch.bmm(nibbles(x, torch.float64), B.to(torch.float64))
    return fold(conv.to(torch.int64), block or m)


def carry_blocks_plain(limbs, olb: int, width: int, addend=None):
    """int32 (G, rows, nblk * olb) folded limbs (+ int32 (G, rows, A)
    added to every block, each entry mod 2^16) -> int32 (G, rows, nblk *
    width): each block carried on its own into ``width`` 16-bit limbs,
    the top carry dropped.  A plain int64 ripple, limb by limb."""
    g, rows, n = limbs.shape
    v = limbs.to(torch.int64).reshape(g, rows, n // olb, olb)
    v = torch.nn.functional.pad(v, (0, max(width - olb, 0)))[..., :width]
    if addend is not None:
        a = addend.to(torch.int64)[:, :, None, :] & LIMB_MASK
        v = v + torch.nn.functional.pad(a, (0, width - a.shape[-1]))
    out = torch.empty_like(v)
    carry = torch.zeros_like(v[..., 0])
    for j in range(width):
        s = v[..., j] + carry
        out[..., j] = s & LIMB_MASK
        carry = s >> LIMB_BITS
    return out.reshape(g, rows, -1).to(torch.int32)


def nibble_normalize_plain(x, B, block: int | None, width: int, addend=None):
    """``nibble_normalize`` in plain PyTorch: the plain product, then each
    block's limbs plus the addend carried into ``width`` limbs."""
    block = block or B.shape[-1]
    return carry_blocks_plain(nibble_product_plain(x, B, block),
                              -(-block // 4), width, addend)


# --------------------------------------------------------------------------
# the packed B
# --------------------------------------------------------------------------

def tile_limbs(olb: int, nblk: int) -> int:
    """Limbs of one column tile: as many whole column blocks as fit in
    ``MAX_TILE_LIMBS`` (so the epilogue can carry a block), else the most
    limbs a tile holds (a block then spans tiles; no carry entry)."""
    if olb > MAX_TILE_LIMBS:
        return MAX_TILE_LIMBS
    return min(MAX_TILE_LIMBS // olb, nblk) * olb


@dataclass(frozen=True)
class PackedB:
    """B in K5's layout (module note), made by ``pack``.

    ``data``: uint8 (n_frags, 256), the n-tiles of the kept chunks in
    (group, tile, k-step, n-tile) order; ``masks``: int32 (G, tiles,
    ksteps), bit c set where chunk c (n-tiles 4c .. 4c + 3) of that
    k-step is kept; ``offsets``: int32 (G * tiles * ksteps + 1,), the
    first fragment of each k-step; ``source``: the B it was packed
    from."""
    data: torch.Tensor
    masks: torch.Tensor
    offsets: torch.Tensor
    shape: tuple          # B's (G, K, M)
    block: int
    olb: int
    nlimbs: int
    tile_limbs: int
    ntc: int              # n-tiles a column tile
    tiles: int
    ksteps: int
    source: torch.Tensor

    @property
    def device(self):
        return self.data.device


def _padded_columns(m: int, block: int):
    """(tile_limbs, ntc, tiles, olb, nlimbs, src): src (tiles * ntc * 8,)
    int64, the B column of each padded column, -1 where it is zero."""
    olb = -(-block // 4)
    nblk = m // block
    nlimbs = nblk * olb
    tl = tile_limbs(olb, nblk)
    ntc = -(-tl // 2)
    tiles = -(-nlimbs // tl)
    pc = torch.arange(ntc * NTILE)
    limb = torch.arange(tiles)[:, None] * tl + pc // 4
    valid = (pc // 4 < tl) & (limb < nlimbs)
    b = limb // olb
    cc = 4 * (limb - b * olb) + pc % 4
    valid &= cc < block
    src = torch.where(valid, b * block + cc, torch.full_like(cc, -1))
    return tl, ntc, tiles, olb, nlimbs, src.reshape(-1)


def _fragments(Bp, g: int, ksteps: int, tiles: int, ntc: int):
    """(G, ksteps * 32, tiles * ntc * 8) padded B -> (G, tiles, ksteps,
    ntc, 256): an n-tile is two 8 x 16-byte core matrices (nibble rows
    0-15, then 16-31), column n's 16 rows at byte 16 n, lowest row first."""
    v = Bp.reshape(g, ksteps, 2, 16, tiles, ntc, NTILE)
    # (g, ks, half, k, tile, nt, col) -> (g, tile, ks, nt, half, col, k)
    return v.permute(0, 4, 1, 5, 2, 6, 3).reshape(g, tiles, ksteps, ntc, FRAG)


def _chunk_kept(nz, ntc: int):
    """bool (..., ntc) non-zero n-tiles -> bool (..., ntc): every n-tile of
    a chunk that holds one."""
    nch = -(-ntc // CHUNK)
    pad = torch.nn.functional.pad(nz, (0, nch * CHUNK - ntc))
    chunk = pad.reshape(*nz.shape[:-1], nch, CHUNK).any(-1)
    return chunk.repeat_interleave(CHUNK, -1)[..., :ntc]


def pack(B, block: int | None = None) -> PackedB:
    """int8 (G, 4L, M) B -> ``PackedB`` on B's device.  A chunk (a k-step
    of 4 n-tiles) is dropped only when all of its entries are zero."""
    g, k, m = B.shape
    block = block or m
    if m == 0 or m % block:
        raise ValueError(f"pack: block {block} does not divide {m} columns")
    tl, ntc, tiles, olb, nlimbs, src = _padded_columns(m, block)
    ksteps = -(-k // KSTEP)
    src = src.to(B.device)
    keep = src >= 0
    Bp = torch.zeros((g, ksteps * KSTEP, src.numel()), dtype=torch.uint8,
                     device=B.device)
    Bp[:, :k, keep] = B.view(torch.uint8)[:, :, src[keep]]
    frags = _fragments(Bp, g, ksteps, tiles, ntc)
    nz = _chunk_kept(frags.ne(0).any(-1), ntc)             # (g, tiles, ks, ntc)
    bits = torch.arange(ntc, device=B.device) // CHUNK
    first = torch.arange(ntc, device=B.device) % CHUNK == 0
    masks = ((nz & first).to(torch.int64) << bits).sum(-1).to(torch.int32)
    counts = nz.sum(-1).reshape(-1)
    offsets = torch.zeros(counts.numel() + 1, dtype=torch.int32, device=B.device)
    offsets[1:] = torch.cumsum(counts, 0)
    data = frags[nz]
    if data.shape[0] == 0:               # an all-zero B: one fragment, never read
        data = torch.zeros((1, FRAG), dtype=torch.uint8, device=B.device)
    return PackedB(data.contiguous(), masks, offsets, (g, k, m), block, olb,
                   nlimbs, tl, ntc, tiles, ksteps, B)


def _kept(pk: PackedB):
    """bool (G, tiles, ksteps, ntc): the n-tiles ``pk`` keeps."""
    bits = torch.arange(pk.ntc, device=pk.device) // CHUNK
    return (pk.masks[..., None] >> bits) & 1 == 1


def _padded(pk: PackedB):
    """The padded (G, ksteps * 32, tiles * ntc * 8) B from the packed data
    alone (zeros where a fragment was dropped)."""
    g = pk.shape[0]
    frags = torch.zeros((g, pk.tiles, pk.ksteps, pk.ntc, FRAG), dtype=torch.uint8,
                        device=pk.device)
    kept = _kept(pk)
    frags[kept] = pk.data[:int(kept.sum())]
    v = frags.reshape(g, pk.tiles, pk.ksteps, pk.ntc, 2, NTILE, 16)
    # (g, tile, ks, nt, half, col, k) -> (g, ks, half, k, tile, nt, col)
    v = v.permute(0, 2, 4, 6, 1, 3, 5)
    return v.reshape(g, pk.ksteps * KSTEP, pk.tiles * pk.ntc * NTILE)


def unpack(pk: PackedB):
    """``PackedB`` -> the int8 (G, 4L, M) B it was packed from."""
    g, k, m = pk.shape
    *_, src = _padded_columns(m, pk.block)
    src = src.to(pk.device)
    keep = src >= 0
    B = torch.empty((g, k, m), dtype=torch.uint8, device=pk.device)
    B[:, :, src[keep]] = _padded(pk)[:, :k, keep]
    return B.view(torch.int8)


def packed_product_plain(x, pk: PackedB):
    """``nibble_product`` computed as the kernel reads the packed layout:
    the nibbles times each padded column tile, four padded columns a
    limb, the first ``tile_limbs`` limbs of each tile in order."""
    g, rows, _ = x.shape
    k = pk.shape[1]
    conv = torch.bmm(nibbles(x, torch.float64),
                     _padded(pk)[:, :k].to(torch.float64)).to(torch.int64)
    w = torch.tensor(FOLD, dtype=torch.int64, device=x.device)
    limbs = (conv.reshape(g, rows, pk.tiles, 2 * pk.ntc, 4) * w).sum(-1)
    limbs = limbs[..., :pk.tile_limbs].reshape(g, rows, -1)
    return limbs[..., :pk.nlimbs].to(torch.int32)


# --------------------------------------------------------------------------
# the entries
# --------------------------------------------------------------------------

def _check(x, B, block):
    if x.dtype != torch.int32:
        raise TypeError(f"nibble_product: x must be int32 limbs, not {x.dtype}")
    if B.dtype != torch.int8:
        raise TypeError(f"nibble_product: B must be int8, not {B.dtype}")
    if x.dim() != 3 or B.dim() != 3:
        raise ValueError(f"nibble_product: want x (G, rows, L), B (G, 4L, M); "
                         f"got {tuple(x.shape)} {tuple(B.shape)}")
    g, rows, limbs = x.shape
    m = B.shape[2]
    block = block or m
    if B.shape[0] != g or B.shape[1] != 4 * limbs or m == 0 or m % block:
        raise ValueError(f"nibble_product: x {tuple(x.shape)}, B {tuple(B.shape)} "
                         f"and block {block} do not fit")
    if 4 * limbs > MAX_NIBBLES:
        raise ValueError(f"nibble_product: {4 * limbs} nibble rows exceed "
                         f"{MAX_NIBBLES}, the int32 bound of a folded limb")
    if x.device != B.device:
        raise ValueError(f"nibble_product: x on {x.device}, B on {B.device}")
    if not (x.is_contiguous() and B.is_contiguous()):
        raise ValueError("nibble_product: x and B must be contiguous")
    return g, rows, limbs, m, block


def _check_packed(pk, B, block):
    if pk is None:
        return None
    if pk.source is not B:
        raise ValueError("nibble_product: the packed operand was not packed "
                         "from this B")
    if pk.block != block:
        raise ValueError(f"nibble_product: packed operand of block {pk.block} "
                         f"is not B's block {block}")
    return pk


def _check_width(x, block, width, addend):
    olb = -(-block // 4)
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"nibble_normalize: width {width} not in 1..{MAX_WIDTH}")
    if olb > MAX_TILE_LIMBS:
        raise ValueError(f"nibble_normalize: a block of {block} columns "
                         f"({olb} limbs) exceeds a tile's {MAX_TILE_LIMBS}")
    if addend is None:
        return
    if (addend.dtype != torch.int32 or addend.dim() != 3
            or addend.shape[:2] != x.shape[:2] or addend.shape[2] > width
            or not addend.is_contiguous() or addend.device != x.device):
        raise ValueError(f"nibble_normalize: the addend must be contiguous int32 "
                         f"(G, rows, A <= {width}) on {x.device}, not "
                         f"{addend.dtype} {tuple(addend.shape)} on {addend.device}")


def _launch(x, pk: PackedB, width: int, addend, n_out: int):
    g, rows, limbs = x.shape
    out = torch.empty((g, rows, n_out), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    global LAUNCHES
    LAUNCHES += 1
    ENTRY_LAUNCHES["normalize" if width else "product"] += 1
    code = _build.library().nibble_mma_launch(
        out.data_ptr(), x.data_ptr(), pk.data.data_ptr(), pk.offsets.data_ptr(),
        pk.masks.data_ptr(), None if addend is None else addend.data_ptr(),
        g, rows, limbs, pk.ksteps, pk.tiles, pk.tile_limbs, pk.olb, pk.nlimbs,
        width, 0 if addend is None else addend.shape[2], _build.stream_of(out))
    _build.check(code, "nibble_product")
    return out


def _device(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nibble_product: no kernel for {x.device}")
    return x.device.type


def nibble_product(x, B, block: int | None = None, packed: PackedB | None = None):
    """Nibble product plus fold (module note).  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise), on ``packed``
    (``pack(B, block)``, made here when it is not given)."""
    g, rows, limbs, m, block = _check(x, B, block)
    pk = _check_packed(packed, B, block)
    if _device(x) == "cpu":
        return nibble_product_plain(x, B, block)
    pk = pack(B, block) if pk is None else pk
    return _launch(x, pk, 0, None, pk.nlimbs)


def nibble_normalize(x, B, block: int | None, width: int, addend=None,
                     packed: PackedB | None = None):
    """Nibble product, fold, addend and carry (module note): int32 (G,
    rows, (M / block) * width) canonical 16-bit limbs.  ``addend`` is
    canonical 16-bit limbs; any other entry is taken mod 2^16, on both
    devices.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise)."""
    g, rows, limbs, m, block = _check(x, B, block)
    _check_width(x, block, width, addend)
    pk = _check_packed(packed, B, block)
    if _device(x) == "cpu":
        return nibble_normalize_plain(x, B, block, width, addend)
    pk = pack(B, block) if pk is None else pk
    return _launch(x, pk, width, addend, (m // block) * width)
