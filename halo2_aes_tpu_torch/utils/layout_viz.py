"""Circuit layout renderer.

Role of the reference's dev-graph feature (reference src/aes128.rs:
437-456: CircuitLayout -> prints/aes128-layout.png).  Renders column
occupancy (advice witness map, fixed/selector/table fill) as a PNG,
written with a dependency-free encoder (zlib + struct from stdlib).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from halo2_aes_tpu_torch.circuit.ir import ADVICE, FIXED, INSTANCE, CompiledCircuit

_KIND_COLOR = {
    ADVICE: (220, 60, 60),     # red-ish: assigned advice
    FIXED: (70, 110, 220),     # blue-ish: nonzero fixed
    INSTANCE: (240, 180, 40),  # amber: instance
}
_EMPTY = (245, 245, 245)
_BLIND = (180, 180, 180)


def _write_png(path: str, rgb: np.ndarray) -> None:
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def render(layout: CompiledCircuit, path: str, max_rows: int = 4096) -> None:
    """One pixel column per circuit column, rows downsampled to max_rows."""
    n = layout.n
    num_cols = len(layout.cs.columns)
    rows = min(n, max_rows)
    stride = max(1, n // rows)
    col_px = 8
    img = np.empty((rows, num_cols * col_px, 3), dtype=np.uint8)
    usable = layout.usable_rows

    for c, col in enumerate(layout.cs.columns):
        if col.kind == ADVICE:
            occupied = layout.witness_map[c] >= 0
        else:
            occupied = layout.fixed[c] != 0
        color = _KIND_COLOR[col.kind]
        for r in range(rows):
            base = r * stride
            seg = occupied[base : base + stride]
            if base >= usable:
                px = _BLIND
            elif seg.any():
                frac = seg.mean()
                px = tuple(int(e + (c2 - e) * frac)
                           for e, c2 in zip(_EMPTY, color))
            else:
                px = _EMPTY
            img[r, c * col_px : (c + 1) * col_px - 1] = px
            img[r, (c + 1) * col_px - 1] = (120, 120, 120)  # separator
    _write_png(path, img)
