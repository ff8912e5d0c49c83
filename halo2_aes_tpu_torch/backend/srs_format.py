"""halo2 `ParamsKZG` wire-format reader/writer (`ptau/kzg_bn254_{k}.srs`;
port of ``backend/srs_format.py``).

The reference driver loads/saves its SRS in halo2's ParamsKZG
serialization (reference src/main.rs:69-75).  This module reads and
writes that format so a Rust-produced `.srs` file can be loaded
directly, and our dev SRS can be exported for a Rust cross-check.

Layout (halo2 PSE v0.3.0 `ParamsKZG::write_custom`, SerdeFormat::
RawBytes — the default `Params::read` path the reference uses):

    k:          u32 LE
    g:          n = 2^k G1 points, 64 bytes each (x || y)
    g_lagrange: n G1 points, 64 bytes each
    g2:         G2 point, 128 bytes (x.c0 || x.c1 || y.c0 || y.c1)
    s_g2:       G2 point, 128 bytes

Every base-field element is the INTERNAL Montgomery representation
(value * 2^256 mod p) as 32-byte little-endian — which is byte-for-byte
our own limb layout (16 u16 LE limbs, Montgomery, R = 2^256), so G1
tables convert by reinterpretation alone.  Identity encodes as zeros.

The format is implemented from the halo2curves v0.6.1
`SerdeObject::to_raw_bytes` definition and validated by self round-trip,
on-curve checks and byte equality with the reference package's file for
the same dev SRS; no Rust artifact was at hand for a byte-level
cross-check (see BASELINE.md).
"""

from __future__ import annotations

import numpy as np

from halo2_aes_tpu_torch.ops import field as F

FQ = F.FQ
Q = FQ.modulus


def _fq_to_raw(v: int) -> bytes:
    """Plain int -> 32-byte LE Montgomery raw bytes."""
    return FQ.to_mont_host(v % Q).to_bytes(32, "little")


def _fq_from_raw(b: bytes) -> int:
    m = int.from_bytes(b, "little")
    if m >= Q:
        raise ValueError("field element out of range")
    return FQ.from_mont_host(m)


def _g2_to_raw(pt) -> bytes:
    (x0, x1), (y0, y1) = pt
    return b"".join(_fq_to_raw(v) for v in (x0, x1, y0, y1))


def _g2_from_raw(b: bytes):
    vals = [_fq_from_raw(b[i * 32 : (i + 1) * 32]) for i in range(4)]
    return ((vals[0], vals[1]), (vals[2], vals[3]))


def write_srs(path: str, srs, tau: int | None = None) -> None:
    """Export an SRS to halo2 ParamsKZG RawBytes format.

    ``g_lagrange`` (the Lagrange-basis commitment table halo2 carries)
    is derived from tau when known (our deterministic dev SRS); for a
    tau-less SRS pass tau=None to write a recomputed Lagrange table via
    the group-element identity L_i(tau) G = IFFT row — not supported
    here, so tau is required."""
    if tau is None:
        raise ValueError("writing requires tau (dev SRS); ceremony SRS "
                         "files should be round-tripped, not regenerated")
    from halo2_aes_tpu_torch.backend.srs import _points_from_scalars
    from halo2_aes_tpu_torch.ops.ntt import domain

    k, n = srs.k, srs.n
    # L_i(tau) scalars: (tau^n - 1) * w^i / (n (tau - w^i))
    r = F.FR.modulus
    dom = domain(F.FR, k)
    w = dom.omega
    zh = (pow(tau, n, r) - 1) % r
    n_inv = pow(n, -1, r)
    wi = 1
    lags = []
    for _ in range(n):
        lags.append(zh * wi % r * pow((tau - wi) % r, -1, r) % r * n_inv % r)
        wi = wi * w % r
    lx, ly = _points_from_scalars(lags, srs.device)

    def interleave(xs, ys):
        # halo2 stores points as x||y 64-byte records
        xs = F.to_numpy(xs).astype("<u2", casting="unsafe")
        ys = F.to_numpy(ys).astype("<u2", casting="unsafe")
        return np.stack([xs, ys], axis=1).tobytes()

    with open(path, "wb") as f:
        f.write(np.uint32(k).tobytes())
        f.write(interleave(srs.g1_x, srs.g1_y))
        f.write(interleave(lx, ly))
        f.write(_g2_to_raw(srs.g2))
        f.write(_g2_to_raw(srs.s_g2))


def read_srs(path: str, device):
    """Load a halo2 ParamsKZG RawBytes file -> SRS on ``device``
    (g_lagrange is parsed and validated but not retained — our commits
    run in the coefficient basis)."""
    from halo2_aes_tpu_torch.backend.srs import SRS

    with open(path, "rb") as f:
        buf = f.read()
    k = int(np.frombuffer(buf[:4], dtype="<u4")[0])
    n = 1 << k
    off = 4
    pts = np.frombuffer(buf[off : off + n * 64], dtype="<u2")
    pts = pts.reshape(n, 2, F.LIMBS).astype(np.uint32)
    g1_x, g1_y = pts[:, 0], pts[:, 1]
    off += n * 64
    off += n * 64  # skip g_lagrange
    g2 = _g2_from_raw(buf[off : off + 128])
    off += 128
    s_g2 = _g2_from_raw(buf[off : off + 128])
    off += 128
    if off != len(buf):
        raise ValueError(f"{len(buf) - off} trailing bytes in {path}")

    # spot-check: first few points on curve, first point is the generator
    from halo2_aes_tpu_torch.ops import curve as CV

    for i in range(min(4, n)):
        x = FQ.from_mont_host(F.limbs_to_int(g1_x[i]))
        y = FQ.from_mont_host(F.limbs_to_int(g1_y[i]))
        if not CV.py_is_on_curve((x, y)):
            raise ValueError(f"g[{i}] not on curve")
    return SRS(k, F.limbs(g1_x, device), F.limbs(g1_y, device), g2, s_g2)
