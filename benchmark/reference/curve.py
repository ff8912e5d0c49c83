"""BN254 G1 in Python integers, the proof's point and scalar encoding,
and the Blake2b Fiat-Shamir transcript, for the reference.

Points are affine (x, y) pairs of ints, None for the identity.  The wire
format is halo2's: 32-byte little-endian scalars; points compressed to
x with the sign of y in bit 7 of byte 31.  The transcript is blake2b
with a 64-byte digest and the personalisation b"Halo2-Transcript",
prefix bytes 0 / 1 / 2 before a challenge / point / scalar, a point
absorbed as x || y, and a challenge the digest of a copy of the state
read little-endian mod r.
"""

from __future__ import annotations

import hashlib

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617
G1 = (1, 2)


def add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    (x1, y1), (x2, y2) = a, b
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    return x3, (lam * (x1 - x3) - y1) % Q


def _jac_double(p):
    x, y, z = p
    if z == 0 or y == 0:
        return (0, 1, 0)
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) ** 2 - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    return x3, (e * (d - x3) - 8 * c) % Q, 2 * y * z % Q


def _jac_add_affine(p, q):
    x1, y1, z1 = p
    if z1 == 0:
        return (q[0], q[1], 1)
    z1z1 = z1 * z1 % Q
    u2 = q[0] * z1z1 % Q
    s2 = q[1] * z1 * z1z1 % Q
    if u2 == x1:
        if s2 == y1:
            return _jac_double(p)
        return (0, 1, 0)
    h = (u2 - x1) % Q
    hh = h * h % Q
    i = 4 * hh % Q
    j = h * i % Q
    r = 2 * (s2 - y1) % Q
    v = x1 * i % Q
    x3 = (r * r - j - 2 * v) % Q
    y3 = (r * (v - x3) - 2 * y1 * j) % Q
    return x3, y3, ((z1 + h) ** 2 - z1z1 - hh) % Q


def mul(p, s: int):
    """[s] p by double-and-add in Jacobian coordinates."""
    s %= R_MOD
    if p is None or s == 0:
        return None
    acc = (0, 1, 0)
    for bit in bin(s)[2:]:
        acc = _jac_double(acc)
        if bit == "1":
            acc = _jac_add_affine(acc, p)
    x, y, z = acc
    if z == 0:
        return None
    zi = pow(z, -1, Q)
    zi2 = zi * zi % Q
    return x * zi2 % Q, y * zi2 * zi % Q


def lincomb(points, scalars):
    out = None
    for p, s in zip(points, scalars):
        out = add(out, mul(p, s))
    return out


def point_bytes(pt) -> bytes:
    if pt is None:
        return bytes(32)
    b = bytearray(pt[0].to_bytes(32, "little"))
    b[31] |= (pt[1] & 1) << 7
    return bytes(b)


def point_from_bytes(b: bytes):
    """The affine point of 32 compressed bytes; None where they name no
    point of the curve (or the identity)."""
    b = bytearray(b)
    sign = b[31] >> 7
    b[31] &= 0x7F
    x = int.from_bytes(bytes(b), "little")
    if x == 0 and sign == 0 or x >= Q:
        return None
    rhs = (x * x * x + 3) % Q
    y = pow(rhs, (Q + 1) // 4, Q)
    if y * y % Q != rhs:
        return None
    if y & 1 != sign:
        y = Q - y
    return x, y


def scalar_bytes(s: int) -> bytes:
    return (s % R_MOD).to_bytes(32, "little")


class Transcript:
    """The expected proof: what it absorbs, and its bytes with each
    32-byte word marked as a point or a scalar."""

    def __init__(self):
        self._state = hashlib.blake2b(digest_size=64, person=b"Halo2-Transcript")
        self.words = []            # (kind, bytes)

    def common_scalar(self, s: int):
        self._state.update(b"\x02" + scalar_bytes(s))

    def point(self, pt, wire: bytes | None = None):
        """Absorb ``pt`` and put its bytes on the wire (``wire`` where the
        proof's own bytes stand in for a point the reference does not
        make itself)."""
        self._state.update(b"\x01")
        if pt is None:
            self._state.update(bytes(64))
        else:
            self._state.update(pt[0].to_bytes(32, "little") + pt[1].to_bytes(32, "little"))
        self.words.append(("point", wire if wire is not None else point_bytes(pt)))

    def scalar(self, s: int):
        self.common_scalar(s)
        self.words.append(("scalar", scalar_bytes(s)))

    def challenge(self) -> int:
        self._state.update(b"\x00")
        return int.from_bytes(self._state.copy().digest(), "little") % R_MOD
