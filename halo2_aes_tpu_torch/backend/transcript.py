"""Blake2b Fiat-Shamir transcript + proof byte serialization.

Follows the conventions of halo2's ``Blake2bWrite<_, G1Affine,
Challenge255>`` (the transcript the Rust halo2-aes prover uses,
its src/main.rs:92):

  * blake2b, 64-byte digest, personalization b"Halo2-Transcript",
  * domain-prefix bytes 0/1/2 for challenge/point/scalar absorption,
  * common_point absorbs x.to_repr() || y.to_repr() (32-byte LE each),
  * squeeze_challenge appends the challenge prefix byte to the running
    state, finalizes a CLONE, and reduces the 64-byte digest little-
    endian mod r (Challenge255 / from_uniform_bytes semantics).

Proof wire format (independent of the hash state): scalars are 32-byte
LE; points are 32-byte compressed — x LE with the sign of y in bit 7 of
byte 31.  The identity NEVER appears on the wire: write_point/read_point
reject it, matching halo2's panic-on-identity transcript semantics
(the prover's blinding guarantees it cannot occur honestly).  (Assumed
halo2curves-compatible; with no Rust toolchain or network in this
environment, cross-parity is isolated to this module and documented
rather than tested.)
"""

from __future__ import annotations

import hashlib

from halo2_aes_tpu_torch.ops.field import FQ, FR

PREFIX_CHALLENGE = b"\x00"
PREFIX_POINT = b"\x01"
PREFIX_SCALAR = b"\x02"

_PERSON = b"Halo2-Transcript"


def _sqrt_fq(a: int) -> int | None:
    # q == 3 (mod 4)
    assert FQ.modulus % 4 == 3
    r = pow(a, (FQ.modulus + 1) // 4, FQ.modulus)
    return r if r * r % FQ.modulus == a else None


def point_to_bytes(pt) -> bytes:
    """Affine (x, y) plain ints (or None=identity) -> 32-byte compressed."""
    if pt is None:
        return bytes(32)
    x, y = pt
    b = bytearray(x.to_bytes(32, "little"))
    b[31] |= (y & 1) << 7
    return bytes(b)


def point_from_bytes(b: bytes):
    if b == bytes(32):
        return None
    b = bytearray(b)
    sign = b[31] >> 7
    b[31] &= 0x7F
    x = int.from_bytes(bytes(b), "little")
    if x >= FQ.modulus:
        raise ValueError("point x out of range")
    y = _sqrt_fq((x * x % FQ.modulus * x + 3) % FQ.modulus)
    if y is None:
        raise ValueError("x not on curve")
    if (y & 1) != sign:
        y = FQ.modulus - y
    return (x, y)


def scalar_to_bytes(s: int) -> bytes:
    return (s % FR.modulus).to_bytes(32, "little")


def scalar_from_bytes(b: bytes) -> int:
    s = int.from_bytes(b, "little")
    if s >= FR.modulus:
        raise ValueError("scalar out of range")
    return s


class Transcript:
    """Hash-state core shared by reader and writer."""

    def __init__(self):
        self._state = hashlib.blake2b(digest_size=64, person=_PERSON)

    def common_point(self, pt) -> None:
        # write_point/read_point refuse the identity before reaching
        # here (halo2 panic semantics); the (0,0) absorption below only
        # serves direct common_point callers outside the wire path.
        self._state.update(PREFIX_POINT)
        if pt is None:
            self._state.update(bytes(64))
            return
        self._state.update(pt[0].to_bytes(32, "little"))
        self._state.update(pt[1].to_bytes(32, "little"))

    def common_scalar(self, s: int) -> None:
        self._state.update(PREFIX_SCALAR)
        self._state.update(scalar_to_bytes(s))

    def squeeze_challenge(self) -> int:
        self._state.update(PREFIX_CHALLENGE)
        digest = self._state.copy().digest()
        return int.from_bytes(digest, "little") % FR.modulus


class TranscriptWriter(Transcript):
    def __init__(self):
        super().__init__()
        self._buf = bytearray()

    def write_point(self, pt) -> None:
        # Match halo2 semantics on the wire: its Blake2bWrite unwraps
        # coordinates() and panics on the identity (reference
        # src/main.rs:92).  The prover guarantees no identity commitment
        # reaches the transcript (blinded advice/products, staggered
        # quotient-piece blinds, pruned zero fixed columns); hitting this
        # assert means a blinding invariant broke upstream.
        if pt is None:
            raise ValueError("identity point on the transcript wire")
        self.common_point(pt)
        self._buf += point_to_bytes(pt)

    def write_scalar(self, s: int) -> None:
        self.common_scalar(s)
        self._buf += scalar_to_bytes(s)

    def finalize(self) -> bytes:
        return bytes(self._buf)


class TranscriptReader(Transcript):
    def __init__(self, proof: bytes):
        super().__init__()
        self._buf = memoryview(proof)
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._buf):
            raise ValueError("proof too short")
        out = bytes(self._buf[self._pos : self._pos + n])
        self._pos += n
        return out

    def read_point(self):
        pt = point_from_bytes(self._take(32))
        if pt is None:
            # mirror of write_point: reject identity on the wire
            raise ValueError("identity point in proof")
        self.common_point(pt)
        return pt

    def read_scalar(self) -> int:
        s = scalar_from_bytes(self._take(32))
        self.common_scalar(s)
        return s

    def assert_consumed(self) -> None:
        if self._pos != len(self._buf):
            raise ValueError(f"{len(self._buf) - self._pos} unread proof bytes")
