"""arkworks-compatible canonical serialization (host side).

Byte formats follow ark-serialize 0.4 conventions as used for Fiat-Shamir
framing throughout the reference (`gipa.rs:240-247`, `sipp/src/lib.rs:56-60`):

  Fp element      : little-endian bytes of the canonical integer,
                    ceil(MODULUS_BIT_SIZE / 8) bytes (48 for the BLS12 base
                    fields, 32 for their scalar fields)
  Fp2 / Fp6 / Fp12: concatenation of coefficients, c0 first
  GT              : the underlying Fp12
  G1/G2 affine uncompressed: ser(x) || ser(y), flag bits OR'd into the most
                    significant bits of the FINAL byte of y:
                      0x40 -> point at infinity (x = y = 0)
                      0x80 -> y is lexicographically "negative" (y > -y)
  G1/G2 affine compressed: ser(x) with the same flag scheme on x's last byte
  Vec<T>          : u64 little-endian length prefix, then elements
  usize nonce     : 8-byte big-endian (matches counter_nonce.to_be_bytes())

NOTE: exact bit-for-bit agreement with arkworks cannot be revalidated in this
environment (no Rust toolchain); the format is centralized here so a future
golden-vector check only needs to touch this module.

The port's own copy of ripp_tpu/utils/serialize.py, over the port's host
model (tests/test_torch_utils.py holds the bytes equal).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..host.curves import PairingCurve
from ..host.field import FieldOps, FpOps


def int_to_bytes_le(v: int, length: int) -> bytes:
    return int(v).to_bytes(length, "little")


def bytes_le_to_int(b: bytes) -> int:
    return int.from_bytes(b, "little")


def field_nbytes(f: FieldOps) -> int:
    # per base-field coefficient
    return (f.p.bit_length() + 7) // 8


def ser_fp(f: FpOps, a: int) -> bytes:
    return int_to_bytes_le(a, field_nbytes(f))


def ser_field(f: FieldOps, a) -> bytes:
    """Serialize any tower element (flatten to base-field coeffs, c0 first)."""
    nb = field_nbytes(f)
    return b"".join(int_to_bytes_le(c, nb) for c in f.tolist(a))


def deser_field(f: FieldOps, data: bytes):
    nb = field_nbytes(f)
    n = f.degree
    assert len(data) == nb * n
    ints = [bytes_le_to_int(data[i * nb : (i + 1) * nb]) for i in range(n)]
    # Canonicity: arkworks CanonicalDeserialize rejects coefficients >= p;
    # accepting them silently (fromlist reduces mod p) would make encodings
    # malleable for Fiat-Shamir purposes.
    if any(c >= f.p for c in ints):
        raise ValueError("non-canonical field element (coefficient >= p)")
    return f.fromlist(ints)


def _y_is_negative(f: FieldOps, y) -> bool:
    """Lexicographic comparison y > -y (big-endian over flattened coeffs,
    most significant coefficient first)."""
    ly = list(reversed(f.tolist(y)))
    ln = list(reversed(f.tolist(f.neg(y))))
    return ly > ln


def ser_group_uncompressed(f: FieldOps, pt) -> bytes:
    """Short-Weierstrass affine point, uncompressed."""
    nb = field_nbytes(f) * f.degree
    if pt is None:
        x = b"\x00" * nb
        y = bytearray(b"\x00" * nb)
        y[-1] |= 0x40
        return x + bytes(y)
    xb = ser_field(f, pt[0])
    yb = bytearray(ser_field(f, pt[1]))
    if _y_is_negative(f, pt[1]):
        yb[-1] |= 0x80
    return xb + bytes(yb)


def ser_group_compressed(f: FieldOps, pt) -> bytes:
    nb = field_nbytes(f) * f.degree
    if pt is None:
        x = bytearray(b"\x00" * nb)
        x[-1] |= 0x40
        return bytes(x)
    xb = bytearray(ser_field(f, pt[0]))
    if _y_is_negative(f, pt[1]):
        xb[-1] |= 0x80
    return bytes(xb)


def deser_group_uncompressed(f: FieldOps, curve, data: bytes):
    """Deserialize an affine point with full validation: canonical
    coordinates, on-curve, AND prime-order-subgroup membership (arkworks
    validates all three by default; BLS12 curves have composite cofactors,
    so skipping the subgroup check would let small-order components reach
    the verifier's pairing checks)."""
    nb = field_nbytes(f) * f.degree
    assert len(data) == 2 * nb
    xb, yb = data[:nb], bytearray(data[nb:])
    flags = yb[-1] & 0xC0
    yb[-1] &= 0x3F
    if flags & 0x40:
        return None
    x = deser_field(f, xb)
    y = deser_field(f, bytes(yb))
    pt = (x, y)
    if not curve.is_on_curve(pt):
        raise ValueError("deserialized point not on curve")
    if not curve.in_subgroup(pt):
        raise ValueError("deserialized point not in prime-order subgroup")
    return pt


def ser_vec(elem_ser, items: Sequence) -> bytes:
    out = len(items).to_bytes(8, "little")
    return out + b"".join(elem_ser(i) for i in items)


def nonce_bytes(counter: int) -> bytes:
    return counter.to_bytes(8, "big")


# --- curve-bound convenience wrappers --------------------------------------

class CurveSerializer:
    """Serialization helpers bound to a pairing curve (host representation)."""

    def __init__(self, curve: PairingCurve):
        self.curve = curve
        self.t = curve.tower

    # single elements
    def fr(self, a: int) -> bytes:
        return ser_fp(self.curve.fr, a % self.curve.r)

    def fp(self, a: int) -> bytes:
        return ser_fp(self.t.fp, a)

    def g1(self, pt, compressed: bool = False) -> bytes:
        f = self.t.fp
        return (ser_group_compressed(f, pt) if compressed
                else ser_group_uncompressed(f, pt))

    def g2(self, pt, compressed: bool = False) -> bytes:
        f = self.t.fp2
        return (ser_group_compressed(f, pt) if compressed
                else ser_group_uncompressed(f, pt))

    def gt(self, a) -> bytes:
        return ser_field(self.t.fp12, a)

    # vectors (with u64 length prefix, ark Vec/slice convention)
    def g1_vec(self, pts: Sequence) -> bytes:
        return ser_vec(self.g1, pts)

    def g2_vec(self, pts: Sequence) -> bytes:
        return ser_vec(self.g2, pts)

    def fr_vec(self, xs: Sequence[int]) -> bytes:
        return ser_vec(self.fr, xs)

    # --- element sizes and deserializers (uncompressed) --------------------
    def fr_size(self) -> int:
        return field_nbytes(self.curve.fr)

    def g1_size(self) -> int:
        return 2 * field_nbytes(self.t.fp)

    def g2_size(self) -> int:
        return 2 * field_nbytes(self.t.fp) * 2

    def gt_size(self) -> int:
        return field_nbytes(self.t.fp) * 12

    def deser_fr(self, data: bytes) -> int:
        v = bytes_le_to_int(data)
        assert v < self.curve.r, "non-canonical Fr"
        return v

    def deser_g1(self, data: bytes):
        return deser_group_uncompressed(self.t.fp, self.curve.g1, data)

    def deser_g2(self, data: bytes):
        return deser_group_uncompressed(self.t.fp2, self.curve.g2, data)

    def deser_gt(self, data: bytes):
        """Deserialize a GT element with an order-r subgroup check
        (v^r == 1); GT is the unique order-r subgroup of Fp12^*, so
        out-of-subgroup values cannot reach verifier pairing equations."""
        v = deser_field(self.t.fp12, data)
        if self.t.fp12.pow(v, self.curve.r) != self.t.fp12.one():
            raise ValueError("deserialized GT element not in order-r subgroup")
        return v
