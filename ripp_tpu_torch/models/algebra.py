"""Host-side algebra adapters for protocol single elements.

The protocol loops (GIPA/TIPA/SIPP) keep *single* elements - round
commitments, challenges, base values - on host as python objects (they feed
Fiat-Shamir hashing anyway), while vectors live on device. This module gives
each element kind a uniform (add, scalar-mul, serialize, zero) surface, i.e.
the MulAssign/Add bounds of DoublyHomomorphicCommitment
(arkworks ripp dh_commitments/src/lib.rs:20-55) re-expressed for host use.

Kinds: 'fr' (int), 'g1'/'g2' (host affine tuple | None), 'gt' (fp12 tuple),
'identity' (IdentityOutput wrapper), 'placeholder' (no-op unit).

The port's own copy of ripp_tpu/models/algebra.py (pure Python over the
port's host model).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

from ..host import pairing as hp
from ..host.curves import PairingCurve
from ..utils.serialize import CurveSerializer, ser_vec


class Placeholder:
    """HomomorphicPlaceholderValue analog (identity/SSM commitment keys)."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "Placeholder"

    def __eq__(self, other):
        return isinstance(other, Placeholder)

    def __hash__(self):
        return 0


PLACEHOLDER = Placeholder()


@dataclass
class IdentityOutput:
    """IdentityCommitment output: the message vector in the clear
    (dh_commitments/src/identity/mod.rs:32-62)."""

    items: List[Any]
    kind: str  # inner element kind

    def __eq__(self, other):
        return (
            isinstance(other, IdentityOutput)
            and self.kind == other.kind
            and self.items == other.items
        )


class HostAlg:
    """Algebra for one element kind over one curve."""

    def __init__(self, curve: PairingCurve, kind: str):
        self.curve = curve
        self.kind = kind
        self.s = CurveSerializer(curve)

    def zero(self):
        c = self.curve
        if self.kind == "fr":
            return 0
        if self.kind in ("g1", "g2"):
            return None
        if self.kind == "gt":
            return c.tower.fp12.one()
        if self.kind == "placeholder":
            return PLACEHOLDER
        raise ValueError(self.kind)

    def add(self, a, b):
        c = self.curve
        if self.kind == "fr":
            return (a + b) % c.r
        if self.kind == "g1":
            return c.g1.add(a, b)
        if self.kind == "g2":
            return c.g2.add(a, b)
        if self.kind == "gt":
            return hp.gt_mul(c, a, b)  # GT written additively in RIPP
        if self.kind == "placeholder":
            return PLACEHOLDER
        raise ValueError(self.kind)

    def mul_scalar(self, a, k: int):
        c = self.curve
        k = k % c.r
        if self.kind == "fr":
            return (a * k) % c.r
        if self.kind == "g1":
            return c.g1.scalar_mul(a, k)
        if self.kind == "g2":
            return c.g2.scalar_mul(a, k)
        if self.kind == "gt":
            return hp.gt_exp(c, a, k)
        if self.kind == "placeholder":
            return PLACEHOLDER
        raise ValueError(self.kind)

    def ser(self, a) -> bytes:
        if self.kind == "fr":
            return self.s.fr(a)
        if self.kind == "g1":
            return self.s.g1(a)
        if self.kind == "g2":
            return self.s.g2(a)
        if self.kind == "gt":
            return self.s.gt(a)
        if self.kind == "placeholder":
            return b""
        raise ValueError(self.kind)

    def eq(self, a, b) -> bool:
        if self.kind in ("g1", "g2"):
            curve = self.curve.g1 if self.kind == "g1" else self.curve.g2
            if a is None or b is None:
                return a is None and b is None
            return curve.eq(a, b)
        return a == b


class IdentityAlg:
    """Algebra for IdentityOutput (vector of inner elements)."""

    def __init__(self, inner: HostAlg):
        self.inner = inner
        self.kind = "identity"

    def zero(self):
        return IdentityOutput([], self.inner.kind)

    def add(self, a: IdentityOutput, b: IdentityOutput):
        if not a.items:
            return b
        if not b.items:
            return a
        return IdentityOutput(
            [self.inner.add(x, y) for x, y in zip(a.items, b.items)],
            self.inner.kind,
        )

    def mul_scalar(self, a: IdentityOutput, k: int):
        return IdentityOutput(
            [self.inner.mul_scalar(x, k) for x in a.items], self.inner.kind
        )

    def ser(self, a: IdentityOutput) -> bytes:
        return ser_vec(self.inner.ser, a.items)

    def eq(self, a, b) -> bool:
        return (
            isinstance(a, IdentityOutput)
            and isinstance(b, IdentityOutput)
            and len(a.items) == len(b.items)
            and all(self.inner.eq(x, y) for x, y in zip(a.items, b.items))
        )
