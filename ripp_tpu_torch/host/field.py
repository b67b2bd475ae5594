"""Host-side (pure Python int) finite field and extension tower arithmetic.

This module is the *reference model* for the whole framework: every device
(PyTorch/CUDA) kernel is differential-tested against it, and the protocol layer
uses it for single-element math (Fiat-Shamir commitments, challenge scalars,
final exponentiations) where device round-trips would be wasteful.

Representation conventions:
  Fp      : python int in [0, p)
  Fp2     : tuple (c0, c1)         = c0 + c1*u        with u^2 = beta
  Fp6     : tuple (a0, a1, a2)     = a0 + a1*v + a2*v^2, a_i in Fp2, v^3 = xi
  Fp12    : tuple (b0, b1)         = b0 + b1*w,       b_i in Fp6,  w^2 = v

Mirrors the capabilities RIPP consumes from arkworks ark-ff
(`arkworks ripp inner_products/src/lib.rs:1-9`, field trait usage surveyed
in SURVEY.md section 2.3), re-derived from standard mathematics - no code is
translated from the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Sequence, Tuple


class FieldOps:
    """Abstract interface for a field's host operations.

    Elements are immutable python objects (ints or nested tuples of ints).
    """

    name: str = "field"
    # characteristic of the base prime field
    p: int = 0
    # extension degree over the prime field
    degree: int = 1

    def zero(self):
        raise NotImplementedError

    def one(self):
        raise NotImplementedError

    def add(self, a, b):
        raise NotImplementedError

    def sub(self, a, b):
        raise NotImplementedError

    def neg(self, a):
        raise NotImplementedError

    def mul(self, a, b):
        raise NotImplementedError

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        raise NotImplementedError

    def eq(self, a, b) -> bool:
        return a == b

    def is_zero(self, a) -> bool:
        return self.eq(a, self.zero())

    def from_int(self, n: int):
        """Embed an integer (scalar) into the field."""
        raise NotImplementedError

    def mul_int(self, a, n: int):
        """Multiply a field element by a small integer."""
        out = self.zero()
        b = a
        while n:
            if n & 1:
                out = self.add(out, b)
            b = self.add(b, b)
            n >>= 1
        return out

    def pow(self, a, e: int):
        """a^e for a non-negative python int exponent (square and multiply)."""
        if e < 0:
            return self.pow(self.inv(a), -e)
        result = self.one()
        base = a
        while e:
            if e & 1:
                result = self.mul(result, base)
            base = self.sqr(base)
            e >>= 1
        return result

    def batch_inv(self, xs: Sequence[Any]) -> List[Any]:
        """Montgomery batch inversion: one inv + 3(n-1) muls.

        Zero entries are passed through as zero (matching ark_ff::batch_inversion
        semantics used at arkworks ripp sipp/src/lib.rs:149).
        """
        n = len(xs)
        prefix = []
        acc = self.one()
        for x in xs:
            prefix.append(acc)
            if not self.is_zero(x):
                acc = self.mul(acc, x)
        acc = self.inv(acc)
        out = [None] * n
        for i in range(n - 1, -1, -1):
            if self.is_zero(xs[i]):
                out[i] = xs[i]
            else:
                out[i] = self.mul(acc, prefix[i])
                acc = self.mul(acc, xs[i])
        return out

    # --- helpers for generic tower code -------------------------------------
    def tolist(self, a) -> List[int]:
        """Flatten an element to a list of base-field ints (little-endian in
        tower order: c0 first)."""
        raise NotImplementedError

    def fromlist(self, ints: Sequence[int]):
        raise NotImplementedError


class FpOps(FieldOps):
    """Prime field Z/pZ with python ints."""

    degree = 1

    def __init__(self, p: int, name: str = "Fp"):
        self.p = p
        self.name = name
        self.bits = p.bit_length()
        self.nbytes = (self.bits + 7) // 8

    def zero(self):
        return 0

    def one(self):
        return 1

    def add(self, a, b):
        s = a + b
        return s - self.p if s >= self.p else s

    def sub(self, a, b):
        d = a - b
        return d + self.p if d < 0 else d

    def neg(self, a):
        return 0 if a == 0 else self.p - a

    def mul(self, a, b):
        return (a * b) % self.p

    def sqr(self, a):
        return (a * a) % self.p

    def inv(self, a):
        if a == 0:
            raise ZeroDivisionError("inverse of zero in " + self.name)
        return pow(a, -1, self.p)

    def pow(self, a, e: int):
        if e < 0:
            return pow(self.inv(a), -e, self.p)
        return pow(a, e, self.p)

    def from_int(self, n: int):
        return n % self.p

    def mul_int(self, a, n: int):
        return (a * n) % self.p

    def legendre(self, a) -> int:
        if a == 0:
            return 0
        s = pow(a, (self.p - 1) // 2, self.p)
        return 1 if s == 1 else -1

    def sqrt(self, a):
        """Tonelli-Shanks square root; returns None if a is a non-residue."""
        p = self.p
        if a == 0:
            return 0
        if self.legendre(a) != 1:
            return None
        if p % 4 == 3:
            return pow(a, (p + 1) // 4, p)
        # general Tonelli-Shanks
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while self.legendre(z) != -1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            t2i = t
            i = 0
            for i in range(1, m):
                t2i = (t2i * t2i) % p
                if t2i == 1:
                    break
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, (b * b) % p
            t = (t * c) % p
            r = (r * b) % p
        return r

    def tolist(self, a):
        return [a]

    def fromlist(self, ints):
        assert len(ints) == 1
        return ints[0] % self.p


class QuadExtOps(FieldOps):
    """Quadratic extension base[x]/(x^2 - nr).

    `mul_by_nr` multiplies a base element by the non-residue nr.
    """

    def __init__(self, base: FieldOps, mul_by_nr: Callable, name: str):
        self.base = base
        self.mul_by_nr = mul_by_nr
        self.name = name
        self.p = base.p
        self.degree = 2 * base.degree

    def zero(self):
        return (self.base.zero(), self.base.zero())

    def one(self):
        return (self.base.one(), self.base.zero())

    def add(self, a, b):
        return (self.base.add(a[0], b[0]), self.base.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.base.sub(a[0], b[0]), self.base.sub(a[1], b[1]))

    def neg(self, a):
        return (self.base.neg(a[0]), self.base.neg(a[1]))

    def mul(self, a, b):
        # Karatsuba: (a0 + a1 x)(b0 + b1 x)
        B = self.base
        v0 = B.mul(a[0], b[0])
        v1 = B.mul(a[1], b[1])
        c0 = B.add(v0, self.mul_by_nr(v1))
        c1 = B.sub(
            B.sub(B.mul(B.add(a[0], a[1]), B.add(b[0], b[1])), v0), v1
        )
        return (c0, c1)

    def sqr(self, a):
        B = self.base
        v0 = B.mul(a[0], a[1])
        # (a0 + a1)(a0 + nr*a1) - v0 - nr*v0
        t = B.mul(B.add(a[0], a[1]), B.add(a[0], self.mul_by_nr(a[1])))
        c0 = B.sub(B.sub(t, v0), self.mul_by_nr(v0))
        c1 = B.add(v0, v0)
        return (c0, c1)

    def inv(self, a):
        B = self.base
        # norm = a0^2 - nr * a1^2
        norm = B.sub(B.sqr(a[0]), self.mul_by_nr(B.sqr(a[1])))
        ninv = B.inv(norm)
        return (B.mul(a[0], ninv), B.neg(B.mul(a[1], ninv)))

    def conj(self, a):
        return (a[0], self.base.neg(a[1]))

    def from_int(self, n: int):
        return (self.base.from_int(n), self.base.zero())

    def scale(self, a, s):
        """Multiply by a base-field element s."""
        return (self.base.mul(a[0], s), self.base.mul(a[1], s))

    def tolist(self, a):
        return self.base.tolist(a[0]) + self.base.tolist(a[1])

    def fromlist(self, ints):
        h = len(ints) // 2
        return (self.base.fromlist(ints[:h]), self.base.fromlist(ints[h:]))


class CubicExtOps(FieldOps):
    """Cubic extension base[x]/(x^3 - nr)."""

    def __init__(self, base: FieldOps, mul_by_nr: Callable, name: str):
        self.base = base
        self.mul_by_nr = mul_by_nr
        self.name = name
        self.p = base.p
        self.degree = 3 * base.degree

    def zero(self):
        z = self.base.zero()
        return (z, z, z)

    def one(self):
        return (self.base.one(), self.base.zero(), self.base.zero())

    def add(self, a, b):
        B = self.base
        return (B.add(a[0], b[0]), B.add(a[1], b[1]), B.add(a[2], b[2]))

    def sub(self, a, b):
        B = self.base
        return (B.sub(a[0], b[0]), B.sub(a[1], b[1]), B.sub(a[2], b[2]))

    def neg(self, a):
        B = self.base
        return (B.neg(a[0]), B.neg(a[1]), B.neg(a[2]))

    def mul(self, a, b):
        # Toom/Karatsuba-style (CH-SQR3 layout)
        B = self.base
        v0 = B.mul(a[0], b[0])
        v1 = B.mul(a[1], b[1])
        v2 = B.mul(a[2], b[2])
        t01 = B.mul(B.add(a[0], a[1]), B.add(b[0], b[1]))
        t02 = B.mul(B.add(a[0], a[2]), B.add(b[0], b[2]))
        t12 = B.mul(B.add(a[1], a[2]), B.add(b[1], b[2]))
        c0 = B.add(v0, self.mul_by_nr(B.sub(B.sub(t12, v1), v2)))
        c1 = B.add(B.sub(B.sub(t01, v0), v1), self.mul_by_nr(v2))
        c2 = B.add(B.sub(B.sub(t02, v0), v2), v1)
        return (c0, c1, c2)

    def inv(self, a):
        B = self.base
        a0, a1, a2 = a
        t0 = B.sub(B.sqr(a0), self.mul_by_nr(B.mul(a1, a2)))
        t1 = B.sub(self.mul_by_nr(B.sqr(a2)), B.mul(a0, a1))
        t2 = B.sub(B.sqr(a1), B.mul(a0, a2))
        # norm = a0*t0 + nr*(a2*t1 + a1*t2)
        norm = B.add(
            B.mul(a0, t0),
            self.mul_by_nr(B.add(B.mul(a2, t1), B.mul(a1, t2))),
        )
        ninv = B.inv(norm)
        return (B.mul(t0, ninv), B.mul(t1, ninv), B.mul(t2, ninv))

    def from_int(self, n: int):
        return (self.base.from_int(n), self.base.zero(), self.base.zero())

    def scale(self, a, s):
        B = self.base
        return (B.mul(a[0], s), B.mul(a[1], s), B.mul(a[2], s))

    def mul_by_x(self, a):
        """Multiply by the extension generator v (v^3 = nr)."""
        return (self.mul_by_nr(a[2]), a[0], a[1])

    def tolist(self, a):
        return (
            self.base.tolist(a[0]) + self.base.tolist(a[1]) + self.base.tolist(a[2])
        )

    def fromlist(self, ints):
        t = len(ints) // 3
        return (
            self.base.fromlist(ints[:t]),
            self.base.fromlist(ints[t : 2 * t]),
            self.base.fromlist(ints[2 * t :]),
        )


@dataclass
class Tower:
    """The full BLS-style tower Fp -> Fp2 -> Fp6 -> Fp12 with Frobenius data.

    beta: the Fp2 non-residue (u^2 = beta)
    xi:   the Fp6/Fp12 non-residue in Fp2 (v^3 = xi, w^2 = v)
    """

    fp: FpOps
    fp2: QuadExtOps
    fp6: CubicExtOps
    fp12: QuadExtOps
    beta: int
    xi: Tuple[int, int]
    # Frobenius coefficients
    frob2_c1: List[int]  # beta^(i*(p-1)/2) for i in 0..1 (u -> u * coeff)
    frob6_c1: List[Tuple[int, int]]  # xi^((p^i - 1)/3), i in 0..5
    frob6_c2: List[Tuple[int, int]]  # xi^(2*(p^i - 1)/3)
    frob12_c1: List[Tuple[int, int]]  # xi^((p^i - 1)/6), i in 0..11

    @staticmethod
    def build(p: int, beta: int, xi: Tuple[int, int], name: str = "") -> "Tower":
        fp = FpOps(p, name=f"{name}Fp")
        beta = beta % p

        def fp_mul_beta(a):
            return (a * beta) % p

        fp2 = QuadExtOps(fp, fp_mul_beta, name=f"{name}Fp2")
        xi = (xi[0] % p, xi[1] % p)

        def fp2_mul_xi(a):
            return fp2.mul(a, xi)

        fp6 = CubicExtOps(fp2, fp2_mul_xi, name=f"{name}Fp6")

        def fp6_mul_v(a):
            # multiply an Fp6 element by v  (the Fp12 non-residue, w^2 = v)
            return fp6.mul_by_x(a)

        fp12 = QuadExtOps(fp6, fp6_mul_v, name=f"{name}Fp12")

        # Frobenius precomputation
        frob2_c1 = [pow(beta, (i * (p - 1)) // 2, p) for i in range(2)]
        frob6_c1 = [fp2.pow(xi, (pow(p, i) - 1) // 3) for i in range(6)]
        frob6_c2 = [fp2.pow(xi, 2 * (pow(p, i) - 1) // 3) for i in range(6)]
        frob12_c1 = [fp2.pow(xi, (pow(p, i) - 1) // 6) for i in range(12)]
        return Tower(
            fp=fp,
            fp2=fp2,
            fp6=fp6,
            fp12=fp12,
            beta=beta,
            xi=xi,
            frob2_c1=frob2_c1,
            frob6_c1=frob6_c1,
            frob6_c2=frob6_c2,
            frob12_c1=frob12_c1,
        )

    # --- Frobenius endomorphisms -------------------------------------------
    def frob_fp2(self, a, power: int = 1):
        """(c0 + c1 u)^(p^power)"""
        if power % 2 == 0:
            return a
        return (a[0], (a[1] * self.frob2_c1[1]) % self.fp.p)

    def frob_fp6(self, a, power: int = 1):
        i = power % 6
        c0 = self.frob_fp2(a[0], power)
        c1 = self.fp2.mul(self.frob_fp2(a[1], power), self.frob6_c1[i])
        c2 = self.fp2.mul(self.frob_fp2(a[2], power), self.frob6_c2[i])
        return (c0, c1, c2)

    def frob_fp12(self, a, power: int = 1):
        i = power % 12
        c0 = self.frob_fp6(a[0], power)
        b0, b1, b2 = (
            self.frob_fp2(a[1][0], power),
            self.frob_fp2(a[1][1], power),
            self.frob_fp2(a[1][2], power),
        )
        g = self.frob12_c1[i]
        c1 = (
            self.fp2.mul(b0, g),
            self.fp2.mul(self.fp2.mul(b1, g), self.frob6_c1[i]),
            self.fp2.mul(self.fp2.mul(b2, g), self.frob6_c2[i]),
        )
        return (c0, c1)

    # --- GT (cyclotomic subgroup) helpers ----------------------------------
    def fp12_conj(self, a):
        """f^(p^6): conjugation over Fp6 (negate the w component)."""
        return (a[0], self.fp6.neg(a[1]))

    def cyclotomic_inv(self, a):
        """In the cyclotomic subgroup, inverse == conjugation (unitary)."""
        return self.fp12_conj(a)

    def cyclotomic_sqr(self, a):
        """Squaring specialized to the cyclotomic subgroup GPhi12(p).

        Currently a plain Fp12 squaring; a Granger-Scott fast path will be
        substituted later (differential-tested against this on GT elements).
        """
        return self.fp12.sqr(a)

    def cyclotomic_pow(self, a, e: int):
        """a^e using cyclotomic squarings (a must be in GT). Handles e<0 via
        conjugation."""
        if e < 0:
            return self.cyclotomic_pow(self.cyclotomic_inv(a), -e)
        result = self.fp12.one()
        found = False
        for bit in bin(e)[2:]:
            if found:
                result = self.cyclotomic_sqr(result)
            if bit == "1":
                if found:
                    result = self.fp12.mul(result, a)
                else:
                    result = a
                    found = True
        return result if found else self.fp12.one()
