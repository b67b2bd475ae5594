"""Host-side (pure python) elliptic curve group operations.

Affine representation: a point is a tuple (x, y) of field elements, or None
for the identity. Generic over a FieldOps instance so the same code serves
G1 (Fp), G2 (Fp2) and BW6 groups; a twisted-Edwards variant covers JubJub.

Capability parity with ark-ec group ops consumed by RIPP
(SURVEY.md section 2.3: point add/double, scalar mul, batch-to-affine, MSM).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .field import FieldOps

Point = Optional[Tuple]  # (x, y) affine or None = identity


class SWCurve:
    """Short Weierstrass curve y^2 = x^3 + a x + b over a FieldOps."""

    kind = "sw"

    def __init__(self, field: FieldOps, a, b, order: int, cofactor: int = 1,
                 name: str = "curve"):
        self.F = field
        self.a = a
        self.b = b
        self.order = order  # prime subgroup order r
        self.cofactor = cofactor
        self.name = name
        self._native = False  # False=untried, None=unavailable, else NativeSW

    def _native_group(self):
        """Lazily bind the C group-law backend (ripp_tpu_torch/native) when this
        is an a=0 curve over Fp or Fp2 — bit-exact, ~20x faster scalar
        muls; pure-Python remains both the fallback and the cross-check."""
        if self._native is not False:
            return self._native
        self._native = None
        try:
            from .field import FpOps, QuadExtOps
            if not self.F.is_zero(self.a):
                return None
            if isinstance(self.F, FpOps):
                from ..native import NativeFp, NativeSW
                self._native = NativeSW(NativeFp(self.F.p), 1)
            elif isinstance(self.F, QuadExtOps) and \
                    isinstance(self.F.base, FpOps):
                from ..native import NativeFp, NativeSW
                beta = self.F.mul_by_nr(1)  # closure is a -> a*beta in Fp
                self._native = NativeSW(
                    NativeFp(self.F.base.p), 2, beta=beta)
        except Exception:
            self._native = None
        return self._native

    # --- predicates ---------------------------------------------------------
    def is_on_curve(self, pt: Point) -> bool:
        if pt is None:
            return True
        x, y = pt
        F = self.F
        lhs = F.sqr(y)
        rhs = F.add(F.add(F.mul(F.sqr(x), x), F.mul(self.a, x)), self.b)
        return F.eq(lhs, rhs)

    def in_subgroup(self, pt: Point) -> bool:
        # must NOT reduce mod order (r*P == identity is the whole test)
        return self.scalar_mul_unreduced(pt, self.order) is None

    def eq(self, p: Point, q: Point) -> bool:
        if p is None or q is None:
            return p is None and q is None
        return self.F.eq(p[0], q[0]) and self.F.eq(p[1], q[1])

    # --- group law ----------------------------------------------------------
    def neg(self, p: Point) -> Point:
        if p is None:
            return None
        return (p[0], self.F.neg(p[1]))

    def double(self, p: Point) -> Point:
        if p is None:
            return None
        F = self.F
        x, y = p
        if F.is_zero(y):
            return None
        # lambda = (3x^2 + a) / 2y
        num = F.add(F.mul_int(F.sqr(x), 3), self.a)
        lam = F.mul(num, F.inv(F.add(y, y)))
        x3 = F.sub(F.sqr(lam), F.add(x, x))
        y3 = F.sub(F.mul(lam, F.sub(x, x3)), y)
        return (x3, y3)

    def add(self, p: Point, q: Point) -> Point:
        if p is None:
            return q
        if q is None:
            return p
        F = self.F
        x1, y1 = p
        x2, y2 = q
        if F.eq(x1, x2):
            if F.eq(y1, y2):
                return self.double(p)
            return None  # p = -q
        lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
        x3 = F.sub(F.sub(F.sqr(lam), x1), x2)
        y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
        return (x3, y3)

    def sub(self, p: Point, q: Point) -> Point:
        return self.add(p, self.neg(q))

    def scalar_mul(self, p: Point, k: int) -> Point:
        k = k % self.order if self.order else k
        if p is None or k == 0:
            return None
        nat = self._native_group()
        if nat is not None:
            return nat.scalar_mul(p, k)
        acc = None
        for bit in bin(k)[2:]:
            acc = self.double(acc)
            if bit == "1":
                acc = self.add(acc, p)
        return acc

    def scalar_mul_unreduced(self, p: Point, k: int) -> Point:
        """Scalar mul without reducing k mod r (for cofactor clearing)."""
        if p is None or k == 0:
            return None
        if k < 0:
            return self.neg(self.scalar_mul_unreduced(p, -k))
        nat = self._native_group()
        if nat is not None:
            return nat.scalar_mul(p, k)
        acc = None
        for bit in bin(k)[2:]:
            acc = self.double(acc)
            if bit == "1":
                acc = self.add(acc, p)
        return acc

    def scalar_mul_batch(self, p: Point, ks: Sequence[int]) -> List[Point]:
        """[k_i * p for each k_i] — the fixture-generation hot path
        (one native call for the whole batch when available)."""
        ks = [k % self.order if self.order else k for k in ks]
        nat = self._native_group()
        if nat is not None and p is not None:
            out = nat.scalar_mul_batch(p, ks)
            return [None if k == 0 else q for k, q in zip(ks, out)]
        return [self.scalar_mul(p, k) for k in ks]

    def msm(self, points: Sequence[Point], scalars: Sequence[int]) -> Point:
        """Reference MSM (Pippenger, host-side)."""
        assert len(points) == len(scalars)
        if not points:
            return None
        nat = self._native_group()
        if nat is not None:
            red = [s % self.order if self.order else s for s in scalars]
            return nat.msm(points, red)
        c = max(2, min(16, (len(points).bit_length())))
        nbits = self.order.bit_length() if self.order else 256
        windows = (nbits + c - 1) // c
        result = None
        for w in range(windows - 1, -1, -1):
            if result is not None:
                for _ in range(c):
                    result = self.double(result)
            buckets: List[Point] = [None] * (1 << c)
            for pt, s in zip(points, scalars):
                idx = (s >> (w * c)) & ((1 << c) - 1)
                if idx:
                    buckets[idx] = self.add(buckets[idx], pt)
            running = None
            acc = None
            for b in range(len(buckets) - 1, 0, -1):
                running = self.add(running, buckets[b])
                acc = self.add(acc, running)
            result = self.add(result, acc)
        return result

    # --- point generation ---------------------------------------------------
    def point_from_x(self, x, greatest: bool) -> Point:
        """Solve for y given x; pick the lexicographically-greatest root when
        `greatest` (mirrors arkworks get_point_from_x semantics). Returns None
        if x is not on the curve. Only for prime fields or Fp2."""
        F = self.F
        rhs = F.add(F.add(F.mul(F.sqr(x), x), F.mul(self.a, x)), self.b)
        y = self._sqrt(rhs)
        if y is None:
            return None
        y_neg = F.neg(y)
        if self._lex_greater(y, y_neg) != greatest:
            y = y_neg
        return (x, y)

    def _sqrt(self, a):
        F = self.F
        if hasattr(F, "sqrt"):
            return F.sqrt(a)
        # Fp2 sqrt via the complex method (works when -1 is usable); generic:
        # use the p^2 formula: candidate = a^((q+1)/4) patterns. Fall back to
        # generic Tonelli-Shanks over the extension via exponentiation.
        q = F.p ** F.degree
        if q % 4 == 3:
            cand = F.pow(a, (q + 1) // 4)
        else:
            cand = self._ts_sqrt(a, q)
            if cand is None:
                return None
        return cand if F.eq(F.sqr(cand), a) else None

    def _ts_sqrt(self, a, q):
        F = self.F
        if F.is_zero(a):
            return F.zero()
        # Euler criterion
        if not F.eq(F.pow(a, (q - 1) // 2), F.one()):
            return None
        s, m = q - 1, 0
        while s % 2 == 0:
            s //= 2
            m += 1
        # find a non-residue z
        z = None
        # try small "integers" and the extension generator patterns
        for trial in range(2, 50):
            cand = F.from_int(trial)
            if F.eq(F.pow(cand, (q - 1) // 2), F.one()):
                continue
            z = cand
            break
        if z is None and hasattr(F, "fromlist"):
            n = F.degree
            for trial in range(1, 50):
                ints = [trial] + [1] * (n - 1)
                cand = F.fromlist([v % F.p for v in ints])
                if F.eq(F.pow(cand, (q - 1) // 2), F.one()):
                    continue
                z = cand
                break
        if z is None:
            return None
        c = F.pow(z, s)
        t = F.pow(a, s)
        r = F.pow(a, (s + 1) // 2)
        while not F.eq(t, F.one()):
            t2i = t
            i = 0
            for i in range(1, m):
                t2i = F.sqr(t2i)
                if F.eq(t2i, F.one()):
                    break
            b = F.pow(c, 1 << (m - i - 1))
            m, c = i, F.sqr(b)
            t = F.mul(t, c)
            r = F.mul(r, b)
        return r

    def _lex_greater(self, y, y_neg) -> bool:
        """Is y lexicographically greater than -y (arkworks 'greatest' flag)?
        Compares flattened coordinate lists big-endian-most-significant-first
        (for Fp: y > p/2; for Fp2: compare c1 then c0 like arkworks)."""
        ly = list(reversed(self.F.tolist(y)))
        ln = list(reversed(self.F.tolist(y_neg)))
        return ly > ln

    def find_point(self, start_x_int: int = 0) -> Point:
        """Deterministically find a subgroup point by walking x candidates and
        clearing the cofactor."""
        F = self.F
        i = start_x_int
        while True:
            x = F.from_int(i)
            pt = self.point_from_x(x, greatest=True)
            if pt is not None:
                pt = self.scalar_mul_unreduced(pt, self.cofactor)
                if pt is not None:
                    return pt
            i += 1


class EdwardsCurve:
    """Twisted Edwards curve a x^2 + y^2 = 1 + d x^2 y^2 (JubJub analog).

    Identity is (0, 1); addition is complete.
    """

    kind = "edwards"

    def __init__(self, field: FieldOps, a, d, order: int, cofactor: int = 1,
                 name: str = "edwards"):
        self.F = field
        self.a = a
        self.d = d
        self.order = order
        self.cofactor = cofactor
        self.name = name

    def identity(self):
        return (self.F.zero(), self.F.one())

    def is_identity(self, p) -> bool:
        return self.F.is_zero(p[0]) and self.F.eq(p[1], self.F.one())

    def is_on_curve(self, p) -> bool:
        F = self.F
        x, y = p
        x2, y2 = F.sqr(x), F.sqr(y)
        lhs = F.add(F.mul(self.a, x2), y2)
        rhs = F.add(F.one(), F.mul(F.mul(self.d, x2), y2))
        return F.eq(lhs, rhs)

    def eq(self, p, q) -> bool:
        return self.F.eq(p[0], q[0]) and self.F.eq(p[1], q[1])

    def neg(self, p):
        return (self.F.neg(p[0]), p[1])

    def add(self, p, q):
        F = self.F
        x1, y1 = p
        x2, y2 = q
        x1y2 = F.mul(x1, y2)
        x2y1 = F.mul(x2, y1)
        y1y2 = F.mul(y1, y2)
        x1x2 = F.mul(x1, x2)
        dxy = F.mul(self.d, F.mul(x1y2, x2y1))
        x3 = F.mul(F.add(x1y2, x2y1), F.inv(F.add(F.one(), dxy)))
        y3 = F.mul(
            F.sub(y1y2, F.mul(self.a, x1x2)), F.inv(F.sub(F.one(), dxy))
        )
        return (x3, y3)

    def double(self, p):
        return self.add(p, p)

    def scalar_mul(self, p, k: int):
        k = k % self.order
        acc = self.identity()
        for bit in bin(k)[2:] if k else "":
            acc = self.double(acc)
            if bit == "1":
                acc = self.add(acc, p)
        return acc

    def msm(self, points, scalars):
        acc = self.identity()
        for p, s in zip(points, scalars):
            acc = self.add(acc, self.scalar_mul(p, s))
        return acc
