"""Host-side (pure python) optimal ate pairing for BLS12 curves.

Deliberately generic and simple: Q is embedded into E(Fp12) through the twist
isomorphism and the Miller loop runs with affine formulas over Fp12. This is
the *specification* implementation the device kernels (projective, sparse
line multiplication) are differential-tested against.

Capability parity targets: ark-ec Pairing::{multi_miller_loop,
final_exponentiation, pairing} as consumed at
arkworks ripp inner_products/src/lib.rs:110-115 and
arkworks ripp sipp/src/lib.rs:210-216.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .curves import PairingCurve


def fp12_from_w_coeffs(curve: PairingCurve, coeffs: Sequence[Tuple]) -> Tuple:
    """Build an Fp12 element from coefficients of 1, w, w^2, ..., w^5 (Fp2
    each), where w^6 = xi, v = w^2, Fp6 = Fp2[v], Fp12 = Fp6[w]."""
    a0, a1, a2, a3, a4, a5 = coeffs
    return ((a0, a2, a4), (a1, a3, a5))


def embed_fp(curve: PairingCurve, a: int) -> Tuple:
    z2 = curve.tower.fp2.zero()
    return fp12_from_w_coeffs(curve, [(a % curve.p, 0), z2, z2, z2, z2, z2])


def embed_g1(curve: PairingCurve, pt) -> Tuple:
    """G1 affine point -> E(Fp12) affine."""
    assert pt is not None
    return (embed_fp(curve, pt[0]), embed_fp(curve, pt[1]))


def embed_g2(curve: PairingCurve, pt) -> Tuple:
    """G2 affine (on the twist E'/Fp2) -> E(Fp12) affine via untwisting.

    D-type (b' = b/xi):  (x, y) -> (x*w^2, y*w^3)
    M-type (b' = b*xi):  (x, y) -> (x*w^-2, y*w^-3) = (x*w^4/xi, y*w^3/xi)
    """
    assert pt is not None
    T = curve.tower
    F2 = T.fp2
    z2 = F2.zero()
    x, y = pt
    if curve.twist_type == "D":
        X = fp12_from_w_coeffs(curve, [z2, z2, x, z2, z2, z2])
        Y = fp12_from_w_coeffs(curve, [z2, z2, z2, y, z2, z2])
    else:
        xi_inv = F2.inv(T.xi)
        X = fp12_from_w_coeffs(curve, [z2, z2, z2, z2, F2.mul(x, xi_inv), z2])
        Y = fp12_from_w_coeffs(curve, [z2, z2, z2, F2.mul(y, xi_inv), z2, z2])
    return (X, Y)


def miller_loop(curve: PairingCurve, p1, q2) -> Tuple:
    """f_{|x|, Q}(P) with affine arithmetic in E(Fp12).

    p1: G1 affine point, q2: G2 affine point (on the twist).
    Returns the (unreduced) Miller value; conjugated if the BLS parameter is
    negative (valid up to final exponentiation).
    """
    T12 = curve.tower
    F = T12.fp12
    P = embed_g1(curve, p1)
    Q = embed_g2(curve, q2)
    xP, yP = P
    xQ, yQ = Q

    f = F.one()
    Tx, Ty = xQ, yQ
    bits = bin(abs(curve.x))[3:]  # skip the leading 1
    for bit in bits:
        # tangent line at T, evaluated at P
        lam = F.mul(
            F.mul_int(F.sqr(Tx), 3), F.inv(F.add(Ty, Ty))
        )
        l = F.sub(F.sub(yP, Ty), F.mul(lam, F.sub(xP, Tx)))
        f = F.mul(F.sqr(f), l)
        # T = 2T
        x3 = F.sub(F.sqr(lam), F.add(Tx, Tx))
        y3 = F.sub(F.mul(lam, F.sub(Tx, x3)), Ty)
        Tx, Ty = x3, y3
        if bit == "1":
            # chord through T and Q, evaluated at P
            lam = F.mul(F.sub(yQ, Ty), F.inv(F.sub(xQ, Tx)))
            l = F.sub(F.sub(yP, Ty), F.mul(lam, F.sub(xP, Tx)))
            f = F.mul(f, l)
            x3 = F.sub(F.sub(F.sqr(lam), Tx), xQ)
            y3 = F.sub(F.mul(lam, F.sub(Tx, x3)), Ty)
            Tx, Ty = x3, y3
    if curve.x < 0:
        f = T12.fp12_conj(f)
    return f


def hard_part_ladder(curve: PairingCurve, m) -> Tuple:
    """m^((p^4 - p^2 + 1)/r) for m in the cyclotomic subgroup via the
    BLS12 seed ladder

        h = ((x-1)/3) * (x-1) * (x+p) * (x^2 + p^2 - 1) + 1

    (exact -- verified for BLS12-381/-377/toy; cf. the 3h variant of
    Hayashida et al. 2020/875; 3 | x-1 for BLS seeds so the exact form
    exists).  4 seed-length exponentiations + 2 Frobenius + a few muls,
    vs a ~4|p|-bit blind exponentiation."""
    T = curve.tower
    F = T.fp12
    x = curve.x
    g0 = T.cyclotomic_pow(m, (x - 1) // 3)
    g1 = T.cyclotomic_pow(g0, x - 1)
    g2 = F.mul(T.cyclotomic_pow(g1, x), T.frob_fp12(g1, 1))
    g3 = F.mul(
        F.mul(T.cyclotomic_pow(T.cyclotomic_pow(g2, x), x),
              T.frob_fp12(g2, 2)),
        T.cyclotomic_inv(g2),
    )
    return F.mul(g3, m)


def hard_part_blind(curve: PairingCurve, m) -> Tuple:
    """Reference hard part: blind exponentiation by the full integer
    (p^4 - p^2 + 1)/r.  Kept as the differential ground truth for
    hard_part_ladder."""
    p = curve.p
    d = (pow(p, 4) - pow(p, 2) + 1) // curve.r
    return curve.tower.cyclotomic_pow(m, d)


def final_exponentiation(curve: PairingCurve, f) -> Tuple:
    """f^((p^12 - 1)/r): easy part via Frobenius, hard part via the BLS12
    seed ladder (hard_part_ladder)."""
    T = curve.tower
    F = T.fp12
    # easy part: f^((p^6 - 1)(p^2 + 1))
    f = F.mul(T.fp12_conj(f), F.inv(f))
    f = F.mul(T.frob_fp12(f, 2), f)
    return hard_part_ladder(curve, f)


def pairing(curve: PairingCurve, p1, q2) -> Tuple:
    """Full pairing e(P, Q) in GT (Fp12). Identity inputs map to 1."""
    if p1 is None or q2 is None:
        return curve.tower.fp12.one()
    return final_exponentiation(curve, miller_loop(curve, p1, q2))


def multi_pairing(curve: PairingCurve, ps: Sequence, qs: Sequence) -> Tuple:
    """prod_i e(P_i, Q_i): product of Miller values, one final exp.

    Mirrors cfg_multi_pairing (arkworks ripp inner_products/src/lib.rs:77-116)
    semantics."""
    assert len(ps) == len(qs)
    T = curve.tower
    F = T.fp12
    acc = F.one()
    any_pair = False
    for p1, q2 in zip(ps, qs):
        if p1 is None or q2 is None:
            continue
        acc = F.mul(acc, miller_loop(curve, p1, q2))
        any_pair = True
    if not any_pair:
        return F.one()
    return final_exponentiation(curve, acc)


def gt_exp(curve: PairingCurve, g, e: int) -> Tuple:
    """GT exponentiation (uses cyclotomic structure)."""
    e = e % curve.r
    return curve.tower.cyclotomic_pow(g, e)


def gt_mul(curve: PairingCurve, a, b) -> Tuple:
    return curve.tower.fp12.mul(a, b)


def gt_inv(curve: PairingCurve, a) -> Tuple:
    return curve.tower.cyclotomic_inv(a)


def gt_one(curve: PairingCurve) -> Tuple:
    return curve.tower.fp12.one()
