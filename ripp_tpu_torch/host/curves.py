"""Pairing curve configurations (host-side ground truth).

Each `PairingCurve` bundles the tower, G1/G2 curves, generators, and pairing
parameters. Constants are validated at construction (on-curve + subgroup
checks); generators are derived deterministically if a provided constant
fails validation, so the framework never silently runs on a bad point.

Curves covered (matching reference usage, SURVEY.md section 2.2):
  BLS12-381 : all ip_proofs/dh_commitments tests and benches
  BLS12-377 : SIPP test, Groth16-aggregation bench
  JubJub    : Pedersen commitment test (ed-on-bls12-381)
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field as dc_field
from typing import Optional, Tuple

from .curve import EdwardsCurve, SWCurve
from .field import FpOps, Tower


@dataclass
class PairingCurve:
    name: str
    tower: Tower
    r: int                      # scalar field (Fr) modulus
    x: int                      # BLS parameter (signed)
    g1: SWCurve
    g2: SWCurve
    g1_gen: Tuple
    g2_gen: Tuple
    twist_type: str             # "M" or "D"
    fr: FpOps = dc_field(init=False)

    def __post_init__(self):
        self.fr = FpOps(self.r, name=f"{self.name}Fr")

    @property
    def p(self) -> int:
        return self.tower.fp.p


def _twist_cofactor(p: int, r: int, trace: int, g2curve: SWCurve) -> int:
    """Compute #E'(Fp2)/r for the correct sextic twist by testing candidate
    orders against a sample point."""
    t2 = trace * trace - 2 * p  # trace of Frobenius on E(Fp2)
    # 4p^2 - t2^2 = 3 f^2
    f2 = (4 * p * p - t2 * t2) // 3
    f = math.isqrt(f2)
    assert f * f == f2, "CM discriminant structure violated"
    candidates = []
    for tc in {t2, -t2, (t2 + 3 * f) // 2, (t2 - 3 * f) // 2,
               (-t2 + 3 * f) // 2, (-t2 - 3 * f) // 2}:
        n = p * p + 1 - tc
        if n % r == 0:
            candidates.append(n)
    pt = g2curve.find_point(start_x_int=1)
    # find_point clears no cofactor here (cofactor=1 placeholder); test orders
    for n in candidates:
        if g2curve.scalar_mul_unreduced(pt, n) is None:
            return n // r
    raise AssertionError("no candidate twist order annihilated sample point")


def _validated_gen(curve: SWCurve, candidate, start_x: int):
    """Return candidate generator if valid (on curve, in subgroup, not id),
    else derive one deterministically."""
    if (candidate is not None and curve.is_on_curve(candidate)
            and curve.in_subgroup(candidate) and candidate is not None):
        return candidate
    pt = None
    i = start_x
    while pt is None:
        cand = curve.point_from_x(curve.F.from_int(i), greatest=True)
        if cand is not None:
            cand = curve.scalar_mul_unreduced(cand, curve.cofactor)
            if cand is not None and curve.in_subgroup(cand):
                pt = cand
        i += 1
    return pt


@functools.lru_cache(maxsize=None)
def bls12_381() -> PairingCurve:
    p = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
    r = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
    x = -0xD201000000010000
    tower = Tower.build(p, beta=p - 1, xi=(1, 1), name="bls381.")
    fp, fp2 = tower.fp, tower.fp2

    h1 = (p - x) // r  # x is negative, so p - x = p + |x|
    g1 = SWCurve(fp, 0, 4, order=r, cofactor=h1, name="bls12_381.G1")

    b2 = fp2.mul_int((1, 1), 4)  # 4*(1+u): M-type twist, b' = b * xi
    g2curve = SWCurve(fp2, fp2.zero(), b2, order=r, cofactor=1,
                      name="bls12_381.G2")
    trace = x + 1
    h2 = _twist_cofactor(p, r, trace, g2curve)
    g2curve.cofactor = h2

    g1_gen = (
        0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
        0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    )
    g2_gen = (
        (
            0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
            0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
        ),
        (
            0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
            0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
        ),
    )
    g1_gen = _validated_gen(g1, g1_gen, start_x=1)
    g2_gen = _validated_gen(g2curve, g2_gen, start_x=1)
    return PairingCurve(
        name="bls12_381", tower=tower, r=r, x=x, g1=g1, g2=g2curve,
        g1_gen=g1_gen, g2_gen=g2_gen, twist_type="M",
    )


@functools.lru_cache(maxsize=None)
def bls12_377() -> PairingCurve:
    p = 0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001
    r = 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001
    x = 0x8508C00000000001
    tower = Tower.build(p, beta=p - 5, xi=(0, 1), name="bls377.")
    fp, fp2 = tower.fp, tower.fp2

    h1 = (p - x) // r
    g1 = SWCurve(fp, 0, 1, order=r, cofactor=h1, name="bls12_377.G1")

    # D-type twist: b' = b / xi = 1/u = -u/5
    inv_u = fp2.inv((0, 1))
    g2curve = SWCurve(fp2, fp2.zero(), inv_u, order=r, cofactor=1,
                      name="bls12_377.G2")
    trace = x + 1
    h2 = _twist_cofactor(p, r, trace, g2curve)
    g2curve.cofactor = h2

    g1_gen = (
        0x008848DEFE740A67C8FC6225BF87FF5485951E2CAA9D41BB188282C8BD37CB5CD5481512FFCD394EEAB9B16EB21BE9EF,
        0x01914A69C5102EFF1F674F5D30AFEEC4BD7FB348CA3E52D96D182AD44FB82305C2FE3D3634A9591AFD82DE55559C8EA6,
    )
    g2_gen = (
        (
            0x018480BE71C785FEC89630A2A3841D01C565F071203E50317EA501F557DB6B9B71889F52BB53540274E3E48F7C005196,
            0x00EA6040E700403170DC5A51B1B140D5532777EE6651CECBE7223ECE0799C9DE5CF89984BFF76FE6B26BFEFA6EA16AFE,
        ),
        (
            0x00690D665D446F7BD960736BCBB2EFB4DE03ED7274B49A58E458C282F832D204F2CF88886D8C7C2EF094094409FD4DDF,
            0x00F8169FD28355189E549DA3151A70AA61EF11AC3D591BF12463B01ACEE304C24279B83F5E52270BD9A1CDD185EB8F93,
        ),
    )
    g1_gen = _validated_gen(g1, g1_gen, start_x=1)
    g2_gen = _validated_gen(g2curve, g2_gen, start_x=1)
    return PairingCurve(
        name="bls12_377", tower=tower, r=r, x=x, g1=g1, g2=g2curve,
        g1_gen=g1_gen, g2_gen=g2_gen, twist_type="D",
    )


def _bls12_small(name: str, x: int) -> PairingCurve:
    """BLS12-family curve from a small seed x with the BLS12-381 tower
    shape (beta = -1, xi = 1 + u). Requires: r = x^4-x^2+1 and
    p = (x-1)^2 r/3 + x prime, p = 3 mod 4, xi a sextic non-residue."""
    r = x ** 4 - x ** 2 + 1
    p = (x - 1) ** 2 * r // 3 + x
    tower = Tower.build(p, beta=p - 1, xi=(1, 1), name=name + ".")
    fp, fp2 = tower.fp, tower.fp2

    h1 = (p - x) // r
    # find the curve constant b: y^2 = x^3 + b must be the twist with
    # #E(Fp) = p - x (sample points must be annihilated by p - x)
    for b in range(1, 1000):
        g1 = SWCurve(fp, 0, b, order=r, cofactor=h1, name=f"{name}.G1")
        found, ok = 0, True
        for i in range(1, 100):
            cand = g1.point_from_x(fp.from_int(i), greatest=True)
            if cand is None:
                continue
            found += 1
            if g1.scalar_mul_unreduced(cand, p - x) is not None:
                ok = False
                break
            if found >= 5:
                break
        if ok and found:
            break
    else:
        raise AssertionError(f"no valid G1 constant b for {name}")

    trace = x + 1
    # pick the sextic twist (M: b' = b*xi, D: b' = b/xi) whose order is
    # divisible by r
    for twist_type, b2 in (("M", fp2.mul_int((1, 1), b)),
                           ("D", fp2.scale(fp2.inv((1, 1)), b))):
        g2curve = SWCurve(fp2, fp2.zero(), b2, order=r, cofactor=1,
                          name=f"{name}.G2")
        try:
            h2 = _twist_cofactor(p, r, trace, g2curve)
        except AssertionError:
            continue
        g2curve.cofactor = h2
        break
    else:
        raise AssertionError(f"no valid twist found for {name}")

    g1_gen = _validated_gen(g1, None, start_x=1)
    g2_gen = _validated_gen(g2curve, None, start_x=1)
    return PairingCurve(
        name=name, tower=tower, r=r, x=x, g1=g1, g2=g2curve,
        g1_gen=g1_gen, g2_gen=g2_gen, twist_type=twist_type,
    )


@functools.lru_cache(maxsize=None)
def bls12_toy() -> PairingCurve:
    """Tiny BLS12-family curve (x = -34169, 89-bit p, 61-bit r) with the
    same tower shape as BLS12-381 (beta = -1, xi = 1 + u).

    Purpose: multi-device CPU-mesh tests and dry-run compiles the
    exact same kernel code paths ~20x faster - XLA compile time for the limb
    kernels scales with limb_count^2, and the full-width Miller loop takes
    >40 min to compile on the CPU backend. Cryptographically REAL (prime p,
    prime r, valid sextic twist), just far too small to be secure."""
    return _bls12_small("bls12_toy", -34169)


@functools.lru_cache(maxsize=None)
def bls12_nano() -> PairingCurve:
    """Smallest valid BLS12-family seed (x = -56: 34-bit p, 24-bit r,
    5-step Miller loop) with the BLS12-381 tower shape.

    Purpose: the multichip dryrun gate (__graft_entry__.dryrun_multichip)
    runs on a 1-core CPU host where even the toy curve's sharded Miller
    module is a multi-minute XLA:CPU compile (the rc=124 timeouts of
    rounds 2-3); at 3 limbs and 5 Miller steps the same code paths
    compile another order of magnitude faster. Cryptographically REAL
    (prime p, prime r, valid sextic twist), zero security."""
    return _bls12_small("bls12_nano", -56)


@dataclass
class BW6Curve:
    """BW6-761: the embedding-degree-6 outer curve for BLS12-377 (used by the
    reference only in the one-layer-recursion benchmark,
    arkworks ripp benches/benches/groth16_aggregation/bench.rs:84-161).

    Its scalar field r equals BLS12-377's BASE field p, so a SNARK over
    BW6-761 can verify BLS12-377 pairings natively.  Both G1 and G2 live
    over Fp directly (sextic twist of y^2 = x^3 - 1 is y^2 = x^3 + 4).

    Parameters reconstructed in-image from the published Brezing-Weng
    parameterization (El Housni-Guillevic 2020): p = p(u)/9 at the
    BLS12-377 seed u, VERIFIED here by (a) Miller-Rabin primality of p,
    (b) exhaustive trace search t = p+1 mod r + k*r over |t| <= 2*sqrt(p)
    with random-point order tests -- both curves have a unique passing
    trace and r | #E, and the cofactors satisfy the published h2 = h1 - 7.
    Generators are derived deterministically (smallest valid x, cofactor
    cleared); they need not match ark-bw6-761's choice (affects only
    cross-library fixture bytes, not any protocol math).
    """

    name: str
    u: int                 # shared BLS12-377 seed
    r: int                 # scalar field = BLS12-377 base field p
    fp: "FpOps"
    fr: "FpOps"
    g1: SWCurve
    g2: SWCurve
    g1_gen: Tuple
    g2_gen: Tuple

    @property
    def p(self) -> int:
        return self.fp.p


@functools.lru_cache(maxsize=None)
def bw6_761() -> BW6Curve:
    u = 0x8508C00000000001
    # p = (103u^12 - 379u^11 + 250u^10 + 691u^9 - 911u^8 - 79u^7 + 623u^6
    #      - 640u^5 + 274u^4 + 763u^3 + 73u^2 + 254u + 229)/9
    p = 0x122E824FB83CE0AD187C94004FAFF3EB926186A81D14688528275EF8087BE41707BA638E584E91903CEBAFF25B423048689C8ED12F9FD9071DCD3DC73EBFF2E98A116C25667A8F8160CF8AEEAF0A437E6913E6870000082F49D00000000008B
    r = 0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001
    # verified traces (unique in the Hasse interval with r | p+1-t)
    t1 = 0x15D8F58F3501DBEC1AB2F9CB6145AEECB55FC0D440CB48F058490FB40986940170B5D44300000007467A800000000010
    t2 = 0x219C8D79DB6552578650220E59AEAF8A6C53B679477ED1DA30F0BF021FC78C02120561205000000AE9B7C00000000017
    h1 = (p + 1 - t1) // r
    h2 = (p + 1 - t2) // r
    fp = FpOps(p, name="bw6_761.Fp")
    fr = FpOps(r, name="bw6_761.Fr")
    g1 = SWCurve(fp, 0, p - 1, order=r, cofactor=h1, name="bw6_761.G1")
    g2 = SWCurve(fp, 0, 4, order=r, cofactor=h2, name="bw6_761.G2")
    g1_gen = _validated_gen(g1, None, start_x=1)
    g2_gen = _validated_gen(g2, None, start_x=1)
    return BW6Curve(name="bw6_761", u=u, r=r, fp=fp, fr=fr,
                    g1=g1, g2=g2, g1_gen=g1_gen, g2_gen=g2_gen)


@dataclass
class EmbeddedCurve:
    """A non-pairing curve embedded over some Fr (JubJub over BLS12-381 Fr)."""
    name: str
    curve: EdwardsCurve
    gen: Tuple
    r: int  # its own prime subgroup order


@functools.lru_cache(maxsize=None)
def jubjub() -> EmbeddedCurve:
    """ed-on-bls12-381 (JubJub): twisted Edwards, a = -1, over BLS12-381 Fr."""
    q = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
    r = 0x0E7DB4EA6533AFA906673B0101343B00A6682093CCC81082D0970E5ED6F72CB7
    d = 0x2A9318E74BFA2B48F5FD9207E6BD7FD4292D7F6D37579D2601065FD6D6343EB1
    F = FpOps(q, name="jubjub.Fq")
    curve = EdwardsCurve(F, F.neg(F.one()), d, order=r, cofactor=8,
                         name="jubjub")
    # deterministic generator: walk y candidates, solve for x, clear cofactor
    gen = None
    y_int = 2
    while gen is None:
        y = F.from_int(y_int)
        # a x^2 + y^2 = 1 + d x^2 y^2 -> x^2 = (y^2 - 1) / (d y^2 - a)
        num = F.sub(F.sqr(y), F.one())
        den = F.sub(F.mul(d, F.sqr(y)), curve.a)
        if not F.is_zero(den):
            x2 = F.mul(num, F.inv(den))
            xx = F.sqrt(x2)
            if xx is not None:
                cand = (xx, y)
                for _ in range(3):  # multiply by cofactor 8
                    cand = curve.double(cand)
                if not curve.is_identity(cand):
                    gen = cand
        y_int += 1
    return EmbeddedCurve(name="jubjub", curve=curve, gen=gen, r=r)


def get_curve(name: str) -> PairingCurve:
    if name in ("bls12_381", "BLS12-381"):
        return bls12_381()
    if name in ("bls12_377", "BLS12-377"):
        return bls12_377()
    if name in ("bls12_toy", "BLS12-toy"):
        return bls12_toy()
    if name in ("bls12_nano", "BLS12-nano"):
        return bls12_nano()
    raise ValueError(f"unknown curve {name}")
