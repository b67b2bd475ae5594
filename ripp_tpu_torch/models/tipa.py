"""TIPA: GIPA with a structured (KZG-style) SRS.

Re-implementation of arkworks ripp ip_proofs/src/tipa/mod.rs: the
verifier never touches the O(n) commitment keys - the prover ships the
final folded keys plus KZG openings proving they are consistent with the
transcript's challenge polynomial.

Device usage: SRS generation is a fixed-base table over the power vector
(ops/fixed_base.py); the openings are device MSMs over quotient
coefficients; the verifier's pairing equations (KZG key openings +
base-commitment checks) batch into one device Miller product + final
exponentiation (models/pairing_check.py).

Counterpart of ripp_tpu/models/tipa.py for the TIPP configuration (the
code is generic in the config's commitments, but only tipp_config is
ported): proofs byte-identical. `prove(_with_srs_shift)` and
`verify(_with_srs_shift)` also take an optional `step(name, fn)` (as in
models/sipp.py; chip_smoke.py times the steps with it), and the
verifiers a `rand` for the PairingCheck's coefficients. The verifier is
the batched one, the reference's default; its RIPP_BATCH_VERIFY=0
per-equation host pairings are not ported yet. `ser_proof` gives a
proof's bytes in the framing of ripp_tpu/utils/proof_io.py
ser_tipa_proof.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Sequence, Tuple

from ..ops.fixed_base import fixed_base_msm
from ..ops.points import DevCurveCtx
from ..ops.tower import tree_map
from ..utils.fiat_shamir import blake2b_digest, challenge_field, rand_field
from ..utils.poly import (
    poly_coeffs_from_transcript,
    poly_eval_product_form,
    quotient_by_linear,
)
from ..utils.serialize import CurveSerializer, nonce_bytes
from . import gipa
from .algebra import HostAlg
from .gipa import _run
from .pairing_check import PairingCheck, add_base_commitment_checks
from .vectors import FrVec, PointVec


# --------------------------------------------------------------------------
# SRS (tipa/mod.rs:96-128)
# --------------------------------------------------------------------------

@dataclass
class SRS:
    ctx: DevCurveCtx
    g_alpha_powers: PointVec  # G1: g, g^a, ..., g^(a^(2n-2))
    h_beta_powers: PointVec   # G2: h, h^b, ...
    g_beta: Any               # host G1 point
    h_alpha: Any              # host G2 point

    def get_commitment_keys(self) -> Tuple[PointVec, PointVec]:
        """Even powers (step_by(2), tipa/mod.rs:114-118): ck_1 in G2 (for
        the left/G1 messages), ck_2 in G1."""
        def even(v: PointVec) -> PointVec:
            return PointVec(self.ctx, v.grp,
                            tree_map(lambda x: x[::2].contiguous(), v.pts),
                            (v.n + 1) // 2)

        return even(self.h_beta_powers), even(self.g_alpha_powers)

    def get_verifier_key(self) -> "VerifierSRS":
        return VerifierSRS(
            g=self.g_alpha_powers.first(),
            h=self.h_beta_powers.first(),
            g_beta=self.g_beta,
            h_alpha=self.h_alpha,
        )


@dataclass
class VerifierSRS:
    g: Any
    h: Any
    g_beta: Any
    h_alpha: Any


def structured_generators_scalar_power(ctx: DevCurveCtx, grp: str, num: int,
                                       g_host, s: int) -> PointVec:
    """(g, g^s, ..., g^(s^(num-1))) via the fixed-base window table
    (tipa/mod.rs:372-391)."""
    r = ctx.host.r
    powers = [1] * num
    for i in range(1, num):
        powers[i] = powers[i - 1] * s % r
    dcurve = ctx.g1 if grp == "g1" else ctx.g2
    base = PointVec.from_host(ctx, grp, [g_host])
    out = fixed_base_msm(dcurve, base.pts, powers, r.bit_length())
    return PointVec(ctx, grp, out, num)


def setup_srs(ctx: DevCurveCtx, rng, size: int) -> SRS:
    """TIPA::setup (tipa/mod.rs:150-164)."""
    host = ctx.host
    alpha = rand_field(rng, host.r)
    beta = rand_field(rng, host.r)
    g = host.g1_gen
    h = host.g2_gen
    return SRS(
        ctx=ctx,
        g_alpha_powers=structured_generators_scalar_power(
            ctx, "g1", 2 * size - 1, g, alpha
        ),
        h_beta_powers=structured_generators_scalar_power(
            ctx, "g2", 2 * size - 1, h, beta
        ),
        g_beta=host.g1.scalar_mul(g, beta),
        h_alpha=host.g2.scalar_mul(h, alpha),
    )


# --------------------------------------------------------------------------
# KZG helpers for commitment-key wellformedness (tipa/mod.rs:304-370)
# --------------------------------------------------------------------------

def prove_commitment_key_kzg_opening(srs_powers: PointVec,
                                     transcript: Sequence[int],
                                     r_shift: int, kzg_challenge: int):
    """Open the challenge polynomial at kzg_challenge; returns a host point
    (the MSM runs on the device)."""
    ctx = srs_powers.ctx
    r = ctx.host.r
    coeffs = poly_coeffs_from_transcript(transcript, r_shift, r)
    if len(coeffs) != srs_powers.n:
        raise ValueError(f"{len(coeffs)} coefficients for "
                         f"{srs_powers.n} SRS powers")
    c_eval = poly_eval_product_form(transcript, kzg_challenge, r_shift, r)
    # (f - f(c)) / (X - c)
    shifted = list(coeffs)
    shifted[0] = (shifted[0] - c_eval) % r
    quotient = quotient_by_linear(shifted, kzg_challenge, r)
    quotient += [0] * (srs_powers.n - len(quotient))
    return srs_powers.msm(FrVec.from_ints(ctx, quotient))


def add_commitment_key_g2_kzg_check(pc, ctx: DevCurveCtx,
                                    v_srs: VerifierSRS, ck_final,
                                    ck_opening, transcript: Sequence[int],
                                    r_shift: int, c: int) -> None:
    """Accumulate the G2-key opening equation (tipa/mod.rs:340-354) into a
    PairingCheck: e(g, ck_final - h^f(c)) * e(-(g_beta - g^c), op) == 1."""
    host = ctx.host
    c_eval = poly_eval_product_form(transcript, c, r_shift, host.r)
    x = host.g2.sub(ck_final, host.g2.scalar_mul(v_srs.h, c_eval))
    w = host.g1.neg(
        host.g1.sub(v_srs.g_beta, host.g1.scalar_mul(v_srs.g, c))
    )
    pc.add([(v_srs.g, x), (w, ck_opening)])


def add_commitment_key_g1_kzg_check(pc, ctx: DevCurveCtx,
                                    v_srs: VerifierSRS, ck_final,
                                    ck_opening, transcript: Sequence[int],
                                    r_shift: int, c: int) -> None:
    """Accumulate the G1-key opening equation (tipa/mod.rs:356-368):
    e(ck_final - g^f(c), h) * e(-op, h_alpha - h^c) == 1."""
    host = ctx.host
    c_eval = poly_eval_product_form(transcript, c, r_shift, host.r)
    y = host.g1.sub(ck_final, host.g1.scalar_mul(v_srs.g, c_eval))
    z = host.g2.sub(v_srs.h_alpha, host.g2.scalar_mul(v_srs.h, c))
    pc.add([(y, v_srs.h), (host.g1.neg(ck_opening), z)])


def kzg_challenge(ctx: DevCurveCtx, first_challenge: int,
                  ck_parts: List[bytes]) -> int:
    """from_random_bytes counter loop (tipa/mod.rs:194-209); ark-ff
    semantics (top-limb shave + reject) via challenge_field."""
    host = ctx.host
    fr_alg = HostAlg(host, "fr")

    def material(counter: int) -> bytes:
        return (nonce_bytes(counter) + fr_alg.ser(first_challenge)
                + b"".join(ck_parts))

    return challenge_field(blake2b_digest, material, host.r)


# --------------------------------------------------------------------------
# TIPA proper (tipa/mod.rs:130-301)
# --------------------------------------------------------------------------

@dataclass
class TIPAProof:
    gipa_proof: gipa.GIPAProof
    final_ck: Tuple[Any, Any]         # (G2 host point, G1 host point)
    final_ck_proof: Tuple[Any, Any]   # (G2 opening, G1 opening)


def _ser_key(s: CurveSerializer, kind: str, pt) -> bytes:
    """Serialize a commitment-key point by its commitment's key_kind, so
    the KZG challenge framing follows the instantiation."""
    if kind == "g1":
        return s.g1(pt)
    if kind == "g2":
        return s.g2(pt)
    raise ValueError(f"unsupported commitment key kind: {kind}")


def _kzg_challenge_of(cfg: gipa.GIPAConfig, transcript, final_ck) -> int:
    s = CurveSerializer(cfg.ctx.host)
    return kzg_challenge(cfg.ctx, transcript[0],
                         [_ser_key(s, cfg.lmc.key_kind, final_ck[0]),
                          _ser_key(s, cfg.rmc.key_kind, final_ck[1])])


def prove_with_srs_shift(cfg: gipa.GIPAConfig, srs: SRS, values, ck,
                         r_shift: int, step: Callable = _run) -> TIPAProof:
    """values = (m_a, m_b); ck = (ck_a, ck_b, ck_t). The LMC key vector
    must already be shifted by r^-1 (tipa/mod.rs:174-181)."""
    r = cfg.ctx.host.r
    m_a, m_b = values
    ck_a, ck_b, ck_t = ck
    proof, aux = gipa.prove_with_aux(cfg, m_a, m_b, ck_a, ck_b, ck_t,
                                     step=step)

    transcript = aux.transcript
    transcript_inverse = [pow(c, -1, r) for c in transcript]
    c = step("kzg_challenge",
             lambda: _kzg_challenge_of(cfg, transcript, aux.ck_base))
    ck_a_opening = step("kzg_opening_g2", lambda: (
        prove_commitment_key_kzg_opening(
            srs.h_beta_powers, transcript_inverse, pow(r_shift, -1, r), c)))
    ck_b_opening = step("kzg_opening_g1", lambda: (
        prove_commitment_key_kzg_opening(
            srs.g_alpha_powers, transcript, 1, c)))
    return TIPAProof(
        gipa_proof=proof,
        final_ck=aux.ck_base,
        final_ck_proof=(ck_a_opening, ck_b_opening),
    )


def prove(cfg: gipa.GIPAConfig, srs: SRS, values, ck,
          step: Callable = _run) -> TIPAProof:
    return prove_with_srs_shift(cfg, srs, values, ck, 1, step=step)


def verify_with_srs_shift(cfg: gipa.GIPAConfig, v_srs: VerifierSRS, ck_t,
                          com, proof: TIPAProof, r_shift: int, pc=None,
                          rand=None, step: Callable = _run) -> bool:
    """Every pairing equation of the verifier — both KZG key openings and
    the pairing-shaped base-commitment checks — folds into ONE device
    Miller product + final exponentiation under random 128-bit
    coefficients (models/pairing_check.py; `rand` is their source).

    When `pc` (a PairingCheck) is supplied, this verifier's pairing
    equations are ACCUMULATED into it instead of checked here; the caller
    runs one pc.verify() over every sub-protocol's equations."""
    ctx = cfg.ctx
    r = ctx.host.r
    base_com, transcript = step(
        "recursive_challenges",  # tipa/mod.rs:223
        lambda: gipa.compute_recursive_challenges(cfg, com, proof.gipa_proof))
    transcript_inverse = [pow(c, -1, r) for c in transcript]

    ck_a_final, ck_b_final = proof.final_ck
    ck_a_proof, ck_b_proof = proof.final_ck_proof
    own = pc is None
    if own:
        pc = PairingCheck(ctx, rand=rand)

    def kzg_checks():
        c = _kzg_challenge_of(cfg, transcript, proof.final_ck)
        add_commitment_key_g2_kzg_check(
            pc, ctx, v_srs, ck_a_final, ck_a_proof, transcript_inverse,
            pow(r_shift, -1, r), c,
        )
        add_commitment_key_g1_kzg_check(
            pc, ctx, v_srs, ck_b_final, ck_b_proof, transcript, 1, c,
        )

    step("kzg_checks", kzg_checks)
    a_base, b_base = proof.gipa_proof.r_base
    direct = step("base_checks", lambda: add_base_commitment_checks(
        pc, cfg, (ck_a_final, ck_b_final, ck_t), base_com, a_base, b_base))
    if direct is False:
        return False
    return step("pairing_check", pc.verify) if own else True


def verify(cfg: gipa.GIPAConfig, v_srs: VerifierSRS, ck_t, com,
           proof: TIPAProof, rand=None, step: Callable = _run) -> bool:
    return verify_with_srs_shift(cfg, v_srs, ck_t, com, proof, 1,
                                 rand=rand, step=step)


def ser_proof(cfg: gipa.GIPAConfig, proof: TIPAProof) -> bytes:
    """A TIPP proof's bytes, framed as ripp_tpu/utils/proof_io.py
    ser_tipa_proof frames them: u64-LE round count, each round's two
    (com_a, com_b, com_t) commitments, the base messages, the final keys
    and their openings (arkworks uncompressed encodings)."""
    s = CurveSerializer(cfg.ctx.host)
    gp = proof.gipa_proof
    out = len(gp.steps).to_bytes(8, "little")
    for com_1, com_2 in gp.steps:
        for a, b, t in (com_1, com_2):
            out += s.gt(a) + s.gt(b) + s.gt(t.items[0])
    a, b = gp.r_base
    out += s.g1(a) + s.g2(b)
    out += s.g2(proof.final_ck[0]) + s.g1(proof.final_ck[1])
    out += s.g2(proof.final_ck_proof[0]) + s.g1(proof.final_ck_proof[1])
    return out
