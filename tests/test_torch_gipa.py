"""GIPA over the TIPP configuration: the port against the JAX package.

  * the port's prove_with_aux on the instance of tests/test_golden.py
    (test_golden_gipa_transcript: n = 8, bls12_nano, SeededRng(18))
    reproduces tests/golden_transcripts.json["gipa"] byte for byte: the
    challenge transcript and every round's serialized com_1 / com_2. That
    fixture is the JAX package's output; tests/test_golden.py re-derives
    it from ripp_tpu on every run;
  * the verifier: gipa.verify accepts that proof and rejects a proof with
    a doubled base message and one with a round commitment changed; the
    keys it folds through the challenge-product MSM equal the prover's
    folded keys and the host's MSM by final_ck_exponents;
  * the host-side helpers ported with the slice equal the JAX package's:
    the counter-nonce challenges, the random generators, the TIPA
    polynomial helpers, the fixed-base digit matrix, the errors.

Exact comparisons throughout (integer arithmetic, bytes): tolerance zero.
"""

import copy
import json
import os

import pytest

from ripp_tpu_torch.errors import (
    InnerProductArgumentError,
    InnerProductError,
    check_power_of_two,
    check_same_length,
)
from ripp_tpu_torch.models import gipa
from ripp_tpu_torch.models.instances import tipp_config
from ripp_tpu_torch.models.vectors import PointVec
from ripp_tpu_torch.ops.points import dev_ctx
from ripp_tpu_torch.utils.fiat_shamir import SeededRng, rand_sw_point


def _fixture():
    path = os.path.join(os.path.dirname(__file__), "golden_transcripts.json")
    with open(path) as fh:
        return json.load(fh)["gipa"]


@pytest.fixture(scope="module")
def golden():
    """The golden GIPA instance and the port's proof of it."""
    ctx = dev_ctx("bls12_nano", device="cpu")
    host = ctx.host
    rng = SeededRng(18)
    cfg = tipp_config(ctx)
    n = 8
    mA = [rand_sw_point(rng, host.g1) for _ in range(n)]
    mB = [rand_sw_point(rng, host.g2) for _ in range(n)]
    # the commitments' own key setup draws the fixture's keys
    ck_a, ck_b = cfg.lmc.setup(rng, n), cfg.rmc.setup(rng, n)
    ck_t = cfg.ipc.setup(rng, 1)
    vecs = (PointVec.from_host(ctx, "g1", mA),
            PointVec.from_host(ctx, "g2", mB), ck_a, ck_b)
    proof, aux = gipa.prove_with_aux(cfg, *vecs, ck_t)
    return (cfg, (mA, mB, ck_a.to_host(), ck_b.to_host()), vecs, ck_t,
            proof, aux)


def test_golden_gipa_transcript_and_commitments(golden):
    cfg, _, _, _, proof, aux = golden
    fix = _fixture()
    assert [hex(c) for c in reversed(aux.transcript)] == fix["transcript"]
    assert len(proof.steps) == len(fix["coms"]) == 3
    for (com_1, com_2), want in zip(reversed(proof.steps), fix["coms"]):
        assert gipa._ser_com(cfg, com_1).hex() == want["com1"]
        assert gipa._ser_com(cfg, com_2).hex() == want["com2"]


def test_gipa_verify_accepts_and_rejects(golden):
    cfg, (mA, mB, ckA, ckB), vecs, ck_t, proof, aux = golden
    ctx = cfg.ctx
    host = ctx.host
    m_a, m_b, ck_a, ck_b = vecs
    com = (cfg.lmc.commit(ck_a, m_a), cfg.rmc.commit(ck_b, m_b),
           cfg.ipc.commit(ck_t, [cfg.ip.compute(m_a, m_b)]))
    # the verifier's folded keys are the prover's, and the host's MSM
    base_com, transcript = gipa.compute_recursive_challenges(cfg, com, proof)
    assert transcript == aux.transcript
    ck_a_base, ck_b_base = gipa.compute_final_commitment_keys(
        cfg, ck_a, ck_b, transcript)
    assert (ck_a_base, ck_b_base) == aux.ck_base
    w_a, w_b = gipa.final_ck_exponents(host.r, transcript)
    assert ck_a_base == host.g2.msm(ckA, w_a)
    assert ck_b_base == host.g1.msm(ckB, w_b)
    ck = (ck_a, ck_b, ck_t)
    assert gipa.verify(cfg, ck, com, proof)
    # gipa.prove's consistency prechecks (gipa.rs:108) refuse a wrong
    # inner product and a wrong left commitment before any round
    t = com[2].items[0]
    bad_t = host.tower.fp12.mul(t, t)
    with pytest.raises(InnerProductArgumentError, match="not sound"):
        gipa.prove(cfg, (m_a, m_b, bad_t), ck, (com[0], com[1],
                                               cfg.ipc.commit(ck_t, [bad_t])))
    with pytest.raises(InnerProductArgumentError, match="left message"):
        gipa.prove(cfg, (m_a, m_b, t), ck, (bad_t, com[1], com[2]))
    bad = copy.deepcopy(proof)
    a0, b0 = bad.r_base
    bad.r_base = (host.g1.double(a0), b0)
    assert not gipa.verify(cfg, ck, com, bad)
    bad = copy.deepcopy(proof)
    (ca, cb, ct), com_2 = bad.steps[1]
    bad.steps[1] = ((ca, host.tower.fp12.mul(cb, cb), ct), com_2)
    assert not gipa.verify(cfg, ck, com, bad)


def test_challenges_and_generators_equal_reference():
    from ripp_tpu.host.curves import bls12_nano as ref_nano
    from ripp_tpu.utils import fiat_shamir as ref_fs

    from ripp_tpu_torch.host.curves import bls12_nano
    from ripp_tpu_torch.utils import fiat_shamir as fs

    r = bls12_nano().r
    for k in range(64):
        data = fs.blake2b_digest(bytes([k]) * 9)
        assert fs.field_from_random_bytes(data, r) == \
            ref_fs.field_from_random_bytes(data, r)

    def material(counter):
        return counter.to_bytes(8, "big") + b"material"

    for modulus in (r, bls12_nano().p, 2**255 - 19):
        assert fs.challenge_field(fs.blake2b_digest, material, modulus) == \
            ref_fs.challenge_field(ref_fs.blake2b_digest, material, modulus)
    got = fs.random_generators(fs.SeededRng(3), bls12_nano().g2, 3)
    want = ref_fs.random_generators(ref_fs.SeededRng(3), ref_nano().g2, 3)
    assert got == want


def test_poly_and_digit_helpers_equal_reference():
    import numpy as np

    from ripp_tpu.ops.fixed_base import scalars_to_digit_matrix as ref_dm
    from ripp_tpu.utils import poly as ref_poly

    from ripp_tpu_torch.ops.fixed_base import scalars_to_digit_matrix
    from ripp_tpu_torch.utils import poly

    r = (1 << 61) - 1
    ts = [3, 5, 7, 11]
    for shift in (1, 12345):
        assert poly.poly_coeffs_from_transcript(ts, shift, r) == \
            ref_poly.poly_coeffs_from_transcript(ts, shift, r)
        assert poly.poly_eval_product_form(ts, 99, shift, r) == \
            ref_poly.poly_eval_product_form(ts, 99, shift, r)
    coeffs = poly.poly_coeffs_from_transcript(ts, 7, r)
    q = poly.quotient_by_linear(coeffs, 99, r)
    assert q == ref_poly.quotient_by_linear(coeffs, 99, r)
    # (f(X) - f(z)) = q(X) (X - z): check at X = 5
    f5 = poly.poly_eval(coeffs, 5, r)
    assert (f5 - poly.poly_eval(coeffs, 99, r)) % r == \
        poly.poly_eval(q, 5, r) * (5 - 99) % r
    assert poly.structured_scalar_power(6, 9, r) == \
        ref_poly.structured_scalar_power(6, 9, r)
    ks = [0, 1, 255, 256, 2**40 + 7, r - 1]
    assert np.array_equal(scalars_to_digit_matrix(ks, 8, 61),
                          ref_dm(ks, 8, 61))


def test_errors_match_reference():
    from ripp_tpu import errors as ref_errors

    for n in (0, 3, 6):
        with pytest.raises(InnerProductArgumentError) as got:
            check_power_of_two(n)
        with pytest.raises(ref_errors.InnerProductArgumentError) as want:
            ref_errors.check_power_of_two(n)
        assert str(got.value) == str(want.value)
    check_power_of_two(8)
    with pytest.raises(InnerProductError) as got:
        check_same_length([1, 2], [3])
    assert str(got.value) == str(
        ref_errors.InnerProductError.message_length_invalid(2, 1))
    assert issubclass(InnerProductArgumentError, ValueError)
