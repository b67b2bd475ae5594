"""TIPA over the TIPP configuration (GIPA + KZG-checked keys): the port
against the JAX package, and the slice as a whole on bls12_nano.

  * the port's TIPP proofs at n = 4 on bls12_nano, without and with an SRS
    shift, equal the JAX package's byte for byte. The JAX package's setup
    alone takes minutes of XLA:CPU compile here, so its bytes are frozen
    below (FROZEN). `_reference_proof_hex` makes them through the JAX
    package; test_frozen_bytes_are_the_reference_proofs (marked `slow`, so
    the quick suite leaves it out) holds FROZEN against it:
    `python -m pytest tests/test_torch_tipa.py -m slow`.
  * verify accepts the honest proofs and rejects tampered ones (a doubled
    base message, a doubled final key, one GT element changed) and a wrong
    commitment or SRS shift;
  * a context with fp_kernel="hybrid8" gives the same proof bytes, and
    prove / verify run every step through the `step` argument;
  * PairingCheck decides as the JAX package's PairingCheck on the same
    equations and coefficients: honest equations, a wrong right-hand
    side, and right-hand sides added without pairs (accepted, the
    reference's rule). The reference's accumulator runs with its device
    pairing replaced by its own host model (ripp_tpu.host.pairing), which
    computes the same values without compiling: what is compared is the
    decision logic.

Exact comparisons throughout (bytes, group elements): tolerance zero.
"""

import copy
from types import SimpleNamespace

import pytest
import torch

from ripp_tpu_torch.host import pairing as hp
from ripp_tpu_torch.models import tipa
from ripp_tpu_torch.models.instances import tipp_config
from ripp_tpu_torch.models.pairing_check import PairingCheck
from ripp_tpu_torch.models.vectors import FrVec, PointVec
from ripp_tpu_torch.ops.points import dev_ctx
from ripp_tpu_torch.utils.fiat_shamir import (
    SeededRng,
    rand_field,
    rand_sw_point,
)

FROZEN = {
    41: (
    "020000000000000069ec3a2800ad397cd300e56569430297ea7cb000ec4cefa60113a8cc"
    "b201a333239300a9ebe0350278aa364100f4bfb3a90180162f4802bd67811200859a40b9"
    "0182f404b3012a1c9a5401b376e48a0159c0b22000714f401301f6ba3483000bc69e5902"
    "2f2da65b005a2d55b70113e49f4402e07962a50124fdf22a01aaae304e02690964ed00da"
    "a30f3c00eab207f9006626e58e019b0399300095809f66010fa9a816012d0a65c6019985"
    "d56b00d8a8ae3c01ffc2d6e8013028717d003eeef16a006a1cc68d00a0323446015002b6"
    "5e02d3773b78021d59b84d009165166302e9a532780299e606510143e55f8a002cdb3880"
    "00f2003f76021ea4cf0202c1987a7f008d8c1317026ce3293d022173d96002937308f400"
    "29cbd77e0002966fdb011f9587ca00e3e9eb6701442fa40301219de45501a52e8892013e"
    "35b75c01bf8874670055861e6001a5cb986300d6f8636301b09a8e8700a5c2d82301c98b"
    "713900c6e04a910135391768027c99c7a40155ae2ea6006edad65c021d9a1da100503145"
    "52010209607a00cf5215a4016d9d404c01136aee21024ae4f62600ca9cf159009ba03527"
    "01eb958c57018e88c85c013ab5a1ce00747f2d7b00e103ebc101519685b7009a96c00600"
    "23c4721c00568e6340023cd8ff7d01061938c600bb150c47010e5be6fd00225929090276"
    "1e667d0022e3d091004204bb5a00b6cc283201bfde26b5019f91ada0017bb230d200a786"
    "594901247bdf9e0099b997250127cbac6e01e1737f58003b51954700ef654a770178b2b8"
    "38008b6df9d500ec162e2e022d31cf9901ce945552027164e450019445d3f801d3037950"
    "01b6b010f000c7922e1201fd50f502025498ba0e01ee4d02f4007733565901611b23de00"
    "8e1754a501a1841d42006fcd56b300007ae55c00e77a4e110168e421ca007899e6d900c2"
    "f4866400771912c301c09f5d2f02b816f9ea00833030c1001e949488006aa08291015413"
    "d01d0034fb9220022d938fd400f6ac14af815104c4a701ef6bb9ae019546f5ff00088fe4"
    "4b007ff752a900498b747001700d5d5c0280ac47b681d56df9d9002c491b9f00929d7f7a"
    "023ffed433008735dc470082178b1c000032a29201d28b111501"
    ),
    42: (
    "020000000000000067c4e9e600ce8d087701a92e0a00025f033d4902f3f15471012d5e07"
    "c0014122b64a008ff9d4fc000d2a5309001452bd1202facf73e40148501c3d0008a76506"
    "0151a5e8cb01d37f8b57028724ba4300b3baaadc00e763792d02b1b68e3002dcc784fe01"
    "53a66cc100d0713888003cb06b250252b3d0b6003c91cd6d018764a0be01e513f0bc00bf"
    "7b2fdb00a9ded8f900e13efa4f01193ffa8b017f4cdb56002692bd4a02f6ff1e9b01ce2b"
    "7c5a0192d41a45020187701e004e84265400501d736602bd45358000f230de4b010baebe"
    "7a00a74d62f301ccfb430b024873401202a94f445802a0f4e67702fe024b190112d57588"
    "00b728ddc800d50fcf66029d57cc340050028667009c63538301f9d3d52c011313a53701"
    "2f4631ed0061bfade2003460724501bbdba9b90085fd90bf00802cb1a6014dd15718008a"
    "53c1a70176f40765027ea331330259d6594b025811587602353b4a47026e7ae7200125fa"
    "e175028eedd15102f36b015302f71152c10126b072f0009056652b008df7652101988b58"
    "c7013fac973400ee046ed600ee71438401b3c398b001e304dc67028fbcc0b901957a9790"
    "014d8b72e80072807b7801da1fb5f401889b22d9002a2808bd00b71b17ee018aeabb1300"
    "8675168e0150d2087f0005e4b2df01568b9e180059ab02fd006f29099b00fcc694750276"
    "639e04029103833a01a62f7a350102a904ae015bd6464e023ddd6c0f0279ac94c6004ee8"
    "fccc00926f3437003df9080200e74fe67800fa71e79200dd0cbc60009b998b2600807b05"
    "ad00ffad476e0005d840d60053a4e77601eec644de00c652c95f016dc46e81002a2e6914"
    "01f1b7f732025b8e042701d898343d02312f6b5e01e54ceb12014c47f83d024716087b01"
    "89394f4f01ba0c9100008bd7643b01f218a860008d3833ee0121dea7fb016bcb5f3900e8"
    "add7ac009242c35800e4caf87d01892a8d2202a672682400d79afc840022718cb101dc51"
    "4ee700c26e829d00a0e34fdb0194ba572d82d97edce1004f3c1cb101291f4c7e0072c311"
    "aa817933818301d683f45801fb971f4502ec3b0e8e00d6c0452e01f75d0c0001e0b89bd2"
    "012dd986f301e3b3736100e19c258500604c5f5c0038cddb7681"
    ),
}


def _reference_proof_hex(seed, n=4, shift=False):
    """The JAX package's TIPP proof on the instance `_instance` builds, as
    hex: the source of FROZEN."""
    from ripp_tpu.models import tipa as ref_tipa
    from ripp_tpu.models.instances import tipp_config as ref_tipp_config
    from ripp_tpu.models.vectors import FrVec as RefFrVec
    from ripp_tpu.models.vectors import PointVec as RefPointVec
    from ripp_tpu.ops.points import dev_ctx as ref_dev_ctx
    from ripp_tpu.utils import fiat_shamir as ref_fs
    from ripp_tpu.utils.proof_io import ser_tipa_proof

    ctx = ref_dev_ctx("bls12_nano")
    host = ctx.host
    rng = ref_fs.SeededRng(seed)
    cfg = ref_tipp_config(ctx)
    srs = ref_tipa.setup_srs(ctx, rng, n)
    ck_a, ck_b = srs.get_commitment_keys()
    ck_t = cfg.ipc.setup(rng, 1)
    m_a = RefPointVec.from_host(
        ctx, "g1", [ref_fs.rand_sw_point(rng, host.g1) for _ in range(n)])
    m_b = RefPointVec.from_host(
        ctx, "g2", [ref_fs.rand_sw_point(rng, host.g2) for _ in range(n)])
    r_shift = ref_fs.rand_field(rng, host.r) if shift else 1
    if shift:
        r_inv = pow(r_shift, -1, host.r)
        m_a = m_a.hadamard_scale(RefFrVec.from_ints(
            ctx, [pow(r_shift, i, host.r) for i in range(n)]))
        ck_a = ck_a.hadamard_scale(RefFrVec.from_ints(
            ctx, [pow(r_inv, i, host.r) for i in range(n)]))
    proof = ref_tipa.prove_with_srs_shift(
        cfg, srs, (m_a, m_b), (ck_a, ck_b, ck_t), r_shift)
    return ser_tipa_proof(cfg, proof).hex()


def _instance(seed, shift=False, fp_kernel="cios16", step=tipa._run):
    """The snippet's instance through the port: SRS, keys, messages,
    commitments, proof (the same draws from SeededRng(seed))."""
    n = 4
    ctx = dev_ctx("bls12_nano", device="cpu", fp_kernel=fp_kernel)
    host = ctx.host
    rng = SeededRng(seed)
    cfg = tipp_config(ctx)
    srs = tipa.setup_srs(ctx, rng, n)
    ck_a, ck_b = srs.get_commitment_keys()
    ck_t = cfg.ipc.setup(rng, 1)
    m_a = PointVec.from_host(
        ctx, "g1", [rand_sw_point(rng, host.g1) for _ in range(n)])
    m_b = PointVec.from_host(
        ctx, "g2", [rand_sw_point(rng, host.g2) for _ in range(n)])
    com_a = cfg.lmc.commit(ck_a, m_a)
    com_b = cfg.rmc.commit(ck_b, m_b)
    r_shift = rand_field(rng, host.r) if shift else 1
    if shift:
        r_inv = pow(r_shift, -1, host.r)
        m_a = m_a.hadamard_scale(FrVec.from_ints(
            ctx, [pow(r_shift, i, host.r) for i in range(n)]))
        ck_a = ck_a.hadamard_scale(FrVec.from_ints(
            ctx, [pow(r_inv, i, host.r) for i in range(n)]))
        # the shift leaves the left commitment as it was
        assert cfg.lmc.commit(ck_a, m_a) == com_a
    com_t = cfg.ipc.commit(ck_t, [cfg.ip.compute(m_a, m_b)])
    proof = tipa.prove_with_srs_shift(
        cfg, srs, (m_a, m_b), (ck_a, ck_b, ck_t), r_shift, step=step)
    return SimpleNamespace(cfg=cfg, v_srs=srs.get_verifier_key(), ck_t=ck_t,
                           com=(com_a, com_b, com_t), proof=proof,
                           r_shift=r_shift)


def _verify(inst, proof=None, com=None, r_shift=None, step=tipa._run):
    return tipa.verify_with_srs_shift(
        inst.cfg, inst.v_srs, inst.ck_t, com or inst.com,
        proof or inst.proof, inst.r_shift if r_shift is None else r_shift,
        rand=torch.Generator().manual_seed(7), step=step)


def _tampered_gt(host, proof):
    """The proof with one GT element of a round changed (squared)."""
    bad = copy.deepcopy(proof)
    (ca, cb, ct), com_2 = bad.gipa_proof.steps[0]
    bad.gipa_proof.steps[0] = ((host.tower.fp12.mul(ca, ca), cb, ct), com_2)
    return bad


@pytest.fixture(scope="module")
def plain():
    return _instance(41)


@pytest.fixture(scope="module")
def shifted():
    return _instance(42, shift=True)


def test_tipp_proof_bytes_equal_reference(plain):
    assert tipa.ser_proof(plain.cfg, plain.proof).hex() == FROZEN[41]


@pytest.mark.slow
@pytest.mark.parametrize("seed, shift", [(41, False), (42, True)])
def test_frozen_bytes_are_the_reference_proofs(seed, shift):
    assert _reference_proof_hex(seed, shift=shift) == FROZEN[seed]


def test_tipp_verify_accepts_and_rejects(plain):
    host = plain.cfg.ctx.host
    assert _verify(plain)
    bad = copy.deepcopy(plain.proof)
    a0, b0 = bad.gipa_proof.r_base
    bad.gipa_proof.r_base = (host.g1.double(a0), b0)
    assert not _verify(plain, proof=bad)
    bad = copy.deepcopy(plain.proof)
    cka, ckb = bad.final_ck
    bad.final_ck = (host.g2.double(cka), ckb)
    assert not _verify(plain, proof=bad)
    assert not _verify(plain, proof=_tampered_gt(host, plain.proof))
    com_a, com_b, com_t = plain.com
    wrong = (com_a, host.tower.fp12.mul(com_b, com_b), com_t)
    assert not _verify(plain, com=wrong)


def test_tipp_with_srs_shift_bytes_equal_reference(shifted):
    assert tipa.ser_proof(shifted.cfg, shifted.proof).hex() == FROZEN[42]


def test_tipp_with_srs_shift_verify_accepts_and_rejects(shifted):
    host = shifted.cfg.ctx.host
    assert _verify(shifted)
    assert not _verify(shifted, r_shift=shifted.r_shift + 1)
    assert not _verify(shifted, proof=_tampered_gt(host, shifted.proof))


def test_hybrid8_context_gives_the_same_proof_through_every_step():
    names = []

    def step(name, fn):
        names.append(name)
        return fn()

    inst = _instance(41, fp_kernel="hybrid8", step=step)
    assert inst.cfg.ctx.fp_kernel == "hybrid8"
    assert tipa.ser_proof(inst.cfg, inst.proof).hex() == FROZEN[41]
    assert names == ["commitments", "challenge", "folds"] * 2 + [
        "kzg_challenge", "kzg_opening_g2", "kzg_opening_g1"]
    names.clear()
    assert _verify(inst, step=step)
    assert names == ["recursive_challenges", "kzg_checks", "base_checks",
                     "pairing_check"]


class _HostPairing:
    """Stands in for the JAX package's device pairing: its host model."""

    def __init__(self, host):
        self.host = host

    def multi_pairing(self, ps, qs):
        from ripp_tpu.host import pairing as ref_hp

        return ref_hp.multi_pairing(self.host, list(ps), list(qs))

    def gt_exp_batch(self, gs, es):
        from ripp_tpu.host import pairing as ref_hp

        return [ref_hp.gt_exp(self.host, g, e) for g, e in zip(gs, es)]


def _equations(host):
    """Named lists of (pairs, rhs) equations on bls12_nano."""
    g, h = host.g1_gen, host.g2_gen
    P = host.g1.scalar_mul(g, 5)
    Q = host.g2.scalar_mul(h, 11)
    e_pq = hp.pairing(host, P, Q)
    honest = [([(host.g1.scalar_mul(P, 3), Q),
                (host.g1.neg(P), host.g2.scalar_mul(Q, 3))], None),
              ([(P, Q)], e_pq),
              ([(g, h), (P, Q)], host.tower.fp12.mul(
                  hp.pairing(host, g, h), e_pq))]
    wrong = honest[:1] + [([(P, Q)], host.tower.fp12.mul(e_pq, e_pq))]
    return {
        "honest": honest,
        "wrong_rhs": wrong,
        "rhs_without_pairs": [([], e_pq)],
        "rhs_without_pairs_then_honest": [([], e_pq)] + honest,
        "one_rhs_without_pairs": [([], None)],
        "nothing": [],
    }


def test_pairing_check_decisions_equal_reference(monkeypatch):
    import ripp_tpu.ops.pairing as ref_pairing
    from ripp_tpu.host.curves import bls12_nano as ref_nano
    from ripp_tpu.models.pairing_check import PairingCheck as RefCheck

    ctx = dev_ctx("bls12_nano", device="cpu")
    ref_host = ref_nano()
    monkeypatch.setattr(ref_pairing, "dev_pairing",
                        lambda c: _HostPairing(ref_host))
    ref_ctx = SimpleNamespace(host=ref_host, g1_to_dev=list, g2_to_dev=list)
    want = {"honest": True, "wrong_rhs": False, "rhs_without_pairs": True,
            "rhs_without_pairs_then_honest": False,
            "one_rhs_without_pairs": True, "nothing": True}
    for name, eqs in _equations(ctx.host).items():
        decisions = []
        for make in (lambda rand: PairingCheck(ctx, rand=rand),
                     lambda rand: RefCheck(ref_ctx, rand=rand)):
            rhos = iter([3, 5, 7, 9, 11])
            pc = make(lambda: next(rhos))
            for pairs, rhs in eqs:
                pc.add(pairs, rhs=rhs)
            decisions.append(pc.verify())
        assert decisions == [want[name]] * 2, name


def test_pairing_check_coefficients_from_a_seeded_generator():
    ctx = dev_ctx("bls12_nano", device="cpu")

    def draws(seed):
        pc = PairingCheck(ctx, rand=torch.Generator().manual_seed(seed))
        return [pc._rand() for _ in range(4)]

    first = draws(5)
    assert first == draws(5) and first != draws(6)
    assert all(x % 2 == 1 and 0 < x < 1 << 128 for x in first)
    assert len(set(first)) == 4
