"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and nvcc; they carry the `gpu` marker and skip
elsewhere (chip_smoke.py is the evidence for the kernels at full size).
This file imports nothing of the JAX package, so it runs on a machine
that has no jax:

    python -m pytest tests/test_torch_gpu.py -q --noconftest

Exact equality of every limb: the tolerance is zero.
"""

import random

import pytest
import torch

from ripp_tpu_torch.host.curves import get_curve
from ripp_tpu_torch.ops import fp_cuda
from ripp_tpu_torch.ops.fp import DevFp, limbs_tensor, make_spec
from ripp_tpu_torch.ops.kexec import ProgramKernel
from ripp_tpu_torch.ops.pairing import dev_pairing
from ripp_tpu_torch.ops.curve_fused import FusedLadder
from ripp_tpu_torch.ops.pairing_fused import FusedGtExp, FusedMiller
from ripp_tpu_torch.ops.points import dev_ctx
from ripp_tpu_torch.ops.tower import tree_leaves

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    return torch.device("cuda")


def _rand(spec, n, seed, device):
    rng = random.Random(seed)
    vals = [0, 1, spec.p - 1] + [rng.randrange(spec.p) for _ in range(n - 3)]
    return limbs_tensor(spec.to_mont_limbs(vals), device)


@pytest.mark.parametrize("curve_name", ["bls12_toy", "bls12_381"])
def test_fp_kernels_equal_plain(cuda_device, curve_name):
    spec = make_spec(curve_name + ".fp", get_curve(curve_name).p)
    a, b = _rand(spec, 200, 1, cuda_device), _rand(spec, 200, 2, cuda_device)
    F, P = DevFp(spec, cuda_device), DevFp(spec, cuda_device, plain=True)
    before = fp_cuda.launches, fp_cuda.cheap_launches
    assert torch.equal(F.mul(a, b), P.mul(a, b))
    assert torch.equal(F.add(a, b), P.add(a, b))
    assert torch.equal(F.sub(a, b), P.sub(a, b))
    assert torch.equal(F.neg(a), P.neg(a))
    assert fp_cuda.launches == before[0] + 1
    assert fp_cuda.cheap_launches == before[1] + 3


def test_program_kernel_equals_plain_with_masks(cuda_device):
    from ripp_tpu_torch.ops import kprog

    ctx = dev_ctx("bls12_toy", device=cuda_device)
    prog = kprog.KProg("fp2_mul")
    fp, fp2, _, _, _ = kprog.prog_tower(prog, ctx.host)
    a = (prog.inp(), prog.inp())
    b = (prog.inp(), prog.inp())
    c = fp2.mul(a, b)
    m = prog.mask_inp()
    prog.out([prog.sel(m, fp.sub(c[0], c[1]),
                       fp.neg(fp.add(c[0], fp.const(5)))), c[0], c[1]])
    sched = kprog.schedule(prog)
    spec = ctx.t.spec_fp
    ins = [_rand(spec, 70, s, cuda_device) for s in range(4)]
    mask = torch.arange(70, device=cuda_device) % 3 == 0
    before = ProgramKernel.launches
    got = ProgramKernel(ctx.t.fp, sched)(ins, masks=[mask])
    assert ProgramKernel.launches == before + 1
    want = ProgramKernel(ctx.t.fp, sched, plain=True)(ins, masks=[mask])
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def test_fused_miller_kernel_equals_plain_loop(cuda_device):
    ctx = dev_ctx("bls12_toy", device=cuda_device)
    plain = dev_ctx("bls12_toy", device=cuda_device, plain=True)
    host = ctx.host
    A = [host.g1.scalar_mul(host.g1_gen, 2 * i + 3) for i in range(5)]
    B = [host.g2.scalar_mul(host.g2_gen, 3 * i + 5) for i in range(5)]
    g1a = ctx.g1.normalize(ctx.g1_to_dev(A))
    g2a = ctx.g2.normalize(ctx.g2_to_dev(B))
    ins = (g1a[0], g1a[1], g2a[0], g2a[1])
    before = FusedMiller.launches
    got = tree_leaves(dev_pairing(ctx).fused.miller(*ins))
    assert FusedMiller.launches == before + 1
    want = tree_leaves(dev_pairing(plain)._miller_impl(*ins))
    for w, g in zip(want, got):
        assert torch.equal(w, g)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("curve_name", ["bls12_toy", "bls12_381"])
def test_fused_ladder_kernel_equals_plain_ladder(cuda_device, curve_name,
                                                 group, shared):
    ctx = dev_ctx(curve_name, device=cuda_device)
    plain = dev_ctx(curve_name, device=cuda_device, plain=True)
    host = ctx.host
    n = 37
    rng = random.Random(len(curve_name) + shared)
    nbits = host.r.bit_length()
    if group == "g1":
        pts = [host.g1.scalar_mul(host.g1_gen, 3 * i + 2) for i in range(n)]
        pts[4] = None
        P, curve, pcurve = ctx.g1_to_dev(pts), ctx.g1, plain.g1
    else:
        pts = [host.g2.scalar_mul(host.g2_gen, 5 * i + 2) for i in range(n)]
        pts[4] = None
        P, curve, pcurve = ctx.g2_to_dev(pts), ctx.g2, plain.g2
    if shared:
        bits = ctx.scalar_bits(rng.randrange(host.r), nbits)
    else:
        ks = [0, 1, host.r - 1] + [rng.randrange(host.r) for _ in range(n - 3)]
        bits = ctx.scalars_to_bits(ks, nbits)
    before = FusedLadder.launches[group]
    got = tree_leaves(curve.scalar_mul_bits(P, bits))
    assert FusedLadder.launches[group] == before + 1
    want = tree_leaves(pcurve.scalar_mul_bits(P, bits))
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def test_fused_gtexp_kernel_equals_plain(cuda_device):
    ctx = dev_ctx("bls12_toy", device=cuda_device)
    plain = dev_ctx("bls12_toy", device=cuda_device, plain=True)
    host = ctx.host
    from ripp_tpu_torch.host import pairing as hp

    e = hp.pairing(host, host.g1_gen, host.g2_gen)
    rng = random.Random(3)
    gs = [hp.gt_exp(host, e, rng.randrange(1, host.r)) for _ in range(5)]
    es = [0, 1, host.r - 1, rng.randrange(host.r), rng.randrange(host.r)]
    before = FusedGtExp.launches
    got = dev_pairing(ctx).gt_exp_batch(gs, es)
    assert FusedGtExp.launches == before + 1
    assert got == dev_pairing(plain).gt_exp_batch(gs, es)
    assert got == [hp.gt_exp(host, g, x) for g, x in zip(gs, es)]


def test_fr_products_use_the_fr_library(cuda_device):
    """The Fr field's products (fold, hadamard, de-Montgomery by a
    broadcast plain 1) launch the Montgomery kernel built for r."""
    ctx = dev_ctx("bls12_381", device=cuda_device)
    plain = dev_ctx("bls12_381", device=cuda_device, plain=True)
    spec = ctx.t.spec_fr
    a, b = _rand(spec, 300, 4, cuda_device), _rand(spec, 300, 5, cuda_device)
    before = fp_cuda.launches
    assert torch.equal(ctx.t.fr.mul(a, b), plain.t.fr.mul(a, b))
    got = ctx.fr_limbs_to_bits(a)
    assert fp_cuda.launches == before + 2
    assert torch.equal(got, plain.fr_limbs_to_bits(a))


@pytest.mark.parametrize("field", ["fp", "fr"])
@pytest.mark.parametrize("curve_name", ["bls12_toy", "bls12_381"])
def test_hybrid8_kernel_equals_cios_kernel_and_plain(cuda_device, curve_name,
                                                     field):
    """K1' against K1, against its plain version and against bigints, the
    edge operands 0, 1, p-1, R mod p in every pairing first."""
    c = get_curve(curve_name)
    spec = make_spec(f"{curve_name}.{field}", c.p if field == "fp" else c.r)
    p = spec.p
    edge = [0, 1, p - 1, spec.r % p]
    rng = random.Random(len(curve_name) + len(field))
    xs = [x for x in edge for _ in edge] + [rng.randrange(p) for _ in range(300)]
    ys = [y for _ in edge for y in edge] + [rng.randrange(p) for _ in range(300)]
    a = limbs_tensor(spec.to_mont_limbs(xs), cuda_device)
    b = limbs_tensor(spec.to_mont_limbs(ys), cuda_device)
    before = fp_cuda.launches, fp_cuda.hybrid8_launches
    got = fp_cuda.fp_mul_hybrid8(spec, a, b)
    assert fp_cuda.hybrid8_launches == before[1] + 1
    assert torch.equal(got, fp_cuda.fp_mul(spec, a, b))
    assert fp_cuda.launches == before[0] + 1
    assert torch.equal(got, fp_cuda.mont_mul_limbs_hybrid8(spec, a, b))
    assert spec.from_mont_limbs(got) == [x * y % p for x, y in zip(xs, ys)]


def test_hybrid8_context_proves_tipp_with_hybrid8_only(cuda_device):
    """A TIPP prove + verify on the card in a hybrid8 context: the same
    proof bytes as under cios16, and K1 itself never launches."""
    from ripp_tpu_torch.models import tipa
    from ripp_tpu_torch.models.instances import tipp_config
    from ripp_tpu_torch.models.vectors import PointVec
    from ripp_tpu_torch.utils.fiat_shamir import SeededRng, rand_sw_point

    out = {}
    for kernel in ("cios16", "hybrid8"):
        ctx = dev_ctx("bls12_toy", device=cuda_device, fp_kernel=kernel)
        host = ctx.host
        rng = SeededRng(9)
        cfg = tipp_config(ctx)
        srs = tipa.setup_srs(ctx, rng, 4)
        ck_a, ck_b = srs.get_commitment_keys()
        ck_t = cfg.ipc.setup(rng, 1)
        m_a = PointVec.from_host(
            ctx, "g1", [rand_sw_point(rng, host.g1) for _ in range(4)])
        m_b = PointVec.from_host(
            ctx, "g2", [rand_sw_point(rng, host.g2) for _ in range(4)])
        com = (cfg.lmc.commit(ck_a, m_a), cfg.rmc.commit(ck_b, m_b),
               cfg.ipc.commit(ck_t, [cfg.ip.compute(m_a, m_b)]))
        before = fp_cuda.launches, fp_cuda.hybrid8_launches
        proof = tipa.prove(cfg, srs, (m_a, m_b), (ck_a, ck_b, ck_t))
        assert tipa.verify(cfg, srs.get_verifier_key(), ck_t, com, proof)
        k1 = fp_cuda.launches - before[0]
        k1h = fp_cuda.hybrid8_launches - before[1]
        assert (k1 > 0 and k1h == 0) if kernel == "cios16" else \
            (k1 == 0 and k1h > 0)
        out[kernel] = tipa.ser_proof(cfg, proof)
    assert out["cios16"] == out["hybrid8"]
