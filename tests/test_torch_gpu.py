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
from ripp_tpu_torch.ops.pairing_fused import FusedMiller
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
