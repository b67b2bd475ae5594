"""The slice as a whole: the port's pairing product against the JAX
package and the host model.

  * the plain Miller loop equals the fused kernel's plain replay (the
    step programs run from the kernel's own tables) limb for limb;
  * it equals the JAX package's scan-path Miller loop limb for limb on
    bls12_nano, from the same affine limbs handed over by convert.py;
  * multi_pairing at n = 8 with identity pairs equals the JAX package's
    multi_pairing and the host model on bls12_nano and bls12_toy;
  * one BLS12-381 case at n = 2 against the host model only (no JAX
    compile at that width).

All comparisons are exact (limbs or host integers): tolerance zero.
"""

import numpy as np
import pytest
import torch

from ripp_tpu.ops import pairing as ref_pairing
from ripp_tpu.ops import points as ref_points
from ripp_tpu_torch.host import pairing as hp
from ripp_tpu_torch.ops.curve import pad_with_identity
from ripp_tpu_torch.ops.pairing import dev_pairing
from ripp_tpu_torch.ops.pairing_fused import FusedMiller
from ripp_tpu_torch.ops.points import dev_ctx
from ripp_tpu_torch.ops.tower import tree_leaves
from ripp_tpu_torch.utils.convert import from_reference, to_reference


def _pairs(host, n, with_identity=True):
    A = [host.g1.scalar_mul(host.g1_gen, 2 * i + 3) for i in range(n)]
    B = [host.g2.scalar_mul(host.g2_gen, 3 * i + 5) for i in range(n)]
    if with_identity and n >= 8:
        A[2] = None
        B[5] = None
    return A, B


def _affine(ctx, A, B):
    g1a = ctx.g1.normalize(ctx.g1_to_dev(A))
    g2a = ctx.g2.normalize(ctx.g2_to_dev(B))
    return g1a[0], g1a[1], g2a[0], g2a[1]


@pytest.mark.parametrize("curve_name", ["bls12_nano", "bls12_toy"])
def test_plain_miller_equals_fused_replay(curve_name):
    ctx = dev_ctx(curve_name, device="cpu")
    dp = dev_pairing(ctx)
    xP, yP, qx, qy = _affine(ctx, *_pairs(ctx.host, 3))
    want = tree_leaves(dp._miller_impl(xP, yP, qx, qy))
    before = FusedMiller.launches
    got = tree_leaves(dp.fused.miller(xP, yP, qx, qy))
    assert FusedMiller.launches == before  # CPU: the plain replay, no launch
    assert len(got) == len(want) == 12
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def test_miller_equals_reference_scan_path_nano():
    import jax
    import jax.numpy as jnp

    rctx = ref_points.dev_ctx("bls12_nano")
    rdp = ref_pairing.dev_pairing(rctx)
    # n = 8 with identity pairs: the shapes the JAX package's multi_pairing
    # compiles, so the two tests share one set of XLA executables
    A, B = _pairs(rctx.host, 8)
    g1a = rctx.g1.normalize(rctx.g1_to_dev(A))
    g2a = rctx.g2.normalize(rctx.g2_to_dev(B))
    ins_ref = rdp._masked_inputs(g1a, g2a)[:4]
    want = [np.asarray(x) for x in jax.tree.leaves(rdp._miller_jit(*ins_ref))]

    ctx = dev_ctx("bls12_nano", device="cpu")
    dp = dev_pairing(ctx)
    ins = from_reference(jax.tree.map(np.asarray, ins_ref), "cpu")
    # normalize agrees too (the port's own affine limbs are the same)
    own = dp._masked_inputs(
        ctx.g1.normalize(ctx.g1_to_dev(A)),
        ctx.g2.normalize(ctx.g2_to_dev(B)))[:4]
    for a, b in zip(tree_leaves(own), tree_leaves(ins)):
        assert torch.equal(a, b)
    got = tree_leaves(dp._miller_impl(*ins))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(to_reference(g), w)  # tolerance 0


@pytest.mark.parametrize("curve_name", ["bls12_nano", "bls12_toy"])
def test_multi_pairing_equals_reference_and_host(curve_name):
    ctx = dev_ctx(curve_name, device="cpu")
    host = ctx.host
    A, B = _pairs(host, 8)
    dp = dev_pairing(ctx)
    got = dp.multi_pairing(ctx.g1_to_dev(A), ctx.g2_to_dev(B))
    assert got == hp.multi_pairing(host, A, B)

    rctx = ref_points.dev_ctx(curve_name)
    rdp = ref_pairing.dev_pairing(rctx)
    want = rdp.multi_pairing(rctx.g1_to_dev(A), rctx.g2_to_dev(B))
    assert got == want


def test_multi_pairing_bls12_381_equals_host():
    ctx = dev_ctx("bls12_381", device="cpu")
    host = ctx.host
    A, B = _pairs(host, 2)
    dp = dev_pairing(ctx)
    got = dp.multi_pairing(ctx.g1_to_dev(A), ctx.g2_to_dev(B))
    assert got == hp.multi_pairing(host, A, B)
    # bilinearity: e(3G1, 5G2) e(5G1, 8G2) = e(G1, G2)^55
    e = hp.pairing(host, host.g1_gen, host.g2_gen)
    assert got == hp.gt_exp(host, e, 3 * 5 + 5 * 8)


def test_pairing_phases_and_identity_handling():
    ctx = dev_ctx("bls12_nano", device="cpu")
    host = ctx.host
    dp = dev_pairing(ctx)
    assert dev_pairing(ctx) is dp
    assert dev_pairing(dev_ctx("bls12_nano", device="cpu", plain=True)) is not dp
    A, B = _pairs(host, 8)
    P, Q = ctx.g1_to_dev(A), ctx.g2_to_dev(B)
    g1a, g2a = ctx.g1.normalize(P), ctx.g2.normalize(Q)
    assert g1a[2].tolist() == [i == 2 for i in range(8)]
    f = dp.miller_batch(g1a, g2a)
    vals = ctx.t.fp12_from_dev(f)
    one = host.tower.fp12.one()
    assert vals[2] == one and vals[5] == one and vals[0] != one
    prod = dp.product_reduce(f)
    assert tree_leaves(prod)[0].shape == (1, ctx.t.fp.nl)
    F12 = host.tower.fp12
    acc = one
    for v in vals:
        acc = F12.mul(acc, v)
    assert ctx.t.fp12_from_dev(prod) == [acc]
    assert dp.finalize_product(prod) == hp.multi_pairing(host, A, B)
    # padding with identity pairs leaves the product unchanged
    P9 = pad_with_identity(ctx.g1, P, 11)
    Q9 = pad_with_identity(ctx.g2, Q, 11)
    assert dp.multi_pairing(P9, Q9) == hp.multi_pairing(host, A, B)


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_fp12_program_kernels_equal_stacked_tower(op):
    """The Fp12 mul / sqr field programs that the card runs through the
    program executor give the stacked tower's limbs (plain executor)."""
    ctx = dev_ctx("bls12_nano", device="cpu")
    dp = dev_pairing(ctx)
    mul_k, sqr_k = dp._build_f12_kernels()
    F12 = ctx.host.tower.fp12
    import random

    rng = random.Random(4)
    xs = [F12.fromlist([rng.randrange(ctx.host.p) for _ in range(12)])
          for _ in range(4)]
    ys = [F12.fromlist([rng.randrange(ctx.host.p) for _ in range(12)])
          for _ in range(4)]
    a, b = ctx.t.fp12_to_dev(xs), ctx.t.fp12_to_dev(ys)
    if op == "mul":
        got = mul_k(tree_leaves(a) + tree_leaves(b))
        want = tree_leaves(ctx.t.fp12.mul(a, b))
    else:
        got = sqr_k(tree_leaves(a))
        want = tree_leaves(ctx.t.fp12.sqr(a))
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    assert dp.f12_mul(a, b) is not None  # CPU tensors: the stacked tower


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_fp12_program_kernels_equal_reference_tower_nano(op):
    """The same Fp12 programs against the JAX package's tower, limb for
    limb from the same limbs, with the edge operands 0, 1, p-1 among the
    coefficients: tolerance zero."""
    import random

    import jax

    from ripp_tpu.ops import tower as ref_tower

    tr = ref_tower.dev_tower("bls12_nano")
    ctx = dev_ctx("bls12_nano", device="cpu")
    mul_k, sqr_k = dev_pairing(ctx)._build_f12_kernels()
    p = tr.curve.p
    F12 = tr.curve.tower.fp12
    rng = random.Random(9)

    def elems():
        out = [F12.fromlist([rng.randrange(p) for _ in range(12)])
               for _ in range(5)]
        out.append(F12.fromlist([0, 1, p - 1] * 4))
        out.append(F12.one())
        return out

    a_ref, b_ref = tr.fp12_to_dev(elems()), tr.fp12_to_dev(elems())
    a = from_reference(jax.tree.map(np.asarray, a_ref), "cpu")
    b = from_reference(jax.tree.map(np.asarray, b_ref), "cpu")
    if op == "mul":
        want = tr.fp12.mul(a_ref, b_ref)
        got = mul_k(tree_leaves(a) + tree_leaves(b))
    else:
        want = tr.fp12.sqr(a_ref)
        got = sqr_k(tree_leaves(a))
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(got) == len(want) == 12
    for w, g in zip(want, got):
        np.testing.assert_array_equal(to_reference(g), w)


@pytest.mark.parametrize("curve_name", ["bls12_nano", "bls12_toy"])
def test_multi_pairing_through_fp12_programs_equals_host(curve_name):
    """The route the card takes (product tree and final exponentiation as
    Fp12 programs of the executor), driven on the CPU, where the executor
    runs its plain version: the pairing product still equals the host
    model and the stacked-tower route."""
    from ripp_tpu_torch.ops.kexec import ProgramKernel
    from ripp_tpu_torch.ops.pairing import DevPairing

    ctx = dev_ctx(curve_name, device="cpu")
    host = ctx.host
    A, B = _pairs(host, 8)
    dp = DevPairing(ctx)
    dp._on_card = lambda f: True
    before = ProgramKernel.launches
    got = dp.multi_pairing(ctx.g1_to_dev(A), ctx.g2_to_dev(B))
    assert ProgramKernel.launches == before  # CPU tensors: no kernel launch
    assert dp._f12_kernels is not None       # the programs did run
    assert got == hp.multi_pairing(host, A, B)
    assert got == dev_pairing(ctx).multi_pairing(
        ctx.g1_to_dev(A), ctx.g2_to_dev(B))


def test_convert_round_trip():
    arr = np.arange(24, dtype=np.uint32).reshape(2, 3, 4)
    mask = np.asarray([True, False])
    tree = ((arr, arr + 1), mask)
    t = from_reference(tree, "cpu")
    assert t[0][0].dtype == torch.int32 and t[1].dtype == torch.bool
    back = to_reference(t)
    assert back[0][1].dtype == np.uint32 and back[1].dtype == np.bool_
    np.testing.assert_array_equal(back[0][0], arr)
    np.testing.assert_array_equal(back[1], mask)
    with pytest.raises(ValueError):
        from_reference(np.asarray([1 << 16], dtype=np.uint32), "cpu")
