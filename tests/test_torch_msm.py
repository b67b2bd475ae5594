"""Pippenger MSM against the JAX package and a host bigint MSM:

  * scalars_to_digits equals the reference's digit matrix;
  * on G1 of bls12_nano, from the same limbs: the sorted-scan schedule
    (msm below BUCKET_SERIAL_MIN) equals ripp_tpu.ops.msm.msm limb for
    limb (the same projective point), and _msm_bucket_serial, called
    directly at a small n, equals the reference's; both equal the host's
    bigint MSM;
  * on G2 both schedules equal the host's MSM (the reference's G2 MSM
    compiles for tens of seconds on XLA:CPU, so it is left out here);
  * the bucket-serial schedule when every scalar is the same (all entries
    in one bucket a window), and msm at n = BUCKET_SERIAL_MIN, which
    takes that schedule, against the host.

All comparisons are exact: tolerance zero.
"""

import numpy as np
import pytest

from ripp_tpu_torch.ops import msm as msm_mod
from ripp_tpu_torch.ops.points import dev_ctx
from ripp_tpu_torch.ops.tower import tree_leaves, tree_map
from ripp_tpu_torch.utils.convert import to_reference, vec_from_reference
from ripp_tpu_torch.utils.fiat_shamir import SeededRng, rand_field


def _fixture(ctx, group, n, seed, same=False):
    host = ctx.host
    rng = SeededRng(seed)
    hc = host.g1 if group == "g1" else host.g2
    gen = host.g1_gen if group == "g1" else host.g2_gen
    ks = [rand_field(rng, host.r) for _ in range(n)]
    pts = hc.scalar_mul_batch(gen, [rand_field(rng, host.r) for _ in range(n)])
    if same:
        ks = [ks[0]] * n
    return hc, pts, ks


def _host_point(ctx, group, tree):
    from_dev = ctx.g1_from_dev if group == "g1" else ctx.g2_from_dev
    return from_dev(tree_map(lambda x: x[None], tree))[0]


def test_scalars_to_digits_equals_reference():
    from ripp_tpu.ops import msm as ref_msm
    from ripp_tpu.ops.points import dev_ctx as ref_dev_ctx

    rctx = ref_dev_ctx("bls12_nano")
    ctx = dev_ctx("bls12_nano", device="cpu")
    r = ctx.host.r
    ks = [0, 1, r - 1, 255, 256, 12345, r // 5]
    # 5-bit windows straddle the 16-bit limbs and overrun the 24 bits
    want = np.asarray(ref_msm.scalars_to_digits(
        rctx.t.fr, rctx.t.fr_to_dev(ks), 5, 24))
    got = msm_mod.scalars_to_digits(ctx.t.fr, ctx.t.fr_to_dev(ks), 5, 24)
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("schedule", ["scan", "bucket_serial"])
def test_msm_g1_equals_reference_and_host(schedule):
    import jax

    from ripp_tpu.ops import msm as ref_msm
    from ripp_tpu.ops.points import dev_ctx as ref_dev_ctx

    rctx = ref_dev_ctx("bls12_nano")
    ctx = dev_ctx("bls12_nano", device="cpu")
    hc, pts, ks = _fixture(ctx, "g1", 8, 21)
    from ripp_tpu.models.vectors import FrVec as RefFrVec
    from ripp_tpu.models.vectors import PointVec as RefPointVec

    rpts, rks = rctx.g1_to_dev(pts), rctx.t.fr_to_dev(ks)
    # the port starts from the reference's own limbs
    P = vec_from_reference(ctx, RefPointVec(rctx, "g1", rpts, 8)).pts
    K = vec_from_reference(ctx, RefFrVec(rctx, rks, 8)).arr
    if schedule == "scan":
        # n = 8: the reference's msm takes its sorted-scan schedule too
        want = ref_msm.msm(rctx.g1, rctx.t.fr, rpts, rks)
        got = msm_mod.msm(ctx.g1, ctx.t.fr, P, K)
    else:
        want = ref_msm._msm_bucket_serial(rctx.g1, rctx.t.fr, rpts, rks, 8,
                                          24)
        got = msm_mod._msm_bucket_serial(ctx.g1, ctx.t.fr, P, K, 8, 24)
    for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(w), to_reference(g))
    assert _host_point(ctx, "g1", got) == hc.msm(pts, ks)


@pytest.mark.parametrize("schedule", ["scan", "bucket_serial"])
def test_msm_g2_equals_host(schedule):
    ctx = dev_ctx("bls12_nano", device="cpu")
    hc, pts, ks = _fixture(ctx, "g2", 8, 22)
    P, K = ctx.g2_to_dev(pts), ctx.t.fr_to_dev(ks)
    if schedule == "scan":
        got = msm_mod.msm(ctx.g2, ctx.t.fr, P, K)
    else:
        got = msm_mod._msm_bucket_serial(ctx.g2, ctx.t.fr, P, K, 8, 24)
    assert _host_point(ctx, "g2", got) == hc.msm(pts, ks)


def test_bucket_serial_all_scalars_equal():
    ctx = dev_ctx("bls12_nano", device="cpu")
    hc, pts, ks = _fixture(ctx, "g1", 40, 32, same=True)
    got = msm_mod._msm_bucket_serial(ctx.g1, ctx.t.fr, ctx.g1_to_dev(pts),
                                     ctx.t.fr_to_dev(ks), 8, 24)
    assert _host_point(ctx, "g1", got) == hc.msm(pts, ks)


def test_msm_at_threshold_equals_host():
    ctx = dev_ctx("bls12_nano", device="cpu")
    n = msm_mod.BUCKET_SERIAL_MIN
    hc, pts, ks = _fixture(ctx, "g1", n, 31)
    got = msm_mod.msm(ctx.g1, ctx.t.fr, ctx.g1_to_dev(pts),
                      ctx.t.fr_to_dev(ks))
    assert _host_point(ctx, "g1", got) == hc.msm(pts, ks)
