"""The GT exponentiation (K5's slice) against the JAX package:

  * `_build_gtexp_prog` gives the reference's schedule, and its counts on
    BLS12-381;
  * DevPairing.gt_exp_batch equals ripp_tpu's gt_exp_batch (its XLA scan
    on the CPU) and the host's gt_exp on bls12_nano;
  * the fused kernel's table, replayed with the plain executor, equals the
    plain square and multiply, and launches nothing on CPU tensors.

All comparisons are exact: tolerance zero.
"""

import random

import numpy as np
import pytest
import torch

from ripp_tpu.host.curves import get_curve as ref_get_curve
from ripp_tpu.ops.pairing_fused import _build_gtexp_prog as ref_gtexp_prog
from ripp_tpu_torch.host import pairing as hp
from ripp_tpu_torch.host.curves import get_curve
from ripp_tpu_torch.ops.pairing import dev_pairing
from ripp_tpu_torch.ops.pairing_fused import FusedGtExp, _build_gtexp_prog
from ripp_tpu_torch.ops.points import dev_ctx
from ripp_tpu_torch.ops.tower import tree_leaves, tree_select


def _segments_plain(sched):
    out = []
    for kind, items in sched.segments:
        if kind == "muls":
            out.append((kind, [tuple(t) for t in items]))
        else:
            out.append((kind, [(o.kind, o.dst, o.a, o.b, o.m) for o in items]))
    return out


@pytest.mark.parametrize("curve_name", ["bls12_toy", "bls12_381"])
def test_gtexp_prog_equals_reference(curve_name):
    got = _build_gtexp_prog(get_curve(curve_name))
    want = ref_gtexp_prog(ref_get_curve(curve_name))
    assert got.name == want.name
    assert got.n_regs == want.n_regs
    assert got.inputs == want.inputs == list(range(24))
    assert got.mask_inputs == want.mask_inputs
    assert got.outputs == want.outputs
    assert got.consts == want.consts
    assert _segments_plain(got) == _segments_plain(want)


def test_gtexp_prog_counts_bls12_381():
    sched = _build_gtexp_prog(get_curve("bls12_381"))
    assert sched.mul_groups() == [36, 54]
    cheap = sum(1 for kind, items in sched.segments if kind == "ops"
                for o in items if o.kind in ("add", "sub", "neg", "sel"))
    assert cheap == 441
    assert sched.n_regs == 175


def _gt_elements(host, k, seed):
    rng = random.Random(seed)
    e = hp.pairing(host, host.g1_gen, host.g2_gen)
    gs = [hp.gt_exp(host, e, rng.randrange(1, host.r)) for _ in range(k)]
    es = [0, 1, host.r - 1] + [rng.randrange(host.r) for _ in range(k - 3)]
    return gs, es


def test_gt_exp_batch_equals_reference_and_host():
    from ripp_tpu.ops.pairing import dev_pairing as ref_dev_pairing
    from ripp_tpu.ops.points import dev_ctx as ref_dev_ctx

    ctx = dev_ctx("bls12_nano", device="cpu")
    host = ctx.host
    gs, es = _gt_elements(host, 6, 5)
    got = dev_pairing(ctx).gt_exp_batch(gs, es)
    want = ref_dev_pairing(ref_dev_ctx("bls12_nano")).gt_exp_batch(gs, es)
    assert got == want
    assert got == [hp.gt_exp(host, g, e) for g, e in zip(gs, es)]
    assert dev_pairing(ctx).gt_exp_batch([], []) == []


def test_fused_gtexp_replay_equals_plain():
    """The kernel's table replayed over 7-bit exponents (the loop is the
    same at every width) against the plain loop and the host."""
    ctx = dev_ctx("bls12_nano", device="cpu")
    dp = dev_pairing(ctx)
    host = ctx.host
    gs, _ = _gt_elements(host, 4, 9)
    es = [0, 1, 127, 90]
    nbits = 7
    bits = torch.tensor([[(e >> (nbits - 1 - j)) & 1 for j in range(nbits)]
                         for e in es], dtype=torch.uint8)
    f = ctx.t.fp12_to_dev(gs)
    before = FusedGtExp.launches
    got = FusedGtExp(ctx)(f, bits)
    assert FusedGtExp.launches == before  # CPU: no launch
    assert ctx.t.fp12_from_dev(got) == [
        hp.gt_exp(host, g, e) for g, e in zip(gs, es)]
    # limb for limb against the plain loop of gt_exp_batch
    F12 = ctx.t.fp12
    acc = dp._ones_fp12((len(es),))
    for j in range(nbits):
        sq = F12.sqr(acc)
        acc = tree_select(bits[:, j] > 0, F12.mul(sq, f), sq)
    for w, g in zip(tree_leaves(acc), tree_leaves(got)):
        assert torch.equal(w, g)

