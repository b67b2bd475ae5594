"""ripp_tpu_torch.ops.kexec: the plain executor of the CUDA kernel's
instruction table against the JAX package's Pallas program kernel run in
interpret mode (as the JAX package's own tests run it on the CPU), on
bls12_nano. Outputs are compared limb for limb: tolerance zero.
"""

import random

import numpy as np
import pytest
import torch

from ripp_tpu.ops import kexec as ref_kexec
from ripp_tpu.ops import kprog as ref_kprog
from ripp_tpu.ops.tower import dev_tower as ref_dev_tower
from ripp_tpu_torch.ops import kexec, kprog
from ripp_tpu_torch.ops.tower import dev_tower
from ripp_tpu_torch.utils.convert import from_reference, to_reference


def _mixed_prog(mod, curve):
    """The program of the reference's kexec test, built with either
    package's kprog: an Fp2 product and every cheap op kind."""
    prog = mod.KProg("fp2_mul")
    fp, fp2, _, _, _ = mod.prog_tower(prog, curve)
    a = (prog.inp(), prog.inp())
    b = (prog.inp(), prog.inp())
    c = fp2.mul(a, b)
    d0 = fp.sub(c[0], c[1])
    d1 = fp.neg(fp.add(c[0], fp.const(5)))
    m = prog.mask_inp()
    prog.out([prog.sel(m, d0, d1), c[0], c[1]])
    return mod.schedule(prog)


def _inputs(p, n, seed):
    rng = random.Random(seed)
    ints = [[rng.randrange(p) for _ in range(n)] for _ in range(4)]
    # edge operands in the first lanes
    for row in ints:
        row[0], row[1], row[2] = 0, 1, p - 1
    mask = np.asarray([i % 3 == 0 for i in range(n)])
    return ints, mask


@pytest.mark.parametrize("n", [3, 70])
def test_plain_executor_matches_reference_program_kernel(n):
    import jax.numpy as jnp

    tr = ref_dev_tower("bls12_nano")
    tt = dev_tower("bls12_nano", device="cpu")
    sched_r = _mixed_prog(ref_kprog, tr.curve)
    sched_t = _mixed_prog(kprog, tt.curve)
    ints, mask = _inputs(tr.curve.p, n, 3)
    arrs_np = [tr.fp.spec.to_mont_limbs(v) for v in ints]

    want = ref_kexec.ProgramKernel(tr.fp.spec, sched_r, interpret=True)(
        [jnp.asarray(a) for a in arrs_np], masks=[jnp.asarray(mask)])

    kern = kexec.ProgramKernel(tt.fp, sched_t)
    before = kexec.ProgramKernel.launches
    got = kern([from_reference(a, "cpu") for a in arrs_np],
               masks=[from_reference(mask, "cpu")])
    assert kexec.ProgramKernel.launches == before  # CPU: no kernel launch
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        np.testing.assert_array_equal(to_reference(g), np.asarray(w))


def test_sel_reads_limb_zero_of_a_field_register():
    """A 'sel' whose mask register holds a field element reads its limb 0
    (the reference's executor does), not the whole value."""
    tt = dev_tower("bls12_nano", device="cpu")
    fp = tt.fp
    x = fp.const(3).expand(2, fp.nl)
    y = fp.const(4).expand(2, fp.nl)
    mk = torch.zeros((2, fp.nl), dtype=torch.int32)
    mk[0, 0] = 7       # limb 0 set: take a
    mk[1, 1] = 7       # only limb 1 set: take b
    tab = np.asarray([[kexec.OP_SEL, 3, 0, 1, 2]], dtype=np.int32)
    regs = kexec.run_table(fp, tab, None, {0: x, 1: y, 2: mk})
    assert tt.spec_fp.from_mont_limbs(regs[3]) == [3, 4]


def test_launch_helpers():
    tt = dev_tower("bls12_381", device="cpu")
    spec = tt.spec_fp
    assert kexec.block_threads(256) == kexec.block_threads(4096) == 32
    assert kexec.block_threads(1 << 20) == 128
    a = tt.fp.one()
    b = tt.fp_to_dev([1, 2, 3])
    st = kexec.stack_inputs(spec, [a, b], (3,))
    assert st.shape == (2, 3, spec.nl) and st.is_contiguous()
    assert spec.from_mont_limbs(st[0]) == [1, 1, 1]
    with pytest.raises(ValueError):
        kexec.ProgramKernel(tt.fp, _mixed_prog(kprog, tt.curve))([a], [])
