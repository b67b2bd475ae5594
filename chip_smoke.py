"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run (needs one card)
    python3 chip_smoke.py --quick    # build + kernel checks at small sizes

The main path is the inner pairing product Z = prod e(A_i, B_i) on
BLS12-381: `dev_ctx` -> `g1/g2_to_dev` -> `DevPairing.multi_pairing`
(normalize, fused Miller loop, Fp12 product tree, final exponentiation).

Phases (a failure in any of them ends the run with a non-zero exit code
and no result line):
  1. build: compile the CUDA library from ripp_tpu_torch/csrc with nvcc.
  2. kernels: multi_pairing is driven once at each size while the batch
     every kernel wrapper is given is noted; then each kernel's wrapper is
     held against its plain PyTorch version on the card at every one of
     those batches, same inputs (numpy from a seed, or the main path's own
     affine points), exact equality of every limb (integer arithmetic: the
     tolerance is zero); then timed.
  3. main path, checked: multi_pairing at n = 8 with two identity pairs
     against the host model (Python bigints).
  4. main path, full size: multi_pairing at n = 256, 2048, 4096 with
     A_i = a_i*G1, B_i = b_i*G2; the result must equal
     e(G1, G2)^(sum a_i*b_i mod r). Launch counts are set to 0 before and
     read after. Only then are the per-phase times taken and printed,
     and the product tree and final exponentiation are timed a second way
     (Fp12 products through the stacked tower instead of the program
     executor) for comparison.

Output: JSON objects, one a line; then the card's name and power limit as
nvidia-smi prints them; then the {"kernels": [...]} line; the last line
is {"ok": true, "device": {...}}.
"""

import argparse
import json
import random
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20240607
# Published peaks of one H100 SXM used for `bound_ms`: device memory rate,
# and the float32 rate outside the tensor cores as the nearest published
# figure for 32-bit integer multiply-adds (the card runs integer
# multiplies at half that rate, so the operations bound is generous).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def sync():
    torch.cuda.synchronize()


def time_ms(fn, reps=5, warm=2):
    """Mean milliseconds a call by CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    """Milliseconds of one call on the host clock, synchronised."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return (time.perf_counter() - t0) * 1e3, out


def max_abs_err(got, want):
    """Largest absolute limb difference over two lists of tensors."""
    worst = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        worst = max(worst, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max().item()))
    return worst


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def table_ops(tab, nw):
    """32-bit integer operations one element spends on an instruction
    table: a product is 2*nw^2 + nw multiply-adds of two operations each;
    add / sub / neg are about 2*nw word additions; the rest moves data."""
    from ripp_tpu_torch.ops import kexec

    codes = np.asarray(tab)[:, 0]
    n_mul = int((codes == kexec.OP_MUL).sum())
    n_cheap = int(((codes == kexec.OP_ADD) | (codes == kexec.OP_SUB)
                   | (codes == kexec.OP_NEG)).sum())
    return n_mul * 2 * (2 * nw * nw + nw) + n_cheap * 2 * nw, n_mul, n_cheap


def random_limbs(rng, spec, n, device):
    """n random canonical field elements as limbs [n, NL] (read as
    Montgomery forms): uniform 16-bit limbs below the modulus's top limb,
    and a top limb drawn below the modulus's, so every value is < p."""
    from ripp_tpu_torch.ops.fp import limbs_tensor

    top = (spec.p.bit_length() - 1) // 16
    arr = np.zeros((n, spec.nl), dtype=np.int32)
    arr[:, :top] = rng.integers(0, 1 << 16, size=(n, top), dtype=np.int32)
    arr[:, top] = rng.integers(0, spec.p >> (16 * top), size=n,
                               dtype=np.int32)
    return limbs_tensor(arr, device)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

class ShapeCensus:
    """While active, note the batch each kernel wrapper is given (the
    wrappers themselves keep only a count of launches)."""

    def __enter__(self):
        from ripp_tpu_torch.ops import fp_cuda
        from ripp_tpu_torch.ops.kexec import ProgramKernel
        from ripp_tpu_torch.ops.pairing_fused import FusedMiller

        self.fp_mul, self.kexec, self.miller = set(), set(), set()
        self._saved = (fp_cuda.fp_mul, ProgramKernel._launch,
                       FusedMiller._launch)
        fp_mul, k_launch, m_launch = self._saved

        def seen_fp_mul(spec, a, b):
            shape = torch.broadcast_shapes(a.shape, b.shape)
            self.fp_mul.add(int(np.prod(shape[:-1], dtype=np.int64)))
            return fp_mul(spec, a, b)

        def seen_kexec(kern, inputs, masks, bshape):
            self.kexec.add((kern.sched.name,
                            int(np.prod(bshape, dtype=np.int64))))
            return k_launch(kern, inputs, masks, bshape)

        def seen_miller(fm, xP, yP, qx, qy):
            self.miller.add(int(np.prod(xP.shape[:-1], dtype=np.int64)))
            return m_launch(fm, xP, yP, qx, qy)

        fp_cuda.fp_mul = seen_fp_mul
        ProgramKernel._launch = seen_kexec
        FusedMiller._launch = seen_miller
        return self

    def __exit__(self, *exc):
        from ripp_tpu_torch.ops import fp_cuda
        from ripp_tpu_torch.ops.kexec import ProgramKernel
        from ripp_tpu_torch.ops.pairing_fused import FusedMiller

        fp_cuda.fp_mul, ProgramKernel._launch, FusedMiller._launch = \
            self._saved
        return False


def main_path_shapes(ctx, dp, sizes, fixtures):
    """Drive multi_pairing once at each size and return the batches the
    three kernels were given."""
    _, _, A, B = fixtures
    P_all, Q_all = ctx.g1_to_dev(A), ctx.g2_to_dev(B)
    with ShapeCensus() as seen:
        for n in sizes:
            dp.multi_pairing(
                tuple(x[:n].clone() for x in P_all),
                tuple(tuple(c[:n].clone() for c in q) for q in Q_all))
        sync()
    return seen


def check_fp_mul(ctx, plain_ctx, batches, n_rate):
    """fp_mul against mont_mul_limbs at every batch of `batches` (those the
    main path gives it), with the edge operands; timed at the largest of
    them; `n_rate` elements only for the elements-a-second figure."""
    from ripp_tpu_torch.ops import fp_cuda
    from ripp_tpu_torch.ops.fp import limbs_tensor

    spec = ctx.t.spec_fp
    fp, pfp = ctx.t.fp, plain_ctx.t.fp
    rng = np.random.default_rng(SEED)
    # edge operands 0, 1, p-1, R mod p, every pair of them
    edge = limbs_tensor(spec.to_mont_limbs([0, 1, spec.p - 1, spec.r]),
                        ctx.device)
    ea = edge.repeat_interleave(4, dim=0)
    eb = edge.repeat(4, 1)
    got = fp.mul(ea, eb)
    if max_abs_err([got], [pfp.mul(ea, eb)]):
        raise AssertionError("fp_mul edge products differ from plain")
    p = spec.p
    ev = [0, 1, p - 1, spec.r % p]
    if spec.from_mont_limbs(got) != [x * y % p for x in ev for y in ev]:
        raise AssertionError("fp_mul edge products differ from bigints")

    checked = []
    for n in sorted(batches):
        a = random_limbs(rng, spec, n, ctx.device)
        b = random_limbs(rng, spec, n, ctx.device)
        # the edge operands ride in the first lanes where there is room
        k = min(n, 16)
        a[:k], b[:k] = ea[:k], eb[:k]
        err = max_abs_err([fp.mul(a, b)], [pfp.mul(a, b)])
        if err:
            raise AssertionError(
                f"fp_mul differs from its plain version at batch {n}: {err}")
        checked.append(n)

    n_time = max(batches)
    ta = random_limbs(rng, spec, n_time, ctx.device)
    tb = random_limbs(rng, spec, n_time, ctx.device)
    ms = time_ms(lambda: fp_cuda.fp_mul(spec, ta, tb), reps=20)
    plain_ms = time_ms(lambda: fp_cuda.mont_mul_limbs(spec, ta, tb),
                       reps=2, warm=1)
    ra = random_limbs(rng, spec, n_rate, ctx.device)
    rb = random_limbs(rng, spec, n_rate, ctx.device)
    ms_rate = time_ms(lambda: fp_cuda.fp_mul(spec, ra, rb), reps=20)
    nw = spec.nl // 2
    bms, by = bound(3 * 4 * spec.nl * n_time,
                    n_time * 2 * (2 * nw * nw + nw))
    return {
        "name": "fp_mul", "route": "cuda",
        "source": "ripp_tpu_torch/csrc/fp_mul.cu",
        "replaces": "ripp_tpu/ops/fp_pallas.py:211",
        "equal": True, "max_abs_err": 0, "checked_batches": checked,
        "shape": [n_time, spec.nl], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "elements_per_s": n_rate / (ms_rate * 1e-3),
        "elements_per_s_at": n_rate,
    }


def check_kexec(ctx, plain_ctx, dp, shapes, n_step):
    """The program executor against the plain executor: the Fp12 programs
    at every (program, batch) of `shapes` (those the main path gives it)
    and the two Miller step programs at `n_step` elements."""
    from ripp_tpu_torch.ops.kexec import ProgramKernel

    spec = ctx.t.spec_fp
    nw = spec.nl // 2
    rng = np.random.default_rng(SEED + 1)
    fm = dp.fused
    by_name = {k.sched.name: k for k in dp._build_f12_kernels()}
    cases = [(ProgramKernel(ctx.t.fp, fm.dbl_sched), n_step),
             (ProgramKernel(ctx.t.fp, fm.add_sched), n_step)]
    cases += [(by_name[name], n) for name, n in sorted(shapes)]
    programs = []
    for kern, n in cases:
        sched = kern.sched
        plain = ProgramKernel(plain_ctx.t.fp, sched, plain=True)
        ins = [random_limbs(rng, spec, n, ctx.device)
               for _ in sched.inputs]
        got = kern(ins)
        sync()
        ms_plain, want = host_ms(lambda: plain(ins))
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(
                f"kexec[{sched.name}] differs from its plain version at "
                f"batch {n}: {err}")
        ms = time_ms(lambda: kern(ins), reps=10)
        ops, n_mul, n_cheap = table_ops(kern.table, nw)
        bms, by = bound(
            (len(sched.inputs) + len(sched.outputs)) * 4 * spec.nl * n,
            ops * n)
        programs.append({
            "program": sched.name, "batch": n, "ms": ms,
            "plain_ms": ms_plain, "bound_ms": bms, "bound_by": by,
            "muls": n_mul, "cheap_ops": n_cheap, "n_regs": sched.n_regs,
            "rows": int(kern.table.shape[0])})
    # the row's own figures: the largest launch the main path makes
    main = max((r for r in programs if r["program"] == "fp12_mul"),
               key=lambda r: r["batch"])
    return {
        "name": "kexec", "route": "cuda",
        "source": "ripp_tpu_torch/csrc/kexec.cu",
        "replaces": "ripp_tpu/ops/kexec.py:247",
        "equal": True, "max_abs_err": 0,
        "shape": [main["batch"], spec.nl], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "programs": programs,
    }


def check_miller(ctx, dp, plain_dp, batches, affine):
    """The fused Miller kernel against the plain loop at every batch of
    `batches`, on the main path's own affine points (the first n of
    `affine`); timed at the largest."""
    from ripp_tpu_torch.ops.tower import tree_leaves, tree_map

    spec = ctx.t.spec_fp
    nw = spec.nl // 2
    fm = dp.fused
    checked = []
    for n in sorted(batches):
        ins = tree_map(lambda x: x[:n].contiguous(), affine)
        got = tree_leaves(fm.miller(*ins))
        sync()
        plain_ms, want = host_ms(
            lambda: tree_leaves(plain_dp._miller_impl(*ins)))
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(
                f"fused Miller differs from the plain loop at {n} pairs: "
                f"{err}")
        ms = time_ms(lambda: fm.miller(*ins), reps=3, warm=1)
        checked.append({"pairs": n, "ms": ms, "plain_ms": plain_ms})
    d_ops, d_mul, d_cheap = table_ops(fm.dbl_table, nw)
    a_ops, a_mul, a_cheap = table_ops(fm.add_table, nw)
    n_dbl, n_add = len(fm.x_bits), sum(fm.x_bits)
    ops = n_dbl * d_ops + n_add * a_ops
    top = checked[-1]
    n = top["pairs"]
    bms, by = bound((6 + 12) * 4 * spec.nl * n, ops * n)
    return {
        "name": "fused_miller", "route": "cuda",
        "source": "ripp_tpu_torch/csrc/miller.cu",
        "replaces": "ripp_tpu/ops/pairing_fused.py:327",
        "equal": True, "max_abs_err": 0,
        "checked": checked, "shape": [n, spec.nl], "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "pairs_per_s": n / (top["ms"] * 1e-3),
        "muls_per_pair": n_dbl * d_mul + n_add * a_mul,
        "cheap_ops_per_pair": n_dbl * d_cheap + n_add * a_cheap,
        "n_regs": fm.n_regs,
    }


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------

def reset_counts():
    from ripp_tpu_torch.ops import fp_cuda
    from ripp_tpu_torch.ops.kexec import ProgramKernel
    from ripp_tpu_torch.ops.pairing_fused import FusedMiller

    fp_cuda.launches = 0
    fp_cuda.cheap_launches = 0
    ProgramKernel.launches = 0
    FusedMiller.launches = 0


def read_counts():
    from ripp_tpu_torch.ops import fp_cuda
    from ripp_tpu_torch.ops.kexec import ProgramKernel
    from ripp_tpu_torch.ops.pairing_fused import FusedMiller

    return {"fp_mul": fp_cuda.launches, "kexec": ProgramKernel.launches,
            "fused_miller": FusedMiller.launches,
            "fp_cheap_helpers": fp_cuda.cheap_launches}


def main_checked(ctx, dp):
    from ripp_tpu_torch.host import pairing as hp

    host = ctx.host
    rng = random.Random(SEED + 3)
    A = [host.g1.scalar_mul(host.g1_gen, rng.randrange(1, host.r))
         for _ in range(8)]
    B = [host.g2.scalar_mul(host.g2_gen, rng.randrange(1, host.r))
         for _ in range(8)]
    A[2] = None
    B[5] = None
    got = dp.multi_pairing(ctx.g1_to_dev(A), ctx.g2_to_dev(B))
    want = hp.multi_pairing(host, A, B)
    if got != want:
        raise AssertionError("multi_pairing(n=8) differs from the host model")
    emit({"phase": "main_checked", "n": 8, "identity_pairs": 2,
          "equal_to_host_model": True})


def main_full(ctx, dp, sizes, fixtures):
    """Drive multi_pairing at each size, check it, then time its phases.
    Returns the launch counts of the checked runs (all sizes together)."""
    from ripp_tpu_torch.host import pairing as hp

    host = ctx.host
    a, b, A, B = fixtures
    e_gen = hp.pairing(host, host.g1_gen, host.g2_gen)
    P_all, Q_all = ctx.g1_to_dev(A), ctx.g2_to_dev(B)
    sync()

    def batch(n):
        return (tuple(x[:n].clone() for x in P_all),
                tuple(tuple(c[:n].clone() for c in q) for q in Q_all))

    reset_counts()
    for n in sizes:
        P, Q = batch(n)
        got = dp.multi_pairing(P, Q)
        s = sum(x * y for x, y in zip(a[:n], b[:n])) % host.r
        if got != hp.gt_exp(host, e_gen, s):
            raise AssertionError(
                f"multi_pairing(n={n}) != e(G1,G2)^(sum a_i b_i)")
    sync()
    counts = read_counts()
    emit({"phase": "main_full_checked", "sizes": list(sizes),
          "equal_to_generator_power": True, "launches": counts})

    # times, after the check: fresh input buffers for each timed run
    for n in sizes:
        rows = {"normalize_ms": [], "miller_ms": [], "product_ms": [],
                "final_exp_ms": [], "total_ms": []}
        for _ in range(3):
            P, Q = batch(n)
            t_norm, (g1a, g2a) = host_ms(
                lambda: (ctx.g1.normalize(P), ctx.g2.normalize(Q)))
            t_mil, f = host_ms(lambda: dp.miller_batch(g1a, g2a))
            t_prod, prod = host_ms(lambda: dp.product_reduce(f))
            t_fin, _ = host_ms(lambda: dp.finalize_product(prod))
            P, Q = batch(n)
            t_all, _ = host_ms(lambda: dp.multi_pairing(P, Q))
            for k, v in zip(rows, (t_norm, t_mil, t_prod, t_fin, t_all)):
                rows[k].append(v)
        best = {k: min(v) for k, v in rows.items()}
        emit({"phase": "main_full_times", "n": n, **best,
              "pairs_per_s_miller_product":
                  n / ((best["miller_ms"] + best["product_ms"]) * 1e-3),
              "pairs_per_s_end_to_end": n / (best["total_ms"] * 1e-3),
              "runs": rows,
              "timing": "host clock around synchronised calls, min of 3"})
    fp12_routes(ctx, dp, batch(max(sizes)))
    return counts


def fp12_routes(ctx, dp, inputs):
    """Time the product tree and the final exponentiation with the Fp12
    products taken two ways on the same Miller values: as programs of the
    executor (what multi_pairing does on the card) and through the stacked
    tower (one Montgomery launch and the add / sub / neg launches a
    product). The results must agree."""
    from ripp_tpu_torch.ops.pairing import DevPairing

    tower = DevPairing(ctx)
    tower.f12_mul, tower.f12_sqr = tower.fp12.mul, tower.fp12.sqr
    P, Q = inputs
    f = dp.miller_batch(ctx.g1.normalize(P), ctx.g2.normalize(Q))
    out = {"phase": "fp12_routes", "n": int(P[0].shape[0]),
           "timing": "host clock around synchronised calls, min of 3"}
    results = []
    for name, d in (("programs", dp), ("tower", tower)):
        t_prod, t_fin = [], []
        for _ in range(3):
            reset_counts()
            t, prod = host_ms(lambda: d.product_reduce(f))
            t_prod.append(t)
            t, z = host_ms(lambda: d.finalize_product(prod))
            t_fin.append(t)
        results.append(z)
        out[name] = {"product_ms": min(t_prod), "final_exp_ms": min(t_fin),
                     "product_runs": t_prod, "final_exp_runs": t_fin,
                     "launches": read_counts()}
    if results[0] != results[1]:
        raise AssertionError("the two Fp12 routes disagree")
    emit(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at small sizes only")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print what ptxas says about each kernel")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from ripp_tpu_torch.ops.pairing import dev_pairing
    from ripp_tpu_torch.ops.points import dev_ctx
    from ripp_tpu_torch.utils import build

    t_start = time.time()
    card = gpu_line()

    # phase 1: build
    ctx = dev_ctx("bls12_381")
    spec = ctx.t.spec_fp
    build.load_library(spec, verbose=args.verbose_build)
    key = build.library_key(spec)
    emit({"phase": "build", "seconds": build.BUILD_SECONDS[key],
          "library": key, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if args.verbose_build:
        print(build.BUILD_LOG.get(key, ""), flush=True)

    plain_ctx = dev_ctx("bls12_381", plain=True)
    dp = dev_pairing(ctx)
    plain_dp = dev_pairing(plain_ctx)

    # fixtures of the full-size run, made once (host, native C group law)
    sizes = (8,) if args.quick else (256, 2048, 4096)
    host = ctx.host
    rng = random.Random(SEED + 4)
    n_max = max(sizes)
    a = [rng.randrange(1, host.r) for _ in range(n_max)]
    b = [rng.randrange(1, host.r) for _ in range(n_max)]
    t0 = time.time()
    A = host.g1.scalar_mul_batch(host.g1_gen, a)
    B = host.g2.scalar_mul_batch(host.g2_gen, b)
    emit({"phase": "fixtures", "pairs": n_max, "seconds": time.time() - t0})

    # phase 2: kernels, at the batches the main path gives them
    fixtures = (a, b, A, B)
    seen = main_path_shapes(ctx, dp, sizes, fixtures)
    emit({"phase": "main_path_shapes", "sizes": list(sizes),
          "fp_mul_batches": sorted(seen.fp_mul),
          "kexec_batches": sorted(seen.kexec),
          "fused_miller_batches": sorted(seen.miller)})
    g1a = ctx.g1.normalize(ctx.g1_to_dev(A))
    g2a = ctx.g2.normalize(ctx.g2_to_dev(B))
    affine = (g1a[0], g1a[1], g2a[0], g2a[1])
    rows = [check_fp_mul(ctx, plain_ctx, seen.fp_mul,
                         1 << (12 if args.quick else 20)),
            check_kexec(ctx, plain_ctx, dp, seen.kexec,
                        64 if args.quick else 1024),
            check_miller(ctx, dp, plain_dp, seen.miller, affine)]
    emit({"phase": "kernels_checked",
          "kernels": [{k: r[k] for k in ("name", "equal", "ms", "plain_ms")}
                      for r in rows]})

    # phase 3: main path, checked against the host model
    main_checked(ctx, dp)

    # phase 4: main path, full size
    counts = main_full(ctx, dp, sizes, fixtures)
    for r in rows:
        r["launches"] = counts[r["name"]]
        if r["launches"] < 1:
            raise AssertionError(
                f"the main path never launched kernel {r['name']}")

    emit({"phase": "done", "seconds": time.time() - t_start,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
