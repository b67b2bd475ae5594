"""The port stands alone: importing ripp_tpu_torch and every module of it
in a fresh process leaves neither jax nor ripp_tpu in sys.modules; and
its host model (its own copy) equals the JAX package's host model."""

import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
import ripp_tpu_torch
names = ["ripp_tpu_torch"]
for m in pkgutil.walk_packages(ripp_tpu_torch.__path__, "ripp_tpu_torch."):
    if not m.name.endswith("._hostmath"):  # the ctypes library, not a module
        names.append(m.name)
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "ripp_tpu" or m.startswith("ripp_tpu."))
print("MODULES", len(names))
print("NAMES", " ".join(names))
print("BAD", bad)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = dict(l.split(" ", 1) for l in out.stdout.strip().splitlines())
    assert int(lines["MODULES"]) >= 26
    assert lines["BAD"] == "[]"
    # the SIPP and TIPP slices' modules are among them
    names = set(lines["NAMES"].split())
    for mod in ("utils.chacha", "utils.fiat_shamir", "utils.serialize",
                "ops.curve_fused", "ops.msm", "models.vectors",
                "models.sipp", "errors", "utils.poly", "ops.fixed_base",
                "models.algebra", "models.commitments", "models.instances",
                "models.gipa", "models.pairing_check", "models.tipa"):
        assert "ripp_tpu_torch." + mod in names


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_sources_do_not_name_jax_imports():
    """No module of the port, nor chip_smoke.py, has an import of jax or
    of ripp_tpu in its source."""
    import re

    pat = re.compile(r"^\s*(from|import)\s+(jax|ripp_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "ripp_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 18
    for path in files:
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def test_host_model_equals_reference_host_model():
    from ripp_tpu.host import curves as ref_curves
    from ripp_tpu.host import pairing as ref_hp
    from ripp_tpu_torch.host import curves as port_curves
    from ripp_tpu_torch.host import pairing as port_hp

    cr, cp = ref_curves.bls12_toy(), port_curves.bls12_toy()
    assert (cr.p, cr.r, cr.x, cr.g1_gen, cr.g2_gen) == (
        cp.p, cp.r, cp.x, cp.g1_gen, cp.g2_gen)
    A = cp.g1.scalar_mul(cp.g1_gen, 1234567)
    B = cp.g2.scalar_mul(cp.g2_gen, 7654321)
    assert A == cr.g1.scalar_mul(cr.g1_gen, 1234567)
    assert B == cr.g2.scalar_mul(cr.g2_gen, 7654321)
    e = port_hp.pairing(cp, A, B)
    assert e == ref_hp.pairing(cr, A, B)
    assert e == port_hp.gt_exp(
        cp, port_hp.pairing(cp, cp.g1_gen, cp.g2_gen),
        1234567 * 7654321 % cp.r)
    assert port_hp.multi_pairing(cp, [A, cp.g1_gen], [B, None]) == e


def test_native_group_law_matches_python_fallback():
    from ripp_tpu_torch import native
    from ripp_tpu_torch.host import curves as port_curves

    if native.load() is None:
        pytest.skip("no C toolchain: the host model runs in pure Python")
    c = port_curves.bls12_381()
    ks = [3, 2**200 + 17, c.r - 1]
    got = c.g2.scalar_mul_batch(c.g2_gen, ks)
    env = dict(os.environ, PYTHONPATH=ROOT, RIPP_NO_NATIVE="1")
    code = (
        "from ripp_tpu_torch.host.curves import bls12_381\n"
        "c = bls12_381()\n"
        f"print([c.g2.scalar_mul(c.g2_gen, k) for k in {ks!r}])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert eval(out.stdout.strip()) == got
