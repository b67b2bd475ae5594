"""ctypes binding for the native host-math library (csrc/hostmath.c).

Builds the shared library on demand with the in-image toolchain (g++/cc)
and caches the .so next to the source, keyed by source mtime. Every entry
point degrades gracefully: if the toolchain or the build is unavailable,
``load()`` returns None and callers fall back to the pure-Python host
model (ripp_tpu_torch/host/field.py, host/curve.py).

Set RIPP_NO_NATIVE=1 to force the Python path (used by parity tests).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "csrc", "hostmath.c")
_SO = os.path.join(_DIR, "_hostmath.so")

_lock = threading.Lock()
_lib = None
_lib_failed = False

MAX_NL = 12


def _build() -> Optional[str]:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    # Per-process temp name: concurrent builds (pytest main process +
    # test_parallel.py subprocess on a cold checkout) must not interleave
    # writes to one output file; os.replace keeps the publish atomic.
    tmp = f"{_SO}.tmp.{os.getpid()}"
    for cc in ("cc", "gcc", "g++"):
        try:
            r = subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                capture_output=True, timeout=120,
            )
        except (OSError, subprocess.TimeoutExpired):
            continue
        if r.returncode == 0:
            os.replace(tmp, _SO)
            return _SO
    return None


def load():
    """Return the loaded CDLL, or None if native is unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    if os.environ.get("RIPP_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = _build()
        if so is None:
            _lib_failed = True
            return None
        lib = ctypes.CDLL(so)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        intp = ctypes.POINTER(ctypes.c_int)
        lib.hm_ctx_size.restype = ctypes.c_int
        lib.hm_ctx_init.restype = ctypes.c_int
        lib.hm_ctx_init.argtypes = [ctypes.c_void_p, ctypes.c_int, u64p]
        for name, args in (
            ("hm_fp_mul", [ctypes.c_void_p, u64p, u64p, u64p]),
            ("hm_fp_add", [ctypes.c_void_p, u64p, u64p, u64p]),
            ("hm_fp_sub", [ctypes.c_void_p, u64p, u64p, u64p]),
            ("hm_fp_inv", [ctypes.c_void_p, u64p, u64p]),
            ("hm_fp_pow", [ctypes.c_void_p, u64p, u64p, ctypes.c_int, u64p]),
            ("hm_fp_batch_inv",
             [ctypes.c_void_p, u64p, ctypes.c_long, u64p]),
            ("hm_sw_scalar_mul",
             [ctypes.c_void_p, ctypes.c_int, u64p, u64p, u64p, ctypes.c_int,
              u64p, ctypes.c_int, u64p, u64p, intp]),
            ("hm_sw_scalar_mul_batch",
             [ctypes.c_void_p, ctypes.c_int, u64p, u64p, u64p, ctypes.c_int,
              u64p, ctypes.c_int, ctypes.c_long, u64p, u64p, intp]),
            ("hm_sw_msm",
             [ctypes.c_void_p, ctypes.c_int, u64p, u64p, u64p, intp,
              u64p, ctypes.c_int, ctypes.c_long, u64p, u64p, intp]),
        ):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = args
        _lib = lib
        return _lib


def _to_limbs(n: int, nl: int) -> "ctypes.Array":
    arr = (ctypes.c_uint64 * nl)()
    for i in range(nl):
        arr[i] = n & 0xFFFFFFFFFFFFFFFF
        n >>= 64
    return arr


def _from_limbs(arr, off: int, nl: int) -> int:
    out = 0
    for i in range(nl - 1, -1, -1):
        out = (out << 64) | arr[off + i]
    return out


class NativeFp:
    """Native prime field Fp; values are plain python ints in [0, p)."""

    def __init__(self, p: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native hostmath unavailable")
        nl = (p.bit_length() + 63) // 64
        if nl > MAX_NL:
            raise ValueError("prime too large for native backend")
        self.lib = lib
        self.p = p
        self.nl = nl
        self.ctx = ctypes.create_string_buffer(lib.hm_ctx_size())
        if lib.hm_ctx_init(self.ctx, nl, _to_limbs(p, nl)) != 0:
            raise RuntimeError("hm_ctx_init failed")

    def mul(self, a: int, b: int) -> int:
        out = (ctypes.c_uint64 * self.nl)()
        self.lib.hm_fp_mul(self.ctx, _to_limbs(a, self.nl),
                           _to_limbs(b, self.nl), out)
        return _from_limbs(out, 0, self.nl)

    def inv(self, a: int) -> int:
        out = (ctypes.c_uint64 * self.nl)()
        self.lib.hm_fp_inv(self.ctx, _to_limbs(a, self.nl), out)
        return _from_limbs(out, 0, self.nl)

    def pow(self, a: int, e: int) -> int:
        if e < 0:
            return self.pow(self.inv(a), -e)
        e_nl = max(1, (e.bit_length() + 63) // 64)
        out = (ctypes.c_uint64 * self.nl)()
        self.lib.hm_fp_pow(self.ctx, _to_limbs(a, self.nl),
                           _to_limbs(e, e_nl), e_nl, out)
        return _from_limbs(out, 0, self.nl)

    def batch_inv(self, xs: Sequence[int]) -> List[int]:
        n = len(xs)
        buf = (ctypes.c_uint64 * (n * self.nl))()
        for i, x in enumerate(xs):
            for j in range(self.nl):
                buf[i * self.nl + j] = x & 0xFFFFFFFFFFFFFFFF
                x >>= 64
        out = (ctypes.c_uint64 * (n * self.nl))()
        self.lib.hm_fp_batch_inv(self.ctx, buf, n, out)
        return [_from_limbs(out, i * self.nl, self.nl) for i in range(n)]


class NativeSW:
    """Native short-Weierstrass group ops (y^2 = x^3 + b, a = 0) over Fp
    (deg=1) or Fp2 (deg=2, u^2 = beta).

    Affine point convention matches the host model: None = identity,
    else (x, y) with coordinates int (deg 1) or (c0, c1) tuples (deg 2).
    """

    def __init__(self, fp: NativeFp, deg: int, beta: int | Tuple = 0):
        assert deg in (1, 2)
        self.fp = fp
        self.deg = deg
        self.el = deg * fp.nl
        if deg == 2:
            self.beta = _to_limbs(beta if isinstance(beta, int) else beta[0],
                                  fp.nl)
        else:
            self.beta = _to_limbs(0, fp.nl)

    def _coords_to_buf(self, c) -> "ctypes.Array":
        buf = (ctypes.c_uint64 * self.el)()
        comps = (c,) if self.deg == 1 else tuple(c)
        for k, v in enumerate(comps):
            for j in range(self.fp.nl):
                buf[k * self.fp.nl + j] = v & 0xFFFFFFFFFFFFFFFF
                v >>= 64
        return buf

    def _coords_from_buf(self, buf, off: int):
        vals = [_from_limbs(buf, off + k * self.fp.nl, self.fp.nl)
                for k in range(self.deg)]
        return vals[0] if self.deg == 1 else tuple(vals)

    def scalar_mul(self, pt, k: int):
        if pt is None or k == 0:
            return None
        k_nl = max(1, (k.bit_length() + 63) // 64)
        ox = (ctypes.c_uint64 * self.el)()
        oy = (ctypes.c_uint64 * self.el)()
        oinf = ctypes.c_int(0)
        self.fp.lib.hm_sw_scalar_mul(
            self.fp.ctx, self.deg, self.beta,
            self._coords_to_buf(pt[0]), self._coords_to_buf(pt[1]), 0,
            _to_limbs(k, k_nl), k_nl,
            ox, oy, ctypes.byref(oinf))
        if oinf.value:
            return None
        return (self._coords_from_buf(ox, 0), self._coords_from_buf(oy, 0))

    def scalar_mul_batch(self, pt, ks: Sequence[int]):
        """[k * pt for k in ks] — fixture generation hot path."""
        n = len(ks)
        if pt is None:
            return [None] * n
        k_nl = max(1, max((k.bit_length() for k in ks), default=1))
        k_nl = (k_nl + 63) // 64
        kbuf = (ctypes.c_uint64 * (n * k_nl))()
        for i, k in enumerate(ks):
            assert k >= 0
            for j in range(k_nl):
                kbuf[i * k_nl + j] = k & 0xFFFFFFFFFFFFFFFF
                k >>= 64
        oxs = (ctypes.c_uint64 * (n * self.el))()
        oys = (ctypes.c_uint64 * (n * self.el))()
        oinfs = (ctypes.c_int * n)()
        self.fp.lib.hm_sw_scalar_mul_batch(
            self.fp.ctx, self.deg, self.beta,
            self._coords_to_buf(pt[0]), self._coords_to_buf(pt[1]), 0,
            kbuf, k_nl, n, oxs, oys, oinfs)
        out = []
        for i in range(n):
            if oinfs[i]:
                out.append(None)
            else:
                out.append((self._coords_from_buf(oxs, i * self.el),
                            self._coords_from_buf(oys, i * self.el)))
        return out

    def msm(self, points, scalars: Sequence[int]):
        """sum_i scalars[i] * points[i] (Pippenger)."""
        pairs = [(p, s) for p, s in zip(points, scalars) if p is not None]
        if not pairs:
            return None
        n = len(pairs)
        k_nl = max(1, max(s.bit_length() for _, s in pairs))
        k_nl = (k_nl + 63) // 64
        xs = (ctypes.c_uint64 * (n * self.el))()
        ys = (ctypes.c_uint64 * (n * self.el))()
        infs = (ctypes.c_int * n)()
        kbuf = (ctypes.c_uint64 * (n * k_nl))()
        for i, (p, s) in enumerate(pairs):
            assert s >= 0
            xb = self._coords_to_buf(p[0])
            yb = self._coords_to_buf(p[1])
            for j in range(self.el):
                xs[i * self.el + j] = xb[j]
                ys[i * self.el + j] = yb[j]
            for j in range(k_nl):
                kbuf[i * k_nl + j] = s & 0xFFFFFFFFFFFFFFFF
                s >>= 64
        ox = (ctypes.c_uint64 * self.el)()
        oy = (ctypes.c_uint64 * self.el)()
        oinf = ctypes.c_int(0)
        self.fp.lib.hm_sw_msm(
            self.fp.ctx, self.deg, self.beta, xs, ys, infs,
            kbuf, k_nl, n, ox, oy, ctypes.byref(oinf))
        if oinf.value:
            return None
        return (self._coords_from_buf(ox, 0), self._coords_from_buf(oy, 0))
