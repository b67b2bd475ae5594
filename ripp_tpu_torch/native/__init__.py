"""Native (C) host-side acceleration: Montgomery bigint fields and
short-Weierstrass group ops, built on demand and bound via ctypes.

See csrc/hostmath.c and hostmath.py. All consumers fall back to the
pure-Python host model when the toolchain or build is unavailable.
"""

from .hostmath import NativeFp, NativeSW, load  # noqa: F401
