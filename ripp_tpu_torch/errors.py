"""Typed error domains for the framework.

Mirrors the reference's two error enums so protocol boundaries raise
structured, catchable errors instead of bare AssertionError from deep in
kernels:

  * ``InnerProductError`` -- the L1 inner-product domain
    (arkworks ripp inner_products/src/lib.rs:17-38).
  * ``InnerProductArgumentError`` -- the L3 argument domain
    (arkworks ripp ip_proofs/src/lib.rs:21-43).

Both inherit ValueError so pre-existing callers catching ValueError keep
working.  Extra variants (``NotPowerOfTwo``) cover checks the reference
performs with the same MessageLengthInvalid variant or asserts.

The port's own copy of ripp_tpu/errors.py.
"""

from __future__ import annotations


class InnerProductError(ValueError):
    """Inner-product evaluation errors (length mismatch between sides)."""

    @classmethod
    def message_length_invalid(cls, left: int, right: int) -> "InnerProductError":
        return cls(f"left length, right length: {left}, {right}")


class InnerProductArgumentError(ValueError):
    """Argument-system (GIPA/TIPA/SSM) errors."""

    @classmethod
    def message_length_invalid(
        cls, left: int, right: int
    ) -> "InnerProductArgumentError":
        return cls(f"left length, right length: {left}, {right}")

    @classmethod
    def inner_product_invalid(cls) -> "InnerProductArgumentError":
        return cls("inner product not sound")

    @classmethod
    def not_power_of_two(cls, n: int) -> "InnerProductArgumentError":
        return cls(f"vector length must be a power of two, got {n}")


def check_same_length(left, right, domain=InnerProductError) -> None:
    """Raise the domain's MessageLengthInvalid when lengths differ."""
    if len(left) != len(right):
        raise domain.message_length_invalid(len(left), len(right))


def check_power_of_two(n: int) -> None:
    if n <= 0 or (n & (n - 1)) != 0:
        raise InnerProductArgumentError.not_power_of_two(n)
