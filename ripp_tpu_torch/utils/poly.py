"""Host polynomial arithmetic over Fr (python ints mod r).

Covers the ark-poly surface RIPP consumes (SURVEY.md section 2.3): dense
univariate evaluation, the TIPA challenge-polynomial helpers
(tipa/mod.rs:393-422), and quotient-by-linear via synthetic (Ruffini)
division - O(n) host mulmods, only the resulting MSM runs on device.

The port's own copy of ripp_tpu/utils/poly.py, as far as TIPA uses it
(poly_add / poly_scale wait for the applications).
"""

from __future__ import annotations

from typing import List, Sequence


def structured_scalar_power(num: int, s: int, r: int) -> List[int]:
    """(1, s, s^2, ..., s^(num-1)) (structured_scalar_message.rs:334-340)."""
    out = [1]
    for _ in range(num - 1):
        out.append(out[-1] * s % r)
    return out


def poly_eval(coeffs: Sequence[int], z: int, r: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % r
    return acc


def poly_eval_product_form(transcript: Sequence[int], z: int, r_shift: int,
                           r: int) -> int:
    """f_ck(z) = prod_i (1 + c_i * (r_shift * z)^(2^(i+1)) ... ) evaluated in
    O(log n) product form (tipa/mod.rs:393-405): power starts at z^2*r and
    squares each step."""
    power = z * z % r * r_shift % r
    acc = 1
    for c in transcript:
        acc = acc * (1 + c * power) % r
        power = power * power % r
    return acc


def poly_coeffs_from_transcript(transcript: Sequence[int], r_shift: int,
                                r: int) -> List[int]:
    """Coefficient expansion of the ck-polynomial, zero-interleaved so only
    even degrees are populated (tipa/mod.rs:407-422)."""
    coefficients = [1]
    power = r_shift % r
    for i, c in enumerate(transcript):
        cp = c * power % r
        for j in range(1 << i):
            coefficients.append(coefficients[j] * cp % r)
        power = power * power % r
    # interleave with zeros: degree 2k holds coefficients[k]
    out = []
    for i, c in enumerate(coefficients):
        out.append(c)
        if i != len(coefficients) - 1:
            out.append(0)
    return out


def quotient_by_linear(coeffs: Sequence[int], z: int, r: int) -> List[int]:
    """(f(X) - f(z)) / (X - z) via synthetic division; returns quotient
    coefficients (degree = deg f - 1)."""
    d = len(coeffs) - 1
    q = [0] * d
    acc = coeffs[d] % r
    for i in range(d - 1, -1, -1):
        q[i] = acc
        acc = (coeffs[i] + z * acc) % r
    return q
