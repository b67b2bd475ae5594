"""Pippenger multi-scalar multiplication over the device group law.

The JAX package's formulation, with no data-dependent branching: per
window of `window_bits` bits,

  1. digits <- slices of the de-Montgomeryized scalars
  2. points sorted by digit (stable argsort + gather)
  3. a segmented inclusive scan with the complete point add, log2(n)
     vectorized steps (sorted keys make the segment rule exact)
  4. segment-end sums scattered to their buckets at distinct indices
     (non-ends go to private dummy slots)
  5. the bucket combine sum_k k*S_k = sum_t suffix_t via a reversed scan,
     then a log-depth sum
  6. windows combined MSB -> LSB with window_bits doublings a window.

At n >= BUCKET_SERIAL_MIN the work-optimal bucket-serial schedule runs
instead (n*W adds in all, W*2^c buckets in parallel lanes).

Counterpart of ripp_tpu/ops/msm.py. The reference has no Pallas kernel
here (MSM is XLA there), so this is plain PyTorch around the group law,
whose products are the Montgomery kernel's launches on the card. Forms
that differ: the stable argsort is torch.argsort(stable=True); the
while_loop of the bucket-serial schedule is a host loop to the largest
bucket's length, read back once; the scatter to distinct indices is
indexed assignment; lax.map / vmap over the windows are a batch axis.
"""

from __future__ import annotations

import torch

from .curve import DevSWCurve
from .points import limb_bits
from .reduce import axis0_mask
from .tower import tree_leaves, tree_map, tree_select

# Above this size the bucket-serial schedule runs (n*W adds instead of the
# sorted scan's n*log2(n) a window).
BUCKET_SERIAL_MIN = 2048


def scalars_to_digits(fr, scalars_mont, window_bits: int, nbits: int):
    """Fr Montgomery limbs [n, NL] -> digit matrix [n, n_windows] (int64,
    least-significant window first)."""
    one_plain = torch.zeros((fr.nl,), dtype=scalars_mont.dtype,
                            device=scalars_mont.device)
    one_plain[0] = 1
    canon = fr.mul(scalars_mont, one_plain)  # de-Montgomeryize
    n_windows = (nbits + window_bits - 1) // window_bits
    # bits beyond the limbs read as 0, as in the reference's gather
    bits = limb_bits(canon, n_windows * window_bits).to(torch.int64)
    bits = bits.reshape(bits.shape[:-1] + (n_windows, window_bits))
    weights = torch.arange(window_bits, device=bits.device)
    return (bits << weights).sum(-1)


def _segmented_scan_add(curve: DevSWCurve, pts, keys):
    """Inclusive segmented scan with point addition over axis 0. keys
    ([n] or [n, W]) must be sorted ascending along axis 0; pts is a
    projective point tree whose leaves are [n, ..., NL] with the keys'
    shape in front. Each column of keys is a lane of its own."""
    n = keys.shape[0]
    if n == 1:
        return pts
    idx = torch.arange(n, device=keys.device).reshape(
        (n,) + (1,) * (keys.dim() - 1))
    for s in range((n - 1).bit_length()):
        shift = 1 << s
        prev = tree_map(lambda x: torch.roll(x, shift, dims=0), pts)
        prev_keys = torch.roll(keys, shift, dims=0)
        same = (idx >= shift) & (prev_keys == keys)
        combined = curve.add(pts, prev)
        pts = tree_select(same, combined, pts)
    return pts


def _suffix_weighted_sum(curve: DevSWCurve, buckets):
    """Given bucket sums S_k for k = 0..K-1 ([K, *batch, ...] tree), return
    sum_{k>=1} k * S_k = sum_{t>=1} (sum_{k>=t} S_k) for each batch lane."""
    K = tree_leaves(buckets)[0].shape[0]
    # drop bucket 0, reverse so suffix sums become prefix sums
    b = tree_map(lambda x: x[1:].flip(0), buckets)  # [K-1]
    n = K - 1
    idx = torch.arange(n, device=tree_leaves(b)[0].device)
    for s in range((n - 1).bit_length()):
        shift = 1 << s
        prev = tree_map(lambda x: torch.roll(x, shift, dims=0), b)
        combined = curve.add(b, prev)
        b = tree_select(axis0_mask(idx >= shift, b), combined, b)
    # b[i] = S_{K-1} + ... + S_{K-1-i} (prefix of reversed) = suffix sums
    return curve.sum_reduce(b)


def _msm_windows(curve: DevSWCurve, points, digits, window_bits: int):
    """All window sums W_w (sorted-scan schedule): a point tree
    [n_windows, ...]. The windows run side by side as a batch axis (the
    reference maps one window at a time); each is its own lane."""
    n, W = digits.shape
    K = 1 << window_bits
    order = torch.argsort(digits, dim=0, stable=True)          # [n, W]
    keys_s = torch.gather(digits, 0, order)
    pts_s = tree_map(lambda x: x[order], points)               # [n, W, ...]
    scanned = _segmented_scan_add(curve, pts_s, keys_s)
    # segment ends: last position of each key run
    next_keys = torch.cat([keys_s[1:], keys_s.new_full((1, W), K + 1)])
    is_end = keys_s != next_keys
    # distinct scatter indices in each window: ends -> their bucket,
    # others -> dummy slots
    idx = torch.where(is_end, keys_s,
                      K + torch.arange(n, device=keys_s.device)[:, None])
    cols = torch.arange(W, device=keys_s.device)[None, :]
    # untouched bucket slots hold the identity (0:1:0), not zeros
    buckets = curve.identity_like(tree_map(
        lambda x: x.new_zeros((K + n,) + x.shape[1:]), pts_s[0]))

    def scatter(dst, src):
        dst = dst.clone()
        dst[idx, cols] = src
        return dst[:K]

    buckets = tree_map(scatter, buckets, scanned)               # [K, W, ...]
    return _suffix_weighted_sum(curve, buckets)


def msm(curve: DevSWCurve, fr, points, scalars_mont, window_bits: int = 8,
        nbits: int = None):
    """points: projective tree [n, ...]; scalars_mont: Fr limbs [n, NL].
    Returns a single projective point (no batch dim). The whole batch in
    one call: the JAX package padded it to a few shapes for XLA."""
    nbits = nbits or fr.p.bit_length()
    if scalars_mont.shape[0] >= BUCKET_SERIAL_MIN:
        return _msm_bucket_serial(curve, fr, points, scalars_mont,
                                  window_bits, nbits)
    return _msm_impl(curve, fr, points, scalars_mont, window_bits, nbits)


def _msm_bucket_serial(curve: DevSWCurve, fr, points, scalars_mont,
                       window_bits: int, nbits: int):
    """Work-optimal Pippenger: every (window, digit) bucket accumulates its
    own elements serially while all W*2^c buckets run in parallel lanes.

    Sort the n*W (window, digit) entries by bucket once, then step k adds
    element k of every bucket (a [W*2^c] gather + one batched complete
    add). The trip count is the largest bucket's occupancy, read back to
    the host once, so the result is exact for any distribution of the
    scalars (a skewed one only runs more steps)."""
    n = scalars_mont.shape[0]
    K = 1 << window_bits
    digits = scalars_to_digits(fr, scalars_mont, window_bits, nbits)
    W = digits.shape[1]
    NB = W * K
    device = digits.device

    # entry (w, i) at flat id w*n + i, key = w*K + digit[i, w]
    keys_flat = (digits.t()
                 + (torch.arange(W, device=device) * K)[:, None]).reshape(-1)
    order = torch.argsort(keys_flat, stable=True)
    sorted_keys = keys_flat.index_select(0, order)
    point_idx = order % n
    starts = torch.searchsorted(sorted_keys,
                                torch.arange(NB + 1, device=device))
    lens = starts[1:] - starts[:-1]          # [NB]
    max_len = int(lens.max())

    first = tree_map(lambda x: x[0], points[0])
    acc = curve.identity_like(
        tree_map(lambda x: x.new_zeros((NB,) + x.shape), first))
    for k in range(max_len):
        pos = torch.clamp(starts[:NB] + k, 0, W * n - 1)
        pi = point_idx.index_select(0, pos)
        pts = tree_map(lambda x: x.index_select(0, pi), points)
        combined = curve.add(acc, pts)
        acc = tree_select(k < lens, combined, acc)

    # [NB] -> [K, W, ...]: the bucket combine runs along axis 0 with the
    # windows as a batch axis (the reference vmaps it over windows)
    buckets = tree_map(
        lambda x: x.reshape((W, K) + x.shape[1:]).transpose(0, 1), acc)
    windows = _suffix_weighted_sum(curve, buckets)
    return _combine_windows(curve, windows, window_bits)


def _msm_impl(curve: DevSWCurve, fr, points, scalars_mont, window_bits: int,
              nbits: int):
    digits = scalars_to_digits(fr, scalars_mont, window_bits, nbits)
    windows = _msm_windows(curve, points, digits, window_bits)
    return _combine_windows(curve, windows, window_bits)


def _combine_windows(curve: DevSWCurve, windows, window_bits: int):
    """Windows (LSB first, [n_windows, ...]) combined from the top:
    window_bits doublings, then the window's sum."""
    n_windows = tree_leaves(windows)[0].shape[0]
    acc = curve.identity_like(tree_map(lambda x: x[0], windows[0]))
    for w in reversed(range(n_windows)):
        for _ in range(window_bits):
            acc = curve.double(acc)
        acc = curve.add(acc, tree_map(lambda x: x[w], windows))
    return acc
