"""Fiat-Shamir sponge, counter-nonce challenges and deterministic
randomness.

`FiatShamirRng` is SIPP's hash-chain sponge RNG (arkworks ripp
`sipp/src/rng.rs:12-73`): seed = H(new || seed) on absorb, ChaCha20
reseeded from the digest each absorb, values squeezed via the RNG word
stream. Blake2s-256 digests (python hashlib matches the RustCrypto
defaults). GIPA's and TIPA's challenges are Blake2b digests of
nonce || material with a counter nonce, retried until the value is
usable (`challenge_field`, tipa/mod.rs:196-209; GIPA's 128-bit form is
models/gipa.py round_challenge). `SeededRng`, `rand_field`,
`rand_sw_point` and `random_generators` draw test and setup values the
arkworks way.

The port's own copy of ripp_tpu/utils/fiat_shamir.py but its
`challenge_u128`, which nothing of the TIPP slice calls (byte-exact;
tests/test_torch_utils.py and tests/test_torch_gipa.py hold the streams
and challenges equal).
"""

from __future__ import annotations

import hashlib
from typing import Callable, List, Optional

from .chacha import ChaChaRng


def blake2b_digest(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=64).digest()


def blake2s_digest(data: bytes) -> bytes:
    return hashlib.blake2s(data, digest_size=32).digest()


DIGESTS = {"blake2b": blake2b_digest, "blake2s": blake2s_digest}


class FiatShamirRng:
    """SIPP-style sponge RNG (digest must be 32 bytes: Blake2s)."""

    def __init__(self, seed: bytes, digest: str = "blake2s"):
        self._digest = DIGESTS[digest]
        self.seed = self._digest(seed)
        assert len(self.seed) == 32, "FiatShamirRng requires a 32-byte digest"
        self.r = ChaChaRng(self.seed)

    def absorb(self, data: bytes) -> None:
        self.seed = self._digest(data + self.seed)
        self.r = ChaChaRng(self.seed)

    # RngCore surface
    def next_u32(self) -> int:
        return self.r.next_u32()

    def next_u64(self) -> int:
        return self.r.next_u64()

    def next_u128(self) -> int:
        return self.r.next_u128()

    def fill_bytes(self, n: int) -> bytes:
        return self.r.fill_bytes(n)


def field_from_random_bytes(data: bytes, r_modulus: int) -> Optional[int]:
    """ark-ff 0.4 Fp::from_random_bytes semantics: read ceil(bits/64)
    little-endian u64 limbs from the input, MASK the top limb by
    REPR_SHAVE_BITS (= 64*limbs - MODULUS_BIT_SIZE), return None if the
    masked integer is >= the modulus.

    The mask is what makes the rejection loop terminate for any modulus
    (without it a 24-bit test-curve r rejects ~2^-232 of draws) and what
    matches arkworks' accept/reject pattern bit-for-bit on
    BLS12-381/377."""
    bits = r_modulus.bit_length()
    limbs = (bits + 63) // 64
    v = int.from_bytes(data[: limbs * 8], "little")
    v &= (1 << bits) - 1  # shave REPR_SHAVE_BITS off the top limb
    return v if v < r_modulus else None


def challenge_field(digest_fn: Callable[[bytes], bytes],
                    material: Callable[[int], bytes],
                    r_modulus: int) -> int:
    """from_random_bytes-style challenge with the counter-nonce rejection
    loop (tipa/mod.rs:196-209)."""
    counter = 0
    while True:
        h = digest_fn(material(counter))
        v = field_from_random_bytes(h, r_modulus)
        if v is not None:
            return v
        counter += 1


# --- deterministic sampling (arkworks UniformRand analogs) ------------------

class SeededRng:
    """Deterministic RNG for tests/SRS setup (ChaCha20 from a u64 seed,
    standing in for the reference tests' StdRng::seed_from_u64)."""

    def __init__(self, seed: int = 0):
        self.r = ChaChaRng(seed.to_bytes(8, "little") + b"\x00" * 24)

    def next_u32(self) -> int:
        return self.r.next_u32()

    def next_u64(self) -> int:
        return self.r.next_u64()

    def next_u128(self) -> int:
        return self.r.next_u128()


def rand_field(rng, modulus: int) -> int:
    """arkworks-style rejection sampling: draw ceil(bits/64) u64 limbs LE,
    mask the top limb to MODULUS_BIT_SIZE bits, reject if >= modulus."""
    bits = modulus.bit_length()
    nlimbs = (bits + 63) // 64
    shave = 64 * nlimbs - bits
    while True:
        limbs = [rng.next_u64() for _ in range(nlimbs)]
        limbs[-1] &= (1 << (64 - shave)) - 1 if shave else 0xFFFFFFFFFFFFFFFF
        v = 0
        for i, l in enumerate(limbs):
            v |= l << (64 * i)
        if v < modulus:
            return v


def rand_sw_point(rng, curve):
    """arkworks-style projective sampling: random x, 'greatest' bool, solve
    for y, clear cofactor."""
    while True:
        x = rand_field(rng, curve.F.p) if curve.F.degree == 1 else \
            curve.F.fromlist([rand_field(rng, curve.F.p)
                              for _ in range(curve.F.degree)])
        greatest = bool(rng.next_u32() & 1)
        pt = curve.point_from_x(x, greatest)
        if pt is not None:
            pt = curve.scalar_mul_unreduced(pt, curve.cofactor)
            if pt is not None:
                return pt


def random_generators(rng, curve, num: int) -> List:
    """`random_generators` analog (dh_commitments/src/lib.rs:59-61)."""
    return [rand_sw_point(rng, curve) for _ in range(num)]
