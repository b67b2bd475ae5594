"""ChaCha20 stream RNG compatible with rand_chacha's ChaChaRng word stream.

Used by the SIPP Fiat-Shamir sponge (arkworks ripp `sipp/src/rng.rs:16,56,71`
uses `ChaChaRng::from_seed(digest)`): the RNG emits the 16 u32 words of each
64-byte ChaCha20 block in order; `next_u64` combines two consecutive u32s
(low word first); `fill_bytes` is the little-endian byte stream of words.

The port's own copy of ripp_tpu/utils/chacha.py (pure Python, byte-exact;
tests/test_torch_utils.py holds the two streams equal).
"""

from __future__ import annotations

import struct
from typing import List

_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_MASK = 0xFFFFFFFF


def _rotl(v: int, c: int) -> int:
    return ((v << c) | (v >> (32 - c))) & _MASK


def _quarter(state: List[int], a: int, b: int, c: int, d: int) -> None:
    state[a] = (state[a] + state[b]) & _MASK
    state[d] = _rotl(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotl(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b]) & _MASK
    state[d] = _rotl(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotl(state[b] ^ state[c], 7)


def chacha20_block(key_words: List[int], counter: int, nonce_words: List[int]) -> List[int]:
    """One ChaCha20 block (20 rounds). counter is 64-bit (words 12-13),
    nonce_words are 2 u32 (words 14-15) - the rand_chacha "stream" layout."""
    init = list(_CONSTANTS) + list(key_words) + [
        counter & _MASK, (counter >> 32) & _MASK,
        nonce_words[0], nonce_words[1],
    ]
    st = list(init)
    for _ in range(10):
        _quarter(st, 0, 4, 8, 12)
        _quarter(st, 1, 5, 9, 13)
        _quarter(st, 2, 6, 10, 14)
        _quarter(st, 3, 7, 11, 15)
        _quarter(st, 0, 5, 10, 15)
        _quarter(st, 1, 6, 11, 12)
        _quarter(st, 2, 7, 8, 13)
        _quarter(st, 3, 4, 9, 14)
    return [(a + b) & _MASK for a, b in zip(st, init)]


class ChaChaRng:
    """rand_chacha::ChaCha20Rng analog: 32-byte seed, stream = 0."""

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self.key = list(struct.unpack("<8I", seed))
        self.counter = 0
        self.nonce = [0, 0]
        self.buf: List[int] = []
        self.pos = 0
        self.byte_buf = b""

    def _refill(self) -> None:
        self.buf = chacha20_block(self.key, self.counter, self.nonce)
        self.counter += 1
        self.pos = 0

    def next_u32(self) -> int:
        if self.pos >= len(self.buf):
            self._refill()
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def next_u128(self) -> int:
        """rand's Standard distribution for u128: low u64 first."""
        lo = self.next_u64()
        hi = self.next_u64()
        return lo | (hi << 64)

    def fill_bytes(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            out += struct.pack("<I", self.next_u32())
        return bytes(out[:n])
