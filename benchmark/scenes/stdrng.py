"""rand-0.8's `StdRng` (ChaCha12) draw stream, as the reference path tracer
lays out its `more_balls` grid with it (`StdRng::from_seed([249; 32])`).

A frozen copy, for the benchmark's own scene records: the key is 8
little-endian u32 words, the 64-bit block counter starts at 0, the nonce is
0; each block is the state after 12 rounds plus the initial state; every
draw takes an aligned u64, low word first.
"""

from __future__ import annotations

M32 = 0xFFFFFFFF
_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def _quarter(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & M32
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & M32
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & M32
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & M32
    s[b] = _rotl(s[b] ^ s[c], 7)


def chacha_block(key_words, counter: int, rounds: int = 12):
    """16 keystream words of one block."""
    init = list(_CONSTANTS) + list(key_words) + [
        counter & M32, (counter >> 32) & M32, 0, 0]
    s = list(init)
    for _ in range(rounds // 2):
        _quarter(s, 0, 4, 8, 12)
        _quarter(s, 1, 5, 9, 13)
        _quarter(s, 2, 6, 10, 14)
        _quarter(s, 3, 7, 11, 15)
        _quarter(s, 0, 5, 10, 15)
        _quarter(s, 1, 6, 11, 12)
        _quarter(s, 2, 7, 8, 13)
        _quarter(s, 3, 4, 9, 14)
    return [(x + y) & M32 for x, y in zip(s, init)]


class StdRng:
    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("StdRng seed must be 32 bytes")
        self._key = [int.from_bytes(seed[4 * i:4 * i + 4], "little")
                     for i in range(8)]
        self._counter = 0
        self._words: list = []

    def next_u64(self) -> int:
        if not self._words:
            self._words = chacha_block(self._key, self._counter)[::-1]
            self._counter += 1
        lo = self._words.pop()
        hi = self._words.pop()
        return (hi << 32) | lo

    def gen_f64(self) -> float:
        """`rng.gen::<f64>()`: the 53 high bits of a u64 over 2^53."""
        return (self.next_u64() >> 11) * (2.0 ** -53)

    def closed_range(self, a: float, b: float) -> float:
        return a + self.gen_f64() * (b - a)

    def bernoulli(self, p: float) -> bool:
        return self.gen_f64() < p
