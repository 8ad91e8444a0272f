"""Pure-Python port of rand-0.8's `StdRng` (ChaCha12) draw stream.

The reference seeds `Randomizer::from_seed([249; 32])` to lay out the
`more_balls` sphere grid (example_scenes.rs:98) —
`Randomizer = rand::rngs::StdRng` (src/randomness.rs:5), which in rand 0.8
is the ChaCha12 stream cipher. Reproducing that exact stream makes the
generated scene sphere-for-sphere identical to the reference instead of
merely statistically equivalent.

Semantics ported:
- `SeedableRng::from_seed(key: [u8; 32])`: ChaCha12 with the 32-byte key
  as 8 little-endian u32 words, 64-bit block counter = 0, 64-bit
  stream/nonce = 0 (the DJB state layout rand_chacha uses: words 12-13
  counter, 14-15 nonce).
- keystream words: per block, (state after 12 rounds) + (initial state),
  u32 words in order; blocks in counter order. (rand_chacha buffers 4
  blocks per refill; since every draw here consumes an aligned u64 —
  two consecutive words, low word first — the refill boundary is
  unobservable and the flat word stream is equivalent.)
- `rng.gen::<f64>()` (the `Standard` distribution, rand-0.8
  src/distributions/float.rs): `(next_u64() >> 11) as f64 * 2^-53`.
- `ClosedRange(a, b)` = `a + gen::<f64>() * (b - a)`
  (src/randomness.rs:10-16); `Bernoulli(p)` = `gen::<f64>() < p`
  (src/randomness.rs:76-82).

The ChaCha core is validated by the classic DJB/RFC-7539 ChaCha20
zero-key known-answer vector (tests/test_stdrng.py) — the 12-round
variant runs the identical double-round code, just 6 iterations.
"""

from __future__ import annotations

M32 = 0xFFFFFFFF
_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _quarter(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & M32
    s[d] ^= s[a]
    s[d] = ((s[d] << 16) | (s[d] >> 16)) & M32
    s[c] = (s[c] + s[d]) & M32
    s[b] ^= s[c]
    s[b] = ((s[b] << 12) | (s[b] >> 20)) & M32
    s[a] = (s[a] + s[b]) & M32
    s[d] ^= s[a]
    s[d] = ((s[d] << 8) | (s[d] >> 24)) & M32
    s[c] = (s[c] + s[d]) & M32
    s[b] ^= s[c]
    s[b] = ((s[b] << 7) | (s[b] >> 25)) & M32


def chacha_block(key_words, counter: int, nonce_words=(0, 0),
                 rounds: int = 12):
    """One ChaCha block: 16 u32 keystream words (DJB 64-bit-counter
    layout: state[12:14] = counter lo/hi, state[14:16] = nonce)."""
    init = list(_CONSTANTS) + list(key_words) + [
        counter & M32, (counter >> 32) & M32,
        nonce_words[0], nonce_words[1]]
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
    """rand-0.8 `StdRng::from_seed` + the draw methods the reference uses."""

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("StdRng seed must be 32 bytes")
        self._key = [int.from_bytes(seed[4 * i:4 * i + 4], "little")
                     for i in range(8)]
        self._counter = 0
        self._words: list[int] = []
        self._index = 0

    def _next_u32(self) -> int:
        if self._index >= len(self._words):
            self._words = chacha_block(self._key, self._counter, rounds=12)
            self._counter += 1
            self._index = 0
        w = self._words[self._index]
        self._index += 1
        return w

    def next_u64(self) -> int:
        lo = self._next_u32()
        hi = self._next_u32()
        return (hi << 32) | lo

    def gen_f64(self) -> float:
        """`rng.gen::<f64>()`: 53 high bits of a u64, scaled to [0, 1)."""
        return (self.next_u64() >> 11) * (2.0 ** -53)

    def closed_range(self, a: float, b: float) -> float:
        """`ClosedRange(a, b).sample(rng)` (src/randomness.rs:10-16)."""
        return a + self.gen_f64() * (b - a)

    def bernoulli(self, p: float) -> bool:
        """`Bernoulli(p).sample(rng)` (src/randomness.rs:76-82)."""
        return self.gen_f64() < p
