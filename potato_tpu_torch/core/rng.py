"""Counter-based RNG: Threefry-2x32 on (seed, stream, ray-id) counters.

Every random draw is a pure function of

    (seed, salt, global ray id)

so renders are bit-deterministic and independent of how rays are chunked
or split across devices: any tile is recomputable in isolation.

The 32-bit words live in int64 tensors and are masked back to 32 bits
after every add and rotate (torch's uint32 supports too few operators to
carry a cipher). Two round counts:

- `threefry2x32(..., rounds=20)`: the full-strength cipher, pinned to the
  published known-answer vectors.
- the render path draws with `rounds=13`, the least count that passes
  BigCrush for Threefry-2x32 (Salmon et al., SC'11, table 2): Monte Carlo
  rendering needs statistical quality, not a cryptographic margin. The
  13-round stream is its own deterministic spec, pinned by fixture.
"""

from __future__ import annotations

import torch

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF

# Stream salts: purpose of each draw within a bounce. A draw's salt is
# salt = bounce * NUM_STREAMS + stream (bounce 0 also covers camera setup).
STREAM_PIXEL_JITTER = 0
STREAM_LENS = 1
STREAM_SCATTER_A = 2   # lambert sphere / metal ball sample (2 uniforms)
STREAM_SCATTER_B = 3   # word 0: ball radius; word 1: dielectric bernoulli
STREAM_DIELECTRIC = 4  # unused (the bernoulli draw rides SCATTER_B's second
                       # word); kept so the stream numbering stays documented
NUM_STREAMS = 8

RENDER_ROUNDS = 13


def _word(x, device=None):
    """A 32-bit word as an int64 tensor (python ints and tensors alike)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.tensor(int(x) & _M32, dtype=torch.int64, device=device)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key0, key1, ctr0, ctr1, rounds: int = 20):
    """Threefry-2x32. Inputs are broadcastable 32-bit words (python ints or
    integer tensors); returns two int64 tensors holding words in [0, 2^32).

    The key schedule is the canonical one: an injection after every 4
    rounds, plus a final injection when the count is not a multiple of 4
    (rounds=13: injections after rounds 4, 8, 12, 13).
    """
    dev = next((a.device for a in (ctr0, ctr1, key0, key1)
                if isinstance(a, torch.Tensor)), None)
    k0 = _word(key0, dev)
    k1 = _word(key1, dev)
    k2 = k0 ^ k1 ^ _PARITY
    x0 = (_word(ctr0, dev) + k0) & _M32
    x1 = (_word(ctr1, dev) + k1) & _M32

    ks = (k0, k1, k2)
    j = 0
    for r in range(rounds):
        block, i = divmod(r, 4)
        x0 = (x0 + x1) & _M32
        x1 = _rotl(x1, _ROTATIONS[(block % 2) * 4 + i])
        x1 = x1 ^ x0
        if i == 3 or r == rounds - 1:
            j += 1
            x0 = (x0 + ks[j % 3]) & _M32
            x1 = (x1 + ks[(j + 1) % 3] + j) & _M32
    return x0, x1


def _key_from_seed(seed: int):
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _M32, (seed >> 32) & _M32


def random_bits2(seed, salt, ids):
    """Two independent 32-bit words per id. `ids` is an integer tensor of
    global ray ids; `salt` a python int or a scalar tensor; `seed` a python
    int (64 bits used) or a tensor (32 bits used)."""
    if isinstance(seed, torch.Tensor):
        k0, k1 = seed, 0
    else:
        k0, k1 = _key_from_seed(seed)
    ids = _word(ids)
    salt = _word(salt, ids.device).expand(ids.shape)
    return threefry2x32(k0, k1, ids, salt, rounds=RENDER_ROUNDS)


def _bits_to_unit_float(bits, dtype=torch.float32):
    """32-bit word -> float in [0, 1): the top 23 bits become the mantissa
    of a float in [1, 2), bit-cast, minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0).to(dtype)


def uniform2(seed, salt, ids, dtype=torch.float32):
    """Two uniforms in [0,1) per id."""
    b0, b1 = random_bits2(seed, salt, ids)
    return _bits_to_unit_float(b0, dtype), _bits_to_unit_float(b1, dtype)


def uniform1(seed, salt, ids, dtype=torch.float32):
    b0, _ = random_bits2(seed, salt, ids)
    return _bits_to_unit_float(b0, dtype)


def bounce_salt(bounce, stream: int):
    """Salt for a draw of `stream` purpose at a given bounce."""
    return bounce * NUM_STREAMS + stream
