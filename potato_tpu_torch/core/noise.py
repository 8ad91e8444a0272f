"""Deterministic lattice hash noise + Perlin gradient noise.

The libnoise-style integer hash is defined in wrapping signed 64-bit
arithmetic; torch's int64 add and multiply wrap, and its `>>` on int64 is
an arithmetic shift, so the hash is written directly. `noise_i64` is pinned
bit for bit against a pure-Python integer model of the hash.
"""

from __future__ import annotations

import torch

_A = 0x369E6D3B899E43CF
_B = 0x53F89E7FFDA3B07D
_C = 0x3B13C1CA4937E629
_D = 0x577C2C6E4019D645
_E = 60493
_F = 19990303
_G = 1376312589
_I64_MAX = float(2**63 - 1)
_TWO32 = float(2**32)


def _i64(x, device=None):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.tensor(int(x), dtype=torch.int64, device=device)


def noise_i64(x, y, z, seed):
    """The 64-bit lattice hash as an int64 tensor.

    h = A*x + B*y + C*z + D*seed;  h = (h >> 13) ^ h  (arithmetic shift);
    h = h * (h*h*E + F) + G, all wrapping 64-bit."""
    dev = next((a.device for a in (x, y, z, seed)
                if isinstance(a, torch.Tensor)), None)
    h = (_i64(x, dev) * _A + _i64(y, dev) * _B + _i64(z, dev) * _C
         + _i64(seed, dev) * _D)
    h = (h >> 13) ^ h
    return h * (h * h * _E + _F) + _G


def noise_integer(x, y, z, seed):
    """Low 32 bits of the 64-bit hash, as a signed 32-bit value."""
    return noise_i64(x, y, z, seed).to(torch.int32)


def noise_real(x, y, z, seed):
    """Lattice hash -> float32 in [-1, 1]: the signed 64-bit hash over
    i64::MAX. The high and low words are converted to float32 separately
    and recombined, which fixes the rounding."""
    h = noise_i64(x, y, z, seed)
    hi_f = (h >> 32).to(torch.float32)
    lo_f = (h & 0xFFFFFFFF).to(torch.float32)
    return (hi_f * _TWO32 + lo_f) / _I64_MAX


def _grad_dot(p, cx, cy, cz, seed):
    """Dot of (p - corner) with the hash-seeded corner gradient (gradient
    channels use seed+1/2/3)."""
    gx = noise_real(cx, cy, cz, seed + 1)
    gy = noise_real(cx, cy, cz, seed + 2)
    gz = noise_real(cx, cy, cz, seed + 3)
    px = p[..., 0] - cx.to(p.dtype)
    py = p[..., 1] - cy.to(p.dtype)
    pz = p[..., 2] - cz.to(p.dtype)
    return px * gx + py * gy + pz * gz


def _mix(a, b, t):
    return (b - a) * t + a


def value_noise(p, seed):
    """Blocky lattice value noise in [0, 1]: hash of floor(p), remapped
    0.5*x + 0.5."""
    f = torch.floor(p).to(torch.int64)
    x = noise_real(f[..., 0], f[..., 1], f[..., 2], seed)
    return 0.5 * x + 0.5


def perlin(p, seed):
    """Perlin gradient noise in ~[0, 1] with smootherstep fade + trilerp.
    p is (..., 3); seed a python int or an integer tensor."""
    fp = torch.floor(p)
    fl = fp.to(torch.int64)
    flx, fly, flz = fl[..., 0], fl[..., 1], fl[..., 2]
    clx, cly, clz = flx + 1, fly + 1, flz + 1

    k1 = _grad_dot(p, flx, fly, flz, seed)
    k2 = _grad_dot(p, clx, fly, flz, seed)
    k3 = _grad_dot(p, flx, cly, flz, seed)
    k4 = _grad_dot(p, clx, cly, flz, seed)
    k5 = _grad_dot(p, flx, fly, clz, seed)
    k6 = _grad_dot(p, clx, fly, clz, seed)
    k7 = _grad_dot(p, flx, cly, clz, seed)
    k8 = _grad_dot(p, clx, cly, clz, seed)

    t = p - fp
    t = (t * (t * 6.0 - 15.0) + 10.0) * t * t * t  # smootherstep

    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    k12 = _mix(k1, k2, tx)
    k34 = _mix(k3, k4, tx)
    k56 = _mix(k5, k6, tx)
    k78 = _mix(k7, k8, tx)
    k1234 = _mix(k12, k34, ty)
    k5678 = _mix(k56, k78, ty)
    k = _mix(k1234, k5678, tz)
    return 0.5 * k + 0.5
