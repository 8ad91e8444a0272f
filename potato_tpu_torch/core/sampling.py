"""Closed-form sampling of the unit disk, sphere and ball.

Each distribution is an exact closed-form transform of uniforms (no
rejection loops). All functions take uniforms in [0,1) with any batch shape
and return (..., N) tensors.
"""

from __future__ import annotations

import math

import torch


def closed_range(u, lo, hi):
    """Uniform in [lo, hi]."""
    return lo + u * (hi - lo)


def unit_disk(u1, u2):
    """Uniform inside the unit disk via the polar map."""
    r = torch.sqrt(u1)
    theta = (2.0 * math.pi) * u2
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def unit_sphere(u1, u2):
    """Uniform on the unit sphere.

    sin(theta) is derived from the cosine as sign(u2 < 1/2) * sqrt(1 - c^2)
    rather than by a second transcendental; same distribution."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    c = torch.cos((2.0 * math.pi) * u2)
    s = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    s = torch.where(u2 < 0.5, s, -s)
    return torch.stack([r * c, r * s, z], dim=-1)


def unit_ball(u1, u2, u3):
    """Uniform inside the unit ball: sphere direction scaled by cbrt(u)."""
    s = unit_sphere(u1, u2)
    return s * torch.pow(u3, 1.0 / 3.0)[..., None]


def bernoulli(u, p):
    """True with probability p."""
    return u < p
