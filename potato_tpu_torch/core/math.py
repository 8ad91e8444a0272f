"""Vector math: reflect/refract, equirect UVs, AABBs, rigid transforms.

Everything broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot over the last axis -> (...,)."""
    return torch.sum(a * b, dim=-1)


def norm_squared(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * a, dim=-1)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Square root, correctly rounded on every device.

    torch's float32 square root on the CPU is not correctly rounded on
    every machine: on some, about one result in five is one ulp off,
    where XLA's and CUDA's are exact. Taken in float64 and rounded once
    to float32, the root is exact."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Normalize over the last axis."""
    return a / sqrt(norm_squared(a))[..., None]


def safe_normalize(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    n2 = torch.clamp(norm_squared(a), min=eps)
    return a / sqrt(n2)[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Mirror reflection; normal must be unit length."""
    return incident - 2.0 * dot(incident, normal)[..., None] * normal


def refract(incident: torch.Tensor, normal: torch.Tensor, eta):
    """Snell refraction of unit vectors.

    Returns (refracted_direction, valid) where valid=False marks total
    internal reflection; on those lanes the direction is a safe dummy (the
    incident vector) and callers select reflect() instead.
    """
    cos_theta = dot(normal, incident)
    eta = torch.as_tensor(eta, dtype=incident.dtype,
                          device=incident.device).expand(cos_theta.shape)
    k = 1.0 - eta * eta * (1.0 - cos_theta * cos_theta)
    valid = k > 0.0
    sqrt_k = sqrt(torch.where(valid, k, torch.ones_like(k)))
    refr = (eta[..., None] * incident
            - (eta * cos_theta + sqrt_k)[..., None] * normal)
    return torch.where(valid[..., None], refr, incident), valid


def schlick_reflectance(cos_incident_normal, eta):
    """Schlick's approximation r0 + (1-r0)*(1 + n.d)^5 with n the
    outward-flipped normal and d the incident direction (n.d = -cos theta)."""
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    return r0 + (1.0 - r0) * (1.0 + cos_incident_normal) ** 5


def equirect_uv(direction: torch.Tensor) -> torch.Tensor:
    """Equirectangular UVs of a unit direction.

    Latitude is atan2(y, hypot(x, z)), equal to asin(y) for unit vectors;
    at the poles, where the azimuth is undefined, u is pinned to 0.5."""
    x = direction[..., 0]
    y = direction[..., 1]
    z = direction[..., 2]
    r2 = x * x + z * z
    at_pole = r2 < 1e-12
    xs = torch.where(at_pole, torch.ones_like(x), x)
    zs = torch.where(at_pole, torch.zeros_like(z), z)
    u = 0.5 - torch.atan2(zs, xs) / (2.0 * math.pi)
    v = torch.atan2(y, sqrt(r2 + 1e-12)) / math.pi + 0.5
    return torch.stack([u, v], dim=-1)


# ---------------------------------------------------------------- AABB

def aabb_union(min_a, max_a, min_b, max_b):
    return torch.minimum(min_a, min_b), torch.maximum(max_a, max_b)


def aabb_entry_t(box_min, box_max, origin, inv_direction, t_min, t_max):
    """Slab test returning (hit, entry_t): boxes (..., 3) against rays
    (..., 3)."""
    t0 = (box_min - origin) * inv_direction
    t1 = (box_max - origin) * inv_direction
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    tmin = torch.maximum(torch.as_tensor(t_min, dtype=lo.dtype,
                                         device=lo.device),
                         lo.amax(dim=-1))
    tmax = torch.minimum(torch.as_tensor(t_max, dtype=hi.dtype,
                                         device=hi.device),
                         hi.amin(dim=-1))
    return tmax >= tmin, tmin


def aabb_hit(box_min, box_max, origin, inv_direction, t_min, t_max):
    """Slab test; returns a bool mask."""
    return aabb_entry_t(box_min, box_max, origin, inv_direction,
                        t_min, t_max)[0]


# ------------------------------------------------------ Transformation

class Transformation(NamedTuple):
    """Rigid frame: 3x3 orientation (columns = local axes) + position."""

    orientation: torch.Tensor  # (3, 3)
    position: torch.Tensor     # (3,)


def identity_transform(dtype=torch.float32, device="cpu") -> Transformation:
    return Transformation(torch.eye(3, dtype=dtype, device=device),
                          torch.zeros(3, dtype=dtype, device=device))


def lookat(position, target, up, dtype=torch.float32,
           device="cpu") -> Transformation:
    """Camera-style frame: +Z points from target back to position. Only z
    is normalized (x and y keep the length the cross products give)."""
    position = torch.as_tensor(position, dtype=dtype, device=device)
    target = torch.as_tensor(target, dtype=dtype, device=device)
    up = torch.as_tensor(up, dtype=dtype, device=device)
    z = position - target
    z = z / torch.linalg.norm(z)
    x = torch.linalg.cross(up, z)
    y = torch.linalg.cross(z, x)
    return Transformation(torch.stack([x, y, z], dim=-1), position)


def inverse_transform(t: Transformation) -> Transformation:
    inv_o = t.orientation.T
    return Transformation(
        inv_o, -torch.sum(inv_o * t.position[None, :], dim=-1))


def transform_vector(t: Transformation, v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors into the frame."""
    return torch.sum(t.orientation * v[..., None, :], dim=-1)


def transform_point(t: Transformation, p: torch.Tensor) -> torch.Tensor:
    return transform_vector(t, p) + t.position
