"""Vectorized thin-lens camera ray generation.

One pass maps global ray ids to jittered pixel samples to world-space
rays. All randomness is counter-based on the ray id, so any sub-batch of
rays is reproducible in isolation.
"""

from __future__ import annotations

import torch

from potato_tpu_torch.core import math as pmath
from potato_tpu_torch.core import rng as prng
from potato_tpu_torch.core import sampling
from potato_tpu_torch.core.types import BIG, RAY_EPSILON, RayBatch
from potato_tpu_torch.scene.tables import CameraTables


def generate_rays(camera: CameraTables, width: int, height: int, spp: int,
                  ray_ids, seed, jitter: bool = True,
                  lens: bool = True) -> RayBatch:
    """ray_ids (B,) integer global ids in [0, width*height*spp).

    id -> pixel = id // spp (row-major i + j*width), sample = id % spp.
    Jitter and lens draws are threefry streams keyed on the ray id.

    jitter=False uses the regular grid uv = (i/width, j/height): every
    sample of a pixel identical (only the lens draw then differs).
    lens=False is the pinhole camera (lens_radius == 0): the disk sample
    would be all-zero anyway, and STREAM_LENS is a stream of its own, so
    skipping it shifts no other draw.
    """
    ray_ids = ray_ids.to(torch.int64)
    pixel = ray_ids // spp
    i = (pixel % width).to(torch.float32)
    j = (pixel // width).to(torch.float32)

    if jitter:
        j1, j2 = prng.uniform2(seed, prng.STREAM_PIXEL_JITTER, ray_ids)
    else:
        j1 = j2 = torch.zeros_like(i)
    u = (i + j1) / float(width)
    v = (j + j2) / float(height)

    zero = torch.zeros_like(i)
    if lens:
        l1, l2 = prng.uniform2(seed, prng.STREAM_LENS, ray_ids)
        disk = sampling.unit_disk(l1, l2) * camera.lens_radius
        origin_local = torch.stack([disk[..., 0], disk[..., 1], zero], dim=-1)
    else:
        origin_local = torch.zeros(i.shape + (3,), dtype=torch.float32,
                                   device=i.device)

    # local frame: X right, Y up, Z behind => forward is -Z
    scale = camera.tan_half_fov * camera.focal_dist
    target_local = torch.stack([
        (2.0 * u - 1.0) * scale * camera.aspect_ratio,
        (2.0 * v - 1.0) * scale,
        -camera.focal_dist * torch.ones_like(u),
    ], dim=-1)
    direction_local = pmath.normalize(target_local - origin_local)

    # world frame: the orientation may be non-orthonormal (only its z axis
    # is unit length), so world directions are not renormalized
    direction = torch.sum(camera.orientation * direction_local[..., None, :],
                          dim=-1)
    origin = torch.sum(camera.orientation * origin_local[..., None, :],
                       dim=-1) + camera.position

    return RayBatch(
        origin=origin, direction=direction,
        t_min=torch.full_like(zero, RAY_EPSILON),
        t_max=torch.full_like(zero, BIG),
    )
