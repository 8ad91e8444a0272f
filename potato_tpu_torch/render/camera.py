"""Ray order and vectorized thin-lens camera ray generation.

A frame's rays are traced in a traversal order: raw row r holds the ray
id `traversal_ray_ids(r)`, tile by tile where the frame divides into
tiles, else in scanline order. Every driver maps its rows to ray ids
here. One pass then maps global ray ids to jittered pixel samples to
world-space rays. All randomness is counter-based on the ray id, so any
sub-batch of rays is reproducible in isolation.
"""

from __future__ import annotations

import numpy as np
import torch

from potato_tpu_torch.core import math as pmath
from potato_tpu_torch.core import rng as prng
from potato_tpu_torch.core import sampling
from potato_tpu_torch.core.types import BIG, RAY_EPSILON, RayBatch
from potato_tpu_torch.ops import rng_kernel
from potato_tpu_torch.scene.tables import CameraTables

TILE_W, TILE_H = 16, 8   # pixels per ray-order tile (x spp rays)


def _tiles_apply(width: int, height: int) -> bool:
    return width % TILE_W == 0 and height % TILE_H == 0


def tile_swizzle_ids(lin, width: int, spp: int):
    """Permute the linear ray order so consecutive ids cover a compact
    TILE_W x TILE_H pixel tile (x spp samples) instead of a 1-pixel-high
    scanline strip.

    The flash intersector builds one cluster list per block of consecutive
    rays; a tile's list is the union over a compact screen patch instead of
    a width-spanning strip. Pure permutation: each ray's RNG and pixel are
    functions of the *physical* id, so the image is bit-identical to
    scanline order after unpermuting.
    """
    lin = lin.to(torch.int64)
    tile = TILE_W * TILE_H * spp
    t_idx, within = lin // tile, lin % tile
    pix, sample = within // spp, within % spp
    tiles_x = width // TILE_W
    px = (t_idx % tiles_x) * TILE_W + pix % TILE_W
    py = (t_idx // tiles_x) * TILE_H + pix // TILE_W
    return (py * width + px) * spp + sample


def tile_unswizzle_perm(width: int, height: int, spp: int) -> np.ndarray:
    """Host-side: physical ray id for each raw (traversal-order) row; the
    same formula as `tile_swizzle_ids`, in numpy. The plain version that
    tests hold the renderer's unswizzle (a reshape, `_to_host`) to."""
    lin = np.arange(width * height * spp, dtype=np.uint64)
    tile = TILE_W * TILE_H * spp
    t_idx, within = lin // tile, lin % tile
    pix, sample = within // spp, within % spp
    tiles_x = width // TILE_W
    px = (t_idx % tiles_x) * TILE_W + pix % TILE_W
    py = (t_idx // tiles_x) * TILE_H + pix // TILE_W
    return ((py * width + px) * spp + sample).astype(np.int64)


def traversal_ray_ids(raw, width: int, height: int, spp: int):
    """(B,) int64 raw traversal rows -> their physical ray ids. A row at
    or past the frame's end wraps around: its id only feeds the RNG of a
    lane that is dead."""
    lin = raw % max(width * height * spp, 1)
    return tile_swizzle_ids(lin, width, spp) if _tiles_apply(width, height) \
        else lin


def chunk_ray_ids(start: int, chunk_size: int, width: int, height: int,
                  spp: int, device):
    """(ids, live) of the chunk starting at raw row `start`: the tail
    chunk's lanes beyond the frame are born dead (live False), so they
    trace zero segments and the counter counts each frame ray once."""
    raw = torch.arange(chunk_size, dtype=torch.int64, device=device) + start
    return (traversal_ray_ids(raw, width, height, spp),
            raw < width * height * spp)


def generate_rays(camera: CameraTables, width: int, height: int, spp: int,
                  ray_ids, seed, jitter: bool = True,
                  lens: bool = True) -> RayBatch:
    """ray_ids (B,) integer global ids in [0, width*height*spp).

    id -> pixel = id // spp (row-major i + j*width), sample = id % spp.
    Jitter and lens draws are threefry streams keyed on the ray id, drawn
    together (one kernel launch on a card).

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

    # jitter and lens in one draw at bounce 0
    streams = [s for s, on in ((prng.STREAM_PIXEL_JITTER, jitter),
                               (prng.STREAM_LENS, lens)) if on]
    drawn = (rng_kernel.uniforms(seed, 0, streams, ray_ids) if streams
             else None)
    if jitter:
        j1, j2 = drawn[0], drawn[1]
    else:
        j1 = j2 = torch.zeros_like(i)
    u = (i + j1) / float(width)
    v = (j + j2) / float(height)

    zero = torch.zeros_like(i)
    if lens:
        l1, l2 = drawn[-2], drawn[-1]
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
