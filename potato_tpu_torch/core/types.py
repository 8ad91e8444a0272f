"""Core ray/hit records: structure-of-arrays batches of torch tensors.

A "ray" is a batch of rays: every field carries a leading batch dimension,
so the whole renderer is shaped (B, ...). Default precision is float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Nudge the start of a scattered ray to avoid self-intersection.
RAY_EPSILON = 1e-3
# Determinant cutoff for the Cramer-form triangle intersector.
SMOL = 1e-7
# Sentinel "no hit" distance: large and finite, so arithmetic on t stays
# NaN-free where inf would give inf - inf.
BIG = 3.0e38


def resolve_device(device) -> torch.device:
    """The torch.device an entry point was asked for.

    Asking for a CUDA device on a machine without one raises: nothing in
    this package moves work to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


_CONSTANTS = {}


def device_constant(values, dtype, device) -> torch.Tensor:
    """A small constant vector on `device`, made once per device and kept.

    It is written by one fill a value, never copied from the host, so
    making it does not sync the host with a card. Made while a CUDA graph
    is being captured, it is made afresh and not kept: its fills run only
    when the graph replays. Callers must not write to it."""
    device = torch.device(device)
    key = (tuple(values), dtype, device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = torch.empty(len(values), dtype=dtype, device=device)
        for i, v in enumerate(values):
            t[i].fill_(v)
        if not (device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            _CONSTANTS[key] = t
    return t


class RayBatch(NamedTuple):
    """A batch of rays origin + t*direction, t in [t_min, t_max].

    A lane with t_max < t_min is dead: it hits nothing."""

    origin: torch.Tensor     # (B, 3)
    direction: torch.Tensor  # (B, 3)
    t_min: torch.Tensor      # (B,)
    t_max: torch.Tensor      # (B,)

    @property
    def batch_shape(self):
        return self.origin.shape[:-1]

    def at(self, t: torch.Tensor) -> torch.Tensor:
        """Point at parameter t; t is (B,)."""
        return self.origin + t[..., None] * self.direction


def make_rays(origin, direction, t_min=None, t_max=None) -> RayBatch:
    origin = torch.as_tensor(origin)
    direction = torch.as_tensor(direction, device=origin.device)
    batch = origin.shape[:-1]
    kw = dict(dtype=origin.dtype, device=origin.device)
    if t_min is None:
        t_min = torch.full(batch, RAY_EPSILON, **kw)
    if t_max is None:
        t_max = torch.full(batch, BIG, **kw)
    return RayBatch(origin, direction,
                    torch.as_tensor(t_min, **kw), torch.as_tensor(t_max, **kw))


class HitBatch(NamedTuple):
    """A batch of ray-object collisions.

    `valid` takes the place of an optional hit: masked lanes carry
    well-defined dummy values so downstream math is branchless."""

    t: torch.Tensor         # (B,)
    position: torch.Tensor  # (B, 3)
    normal: torch.Tensor    # (B, 3) unit length, except interpolated mesh
                            # normals, which are left unnormalized
    uv: torch.Tensor        # (B, 2)
    material: torch.Tensor  # (B,) int64 material ids
    valid: torch.Tensor     # (B,) bool


def no_hits(batch_shape, dtype=torch.float32, device="cpu") -> HitBatch:
    """An all-miss HitBatch with safe dummy values."""
    batch_shape = tuple(batch_shape)
    kw = dict(dtype=dtype, device=device)
    normal = torch.zeros(batch_shape + (3,), **kw)
    normal[..., 2] = 1.0
    return HitBatch(
        t=torch.full(batch_shape, BIG, **kw),
        position=torch.zeros(batch_shape + (3,), **kw),
        normal=normal,
        uv=torch.zeros(batch_shape + (2,), **kw),
        material=torch.zeros(batch_shape, dtype=torch.int64, device=device),
        valid=torch.zeros(batch_shape, dtype=torch.bool, device=device),
    )


def hits_at_infinity(direction: torch.Tensor) -> HitBatch:
    """Pretend-hit on a sphere at infinity with equirectangular UVs:
    position = normal = direction, uv = equirect(direction)."""
    from potato_tpu_torch.core import math as pmath  # avoid an import cycle

    batch = direction.shape[:-1]
    dev = direction.device
    return HitBatch(
        t=torch.full(batch, BIG, dtype=direction.dtype, device=dev),
        position=direction,
        normal=direction,
        uv=pmath.equirect_uv(direction),
        material=torch.zeros(batch, dtype=torch.int64, device=dev),
        valid=torch.ones(batch, dtype=torch.bool, device=dev),
    )


def closer_hit(a: HitBatch, b: HitBatch) -> HitBatch:
    """Elementwise closest-hit select."""
    take_b = b.valid & (~a.valid | (b.t < a.t))
    tb3 = take_b[..., None]
    return HitBatch(
        t=torch.where(take_b, b.t, a.t),
        position=torch.where(tb3, b.position, a.position),
        normal=torch.where(tb3, b.normal, a.normal),
        uv=torch.where(tb3, b.uv, a.uv),
        material=torch.where(take_b, b.material, a.material),
        valid=a.valid | b.valid,
    )
