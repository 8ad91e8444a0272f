"""Wavefront path-trace integrator.

The path recursion `emit + absorb . L(scatter)` unrolled into an
accumulator over a structure-of-arrays state:

    radiance  L += throughput * emit        (hit lanes)
    L += throughput * background            (miss lanes, then retired)
    throughput *= absorb                    (scattering lanes)

Control flow is an `active` mask; a retired lane keeps flowing through the
loop and its contribution is masked. `max_bounce` segments are traced, and
a path still alive after the last material evaluation contributes that
bounce's emission but no further scatter.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from potato_tpu_torch.core import rng as prng
from potato_tpu_torch.core.types import (
    BIG,
    RAY_EPSILON,
    HitBatch,
    RayBatch,
    device_constant,
    hits_at_infinity,
)
from potato_tpu_torch.ops import rng_kernel
from potato_tpu_torch.ops.material import (
    eval_emit,
    eval_material,
    pack_materials,
)
from potato_tpu_torch.ops.texture import counting
from potato_tpu_torch.scene import description as d


class TraceResult(NamedTuple):
    color: torch.Tensor       # (B,3) path radiance
    aov_normal: torch.Tensor  # (B,3) first-hit normal (zeros on miss)
    aov_hit: torch.Tensor     # (B,) foreground/coverage mask
    segments: torch.Tensor    # () int64: path segments actually traced
                              # (live lanes summed over bounces)


class PathState(NamedTuple):
    """Per-lane loop state of the bounce loop (one lane = one path)."""

    rays: RayBatch
    radiance: torch.Tensor
    throughput: torch.Tensor
    active: torch.Tensor
    aov_normal: torch.Tensor
    aov_hit: torch.Tensor
    segments: torch.Tensor


def init_state(rays: RayBatch, live=None) -> PathState:
    """Fresh bounce-loop state for a batch of camera rays.

    live: optional (B,) bool. Lanes born dead (padding in a fixed-shape
    chunk) trace nothing, contribute nothing, and are excluded from the
    segments counter: their camera ray is made dead (t_max = -1).
    """
    b = rays.t_min.shape
    dev = rays.t_min.device
    zb3 = torch.zeros(b + (3,), dtype=torch.float32, device=dev)
    active0 = torch.ones(b, dtype=torch.bool, device=dev)
    if live is not None:
        active0 = active0 & live
        rays = rays._replace(t_max=torch.where(live, rays.t_max, -1.0))
    return PathState(
        rays=rays,
        radiance=zb3,
        throughput=torch.ones_like(zb3),
        active=active0,
        aov_normal=zb3,
        aov_hit=torch.zeros(b, dtype=torch.bool, device=dev),
        segments=torch.zeros((), dtype=torch.int64, device=dev),
    )


def bounce_rays(origin, direction, alive) -> RayBatch:
    """The rays of the next segment, each over [RAY_EPSILON, BIG].

    The dead-lane rule (here and in `init_state`, nowhere else): a lane
    not `alive` (retired, or stale) keeps flowing through the loop with
    an inert ray, t_max = -1 < t_min, from the origin. The flash
    intersector's per-block culling then skips it entirely (a block of
    only dead lanes does no primitive work), and no BIG-t position
    reaches the next bounce's arithmetic."""
    f32 = dict(dtype=torch.float32, device=alive.device)
    return RayBatch(
        origin=torch.where(alive[..., None], origin, 0.0),
        direction=direction,
        t_min=torch.full(alive.shape, RAY_EPSILON, **f32),
        t_max=torch.full(alive.shape, -1.0, **f32).masked_fill_(alive, BIG))


class PassCounts:
    """Program counters of the bounce loop, kept on the host (no sync):
    `passes` the passes that steps of `make_bounce_step` ran, `replayed`
    those a CUDA graph replay served, `captures` the CUDA graphs captured
    (two a pass variant: render/bounce_graphs.py)."""

    def __init__(self):
        self.passes = 0
        self.replayed = 0
        self.captures = 0

    def snapshot(self):
        return self.passes, self.replayed, self.captures


pass_counts = PassCounts()


def make_bounce_step(tables, intersect_fn: Callable, seed, features=None,
                     ior_score: bool = False, aovs: bool = True):
    """Build the single-bounce transition `step(state, bounce, ray_ids)`.

    One call traces one path segment for every lane: intersect, shade,
    accumulate emission/background into radiance, draw the scatter
    direction, and advance the ray. `bounce` is a python int. The state
    returned is the caller's: no later call writes to it.

    Where the input allows it, the step replays each pass as CUDA graphs
    around the flash kernel (render/bounce_graphs.py): the intersector is
    the flash kernel's (`intersect_fn.flash_accel`), the state is on a
    card, the seed is a python int and nothing asks for a gradient. Else,
    and for a pass variant's first pass, it runs the pass op by op. Both
    give the same bits.
    """
    packed = pack_materials(tables)   # loop-invariant
    graphed = None
    accel = getattr(intersect_fn, "flash_accel", None)
    if accel is not None and accel.tri_flat.is_cuda \
            and not isinstance(seed, torch.Tensor):
        from potato_tpu_torch.render.bounce_graphs import GraphedStep

        graphed = GraphedStep(tables, accel, seed, features=features,
                              ior_score=ior_score, aovs=aovs)
    tables_grad = any(t.requires_grad for t in tables
                      if isinstance(t, torch.Tensor))

    def wants_grad(state: PathState) -> bool:
        return torch.is_grad_enabled() and (tables_grad or any(
            t.requires_grad for t in tuple(state.rays) + state[1:3]))

    def bounce_step(state: PathState, bounce: int, ray_ids):
        pass_counts.passes += 1
        if graphed is not None and state.radiance.is_cuda \
                and not wants_grad(state):
            out = graphed(state, bounce, ray_ids)
            if out is not None:
                return out
        hit: HitBatch = intersect_fn(tables, state.rays)
        return advance(tables, packed, state, hit, seed, bounce, ray_ids,
                       features=features, ior_score=ior_score,
                       aov_now=aovs and bounce == 0)

    return bounce_step


def advance(tables, packed, state: PathState, hit: HitBatch, seed, bounce,
            ray_ids, features=None, ior_score: bool = False,
            aov_now=False) -> PathState:
    """The rest of a pass once the intersector has answered: shade,
    accumulate emission/background into radiance, draw the scatter
    direction, advance the ray. `seed` is what `rng_kernel.uniforms` takes (a
    python int, a `prng.Key`, a tensor) and `bounce` what it takes: a
    python int, an int64 scalar tensor (a captured graph reads both from
    device buffers) or a (B,) int64 tensor, each lane's own bounce (the
    pool driver, render/wavefront.py).
    aov_now: a bool, whether this pass writes the first-hit AOVs, or a
    (B,) bool mask of the lanes whose first-hit AOVs it writes."""
    b = ray_ids.shape

    # Sanitize miss lanes before shading: their BIG-t positions (~3e38)
    # overflow inside the compute-all-kinds texture/material dispatch
    # (e.g. Perlin's corner dots hit inf - inf); every field of a miss
    # lane is replaced by a harmless constant.
    v1 = hit.valid
    v3 = v1[..., None]
    plus_z = device_constant((0.0, 0.0, 1.0), torch.float32,
                             hit.normal.device)
    hit = hit._replace(
        position=torch.where(v3, hit.position,
                             torch.zeros_like(hit.position)),
        normal=torch.where(v3, hit.normal, plus_z),
        uv=torch.where(v3, hit.uv, torch.zeros_like(hit.uv)),
        t=torch.where(v1, hit.t, torch.ones_like(hit.t)),
    )

    # per-bounce scatter uniforms, keyed (seed, bounce stream, ray id).
    # Two threefry blocks per bounce, in one draw: (u1, u2) from SCATTER_A
    # and (u3, u4) from SCATTER_B; the dielectric Bernoulli draw rides
    # SCATTER_B's second word.
    u1, u2, u3, u4 = rng_kernel.uniforms(
        seed, bounce, (prng.STREAM_SCATTER_A, prng.STREAM_SCATTER_B),
        ray_ids)

    mat = eval_material(tables, hit.material, state.rays.direction, hit,
                        u1, u2, u3, u4, features=features,
                        ior_score=ior_score, packed=packed)

    hit_inf = hits_at_infinity(state.rays.direction)
    # the live lanes that missed read the background (texture counters)
    bg_reads = ~v1 & state.active if features is None \
        or (d.EMIT_SKY_SPHERE in features.emit_kinds
            and counting(features.texture_kinds)) else None
    bg = eval_emit(tables, tables.bg_kind.expand(b),
                   tables.bg_color.expand(b + (3,)),
                   tables.bg_tex.expand(b),
                   state.rays.direction, hit_inf, features=features,
                   reads=bg_reads)

    contrib = torch.where(v3, mat.emit, bg)
    live = state.active[..., None].to(torch.float32)
    radiance = state.radiance + state.throughput * contrib * live

    # AOVs from the first segment only
    if isinstance(aov_now, torch.Tensor):
        aov_normal = torch.where(
            aov_now[..., None],
            torch.where(v3, hit.normal, torch.zeros_like(hit.normal)),
            state.aov_normal)
        aov_hit = torch.where(aov_now, hit.valid, state.aov_hit)
    elif aov_now:
        aov_normal = torch.where(v3, hit.normal,
                                 torch.zeros_like(hit.normal))
        aov_hit = hit.valid
    else:
        aov_normal = state.aov_normal
        aov_hit = state.aov_hit

    throughput = torch.where(
        (state.active & hit.valid)[..., None],
        state.throughput * mat.absorb, state.throughput)
    active = state.active & hit.valid & mat.scatter.valid
    next_rays = bounce_rays(hit.position, mat.scatter.direction, active)
    segments = state.segments + state.active.sum()
    return PathState(next_rays, radiance, throughput, active,
                     aov_normal, aov_hit, segments)


def trace_paths(tables, intersect_fn: Callable, rays: RayBatch, ray_ids,
                max_bounce: int, seed, features=None, live=None,
                ior_score: bool = False, aovs: bool = True) -> TraceResult:
    """Trace a batch of camera rays to completion.

    intersect_fn(tables, rays) -> HitBatch is the acceleration-structure
    entry point (brute force or flash), fixed per compiled scene.

    The loop stops once every lane has retired: skipped bounces would
    contribute exactly zero. That costs one device-to-host read of
    `active.any()` per bounce.

    The same loop serves the differentiable path (diff/optimize.py): eager
    autograd records the bounces that ran, and a skipped bounce, whose
    every lane is masked, would add exactly zero to the radiance and to its
    gradient. So no fixed-depth variant is needed here.

    ior_score: fold the score-function surrogate weight of the dielectric's
    reflect/refract Bernoulli into the throughput (diff/surrogate.py), so
    that d(image)/d(IOR) includes the choice-probability term. Forward
    images are bit-identical (the weight's value is 1).
    """
    ray_ids = ray_ids.to(torch.int64)
    state = init_state(rays, live=live)
    step = make_bounce_step(tables, intersect_fn, seed, features=features,
                            ior_score=ior_score, aovs=aovs)
    bounce = 0
    while bounce < max_bounce and bool(state.active.any()):
        state = step(state, bounce, ray_ids)
        bounce += 1
    return TraceResult(color=state.radiance, aov_normal=state.aov_normal,
                       aov_hit=state.aov_hit, segments=state.segments)
