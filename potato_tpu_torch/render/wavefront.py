"""Persistent-pool wavefront renderer with ray regeneration.

The chunked driver (renderer.py) pays every per-bounce cost on all lanes
of a chunk even as lanes retire. This driver keeps one fixed pool of lanes
instead: each iteration intersects and shades the whole pool (through
integrator.advance, the other drivers' bounce transition, with each lane's
own bounce), retires finished paths and refills the freed lanes with fresh
camera rays, so iterations run at full occupancy.

Ray-to-lane dispatch is strided: lane s takes the rays of dispatch rank
g * pool + s for generations g = 0, 1, ...; rank r is the r-th ray of the
tile-swizzled order (the chunked driver's traversal order), so a
freed block of lanes is refilled with a fresh, spatially coherent tile.
A retiring lane banks its result with one scatter to its rank, into
an output of T + pool rows (T = generations x pool); a lane that does not
retire writes to row T + lane, so every index is distinct and in range.

Determinism: every lane carries its (ray id, bounce depth) and all
randomness is a pure function of (seed, bounce, ray id), and the
intersector returns each ray's nearest hit whatever rays share its block,
so the image is bit-identical to the chunked driver's
(tests/test_torch_accels.py). Forward only; it does not change the
default driver.
"""

from __future__ import annotations

import torch

from potato_tpu_torch.core.types import resolve_device
from potato_tpu_torch.ops.material import pack_materials
from potato_tpu_torch.render.camera import generate_rays, traversal_ray_ids
from potato_tpu_torch.render.integrator import (
    PathState,
    TraceResult,
    advance,
    bounce_rays,
    init_state,
)
from potato_tpu_torch.render.renderer import (
    _to_host,
    check_scene_device,
    make_intersect_fn,
)
from potato_tpu_torch.scene.tables import CompiledScene

DEFAULT_POOL = 1 << 18


def build_pool_fn(scene: CompiledScene, width: int, height: int, spp: int,
                  max_bounce: int, pool: int = DEFAULT_POOL):
    """Returns f(tables, camera, seed) -> (buf (G, pool, 8), segments):
    buf rows in dispatch-rank order hold [radiance(3), aov_normal(3),
    aov_hit(1), pad]. After each call `f.iterations` is the number of
    pool iterations it took."""
    intersect_fn = make_intersect_fn(scene)
    features = scene.features
    total = width * height * spp
    gens = max(1, -(-total // pool))  # ceil
    T = gens * pool

    def camera_rays(camera, ranks, seed):
        """The camera rays of dispatch ranks and their ray ids."""
        ids = traversal_ray_ids(ranks, width, height, spp)
        return generate_rays(camera, width, height, spp, ids, seed,
                             lens=features.has_lens), ids

    def pool_render(tables, camera, seed):
        dev = tables.s_center.device
        packed = pack_materials(tables)   # loop-invariant
        lane = torch.arange(pool, dtype=torch.int64, device=dev)
        rays, ray_id = camera_rays(camera, lane, seed)
        state = init_state(rays, live=lane < total)
        gen = torch.zeros(pool, dtype=torch.int64, device=dev)
        bounce = torch.zeros(pool, dtype=torch.int64, device=dev)
        buf = torch.zeros((T + pool, 8), dtype=torch.float32, device=dev)
        iterations = 0

        while bool(state.active.any()):
            iterations += 1
            active = state.active
            nxt = advance(tables, packed, state,
                          intersect_fn(tables, state.rays), seed, bounce,
                          ray_id, features=features,
                          aov_now=(bounce == 0) & active)
            # a path still alive after its max_bounce-th segment keeps that
            # segment's emission but scatters no further
            continues = nxt.active & (bounce + 1 < max_bounce)
            retired = active & ~continues
            payload = torch.cat(
                [nxt.radiance, nxt.aov_normal,
                 nxt.aov_hit.to(torch.float32)[:, None],
                 torch.zeros((pool, 1), dtype=torch.float32, device=dev)],
                dim=1)
            buf.index_copy_(0, torch.where(retired, gen * pool + lane,
                                           T + lane), payload)

            # refill freed lanes with their next-generation camera ray
            gen2 = gen + 1
            rank2 = gen2 * pool + lane
            fresh = retired & (rank2 < total)
            cam, new_ids = camera_rays(camera, rank2, seed)
            f = fresh[..., None]
            zero3 = torch.zeros_like(nxt.radiance)
            state = PathState(
                rays=bounce_rays(
                    torch.where(f, cam.origin, nxt.rays.origin),
                    torch.where(f, cam.direction, nxt.rays.direction),
                    continues | fresh),
                radiance=torch.where(f, zero3, nxt.radiance),
                throughput=torch.where(f, torch.ones_like(nxt.throughput),
                                       nxt.throughput),
                active=continues | fresh,
                aov_normal=torch.where(f, zero3, nxt.aov_normal),
                aov_hit=nxt.aov_hit & ~fresh,
                segments=nxt.segments)
            ray_id = torch.where(fresh, new_ids, ray_id)
            gen = torch.where(fresh, gen2, gen)
            bounce = torch.where(fresh, torch.zeros_like(bounce), bounce + 1)

        pool_render.iterations = iterations
        return buf[:T].reshape(gens, pool, 8), state.segments

    pool_render.iterations = 0
    return pool_render


def render_pool(scene: CompiledScene, width: int, height: int, spp: int = 4,
                max_bounce: int = 8, seed: int = 0,
                pool: int = DEFAULT_POOL, with_aovs: bool = True,
                device="cuda"):
    """Full-frame render through the regeneration pool (forward only): a
    renderer.RenderOutput."""
    check_scene_device(scene, resolve_device(device))
    total = width * height * spp
    pool = min(pool, max(512, total))
    fn = build_pool_fn(scene, width, height, spp, max_bounce, pool)
    buf, segments = fn(scene.tables, scene.camera, seed)
    rows = buf.reshape(-1, 8)
    out = TraceResult(color=rows[:, 0:3], aov_normal=rows[:, 3:6],
                      aov_hit=rows[:, 6] > 0.5, segments=segments)
    return _to_host(out, width, height, spp, with_aovs)
