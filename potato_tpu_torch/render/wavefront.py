"""Persistent-pool wavefront renderer with ray regeneration.

The chunked driver (renderer.py) pays every per-bounce cost on all lanes
of a chunk even as lanes retire. This driver keeps one fixed pool of lanes
instead: each iteration intersects and shades the whole pool, retires
finished paths and refills the freed lanes with fresh camera rays, so
iterations run at full occupancy.

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

from potato_tpu_torch.core import rng as prng
from potato_tpu_torch.core.types import (
    BIG,
    RAY_EPSILON,
    RayBatch,
    hits_at_infinity,
    resolve_device,
)
from potato_tpu_torch.ops.material import (
    eval_emit,
    eval_material,
    pack_materials,
)
from potato_tpu_torch.render.camera import generate_rays
from potato_tpu_torch.render.integrator import TraceResult
from potato_tpu_torch.render.renderer import (
    RenderOutput,
    _tiles_apply,
    _to_host,
    check_scene_device,
    make_intersect_fn,
    tile_swizzle_ids,
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
    tiles = _tiles_apply(width, height)
    gens = max(1, -(-total // pool))  # ceil
    T = gens * pool

    def ray_ids_at(rank):
        """rank-th ray in dispatch order -> physical ray id (swizzled)."""
        lin = rank % max(total, 1)
        return tile_swizzle_ids(lin, width, spp) if tiles else lin

    def camera_rays(camera, ids, seed):
        return generate_rays(camera, width, height, spp, ids, seed,
                             lens=features.has_lens)

    def pool_render(tables, camera, seed):
        dev = tables.s_center.device
        packed = pack_materials(tables)   # loop-invariant
        plus_z = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                              device=dev)
        lane = torch.arange(pool, dtype=torch.int64, device=dev)
        f3 = dict(size=(pool, 3), dtype=torch.float32, device=dev)

        active = lane < total
        ray_id = ray_ids_at(lane)
        rays = camera_rays(camera, ray_id, seed)
        rays = rays._replace(t_max=torch.where(
            active, rays.t_max, torch.full_like(rays.t_max, -1.0)))
        gen = torch.zeros(pool, dtype=torch.int64, device=dev)
        bounce = torch.zeros(pool, dtype=torch.int64, device=dev)
        throughput = torch.ones(**f3)
        radiance = torch.zeros(**f3)
        aov_normal = torch.zeros(**f3)
        aov_hit = torch.zeros(pool, dtype=torch.bool, device=dev)
        segments = torch.zeros((), dtype=torch.int64, device=dev)
        buf = torch.zeros((T + pool, 8), dtype=torch.float32, device=dev)
        iterations = 0

        while bool(active.any()):
            iterations += 1
            hit = intersect_fn(tables, rays)
            # miss lanes: every field replaced by a harmless constant, as
            # in integrator.make_bounce_step
            v1 = hit.valid
            v3 = v1[..., None]
            hit = hit._replace(
                position=torch.where(v3, hit.position,
                                     torch.zeros_like(hit.position)),
                normal=torch.where(v3, hit.normal, plus_z),
                uv=torch.where(v3, hit.uv, torch.zeros_like(hit.uv)),
                t=torch.where(v1, hit.t, torch.ones_like(hit.t)),
            )

            # per-lane bounce depth => per-lane salts
            u1, u2 = prng.uniform2(
                seed, prng.bounce_salt(bounce, prng.STREAM_SCATTER_A), ray_id)
            u3, u4 = prng.uniform2(
                seed, prng.bounce_salt(bounce, prng.STREAM_SCATTER_B), ray_id)
            mat = eval_material(tables, hit.material, rays.direction, hit,
                                u1, u2, u3, u4, features=features,
                                packed=packed)
            bg = eval_emit(tables, tables.bg_kind.expand(pool),
                           tables.bg_color.expand(pool, 3),
                           tables.bg_tex.expand(pool), rays.direction,
                           hits_at_infinity(rays.direction),
                           features=features)

            contrib = torch.where(v3, mat.emit, bg)
            radiance = radiance + throughput * contrib \
                * active[..., None].to(torch.float32)
            first = (bounce == 0) & active
            aov_normal = torch.where(
                first[..., None],
                torch.where(v3, hit.normal, torch.zeros_like(hit.normal)),
                aov_normal)
            aov_hit = torch.where(first, v1, aov_hit)
            throughput = torch.where((active & v1)[..., None],
                                     throughput * mat.absorb, throughput)

            # a path still alive after its max_bounce-th segment keeps that
            # segment's emission but scatters no further
            continues = (active & v1 & mat.scatter.valid
                         & (bounce + 1 < max_bounce))
            retired = active & ~continues
            payload = torch.cat(
                [radiance, aov_normal, aov_hit.to(torch.float32)[:, None],
                 torch.zeros((pool, 1), dtype=torch.float32, device=dev)],
                dim=1)
            buf.index_copy_(0, torch.where(retired, gen * pool + lane,
                                           T + lane), payload)

            # refill freed lanes with their next-generation camera ray
            gen2 = gen + 1
            rank2 = gen2 * pool + lane
            fresh = retired & (rank2 < total)
            new_ids = ray_ids_at(rank2)
            cam = camera_rays(camera, new_ids, seed)

            next_active = continues | fresh
            f = fresh[..., None]
            zero3 = torch.zeros(**f3)
            big = torch.full_like(cam.t_max, BIG)
            segments = segments + active.sum()
            rays = RayBatch(
                origin=torch.where(f, cam.origin, torch.where(
                    continues[..., None], hit.position, zero3)),
                direction=torch.where(f, cam.direction,
                                      mat.scatter.direction),
                t_min=torch.full_like(cam.t_max, RAY_EPSILON),
                t_max=torch.where(next_active,
                                  torch.where(fresh, cam.t_max, big),
                                  torch.full_like(big, -1.0)))
            ray_id = torch.where(fresh, new_ids, ray_id)
            gen = torch.where(fresh, gen2, gen)
            bounce = torch.where(fresh, torch.zeros_like(bounce), bounce + 1)
            active = next_active
            throughput = torch.where(f, torch.ones_like(throughput),
                                     throughput)
            radiance = torch.where(f, zero3, radiance)
            aov_normal = torch.where(f, zero3, aov_normal)
            aov_hit = aov_hit & ~fresh

        pool_render.iterations = iterations
        return buf[:T].reshape(gens, pool, 8), segments

    pool_render.iterations = 0
    return pool_render


def render_pool(scene: CompiledScene, width: int, height: int, spp: int = 4,
                max_bounce: int = 8, seed: int = 0,
                pool: int = DEFAULT_POOL, with_aovs: bool = True,
                device="cuda") -> RenderOutput:
    """Full-frame render through the regeneration pool (forward only)."""
    check_scene_device(scene, resolve_device(device))
    total = width * height * spp
    pool = min(pool, max(512, total))
    fn = build_pool_fn(scene, width, height, spp, max_bounce, pool)
    buf, segments = fn(scene.tables, scene.camera, seed)
    rows = buf.reshape(-1, 8)
    out = TraceResult(color=rows[:, 0:3], aov_normal=rows[:, 3:6],
                      aov_hit=rows[:, 6] > 0.5, segments=segments)
    return _to_host(out, width, height, spp, with_aovs)
