"""Front-to-back traversal of the Morton-cluster acceleration structure
(scene/bvh.py).

1. one dense (B, C) slab test of every ray against every cluster AABB (no
   gathers, no traversal state),
2. per ray, clusters are visited in ascending AABB-entry order (a stable
   sort of the entry distances); each visit intersects the cluster's K
   packed primitives as one (B, K) block,
3. the loop ends when no lane's next cluster entry is closer than its best
   hit: the t_max-shrinking early-out of a BVH walk, at cluster
   granularity and front to back.

The stopping test reads one flag from the device every `CHECK_EVERY`
visits; a visit past the point where every lane is done changes nothing
(no lane takes part in it), so the result does not depend on that period.
"""

from __future__ import annotations

import torch

from potato_tpu_torch.core import math as pmath
from potato_tpu_torch.core.types import BIG, HitBatch, RayBatch
from potato_tpu_torch.ops.intersect import (
    sphere_hit_fields,
    sphere_hit_t,
    triangle_hit_fields,
    triangle_hit_t,
)
from potato_tpu_torch.scene.bvh import (
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    ClusterAccel,
)

CHECK_EVERY = 4   # visits between two host reads of "any lane still live"


def intersect_clustered(accel: ClusterAccel, rays: RayBatch) -> HitBatch:
    """Closest hit for a ray batch via the two-level cluster structure."""
    C = accel.num_clusters
    origin = rays.origin
    direction = rays.direction

    # stage 1: dense slab test against all cluster AABBs -> (B, C)
    boxes_hit, entry = pmath.aabb_entry_t(
        accel.cluster_min[None], accel.cluster_max[None],
        origin[:, None, :], (1.0 / direction)[:, None, :],
        rays.t_min[:, None], rays.t_max[:, None])
    entry = torch.where(boxes_hit, torch.maximum(entry, rays.t_min[:, None]),
                        torch.full_like(entry, BIG))

    # stage 2 schedule: per-ray front-to-back cluster order
    order = torch.sort(entry, dim=1, stable=True)[1]         # (B, C)
    sorted_entry = torch.gather(entry, 1, order)              # ascending

    o = origin[:, None, :]
    dr = direction[:, None, :]
    tmin = rays.t_min[:, None]
    best_t = torch.clamp(rays.t_max, max=BIG)
    zi = torch.zeros_like(rays.t_min, dtype=torch.int64)
    best_c, best_k = zi, zi
    best_u = best_v = torch.zeros_like(rays.t_min)
    best_sphere = found = torch.zeros_like(rays.t_min, dtype=torch.bool)

    for j in range(C):
        entry_j = sorted_entry[:, j]
        # a lane takes part while this cluster could still beat its best
        lane_live = entry_j < best_t
        if j % CHECK_EVERY == 0 and not bool(lane_live.any()):
            break
        cidx = order[:, j]
        tcur = torch.minimum(rays.t_max, best_t)[:, None]

        kind = accel.kind[cidx]                               # (B, K)
        pa = accel.pa[cidx]
        st, s_ok = sphere_hit_t(pa, accel.radius[cidx], o, dr, tmin, tcur)
        s_ok = s_ok & (kind == PRIM_SPHERE)
        tt, tu, tv, t_ok = triangle_hit_t(
            pa, accel.pb[cidx], accel.pc[cidx], o, dr, tmin, tcur)
        t_ok = t_ok & (kind == PRIM_TRIANGLE)

        big = torch.full_like(st, BIG)
        slot_t = torch.where(s_ok, st, torch.where(t_ok, tt, big))  # (B, K)
        cand_t, k_best = torch.min(slot_t, dim=1)

        def take(a):
            return torch.gather(a, 1, k_best[:, None])[:, 0]

        cand_hit = lane_live & (cand_t < best_t)
        best_t = torch.where(cand_hit, cand_t, best_t)
        best_c = torch.where(cand_hit, cidx, best_c)
        best_k = torch.where(cand_hit, k_best, best_k)
        best_u = torch.where(cand_hit, take(tu), best_u)
        best_v = torch.where(cand_hit, take(tv), best_v)
        best_sphere = torch.where(cand_hit, take(s_ok), best_sphere)
        found = found | cand_hit

    # final field assembly: one gather of the winning primitive per lane,
    # t clamped on miss lanes (fields at BIG t overflow)
    t_safe = torch.where(found, best_t, torch.ones_like(best_t))

    def prim(a):
        return a[best_c, best_k]

    s_pos, s_nrm, s_uv = sphere_hit_fields(
        prim(accel.pa), prim(accel.radius), t_safe, origin, direction)
    t_pos, t_nrm, t_uv = triangle_hit_fields(
        t_safe, best_u, best_v,
        prim(accel.na), prim(accel.nb), prim(accel.nc),
        prim(accel.ua), prim(accel.ub), prim(accel.uc),
        origin, direction)

    sphere3 = best_sphere[:, None]
    return HitBatch(
        t=torch.where(found, best_t, torch.full_like(best_t, BIG)),
        position=torch.where(sphere3, s_pos, t_pos),
        normal=torch.where(sphere3, s_nrm, t_nrm),
        uv=torch.where(sphere3, s_uv, t_uv),
        material=prim(accel.mat).to(torch.int64),
        valid=found,
    )
