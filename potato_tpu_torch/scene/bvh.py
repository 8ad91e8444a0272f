"""Acceleration structure: Morton-ordered primitive clusters (two-level).

A per-ray recursive BVH walk is pointer chasing; here the tree is
flattened into two levels shaped for dense tensor ops:

- level 1: C cluster AABBs. A ray batch tests ALL of them at once, a dense
  (B, C) slab test with no traversal state.
- level 2: each cluster holds K spatially coherent primitives (consecutive
  in Morton order, like LBVH leaves). A ray visits its hit clusters front
  to back (sorted by AABB entry t) and intersects each cluster's K
  primitives as one block, stopping when the best hit is closer than the
  next cluster's entry.

The build runs on the host in vectorized numpy.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from potato_tpu_torch.core.types import resolve_device

PRIM_PAD = 0
PRIM_SPHERE = 1
PRIM_TRIANGLE = 2


class ClusterAccel(NamedTuple):
    cluster_min: torch.Tensor  # (C,3) f32
    cluster_max: torch.Tensor  # (C,3) f32
    kind: torch.Tensor         # (C,K) int32
    pa: torch.Tensor           # (C,K,3) sphere center / tri corner a
    pb: torch.Tensor           # (C,K,3) tri corner b (sphere: zeros)
    pc: torch.Tensor           # (C,K,3) tri corner c (sphere: zeros)
    radius: torch.Tensor       # (C,K)   sphere radius (pad/tri: -1)
    na: torch.Tensor           # (C,K,3) tri vertex normals
    nb: torch.Tensor
    nc: torch.Tensor
    ua: torch.Tensor           # (C,K,2) tri vertex uvs
    ub: torch.Tensor
    uc: torch.Tensor
    mat: torch.Tensor          # (C,K) int32

    @property
    def num_clusters(self) -> int:
        return self.cluster_min.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.kind.shape[1]


def morton_codes(points: np.ndarray, lo: np.ndarray,
                 hi: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points quantized to a 1024^3 grid over
    [lo, hi] (vectorized magic-number bit interleave, the LBVH key)."""
    extent = np.maximum(hi - lo, 1e-12)
    q = np.clip(((points - lo) / extent * 1024.0), 0, 1023).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & np.uint32(0x030000FF)
        x = (x | (x << 8)) & np.uint32(0x0300F00F)
        x = (x | (x << 4)) & np.uint32(0x030C30C3)
        x = (x | (x << 2)) & np.uint32(0x09249249)
        return x

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def build_cluster_accel(s_center: np.ndarray, s_radius: np.ndarray,
                        s_material: np.ndarray, tri: Dict[str, np.ndarray],
                        cluster_size: int = 32,
                        device="cuda") -> ClusterAccel:
    """The two-level accel over all spheres + triangles of a scene."""
    device = resolve_device(device)
    ns = s_center.shape[0]
    ntr = tri["pa"].shape[0] if tri["pa"].size else 0
    n = ns + ntr
    if n == 0:
        raise ValueError("empty scene")
    K = int(cluster_size)

    # unified primitive records
    kind = np.concatenate([np.full(ns, PRIM_SPHERE, np.int32),
                           np.full(ntr, PRIM_TRIANGLE, np.int32)])

    def zeros(m, k):
        return np.zeros((m, k), np.float32)

    def corner(key, k):
        return tri[key].reshape(-1, k) if ntr else zeros(0, k)

    pa = np.concatenate([s_center.reshape(-1, 3), corner("pa", 3)])
    pb = np.concatenate([zeros(ns, 3), corner("pb", 3)])
    pc = np.concatenate([zeros(ns, 3), corner("pc", 3)])
    radius = np.concatenate([s_radius.reshape(-1),
                             np.full(ntr, -1.0, np.float32)])
    na = np.concatenate([zeros(ns, 3), corner("na", 3)])
    nb = np.concatenate([zeros(ns, 3), corner("nb", 3)])
    nc = np.concatenate([zeros(ns, 3), corner("nc", 3)])
    ua = np.concatenate([zeros(ns, 2), corner("ua", 2)])
    ub = np.concatenate([zeros(ns, 2), corner("ub", 2)])
    uc = np.concatenate([zeros(ns, 2), corner("uc", 2)])
    mat = np.concatenate([s_material.reshape(-1).astype(np.int32),
                          tri["mat"].reshape(-1).astype(np.int32)[:ntr]])

    # per-primitive AABBs
    r3 = np.abs(radius)[:, None]
    sph_min, sph_max = pa - r3, pa + r3
    tri_min = np.minimum(np.minimum(pa, pb), pc)
    tri_max = np.maximum(np.maximum(pa, pb), pc)
    is_tri = (kind == PRIM_TRIANGLE)[:, None]
    pmin = np.where(is_tri, tri_min, sph_min).astype(np.float32)
    pmax = np.where(is_tri, tri_max, sph_max).astype(np.float32)

    # Morton order on centroids
    centroid = 0.5 * (pmin + pmax)
    order = np.argsort(morton_codes(centroid, centroid.min(0),
                                    centroid.max(0)), kind="stable")

    # pad to a multiple of K with inert primitives
    C = (n + K - 1) // K
    pad = C * K - n

    def pack(a, fill=0.0):
        out = np.concatenate([a[order],
                              np.full((pad,) + a.shape[1:], fill, a.dtype)])
        return out.reshape((C, K) + a.shape[1:])

    packed_kind = pack(kind, PRIM_PAD)
    cl_min = np.concatenate([pmin[order],
                             np.full((pad, 3), np.inf, np.float32)])
    cl_max = np.concatenate([pmax[order],
                             np.full((pad, 3), -np.inf, np.float32)])

    def up(a):
        return torch.tensor(np.ascontiguousarray(a), device=device)

    return ClusterAccel(
        cluster_min=up(cl_min.reshape(C, K, 3).min(axis=1)),
        cluster_max=up(cl_max.reshape(C, K, 3).max(axis=1)),
        kind=up(packed_kind),
        pa=up(pack(pa)), pb=up(pack(pb)), pc=up(pack(pc)),
        radius=up(pack(radius, -1.0)),
        na=up(pack(na)), nb=up(pack(nb)), nc=up(pack(nc)),
        ua=up(pack(ua)), ub=up(pack(ub)), uc=up(pack(uc)),
        mat=up(pack(mat, 0).astype(np.int32)),
    )
