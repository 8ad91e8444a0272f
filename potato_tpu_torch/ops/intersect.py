"""Primitive intersection: analytic spheres + Moller-Trumbore triangles.

Batched, branchless intersectors. Every function broadcasts rays (..., 3)
against primitives and returns mask + hit fields; masked lanes carry safe
dummy values. `intersect_brute_force` tests every ray against every
primitive: it is the oracle the flash intersector is held against.
"""

from __future__ import annotations

import torch

from potato_tpu_torch.core import math as pmath
from potato_tpu_torch.core.types import BIG, SMOL, HitBatch, RayBatch


def sphere_hit_t(center, radius, origin, direction, t_min, t_max):
    """Quadratic sphere test: half-b form, closer root first, farther root
    if the closer is out of range. All args broadcast; returns (t, valid)."""
    to_center = origin - center
    a = pmath.norm_squared(direction)
    half_b = pmath.dot(direction, to_center)
    c = pmath.norm_squared(to_center) - radius * radius
    delta = half_b * half_b - a * c
    sphere_ok = delta > 0.0

    sqrt_delta = torch.sqrt(torch.where(sphere_ok, delta,
                                        torch.ones_like(delta)))
    inv_a = 1.0 / a
    t0 = (-half_b - sqrt_delta) * inv_a
    t1 = (-half_b + sqrt_delta) * inv_a
    t0_ok = (t0 >= t_min) & (t0 <= t_max)
    t1_ok = (t1 >= t_min) & (t1 <= t_max)
    t = torch.where(t0_ok, t0, t1)
    valid = sphere_ok & (t0_ok | t1_ok)
    return torch.where(valid, t, torch.full_like(t, BIG)), valid


def sphere_hit_fields(center, radius, t, origin, direction):
    """Position/normal/uv of a sphere hit."""
    position = origin + t[..., None] * direction
    # the r=0 degenerate pad sphere never wins a hit, but must not divide
    safe_r = torch.where(radius == 0.0, torch.ones_like(radius), radius)
    normal = (position - center) / safe_r[..., None]
    uv = pmath.equirect_uv(normal)
    return position, normal, uv


def triangle_hit_t(pa, pb, pc, origin, direction, t_min, t_max):
    """Cramer's-rule Moller-Trumbore: solve [a-b, a-c, d] [u v t]^T = a-o.
    Degenerate dets (< SMOL) miss.

    Returns (t, u, v, valid); barycentric weight of corner a is w = 1-u-v.
    """
    ba = pa - pb
    ca = pa - pc
    pa_o = pa - origin
    d = direction

    ca_x_d = pmath.cross(ca, d)
    det = pmath.dot(ba, ca_x_d)
    det_ok = torch.abs(det) >= SMOL
    inv_det = torch.where(
        det_ok, 1.0 / torch.where(det_ok, det, torch.ones_like(det)),
        torch.zeros_like(det))

    t = pmath.dot(pa_o, pmath.cross(ba, ca)) * inv_det
    u = pmath.dot(pa_o, ca_x_d) * inv_det
    v = pmath.dot(d, pmath.cross(ba, pa_o)) * inv_det
    w = 1.0 - u - v

    valid = (det_ok & (t >= t_min) & (t <= t_max)
             & (u >= 0.0) & (v >= 0.0) & (w >= 0.0))
    return torch.where(valid, t, torch.full_like(t, BIG)), u, v, valid


def triangle_hit_t_watertight(pa, pb, pc, origin, direction, t_min, t_max):
    """Watertight ray/triangle intersection (Woop, Benthin & Wald 2013).

    The ray is transformed to a shear frame where it points down +z; the
    three 2D edge functions U, V, W are then exact up to a common rounding,
    and a ray crossing a shared edge/vertex is accepted by at least one of
    the adjacent triangles. Boundary hits (some edge function exactly 0)
    are accepted when the remaining signs agree.

    Returns (t, u, v, valid) with the barycentric convention of
    `triangle_hit_t`: u weights pb, v weights pc, 1-u-v weights pa.
    """
    pa, pb, pc, origin, d = torch.broadcast_tensors(
        pa, pb, pc, origin, direction)

    # shear-frame axes: kz = largest |d| component; kx, ky cyclic, swapped
    # when d[kz] < 0 to preserve winding
    kz = torch.argmax(torch.abs(d), dim=-1)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3

    def sel(vec, k):
        return torch.gather(vec, -1, k[..., None])[..., 0]

    dz = sel(d, kz)
    swap = dz < 0.0
    kx, ky = torch.where(swap, ky, kx), torch.where(swap, kx, ky)

    safe_dz = torch.where(dz == 0.0, torch.ones_like(dz), dz)
    sx = sel(d, kx) / safe_dz
    sy = sel(d, ky) / safe_dz
    sz = 1.0 / safe_dz

    a = pa - origin
    b = pb - origin
    c = pc - origin
    az, bz, cz = sel(a, kz), sel(b, kz), sel(c, kz)
    ax = sel(a, kx) - sx * az
    ay = sel(a, ky) - sy * az
    bx = sel(b, kx) - sx * bz
    by = sel(b, ky) - sy * bz
    cx = sel(c, kx) - sx * cz
    cy = sel(c, ky) - sy * cz

    # symmetrized 2D edge function: its value under operand swap is the
    # exact floating-point negation, whatever the contraction into FMAs
    def _edge(px, py, qx, qy):
        return 0.5 * ((px * qy - py * qx) - (qx * py - qy * px))

    u_e = _edge(cx, cy, bx, by)
    v_e = _edge(ax, ay, cx, cy)
    w_e = _edge(bx, by, ax, ay)

    det = u_e + v_e + w_e
    same_sign = (((u_e >= 0.0) & (v_e >= 0.0) & (w_e >= 0.0))
                 | ((u_e <= 0.0) & (v_e <= 0.0) & (w_e <= 0.0)))
    det_ok = det != 0.0
    inv_det = torch.where(
        det_ok, 1.0 / torch.where(det_ok, det, torch.ones_like(det)),
        torch.zeros_like(det))

    t_scaled = u_e * (sz * az) + v_e * (sz * bz) + w_e * (sz * cz)
    t = t_scaled * inv_det
    u = v_e * inv_det   # pb weight
    v = w_e * inv_det   # pc weight

    valid = det_ok & same_sign & (t >= t_min) & (t <= t_max)
    return torch.where(valid, t, torch.full_like(t, BIG)), u, v, valid


def triangle_hit_fields(t, u, v, na, nb, nc, ua, ub, uc, origin, direction):
    """Barycentric interpolation of normal/uv. The interpolated normal is
    intentionally NOT renormalized."""
    w = (1.0 - u - v)[..., None]
    position = origin + t[..., None] * direction
    normal = w * na + u[..., None] * nb + v[..., None] * nc
    uv = w[..., :1] * ua + u[..., None] * ub + v[..., None] * uc
    return position, normal, uv


def intersect_brute_force(tables, rays: RayBatch) -> HitBatch:
    """Closest hit over ALL spheres and triangles: dense (B, N) tests.
    Exact, no acceleration; for small scenes and as the correctness oracle
    of the flash intersector."""
    origin = rays.origin[:, None, :]      # (B,1,3)
    direction = rays.direction[:, None, :]
    t_min = rays.t_min[:, None]
    t_max = rays.t_max[:, None]

    # --- spheres: (B, S) ---
    st, s_valid = sphere_hit_t(
        tables.s_center[None, :, :], tables.s_radius[None, :],
        origin, direction, t_min, t_max)
    s_t, s_best = torch.min(st, dim=1)     # invalid lanes already carry BIG
    s_hit = torch.gather(s_valid, 1, s_best[:, None])[:, 0]

    # --- triangles: (B, T) ---
    tt, tu, tv, t_valid = triangle_hit_t(
        tables.tri_pa[None], tables.tri_pb[None], tables.tri_pc[None],
        origin, direction, t_min, t_max)
    tr_t, t_best = torch.min(tt, dim=1)

    def take(a):
        return torch.gather(a, 1, t_best[:, None])[:, 0]

    tr_u, tr_v = take(tu), take(tv)
    tr_hit = take(t_valid)

    sphere_wins = s_hit & (~tr_hit | (s_t <= tr_t))

    # miss lanes carry t = BIG; fields only matter for winners, so clamp
    s_t_safe = torch.where(s_hit, s_t, torch.ones_like(s_t))
    tr_t_safe = torch.where(tr_hit, tr_t, torch.ones_like(tr_t))

    s_pos, s_nrm, s_uv = sphere_hit_fields(
        tables.s_center[s_best], tables.s_radius[s_best], s_t_safe,
        rays.origin, rays.direction)
    s_mat = tables.s_material[s_best]

    t_pos, t_nrm, t_uv = triangle_hit_fields(
        tr_t_safe, tr_u, tr_v,
        tables.tri_na[t_best], tables.tri_nb[t_best], tables.tri_nc[t_best],
        tables.tri_ua[t_best], tables.tri_ub[t_best], tables.tri_uc[t_best],
        rays.origin, rays.direction)
    t_mat = tables.tri_material[t_best]

    sw3 = sphere_wins[:, None]
    return HitBatch(
        t=torch.where(sphere_wins, s_t, tr_t),
        position=torch.where(sw3, s_pos, t_pos),
        normal=torch.where(sw3, s_nrm, t_nrm),
        uv=torch.where(sw3, s_uv, t_uv),
        material=torch.where(sphere_wins, s_mat, t_mat).to(torch.int64),
        valid=s_hit | tr_hit,
    )
