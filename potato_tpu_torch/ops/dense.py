"""Dense intersector: all rays x all primitives as one matrix product.

Cramer's-rule Moller-Trumbore is bilinear in (ray features) x (triangle
features): with per-ray features r = [d, o, d x o] (9 values) and
precomputed per-triangle weights

    det   = d . n                (n = ba x ca)
    o.n   = o . n
    u_num = d . (a x ca) - (d x o) . ca
    v_num = d . (ba x a) + (d x o) . ba
    t_num = (a . n) - o.n

every pair quantity comes out of one (B, 9) x (9, 4T) product, followed by
a handful of elementwise ops (divide, range checks, argmin). Sphere
quadratics decompose the same way with features [d, o, |o|^2, 1].

The products run in full float32: on the card they refuse to run while
PyTorch allows TF32 for float32 matrix products (10 mantissa bits would
move hit points by ~1e-3 of their distance). Triangle and sphere weights
are padded to a multiple of 128 primitives (zero weights: det 0, never
valid; zero-radius spheres never pass delta > 0).

Semantics are those of ops/intersect.py's brute force: same root
selection, same SMOL det cutoff, same closest-hit resolution.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from potato_tpu_torch.core import math as pmath
from potato_tpu_torch.core.types import BIG, SMOL, HitBatch, RayBatch
from potato_tpu_torch.ops.intersect import (
    sphere_hit_fields,
    triangle_hit_fields,
)

BLOCK_RAYS = 4096   # rays per product; bounds the (B, Tp, 4) intermediate


class DenseAccel(NamedTuple):
    """Product weights (host-built, device-resident)."""

    # triangles
    tri_weights: torch.Tensor  # (9, Tp, 4) f32: det / o.n / u_num / v_num
    tri_tnum0: torch.Tensor    # (Tp,) f32: a . n
    num_triangles: int         # un-padded count
    # spheres
    sph_weights: torch.Tensor  # (8, Sp, 2) f32: half_b terms / c terms
    num_spheres: int


def _pad_axis(a: np.ndarray, axis: int, multiple: int) -> np.ndarray:
    n = a.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return a
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, target - n)
    return np.pad(a, pad)


def build_dense_accel(tables, num_spheres: int, num_triangles: int,
                      pad_to: int = 128, device="cpu") -> DenseAccel:
    """Product weight tables from the compiled scene's numpy tables,
    computed in float64 and stored in float32."""
    pa = np.asarray(tables.tri_pa, np.float64)
    pb = np.asarray(tables.tri_pb, np.float64)
    pc = np.asarray(tables.tri_pc, np.float64)
    ba = pa - pb
    ca = pa - pc
    n = np.cross(ba, ca)                 # (T,3)
    a_x_ca = np.cross(pa, ca)
    ba_x_a = np.cross(ba, pa)

    # rows: d (0:3), o (3:6), m = d x o (6:9)
    w = np.zeros((9, pa.shape[0], 4), np.float64)
    w[0:3, :, 0] = n.T                   # det   = d.n
    w[3:6, :, 1] = n.T                   # o.n
    w[0:3, :, 2] = a_x_ca.T              # u_num = d.(a x ca) - m.ca
    w[6:9, :, 2] = -ca.T
    w[0:3, :, 3] = ba_x_a.T              # v_num = d.(ba x a) + m.ba
    w[6:9, :, 3] = ba.T
    tnum0 = np.einsum("td,td->t", pa, n)

    w = _pad_axis(w.astype(np.float32), 1, pad_to)
    tnum0 = _pad_axis(tnum0.astype(np.float32), 0, pad_to)

    # spheres: half_b = d.o - d.c ; c_term = |o|^2 - 2 o.c + (|c|^2 - r^2)
    # ray features [d (0:3), o (3:6), |o|^2 (6), 1 (7)]. A radius-0 pad
    # sphere gets c_term = |o - c|^2 >= 0, so delta <= 0: never a hit.
    c = np.asarray(tables.s_center, np.float64)
    r = np.asarray(tables.s_radius, np.float64)
    ws = np.zeros((8, c.shape[0], 2), np.float64)
    ws[0:3, :, 0] = -c.T                 # half_b product part: -d.c
    ws[3:6, :, 1] = -2.0 * c.T           # c_term: -2 o.c
    ws[7, :, 1] = np.einsum("sd,sd->s", c, c) - r * r
    ws = _pad_axis(ws.astype(np.float32), 1, pad_to)

    def up(a):
        return torch.tensor(a, device=device).contiguous()

    return DenseAccel(tri_weights=up(w), tri_tnum0=up(tnum0),
                      num_triangles=num_triangles, sph_weights=up(ws),
                      num_spheres=num_spheres)


def _tf32_allowed() -> bool:
    """Whether PyTorch may run float32 matrix products on the card in
    TF32 (either switch, old or new)."""
    matmul = torch.backends.cuda.matmul
    return bool(matmul.allow_tf32
                or torch.get_float32_matmul_precision() != "highest"
                or getattr(matmul, "fp32_precision", "none") == "tf32")


def _product(feat, weights):
    """(B, F) x (F, P, k) -> (B, P, k) in full float32."""
    if feat.is_cuda and _tf32_allowed():
        raise RuntimeError(
            "intersect_dense: float32 matrix products may run in TF32 "
            "(torch.backends.cuda.matmul.allow_tf32 or "
            "torch.set_float32_matmul_precision); the ray-primitive "
            "products need full float32. Turn TF32 off for this call.")
    f, p, k = weights.shape
    return torch.matmul(feat, weights.reshape(f, p * k)).reshape(-1, p, k)


def intersect_dense(accel: DenseAccel, tables, rays: RayBatch,
                    block_rays: int = BLOCK_RAYS) -> HitBatch:
    """Closest hit over all primitives via matrix products, `block_rays`
    rays at a time (the (block, Tp, 4) product is the big intermediate)."""
    b = rays.origin.shape[0]
    if b <= block_rays:
        return _intersect_dense_block(accel, tables, rays)
    parts = [_intersect_dense_block(
        accel, tables, RayBatch(*(f[s:s + block_rays] for f in rays)))
        for s in range(0, b, block_rays)]
    return HitBatch(*(torch.cat(f) for f in zip(*parts)))


def _intersect_dense_block(accel: DenseAccel, tables,
                           rays: RayBatch) -> HitBatch:
    o = rays.origin
    d = rays.direction
    m = torch.linalg.cross(d, o, dim=-1)
    t_min = rays.t_min[:, None]
    t_max = rays.t_max[:, None]

    # ---------------- triangles ----------------
    out = _product(torch.cat([d, o, m], dim=-1), accel.tri_weights)
    det = out[..., 0]
    t_num = accel.tri_tnum0[None, :] - out[..., 1]
    u_num = out[..., 2]
    v_num = out[..., 3]

    det_ok = torch.abs(det) >= SMOL
    inv_det = det_ok.to(det.dtype) / torch.where(det_ok, det,
                                                 torch.ones_like(det))
    tt = t_num * inv_det
    tu = u_num * inv_det
    tv = v_num * inv_det
    t_valid = (det_ok & (tt >= t_min) & (tt <= t_max)
               & (tu >= 0.0) & (tv >= 0.0) & (tu + tv <= 1.0))

    tri_key = torch.where(t_valid, tt, torch.full_like(tt, BIG))
    tr_t, t_best = torch.min(tri_key, dim=1)

    def take(a):
        return torch.gather(a, 1, t_best[:, None])[:, 0]

    tr_u, tr_v, tr_hit = take(tu), take(tv), take(t_valid)

    # ---------------- spheres ----------------
    o2 = torch.sum(o * o, dim=-1, keepdim=True)                 # (B,1)
    sout = _product(torch.cat([d, o, o2, torch.ones_like(o2)], dim=-1),
                    accel.sph_weights)                           # (B, Sp, 2)
    d_dot_o = torch.sum(d * o, dim=-1, keepdim=True)
    a_coef = torch.sum(d * d, dim=-1, keepdim=True)
    half_b = d_dot_o + sout[..., 0]
    c_coef = o2 + sout[..., 1]
    delta = half_b * half_b - a_coef * c_coef
    sph_ok = delta > 0.0
    sqrt_delta = pmath.sqrt(torch.where(sph_ok, delta,
                                         torch.ones_like(delta)))
    inv_a = 1.0 / a_coef
    t0 = (-half_b - sqrt_delta) * inv_a
    t1 = (-half_b + sqrt_delta) * inv_a
    t0_ok = (t0 >= t_min) & (t0 <= t_max)
    t1_ok = (t1 >= t_min) & (t1 <= t_max)
    st = torch.where(t0_ok, t0, t1)
    s_valid = sph_ok & (t0_ok | t1_ok)

    sph_key = torch.where(s_valid, st, torch.full_like(st, BIG))
    s_t, s_best = torch.min(sph_key, dim=1)
    s_hit = torch.gather(s_valid, 1, s_best[:, None])[:, 0]

    # ---------------- resolve winner + fields ----------------
    # (pad rows are never valid, so the winning index is a real primitive
    # wherever it matters; clamp it for the gathers of miss lanes)
    s_idx = s_best.clamp(max=tables.s_center.shape[0] - 1)
    t_idx = t_best.clamp(max=tables.tri_pa.shape[0] - 1)
    sphere_wins = s_hit & (~tr_hit | (s_t <= tr_t))
    one = torch.ones_like(s_t)
    s_t_safe = torch.where(s_hit, s_t, one)
    tr_t_safe = torch.where(tr_hit, tr_t, one)

    s_pos, s_nrm, s_uv = sphere_hit_fields(
        tables.s_center[s_idx], tables.s_radius[s_idx], s_t_safe, o, d)
    s_mat = tables.s_material[s_idx]
    t_pos, t_nrm, t_uv = triangle_hit_fields(
        tr_t_safe, tr_u, tr_v,
        tables.tri_na[t_idx], tables.tri_nb[t_idx], tables.tri_nc[t_idx],
        tables.tri_ua[t_idx], tables.tri_ub[t_idx], tables.tri_uc[t_idx],
        o, d)
    t_mat = tables.tri_material[t_idx]

    sw3 = sphere_wins[:, None]
    return HitBatch(
        t=torch.where(sphere_wins, s_t, tr_t),
        position=torch.where(sw3, s_pos, t_pos),
        normal=torch.where(sw3, s_nrm, t_nrm),
        uv=torch.where(sw3, s_uv, t_uv),
        material=torch.where(sphere_wins, s_mat, t_mat).to(torch.int64),
        valid=s_hit | tr_hit,
    )
