"""Branchless, differentiable material evaluation (scatter / absorb / emit).

Every variant a scene uses is computed for every lane; the per-lane
material kind selects the result. An absorbed path is a False in the
scatter's valid mask.

Gradient conventions:
- albedo / emission colours and texels: gradients flow linearly.
- Metal fuzziness: reparameterized, the fuzzed direction depends smoothly
  on the parameter (reflect + fuzz * unit ball).
- Dielectric IOR: gradients flow through eta, Schlick reflectance and the
  refracted direction; the reflect-vs-refract Bernoulli *choice* is
  detached (drawn against the detached reflectance). The choice
  probability's own gradient is recovered by the score-function surrogate
  of diff/surrogate.py: pass ior_score=True to eval_material /
  eval_scatter.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from potato_tpu_torch.core import math as pmath
from potato_tpu_torch.core import sampling
from potato_tpu_torch.core.types import HitBatch, device_constant
from potato_tpu_torch.ops.texture import (
    CHECKER_DEPTH,
    counting,
    sample_texture,
)
from potato_tpu_torch.scene import description as d


def _checker_depth(features) -> int:
    """Scene-exact checker unroll depth (compile_scene computes it from the
    texture graph); the default when no feature set is supplied."""
    return getattr(features, "checker_depth", CHECKER_DEPTH) \
        if features is not None else CHECKER_DEPTH


class ScatterSample(NamedTuple):
    direction: torch.Tensor  # (B,3) next bounce direction (dummy when invalid)
    valid: torch.Tensor      # (B,) False = path absorbed
    weight: torch.Tensor = None  # (B,) importance weight, forward value 1.0;
    # carries the score-function gradient of the dielectric's choice
    # (diff/surrogate.py) when ior_score=True


def _used(kinds, k):
    return kinds is None or k in kinds


def _pick(kind, k, value, out):
    return torch.where((kind == k)[..., None], value, out)


def eval_emit(tables, kind, color, tex, ray_direction, hit: HitBatch,
              features=None, kinds=None, reads=None):
    """Emission. `kind/color/tex` are the per-lane gathered emit fields
    (also used for the scene background with broadcast scalars and an
    at-infinity hit).

    `features` (SceneFeatures or None = all) skips variants the scene never
    selects; `kinds` overrides the emit-kind set (the material eval passes
    the material-only set so the background's kind does not pull, e.g., the
    SkySphere atlas gather into every hit lane). `reads` (B,) bool marks
    the lanes that use the emission (default: `hit.valid`), for the
    texture counters."""
    ek = kinds if kinds is not None else (
        features.emit_kinds if features is not None else None)
    tk = features.texture_kinds if features is not None else None

    out = torch.zeros_like(color)                                 # EMIT_NONE
    if _used(ek, d.EMIT_DEBUG_NORMALS):
        out = _pick(kind, d.EMIT_DEBUG_NORMALS, hit.normal, out)
    if _used(ek, d.EMIT_COLOR):
        out = _pick(kind, d.EMIT_COLOR, color, out)
    if _used(ek, d.EMIT_SKY_GRADIENT):
        dir_y = ray_direction[..., 1] / torch.linalg.norm(ray_direction,
                                                          dim=-1)
        t = (0.5 * (dir_y + 1.0))[..., None]
        horizon = torch.ones(3, dtype=color.dtype, device=color.device)
        zenith = device_constant((0.5, 0.7, 1.0), color.dtype, color.device)
        out = _pick(kind, d.EMIT_SKY_GRADIENT,
                    (1.0 - t) * horizon + t * zenith, out)
    if _used(ek, d.EMIT_SKY_SPHERE):
        reads = ((hit.valid if reads is None else reads)
                 & (kind == d.EMIT_SKY_SPHERE)) if counting(tk) else None
        sphere_tex = sample_texture(
            tables, tex, hit.position, hit.uv, depth=_checker_depth(features),
            kinds=tk, reads=reads)
        out = _pick(kind, d.EMIT_SKY_SPHERE, sphere_tex, out)
    return out


def eval_absorb(tables, kind, color, tex, hit: HitBatch, features=None):
    """Absorption tint."""
    ak = features.absorb_kinds if features is not None else None
    tk = features.texture_kinds if features is not None else None
    out = torch.zeros_like(color)                                 # BlackBody
    if _used(ak, d.ABSORB_WHITE_BODY):
        out = _pick(kind, d.ABSORB_WHITE_BODY, torch.ones_like(color), out)
    if _used(ak, d.ABSORB_ALBEDO):
        out = _pick(kind, d.ABSORB_ALBEDO, color, out)
    if _used(ak, d.ABSORB_ALBEDO_MAP):
        reads = hit.valid & (kind == d.ABSORB_ALBEDO_MAP) \
            if counting(tk) else None
        mapped = sample_texture(
            tables, tex, hit.position, hit.uv, depth=_checker_depth(features),
            kinds=tk, reads=reads)
        out = _pick(kind, d.ABSORB_ALBEDO_MAP, mapped, out)
    return out


def eval_scatter(tables, kind, param, ray_direction, hit: HitBatch,
                 u1, u2, u3, u4, features=None,
                 ior_score: bool = False) -> ScatterSample:
    """Scatter sampling.

    u1..u3: uniforms for the sphere/ball sample; u4: the dielectric's
    reflect-vs-refract Bernoulli draw. All (B,).

    ior_score: attach the score-function surrogate weight of the
    dielectric's Bernoulli choice (diff/surrogate.py), so that d/d(IOR)
    also sees the choice-probability term. Forward values are unchanged.
    """
    sk = features.scatter_kinds if features is not None else None
    normal = hit.normal
    cos_in = pmath.dot(normal, ray_direction)
    backface = cos_in > 0.0

    out = torch.zeros_like(ray_direction)
    out[..., 2] = 1.0   # inert dummy for SCATTER_NONE lanes
    valid = torch.zeros_like(backface)
    weight = torch.ones_like(u1)

    if _used(sk, d.SCATTER_LAMBERT):
        # normal + unit sphere, backface culled
        sphere = sampling.unit_sphere(u1, u2)
        lambert_dir = pmath.safe_normalize(normal + sphere)
        out = _pick(kind, d.SCATTER_LAMBERT, lambert_dir, out)
        valid = torch.where(kind == d.SCATTER_LAMBERT, ~backface, valid)

    if _used(sk, d.SCATTER_METAL):
        # reflect + fuzz * unit ball; cull if the fuzz pushed the ray below
        # the surface
        reflected = pmath.reflect(ray_direction, normal)
        ball = sampling.unit_ball(u1, u2, u3)
        metal_dir = pmath.safe_normalize(reflected + param[..., None] * ball)
        metal_valid = ~backface & (pmath.dot(normal, metal_dir) >= 0.0)
        out = _pick(kind, d.SCATTER_METAL, metal_dir, out)
        valid = torch.where(kind == d.SCATTER_METAL, metal_valid, valid)

    if _used(sk, d.SCATTER_DIELECTRIC):
        # interior flip, Schlick, Bernoulli reflect-vs-refract, total
        # internal reflection falls back to reflect
        interior = backface
        n = torch.where(interior[..., None], -normal, normal)
        eta = torch.where(interior, param,
                          1.0 / torch.clamp(param, min=1e-8))
        reflectance = pmath.schlick_reflectance(
            pmath.dot(n, ray_direction), eta)
        refracted, refract_ok = pmath.refract(ray_direction, n, eta)
        reflect_n = pmath.reflect(ray_direction, n)
        choose_reflect = sampling.bernoulli(u4, reflectance.detach())
        dielectric_dir = torch.where(
            (choose_reflect | ~refract_ok)[..., None], reflect_n, refracted)
        out = _pick(kind, d.SCATTER_DIELECTRIC, dielectric_dir, out)
        valid = torch.where(kind == d.SCATTER_DIELECTRIC,
                            torch.ones_like(backface), valid)
        if ior_score:
            from potato_tpu_torch.diff.surrogate import score_weight

            # total internal reflection reflects with probability 1: no score
            chose = choose_reflect | ~refract_ok
            prob = torch.where(refract_ok, reflectance,
                               torch.ones_like(reflectance))
            weight = torch.where(kind == d.SCATTER_DIELECTRIC,
                                 score_weight(prob, chose), weight)

    return ScatterSample(direction=out, valid=valid, weight=weight)


class MaterialOutput(NamedTuple):
    """Per-lane material evaluation."""

    scatter: ScatterSample
    absorb: torch.Tensor  # (B,3)
    emit: torch.Tensor    # (B,3)


def pack_materials(tables) -> torch.Tensor:
    """The (M, 12) packed material record: one row gather per lane fetches
    all twelve fields. Kind codes and texture ids are small integers, exact
    in float32. Loop-invariant: callers in a bounce loop build it once."""
    f32 = torch.float32
    return torch.stack([
        tables.m_scatter_kind.to(f32),
        tables.m_scatter_param,
        tables.m_absorb_kind.to(f32),
        tables.m_absorb_color[:, 0], tables.m_absorb_color[:, 1],
        tables.m_absorb_color[:, 2],
        tables.m_absorb_tex.to(f32),
        tables.m_emit_kind.to(f32),
        tables.m_emit_color[:, 0], tables.m_emit_color[:, 1],
        tables.m_emit_color[:, 2],
        tables.m_emit_tex.to(f32),
    ], dim=1)


def eval_material(tables, material_id, ray_direction, hit: HitBatch,
                  u1, u2, u3, u4, features=None,
                  ior_score: bool = False, packed=None) -> MaterialOutput:
    """Gather the per-lane material record and evaluate all three
    functions. `packed` is `pack_materials(tables)` if the caller kept it.

    Material ids are clamped to the table (miss lanes carry arbitrary ids),
    so an invalid id reads the clamped row.

    With ior_score=True the dielectric Bernoulli's score-function weight
    (forward value exactly 1) is folded into `absorb`, so the integrator's
    `throughput *= absorb` picks up the choice-probability gradient."""
    if packed is None:
        packed = pack_materials(tables)
    gm = packed[material_id.long().clamp(0, packed.shape[0] - 1)]  # (B, 12)
    s_kind = gm[:, 0].long()
    s_param = gm[:, 1]
    a_kind = gm[:, 2].long()
    a_color = gm[:, 3:6]
    a_tex = gm[:, 6].long()
    e_kind = gm[:, 7].long()
    e_color = gm[:, 8:11]
    e_tex = gm[:, 11].long()

    scatter = eval_scatter(
        tables, s_kind, s_param, ray_direction, hit, u1, u2, u3, u4,
        features=features, ior_score=ior_score)
    absorb = eval_absorb(
        tables, a_kind, a_color, a_tex, hit, features=features)
    emit = eval_emit(
        tables, e_kind, e_color, e_tex, ray_direction, hit,
        features=features,
        kinds=(getattr(features, "material_emit_kinds", None)
               if features is not None else None))
    if ior_score:
        absorb = absorb * scatter.weight[..., None]
    return MaterialOutput(scatter=scatter, absorb=absorb, emit=emit)
