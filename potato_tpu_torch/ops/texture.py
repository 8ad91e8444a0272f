"""Branchless texture sampling over the flat texture tables.

The texture enum becomes compute-all-kinds + select-by-kind; the checker's
recursion becomes a static unroll, as deep as the scene's longest checker
chain (`SceneFeatures.checker_depth`).

Every per-lane record is a plain gather. Texture ids are clamped to the
table before each gather, so an invalid id reads the clamped (first or
last) row; torch indexing would otherwise raise or wrap.
"""

from __future__ import annotations

import torch

from potato_tpu_torch.core import noise
from potato_tpu_torch.scene import description as d

# Static recursion depth for Checker children when no feature set says
# better: checker -> (solid | perlin) needs 1; 2 leaves headroom.
CHECKER_DEPTH = 2


def _clamp_ids(ids, n):
    return ids.long().clamp(0, n - 1)


def sample_image(tables, tex_id, uv):
    """Nearest-neighbour, clamped image lookup. Texels live in the shared
    atlas; (offset, width, height) per texture."""
    meta = tables.t_image[_clamp_ids(tex_id, tables.t_image.shape[0])].long()
    w = meta[..., 1].to(uv.dtype)
    h = meta[..., 2].to(uv.dtype)
    # the float -> int casts truncate toward zero; the operands are >= 0
    i = torch.minimum(torch.clamp(uv[..., 0] * w, min=0.0), w - 1.0).long()
    j = torch.minimum(torch.clamp(uv[..., 1] * h, min=0.0), h - 1.0).long()
    flat = meta[..., 0] + j * meta[..., 1] + i
    return tables.atlas[flat.clamp(0, tables.atlas.shape[0] - 1)]   # (B,3)


def sample_texture(tables, tex_id, position, uv, depth: int = CHECKER_DEPTH,
                   kinds=None):
    """Sample per-lane texture ids: tex_id (B,), position (B,3), uv (B,2)
    -> (B,3) linear color.

    `kinds` (a frozenset of TEX_* constants, or None = all) names the
    texture kinds present in the scene: variants outside it are skipped.
    """
    def used(k):
        return kinds is None or k in kinds

    tid = _clamp_ids(tex_id, tables.t_kind.shape[0])
    kind = tables.t_kind[tid]
    color = tables.t_color[tid]

    def pick(k, value, out):
        return torch.where((kind == k)[..., None], value, out)

    out = torch.zeros_like(color)                       # TEX_MISSING -> black
    if used(d.TEX_DEBUG_UVS):
        debug_uvs = torch.stack(
            [uv[..., 0], uv[..., 1], torch.zeros_like(uv[..., 0])], dim=-1)
        out = pick(d.TEX_DEBUG_UVS, debug_uvs, out)
    if used(d.TEX_SOLID):
        out = pick(d.TEX_SOLID, color, out)
    if used(d.TEX_IMAGE):
        out = pick(d.TEX_IMAGE, sample_image(tables, tid, uv), out)
    if used(d.TEX_CHECKER) and depth > 0:
        # checker parity: even iff floor(x)+floor(y)+floor(z) is an even
        # integer (remainder is the floor-mod, so negatives work)
        children = tables.t_children[tid]
        fsum = torch.sum(torch.floor(position), dim=-1)
        even = torch.remainder(fsum, 2.0) == 0.0
        child = torch.where(even, children[..., 1], children[..., 0])
        checker = sample_texture(tables, child, position, uv, depth - 1,
                                 kinds)
        out = pick(d.TEX_CHECKER, checker, out)
    if used(d.TEX_NOISE):
        nval = noise.value_noise(position, tables.t_seed[tid])
        out = pick(d.TEX_NOISE, nval[..., None].expand_as(out), out)
    if used(d.TEX_PERLIN):
        pval = noise.perlin(position, tables.t_seed[tid])
        out = pick(d.TEX_PERLIN, pval[..., None].expand_as(out), out)
    return out
