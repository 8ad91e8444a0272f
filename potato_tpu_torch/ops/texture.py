"""Branchless texture sampling over the flat texture tables.

The texture enum becomes compute-all-kinds + select-by-kind; the checker's
recursion becomes a static unroll, as deep as the scene's longest checker
chain (`SceneFeatures.checker_depth`).

Every per-lane record is a plain gather. Texture ids are clamped to the
table before each gather, so an invalid id reads the clamped (first or
last) row; torch indexing would otherwise raise or wrap.

`texture_counts` counts, for the Perlin, value-noise and image samplers,
the lanes whose material read their result.
"""

from __future__ import annotations

import torch

from potato_tpu_torch.core import noise
from potato_tpu_torch.scene import description as d

# Static recursion depth for Checker children when no feature set says
# better: checker -> (solid | perlin) needs 1; 2 leaves headroom.
CHECKER_DEPTH = 2


# the samplers `texture_counts` follows, in the order of its counts
COUNTED = (d.TEX_PERLIN, d.TEX_NOISE, d.TEX_IMAGE)
COUNTED_NAMES = ("perlin", "noise", "image")
_N_KINDS = max(d.TEX_MISSING, d.TEX_DEBUG_UVS, d.TEX_SOLID, d.TEX_IMAGE,
               d.TEX_CHECKER, d.TEX_NOISE, d.TEX_PERLIN) + 1


def counting(kinds) -> bool:
    """Whether `texture_counts` follows a sampler call over the texture
    kinds `kinds` (None = all): only where a counted sampler runs."""
    return kinds is None or any(k in kinds for k in COUNTED)


class TextureCounts:
    """Program counter of the Perlin, value-noise and image samplers.

    `hits`: the lanes whose material (or background) read each kind, an
    int64 tensor on each device, one slot a texture kind, added to inside
    the pass by one `index_add_` a sampler call (so a graph replay adds to
    it as the eager pass does), and read on the host only by `hits_since`,
    which syncs. `kinds_run`: the counted kinds a sampler call has run,
    kept on the host. Compute-all-kinds runs each of them on every lane a
    call is handed, so the lanes they ran on are those lanes times
    `len(kinds_run)`; shading samples once a lane the intersector handed
    on (ops/flash.py::intersect_flash.lanes), and once more where the
    background is a textured sky sphere. Nothing is counted where the
    scene's feature set has no counted kind."""

    def __init__(self):
        self.kinds_run = set()
        self._hits = {}

    def hits_on(self, device) -> torch.Tensor:
        """The device's accumulator, made on first use: make it before a
        graph capture, which would otherwise capture its zeroing."""
        device = torch.device(device)
        acc = self._hits.get(device)
        if acc is None:
            acc = self._hits[device] = torch.zeros(
                (_N_KINDS,), dtype=torch.int64, device=device)
        return acc

    def hits_clone(self) -> dict:
        """A copy of every device's accumulator, made on the device (no
        sync): what `hits_since` subtracts."""
        return {dev: acc.clone() for dev, acc in self._hits.items()}

    def hits_since(self, before: dict):
        """The hits added since `before` (`hits_clone`) to each counted
        kind, in the order of COUNTED, summed over the devices, as python
        ints: one device-to-host read each."""
        total = [0] * len(COUNTED)
        for dev, acc in self._hits.items():
            diff = acc - before[dev] if dev in before else acc
            for i, n in enumerate(diff[list(COUNTED)].tolist()):
                total[i] += n
        return tuple(total)

    def count(self, kind, reads, kinds):
        """One sampler call on lanes of texture kind `kind`: the lanes
        where `reads` (bool, or None: nothing counted) go to their kind's
        slot."""
        if reads is None or not counting(kinds):
            return
        self.kinds_run.update(k for k in COUNTED
                              if kinds is None or k in kinds)
        self.hits_on(kind.device).index_add_(0, kind, reads.to(torch.int64))


texture_counts = TextureCounts()


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
                   kinds=None, reads=None):
    """Sample per-lane texture ids: tex_id (B,), position (B,3), uv (B,2)
    -> (B,3) linear color.

    `kinds` (a frozenset of TEX_* constants, or None = all) names the
    texture kinds present in the scene: variants outside it are skipped.
    `reads` (B,) bool, if given, marks the lanes whose caller uses the
    result: `texture_counts` counts them as hits. Callers pass it only
    where `counting(kinds)`.
    """
    def used(k):
        return kinds is None or k in kinds

    tid = _clamp_ids(tex_id, tables.t_kind.shape[0])
    kind = tables.t_kind[tid]
    color = tables.t_color[tid]
    texture_counts.count(kind, reads, kinds)

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
        checker = sample_texture(
            tables, child, position, uv, depth - 1, kinds,
            None if reads is None else reads & (kind == d.TEX_CHECKER))
        out = pick(d.TEX_CHECKER, checker, out)
    if used(d.TEX_NOISE):
        nval = noise.value_noise(position, tables.t_seed[tid])
        out = pick(d.TEX_NOISE, nval[..., None].expand_as(out), out)
    if used(d.TEX_PERLIN):
        pval = noise.perlin(position, tables.t_seed[tid])
        out = pick(d.TEX_PERLIN, pval[..., None].expand_as(out), out)
    return out
