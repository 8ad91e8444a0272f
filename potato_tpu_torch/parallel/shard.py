"""Sharded rendering and sharded differentiable training over a ray group.

Counterpart of potato_tpu/parallel/shard.py, with the algorithm of its
shard_map written out. Every rank is called with the same global ray ids
and takes its contiguous share (`share`); the scene tables and camera are
replicated (each rank builds its scene from the same description). Each
rank traces its share in chunks of at most `renderer.DEFAULT_CHUNK` rays,
which bounds the memory of the flash queue build and of autograd's graph;
every ray's randomness is a pure function of (seed, global id), so the
chunks and the number of ranks never change a ray's result.

Collectives: the render sums `segments` and gathers the per-ray outputs in
id order, so every rank holds the global TraceResult; the training step
sums the gradient and the loss, once each a step.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch
import torch.distributed as dist

from potato_tpu_torch.diff.optimize import chunked_value_and_grad
from potato_tpu_torch.parallel.mesh import RayGroup
from potato_tpu_torch.render.integrator import TraceResult
from potato_tpu_torch.render.renderer import (
    DEFAULT_CHUNK,
    make_intersect_fn,
    render_chunk,
)
from potato_tpu_torch.scene.tables import CompiledScene


def share(x: torch.Tensor, group: RayGroup) -> torch.Tensor:
    """This rank's contiguous share of the leading axis of `x`, which must
    divide by the world size (the reference's sharding rule)."""
    n = x.shape[0]
    if n % group.world_size:
        raise ValueError(f"length {n} does not divide by the world size "
                         f"{group.world_size}")
    per = n // group.world_size
    return x[group.rank * per:(group.rank + 1) * per]


def all_reduce_sum(t: torch.Tensor, group: RayGroup) -> torch.Tensor:
    """Sum `t` over the ranks, in place; returns it."""
    if group.process_group is not None:
        dist.all_reduce(t, group=group.process_group)
    return t


def all_gather_rows(t: torch.Tensor, group: RayGroup) -> torch.Tensor:
    """The ranks' `t` concatenated along the leading axis in rank order.
    Both backends take the tensor where it lies, CUDA tensors under gloo
    included; a bool tensor travels as its bytes."""
    if group.process_group is None:
        return t
    src = t.view(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(group.world_size)]
    dist.all_gather(parts, src, group=group.process_group)
    out = torch.cat(parts)
    return out.view(torch.bool) if t.dtype == torch.bool else out


def _chunk_fn(scene: CompiledScene, *, width, height, spp, max_bounce, seed):
    # the scene's feature set skips only the material and texture variants
    # it never selects (the same values as the reference's unspecialized
    # render_chunk, at a fraction of the eager ops)
    return partial(render_chunk, intersect_fn=make_intersect_fn(scene),
                   width=width, height=height, spp=spp,
                   max_bounce=max_bounce, seed=seed, features=scene.features)


def make_sharded_render_fn(scene: CompiledScene, group: RayGroup, *,
                           width: int, height: int, spp: int,
                           max_bounce: int, seed: int) -> Callable:
    """f(tables, camera, ray_ids) -> TraceResult over all of `ray_ids`, on
    every rank: each rank traces its share, `segments` is summed over the
    ranks and color, aov_normal and aov_hit are gathered in id order.
    len(ray_ids) must divide by the world size."""
    chunk_fn = _chunk_fn(scene, width=width, height=height, spp=spp,
                         max_bounce=max_bounce, seed=seed)

    def render(tables, camera, ray_ids) -> TraceResult:
        ids = share(torch.as_tensor(ray_ids).to(torch.int64), group)
        parts = [chunk_fn(tables, camera, ids[c:c + DEFAULT_CHUNK])
                 for c in range(0, ids.shape[0], DEFAULT_CHUNK)]
        segments = torch.stack([p.segments for p in parts]).sum()
        return TraceResult(
            color=all_gather_rows(torch.cat([p.color for p in parts]), group),
            aov_normal=all_gather_rows(
                torch.cat([p.aov_normal for p in parts]), group),
            aov_hit=all_gather_rows(torch.cat([p.aov_hit for p in parts]),
                                    group),
            segments=all_reduce_sum(segments, group))

    return render


def make_sharded_train_step(scene: CompiledScene, group: RayGroup, *,
                            width: int, height: int, spp: int,
                            max_bounce: int, seed: int,
                            learning_rate: float = 0.5) -> Callable:
    """One SGD step on the texel atlas (BASELINE.json config 5):
    f(atlas, tables, camera, ray_ids, target, stamp=None) -> (atlas', loss).

    target is per RAY, (len(ray_ids), 3), sharded as the ids are. The loss
    is the squared error summed over the rays and channels of every share,
    over n = target.numel(); the gradient is summed over the ranks and
    atlas' = atlas - learning_rate * grad / n, as the reference computes
    them. Each rank differentiates its share chunk by chunk
    (`diff/optimize.py::chunked_value_and_grad`, as the render loss does).

    stamp: optional callable, called as `chunked_value_and_grad` calls
    it, and with "reduce" before the two all-reduces."""
    chunk_fn = _chunk_fn(scene, width=width, height=height, spp=spp,
                         max_bounce=max_bounce, seed=seed)

    def step(atlas, tables, camera, ray_ids, target,
             stamp: Optional[Callable] = None):
        ids = share(torch.as_tensor(ray_ids).to(torch.int64), group)
        tgt = share(target, group)

        def ray_loss(leaves, c0, c1):
            out = chunk_fn(tables._replace(**leaves), camera, ids[c0:c1])
            return torch.sum((out.color - tgt[c0:c1]) ** 2)

        loss, grads, _ = chunked_value_and_grad(
            ray_loss, {"atlas": atlas}, ids.shape[0], DEFAULT_CHUNK, stamp)
        if stamp is not None:
            stamp("reduce")
        all_reduce_sum(loss, group)
        grad = all_reduce_sum(grads["atlas"], group)
        n = tgt.numel() * group.world_size
        return atlas.detach() - learning_rate * grad / n, loss / n

    return step
