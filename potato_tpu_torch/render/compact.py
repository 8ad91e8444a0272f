"""Breadth-first frame driver with live-ray compaction.

The chunked driver (renderer.py) runs each chunk's bounce loop to
completion: it can only skip a bounce once EVERY lane of the chunk has
retired, so on scenes whose paths diverge in length (dielectric interiors,
thousands of small spheres) nearly every pass still carries a live lane and
the intersector runs at full cost over mostly dead lanes.

This driver flips the loop nest to bounce-major and compacts between
bounces:

  bounce 0:  every chunk traces one segment (camera rays, AOVs); its
             survivors are packed into a dense pool
  bounce b:  only ceil(n_live / C) passes over the pool's live prefix;
             retiring lanes scatter their final radiance to the output by
             ray id, survivors are packed into the other pool
  flush:     paths still alive after max_bounce segments write their
             radiance (their last emission counts, no further scatter)

Bit identity with the chunked driver: a path's radiance is a per-lane
function of (seed, ray id, bounce) and of the state it carries, which the
pool copies exactly, and the intersector returns each ray's nearest hit
whatever rays share its block. So the image equals the chunked image bit
for bit (tests/test_torch_compact.py).

The pool is a set of tensors (origin, direction, throughput, radiance, ray
id), two of them: a bounce reads one and writes the other, so a pass never
overwrites rows that a later pass of the same bounce still reads. The live
count stays on the device between passes and is read once a bounce, to set
that bounce's pass count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from potato_tpu_torch.core.types import BIG, RAY_EPSILON, RayBatch
from potato_tpu_torch.render.camera import generate_rays
from potato_tpu_torch.render.integrator import (
    PathState,
    TraceResult,
    init_state,
    make_bounce_step,
)


class Pool(NamedTuple):
    """T rows of path state; rows at or past the live count are stale."""

    origin: torch.Tensor      # (T, 3) f32
    direction: torch.Tensor   # (T, 3) f32
    throughput: torch.Tensor  # (T, 3) f32
    radiance: torch.Tensor    # (T, 3) f32
    raw: torch.Tensor         # (T,) int64 traversal-order ray id


def new_pool(rows: int, device) -> Pool:
    f3 = dict(size=(rows, 3), dtype=torch.float32, device=device)
    return Pool(torch.zeros(**f3), torch.zeros(**f3), torch.zeros(**f3),
                torch.zeros(**f3),
                torch.zeros(rows, dtype=torch.int64, device=device))


def survivor_key(keep, origin, direction):
    """(C,) int32 sort key: dead flag, then direction octant, then a
    4-bit-per-axis Morton code of the origin in the box of the C origins.

    A stable ascending sort on it puts every survivor before every dead
    lane, whatever the dead lanes hold (the Morton code is masked to 12
    bits, so it never reaches the dead flag); survivors of one octant and
    one region of the box land next to each other, in screen order among
    equals, which keeps the intersector's blocks coherent.
    """
    i32 = torch.int32
    d = direction
    octant = ((d[:, 0] < 0).to(i32) * 4 + (d[:, 1] < 0).to(i32) * 2
              + (d[:, 2] < 0).to(i32))
    lo = origin.amin(dim=0)
    hi = origin.amax(dim=0)
    q = torch.clamp((origin - lo) / torch.clamp(hi - lo, min=1e-6) * 15.999,
                    0, 15)
    # torch leaves the integer value of NaN undefined; 0, as XLA gives
    q = torch.nan_to_num(q, nan=0.0).to(i32)
    morton = torch.zeros(origin.shape[0], dtype=i32, device=origin.device)
    for bit in range(4):
        for axis in range(3):
            morton = morton | (((q[:, axis] >> bit) & 1) << (3 * bit + axis))
    return (~keep).to(i32) * (8 << 12) + octant * (1 << 12) + morton


def compact_into(pool: Pool, state: PathState, raw, n_out):
    """Scatter one pass's lanes into `pool` at n_out + rank, rank being the
    lane's place in the survivor order: the survivors fill
    [n_out, n_out + kept), the dead lanes the rows after them, which the
    next pass's survivors overwrite or the live count masks. Every index is
    distinct and below n_out + C <= T. Returns the new live count, on the
    device."""
    keep = state.active
    order = torch.sort(survivor_key(keep, state.rays.origin,
                                    state.rays.direction), stable=True)[1]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    dst = n_out + rank
    for rows, src in ((pool.origin, state.rays.origin),
                      (pool.direction, state.rays.direction),
                      (pool.throughput, state.throughput),
                      (pool.radiance, state.radiance), (pool.raw, raw)):
        rows.index_copy_(0, dst, src)
    return n_out + keep.sum()


def unpack(pool: Pool, lo: int, hi: int, n_live: int) -> PathState:
    """Rows [lo, hi) of the pool as a bounce-loop state. Rows at or past
    n_live are stale and come out dead (t_max < t_min)."""
    dev = pool.raw.device
    valid = torch.arange(lo, hi, device=dev) < n_live
    zb = torch.zeros(hi - lo, dtype=torch.float32, device=dev)
    rays = RayBatch(origin=pool.origin[lo:hi], direction=pool.direction[lo:hi],
                    t_min=zb + RAY_EPSILON,
                    t_max=torch.where(valid, zb + BIG, zb - 1.0))
    return PathState(rays=rays, radiance=pool.radiance[lo:hi],
                     throughput=pool.throughput[lo:hi], active=valid,
                     aov_normal=torch.zeros_like(pool.origin[lo:hi]),
                     aov_hit=torch.zeros_like(valid),
                     segments=torch.zeros((), dtype=torch.int64, device=dev))


def build_compact_frame_fn(scene, width: int, height: int, spp: int,
                           max_bounce: int, chunk_size: int,
                           aovs: bool = False, jitter: bool = True,
                           force_plain: bool = False):
    """frame(tables, camera, seed, starts) -> TraceResult, the same stacked
    (num_chunks, C, ...) rows in traversal order as the chunked driver's;
    `segments` carries the frame total in element 0.

    After each call `frame.passes` lists the passes each bounce took
    (bounce 0 first; the flush's passes last)."""
    from potato_tpu_torch.render.renderer import (
        chunk_ray_ids,
        make_intersect_fn,
        tile_swizzle_ids,
        _tiles_apply,
    )

    intersect_fn = make_intersect_fn(scene, force_plain=force_plain)
    total = width * height * spp
    C = chunk_size
    tiles = _tiles_apply(width, height)
    features = scene.features

    def frame(tables, camera, seed, starts) -> TraceResult:
        dev = tables.s_center.device
        starts = starts.tolist()
        num_chunks = len(starts)
        T = num_chunks * C
        step0 = make_bounce_step(tables, intersect_fn, seed,
                                 features=features, aovs=aovs)
        step_n = make_bounce_step(tables, intersect_fn, seed,
                                  features=features, aovs=False)
        lane = torch.arange(C, dtype=torch.int64, device=dev)
        # rows [T, T + C) take the writes of lanes that write nothing, each
        # at T + lane: a scatter index is never out of range or shared
        out_color = torch.zeros((T + C, 3), dtype=torch.float32, device=dev)
        out_normal = torch.zeros((T, 3), dtype=torch.float32, device=dev)
        out_hit = torch.zeros((T,), dtype=torch.bool, device=dev)
        pool, other = new_pool(T, dev), new_pool(T, dev)
        n = torch.zeros((), dtype=torch.int64, device=dev)
        segments = torch.zeros((), dtype=torch.int64, device=dev)
        passes = [num_chunks]

        # ---- bounce 0: camera rays, chunk by chunk
        for start in starts:
            ids, live = chunk_ray_ids(start, C, width, height, spp, dev)
            rays = generate_rays(camera, width, height, spp, ids, seed,
                                 jitter=jitter, lens=features.has_lens)
            st = step0(init_state(rays, live=live), 0, ids)
            # retired (and dead-born) lanes are final now; survivors get
            # their value at retirement or flush
            out_color[start:start + C] = torch.where(
                st.active[:, None], torch.zeros_like(st.radiance),
                st.radiance)
            if aovs:
                out_normal[start:start + C] = st.aov_normal
                out_hit[start:start + C] = st.aov_hit
            n = compact_into(pool, st, lane + start, n)
            segments = segments + st.segments

        # ---- bounces 1 .. max_bounce-1 over the live prefix only
        n_live = int(n)
        for bounce in range(1, max_bounce):
            if n_live == 0:
                break
            n_out = torch.zeros((), dtype=torch.int64, device=dev)
            num_passes = (n_live + C - 1) // C
            for j in range(num_passes):
                st = unpack(pool, j * C, (j + 1) * C, n_live)
                raw = pool.raw[j * C:(j + 1) * C]
                # a stale row's id only feeds the RNG of a dead lane
                lin = raw % total
                ids = tile_swizzle_ids(lin, width, spp) if tiles else lin
                valid = st.active
                st = step_n(st, bounce, ids)
                retired = valid & ~st.active
                out_color.index_copy_(
                    0, torch.where(retired, raw, T + lane), st.radiance)
                n_out = compact_into(other, st, raw, n_out)
                segments = segments + st.segments
            passes.append(num_passes)
            pool, other = other, pool
            n_live = int(n_out)

        # ---- flush: paths alive after max_bounce segments are final
        num_passes = (n_live + C - 1) // C
        for j in range(num_passes):
            valid = torch.arange(j * C, (j + 1) * C, device=dev) < n_live
            out_color.index_copy_(
                0, torch.where(valid, pool.raw[j * C:(j + 1) * C], T + lane),
                pool.radiance[j * C:(j + 1) * C])
        passes.append(num_passes)
        frame.passes = passes

        # frame-total segments in element 0: callers sum over chunks
        seg = torch.zeros((num_chunks,), dtype=torch.int64, device=dev)
        seg[0] = segments
        return TraceResult(color=out_color[:T].reshape(num_chunks, C, 3),
                           aov_normal=out_normal.reshape(num_chunks, C, 3),
                           aov_hit=out_hit.reshape(num_chunks, C),
                           segments=seg)

    frame.passes = []
    return frame
