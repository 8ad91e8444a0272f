"""Render driver: deterministic full-frame rendering.

The flat (pixel x sample) ray index space is cut into equal chunks. The
chunked driver traces each chunk to completion in turn; the compact driver
(render/compact.py) goes bounce by bounce over all chunks and packs the
survivors. Determinism is total: every ray's randomness is a pure function
of (seed, ray id), so chunk size, chunk order and driver never change the
image.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from potato_tpu_torch.core import color as pcolor
from potato_tpu_torch.core.types import resolve_device
from potato_tpu_torch.ops.intersect import intersect_brute_force
from potato_tpu_torch.render.camera import generate_rays
from potato_tpu_torch.render.integrator import TraceResult, trace_paths
from potato_tpu_torch.scene.tables import CompiledScene

DEFAULT_CHUNK = 1 << 15   # rays per chunk; a starting value, not yet tuned


@dataclass
class RenderOutput:
    """Full-frame results."""

    color: np.ndarray      # (H, W, 3) float32 linear radiance (spp-averaged)
    normal: np.ndarray     # (H, W, 3) first-hit normal AOV
    coverage: np.ndarray   # (H, W) float32 foreground fraction
    segments: int = 0      # path segments traced (rays/s numerator)

    def srgb(self) -> np.ndarray:
        """(H, W, 4) uint8, gamma 1/2.2."""
        return pcolor.to_srgb_u8(torch.from_numpy(self.color)).numpy()


def scene_digest(scene: CompiledScene) -> int:
    """Order-stable 63-bit digest of the scene content (tables + camera).

    Folded into the render-checkpoint signature so a checkpoint written for
    one scene can never be resumed into a render of another (or of the same
    scene after edits). Fetches the tables to the host once; only called on
    checkpointing paths.
    """
    h = hashlib.blake2b(digest_size=8)
    for record in (scene.tables, scene.camera):
        for leaf in record:
            a = leaf.cpu().numpy()
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    return int.from_bytes(h.digest(), "little") >> 1  # fits int64


def make_intersect_fn(scene: CompiledScene, force_plain: bool = False):
    """Pick the acceleration entry point of the scene: flash, dense,
    cluster or (no accel) brute force.

    force_plain runs the flash kernel's plain PyTorch version whatever the
    device; it exists for comparisons (tests and chip_smoke.py)."""
    from potato_tpu_torch.ops.dense import DenseAccel, intersect_dense
    from potato_tpu_torch.ops.flash import FlashAccel, intersect_flash
    from potato_tpu_torch.ops.traverse import intersect_clustered
    from potato_tpu_torch.scene.bvh import ClusterAccel

    accel = scene.accel
    if isinstance(accel, FlashAccel):
        return lambda tables, rays: intersect_flash(
            accel, tables, rays, force_plain=force_plain)
    if isinstance(accel, DenseAccel):
        return lambda tables, rays: intersect_dense(accel, tables, rays)
    if isinstance(accel, ClusterAccel):
        return lambda tables, rays: intersect_clustered(accel, rays)
    return intersect_brute_force


TILE_W, TILE_H = 16, 8   # pixels per ray-order tile (x spp rays)


def _tiles_apply(width: int, height: int) -> bool:
    return width % TILE_W == 0 and height % TILE_H == 0


def tile_swizzle_ids(lin, width: int, spp: int):
    """Permute the linear ray order so consecutive ids cover a compact
    TILE_W x TILE_H pixel tile (x spp samples) instead of a 1-pixel-high
    scanline strip.

    The flash intersector builds one cluster list per block of consecutive
    rays; a tile's list is the union over a compact screen patch instead of
    a width-spanning strip. Pure permutation: each ray's RNG and pixel are
    functions of the *physical* id, so the image is bit-identical to
    scanline order after unpermuting.
    """
    lin = lin.to(torch.int64)
    tile = TILE_W * TILE_H * spp
    t_idx, within = lin // tile, lin % tile
    pix, sample = within // spp, within % spp
    tiles_x = width // TILE_W
    px = (t_idx % tiles_x) * TILE_W + pix % TILE_W
    py = (t_idx // tiles_x) * TILE_H + pix // TILE_W
    return (py * width + px) * spp + sample


def tile_unswizzle_perm(width: int, height: int, spp: int) -> np.ndarray:
    """Host-side: physical ray id for each raw (traversal-order) row."""
    lin = np.arange(width * height * spp, dtype=np.uint64)
    tile = TILE_W * TILE_H * spp
    t_idx, within = lin // tile, lin % tile
    pix, sample = within // spp, within % spp
    tiles_x = width // TILE_W
    px = (t_idx % tiles_x) * TILE_W + pix % TILE_W
    py = (t_idx // tiles_x) * TILE_H + pix // TILE_W
    return ((py * width + px) * spp + sample).astype(np.int64)


def render_chunk(tables, camera, ray_ids, *, intersect_fn, width, height,
                 spp, max_bounce, seed, features=None, live=None,
                 ior_score: bool = False, jitter: bool = True,
                 aovs: bool = True) -> TraceResult:
    """Trace one chunk of global ray ids to radiance + AOVs."""
    rays = generate_rays(
        camera, width, height, spp, ray_ids, seed, jitter=jitter,
        lens=features.has_lens if features is not None else True)
    return trace_paths(tables, intersect_fn, rays, ray_ids, max_bounce, seed,
                       features=features, live=live,
                       ior_score=ior_score, aovs=aovs)


def chunk_ray_ids(start: int, chunk_size: int, width: int, height: int,
                  spp: int, device):
    """(ids, live) of the chunk starting at raw row `start`: the tail
    chunk's lanes beyond the frame are born dead (live False), so they
    trace zero segments and the counter counts each frame ray once."""
    total = width * height * spp
    raw = torch.arange(chunk_size, dtype=torch.int64, device=device) + start
    lin = raw % total
    ids = tile_swizzle_ids(lin, width, spp) if _tiles_apply(width, height) \
        else lin
    return ids, raw < total


def _build_frame_fn(scene: CompiledScene, width: int, height: int, spp: int,
                    max_bounce: int, chunk_size: int, jitter: bool = True,
                    aovs: bool = True, force_plain: bool = False):
    """frame(tables, camera, seed, starts) -> TraceResult of stacked chunks
    (num_chunks, chunk_size, ...), all on the scene's device."""
    intersect_fn = make_intersect_fn(scene, force_plain=force_plain)

    def frame(tables, camera, seed, starts) -> TraceResult:
        dev = tables.s_center.device
        chunks = []
        for start in starts.tolist():
            ids, live = chunk_ray_ids(start, chunk_size, width, height, spp,
                                      dev)
            chunks.append(render_chunk(
                tables, camera, ids, intersect_fn=intersect_fn, width=width,
                height=height, spp=spp, max_bounce=max_bounce, seed=seed,
                features=scene.features, live=live,
                jitter=jitter, aovs=aovs))
        return TraceResult(*(torch.stack(field) for field in zip(*chunks)))

    return frame


def default_driver(scene: CompiledScene) -> str:
    """Frame-driver policy: "compact" (bounce-major with live-ray
    compaction) for scenes whose paths diverge in length (dielectrics keep
    bouncing while neighbours retire), "chunked" otherwise."""
    from potato_tpu_torch.scene import description as d

    diverges = d.SCATTER_DIELECTRIC in scene.features.scatter_kinds
    return "compact" if diverges else "chunked"


def check_scene_device(scene: CompiledScene, dev: torch.device) -> None:
    """Raise unless the scene's tables live on the device asked for."""
    if scene.device.type != dev.type:
        raise ValueError(
            f"scene tables live on {scene.device} but device={str(dev)!r} "
            "was requested; build the scene with the same device")


def _resolve(scene, device, driver, width, height, spp, chunk_size):
    check_scene_device(scene, resolve_device(device))
    if driver is None:
        driver = default_driver(scene)
    if driver not in ("chunked", "compact"):
        raise ValueError(f"unknown driver {driver!r}")
    total = width * height * spp
    if chunk_size is None:
        chunk_size = DEFAULT_CHUNK
    chunk_size = min(chunk_size, total)
    return driver, chunk_size, (total + chunk_size - 1) // chunk_size


def _frame_fn(driver, scene, width, height, spp, max_bounce, chunk_size, *,
              jitter, aovs, force_plain):
    """The frame function of `driver` (see compile_frame)."""
    if driver == "compact":
        from potato_tpu_torch.render.compact import build_compact_frame_fn
        return build_compact_frame_fn(scene, width, height, spp, max_bounce,
                                      chunk_size, aovs=aovs, jitter=jitter,
                                      force_plain=force_plain)
    return _build_frame_fn(scene, width, height, spp, max_bounce, chunk_size,
                           jitter=jitter, aovs=aovs, force_plain=force_plain)


def compile_frame(scene: CompiledScene, width: int, height: int, spp: int = 4,
                  max_bounce: int = 8, chunk_size: Optional[int] = None,
                  aovs: bool = False, driver: Optional[str] = None,
                  device="cuda", force_plain: bool = False):
    """The device-only frame function, for timing without the host fetch.

    Returns (frame_fn, starts): frame_fn(tables, camera, seed, starts)
    -> TraceResult of stacked chunks, entirely on the device.

    driver: "chunked" (each chunk runs its bounce loop to completion),
    "compact" (bounce-major with live-ray compaction, render/compact.py;
    the frame's segments in element 0) or None = per-scene default
    (`default_driver`).
    """
    driver, chunk_size, num_chunks = _resolve(
        scene, device, driver, width, height, spp, chunk_size)
    frame_fn = _frame_fn(driver, scene, width, height, spp, max_bounce,
                         chunk_size, jitter=True, aovs=aovs,
                         force_plain=force_plain)
    starts = torch.arange(num_chunks, dtype=torch.int64,
                          device=scene.device) * chunk_size
    return frame_fn, starts


def _per_chunk(scene, frame_fn, starts, chunk_size, total, seed, signature,
               progress, checkpoint_path, checkpoint_every, metrics):
    """Dispatch one chunk at a time: a progress line and a `chunk` event
    per chunk, and a running-image checkpoint every `checkpoint_every`
    chunks (atomic write-then-rename). A checkpoint whose signature equals
    `signature` is resumed after its last saved chunk; any other is
    ignored and overwritten. Returns the stacked TraceResult."""
    num_chunks = starts.shape[0]
    chunks = []       # device TraceResults of one chunk each, in order
    host_chunks = []  # numpy copies already written to the checkpoint
    if checkpoint_path and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as ckpt:
            if np.array_equal(ckpt["signature"], signature):
                saved = [ckpt[f] for f in TraceResult._fields]
                host_chunks = [TraceResult(*(a[i] for a in saved))
                               for i in range(int(ckpt["chunks_done"]))]
        chunks = [TraceResult(*(torch.from_numpy(np.asarray(x))
                                .to(scene.device) for x in c))
                  for c in host_chunks]
        if progress and chunks:
            print(f"[resumed at chunk {len(chunks)}/{num_chunks}]",
                  file=sys.stderr, flush=True)

    def save_checkpoint():
        # each chunk is fetched to the host once, so a save costs the new
        # chunks' transfer and a local stack, not every chunk again
        while len(host_chunks) < len(chunks):
            host_chunks.append(TraceResult(
                *(x.cpu().numpy() for x in chunks[len(host_chunks)])))
        tmp = checkpoint_path + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, signature=signature, chunks_done=len(host_chunks),
                     **{name: np.stack([getattr(c, name) for c in host_chunks])
                        for name in TraceResult._fields})
        os.replace(tmp, checkpoint_path)  # atomic: never a torn file

    for i in range(len(chunks), num_chunks):
        t_c = time.perf_counter()
        one = frame_fn(scene.tables, scene.camera, seed, starts[i:i + 1])
        chunks.append(TraceResult(*(x[0] for x in one)))
        if scene.device.type == "cuda":
            torch.cuda.synchronize(scene.device)
        metrics.log("chunk", chunk=i, of=num_chunks,
                    seconds=round(time.perf_counter() - t_c, 4))
        if checkpoint_path and ((i + 1) % checkpoint_every == 0
                                or i + 1 == num_chunks):
            save_checkpoint()
            metrics.log("checkpoint", chunks_done=i + 1)
        if progress:
            done = min((i + 1) * chunk_size, total)
            print(f"\r[{done}/{total} rays, chunk {i + 1}/{num_chunks}]",
                  end="" if i + 1 < num_chunks else "\n",
                  file=sys.stderr, flush=True)
    return TraceResult(*(torch.stack(f) for f in zip(*chunks)))


def render(scene: CompiledScene, width: int, height: int, spp: int = 4,
           max_bounce: int = 8, seed: int = 0,
           chunk_size: Optional[int] = None,
           progress: bool = False,
           with_aovs: bool = True,
           checkpoint_path: Optional[str] = None,
           checkpoint_every: int = 1,
           jitter: bool = True,
           driver: Optional[str] = None,
           metrics=None,
           device="cuda", force_plain: bool = False) -> RenderOutput:
    """Render a full frame (defaults of the full-size workload: 800x600,
    spp 4, bounce 8, are the caller's to pass).

    with_aovs controls only which buffers are fetched to the host.

    metrics: optional utils.metrics.MetricsLogger (or the POTATO_METRICS
    env path): JSONL events render_start, chunk (per-chunk path only),
    checkpoint and render_complete.

    progress / checkpoint_path: dispatch chunk by chunk, with a progress
    line per chunk and, with a path, a running-image checkpoint saved
    every `checkpoint_every` chunks. A rerun with the same arguments on the
    same scene resumes after the last saved chunk and, because every ray's
    randomness is a pure function of (seed, ray id), ends with an image
    bit-identical to an uninterrupted render. This path needs
    chunk-granular results, so it always takes the chunked driver.
    """
    from potato_tpu_torch.utils.metrics import from_env_or

    own_metrics = metrics is None        # a POTATO_METRICS file is ours
    metrics = from_env_or(metrics)
    try:
        t_start = time.perf_counter()
        driver, chunk_size, num_chunks = _resolve(
            scene, device, driver, width, height, spp, chunk_size)
        total = width * height * spp
        per_chunk = progress or checkpoint_path is not None
        if per_chunk:
            driver = "chunked"
        metrics.log("render_start", width=width, height=height, spp=spp,
                    max_bounce=max_bounce, seed=seed, chunk_size=chunk_size,
                    num_chunks=num_chunks, per_chunk=per_chunk,
                    driver=driver)
        frame_fn = _frame_fn(driver, scene, width, height, spp, max_bounce,
                             chunk_size, jitter=jitter, aovs=True,
                             force_plain=force_plain)
        starts = torch.arange(num_chunks, dtype=torch.int64,
                              device=scene.device) * chunk_size
        if per_chunk:
            # the checkpoint is valid only for an identical request OF THE
            # SAME SCENE: a digest of the tables and camera is part of it
            signature = np.asarray([width, height, spp, max_bounce, seed,
                                    chunk_size, int(jitter),
                                    scene_digest(scene)], np.int64)
            out = _per_chunk(scene, frame_fn, starts, chunk_size, total,
                             seed, signature, progress, checkpoint_path,
                             checkpoint_every, metrics)
        else:
            out = frame_fn(scene.tables, scene.camera, seed, starts)
        result = _to_host(out, width, height, spp, with_aovs)
        wall = time.perf_counter() - t_start
        metrics.log("render_complete", segments=result.segments,
                    seconds=round(wall, 4),
                    rays_per_s=round(result.segments / max(wall, 1e-9), 1))
        return result
    finally:
        if own_metrics:
            metrics.close()


def _to_host(out: TraceResult, width: int, height: int, spp: int,
             with_aovs: bool) -> RenderOutput:
    """Stacked traversal-order rows -> the spp-averaged host images."""
    total = width * height * spp
    device = out.color.device
    # rows come back in traversal order; under tile swizzle, scatter them
    # to their physical (pixel, sample) slots before the spp average
    if _tiles_apply(width, height):
        perm = torch.from_numpy(
            tile_unswizzle_perm(width, height, spp)).to(device)

        def unswizzle(rows):
            flat = torch.empty_like(rows)
            flat[perm] = rows
            return flat
    else:
        def unswizzle(rows):
            return rows

    def image(rows, channels):
        shape = (height, width, spp) + channels
        return unswizzle(rows[:total]).reshape(shape).mean(dim=2) \
            .cpu().numpy()

    color = image(out.color.reshape(-1, 3), (3,))
    segments = int(out.segments.sum())
    if with_aovs:
        normal = image(out.aov_normal.reshape(-1, 3), (3,))
        coverage = image(out.aov_hit.reshape(-1).to(torch.float32), ())
    else:
        normal = np.zeros_like(color)
        coverage = np.zeros(color.shape[:2], np.float32)
    return RenderOutput(color=color, normal=normal, coverage=coverage,
                        segments=segments)
