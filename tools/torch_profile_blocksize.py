#!/usr/bin/env python3
"""The flash kernel's rays per queue block, R, swept on the card.

    python3 tools/torch_profile_blocksize.py                 # full sweep
    python3 tools/torch_profile_blocksize.py --device cpu --width 16 \
        --height 16 --spp 1 --max-bounce 2 --rays 256 --blocks 128,256
                                                             # rehearsal

The port's counterpart of tools/profile_blocksize.py. A queue block is
the set of rays that share one front-to-back visit list
(ops/flash.py::prepare_flash): a larger R pays the queue build's fixed
cost over more rays, a smaller R gives each block a shorter, more specific
list. R is passed as an argument (prepare_flash(block=),
intersect_flash(block=)); flash.R keeps its value.

On the middle chunk of a frame (`--rays` ids, 2^15 by default), its camera
rays and the rays one bounce step sends on, of each scene, and at each R:
- gate: chip_smoke.py's compare_kernel_with_plain at block R (hits, slots
  and t against the plain version, visits equal at every group dividing
  R), and the kernel's visits per block (group = R) equal to the plain
  version's;
- the queue build's ms a call (marks around repeated calls: what a frame
  pays, host pacing included) and the kernel's device ms a launch
  (chip_smoke.py's device_ms; the host clock on the CPU);
- visits per block (sphere clusters, packed children, tail parents) and
  the pairs tested at the default termination group.
With `--frames` > 0, whole chunked frames with R threaded through the
intersector (renderer.render_chunk over the frame's chunks), timed in
turns: ms/frame, segments and launches a frame, and the rows that differ
from the first R's frame (a tie between two primitives may fall the other
way when the visit order changes; reported, not gated).
"""

from __future__ import annotations

import contextlib
import os
import sys
from functools import partial

if os.path.dirname(os.path.abspath(__file__)) not in sys.path:
    sys.path.append(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from torch_common import (  # noqa: E402
    Gates, asset_dir, assets_label, build_scenes, chunk_rays, device_of,
    emit, frame_args, ints, launch_ms, names, parser, report)

from chip_smoke import compare_kernel_with_plain  # noqa: E402
from chip_smoke import kernel_args, new_visits, pairs_tested  # noqa: E402
from chip_smoke_ranks import elapsed_ms, event, sync  # noqa: E402
from potato_tpu_torch.ops import flash  # noqa: E402
from potato_tpu_torch.render import renderer  # noqa: E402

SCENES = ("more_balls", "glass_bunny", "bunny")
BLOCKS = (128, 256, 512, 1024)
RAYS = 1 << 15


def queue_build_ms(scene, rays, block, reps=10) -> float:
    """ms a prepare_flash call, between two marks around `reps` calls."""
    dev = scene.device
    flash.prepare_flash(scene.accel, scene.tables, rays, block)     # warm
    sync(dev)
    a = event(dev)
    for _ in range(reps):
        flash.prepare_flash(scene.accel, scene.tables, rays, block)
    b = event(dev)
    sync(dev)
    return elapsed_ms(a, b) / reps


def held_against_plain(gates, label, scene, rays, block):
    """chip_smoke.py's kernel-vs-plain gates at `block` (its log to
    stderr), and the visits per block of kernel and plain version."""
    try:
        with contextlib.redirect_stdout(sys.stderr):
            max_abs = compare_kernel_with_plain(label, scene, rays,
                                                block=block)
        gates(f"{label}: kernel against the plain version at R = {block}",
              f"max abs t err {max_abs:.3e}", True, "chip_smoke.py's gates")
    except SystemExit as missed:
        gates(f"{label}: kernel against the plain version at R = {block}",
              str(missed), False, "chip_smoke.py's gates")
    inp = flash.prepare_flash(scene.accel, scene.tables, rays, block)
    args = kernel_args(scene, inp, block)
    vk = new_visits(scene, inp, block)
    vp = torch.zeros_like(vk)
    flash.flash_intersect_kernel(*args, visits=vk, group=block)
    flash.flash_intersect_plain(*args, visits=vp, group=block)
    gates(f"{label}: visits per block at R = {block} equal to the plain "
          "version's", f"{int((vk != vp).sum())} differ",
          torch.equal(vk, vp), "0 differ")
    return inp, vk


def sweep_rays(gates, label, scene, rays, blocks):
    rows = []
    for block in blocks:
        inp, per_block = held_against_plain(gates, label, scene, rays, block)
        group = flash.resolve_group(block)
        vg = new_visits(scene, inp, group)
        args = kernel_args(scene, inp, block)
        flash.flash_intersect_kernel(*args, visits=vg, group=group)
        sph, children, tail = (float(x) for x in
                               per_block.float().mean(0).tolist())
        rows.append({
            "rays": label, "block": block, "group": group,
            "blocks": per_block.shape[0],
            "queue_build_ms": queue_build_ms(scene, rays, block),
            "kernel_ms": launch_ms(
                lambda: flash.flash_intersect_kernel(*args, group=group),
                scene.device),
            "visits_per_block": {"sphere_clusters": sph,
                                 "children": children, "tail_parents": tail},
            "pairs_tested": pairs_tested(vg, group)})
    return rows


def block_frame(scene, block, *, width, height, spp, max_bounce, seed,
                chunk):
    """A chunked frame with R = `block` threaded through the intersector:
    (segments, the rows' colors in chunk order)."""
    intersect = partial(_intersect_at, scene.accel, block=block)
    colors, segments = [], 0
    for start in range(0, width * height * spp, chunk):
        ids, live = renderer.chunk_ray_ids(start, chunk, width, height, spp,
                                           scene.device)
        out = renderer.render_chunk(
            scene.tables, scene.camera, ids, intersect_fn=intersect,
            width=width, height=height, spp=spp, max_bounce=max_bounce,
            seed=seed, features=scene.features, live=live, aovs=False)
        colors.append(out.color)
        segments = segments + out.segments
    return int(segments), torch.cat(colors)


def _intersect_at(accel, tables, rays, *, block):
    return flash.intersect_flash(accel, tables, rays, block=block)


def frames_in_turns(scene, blocks, frames, size, chunk):
    """Whole frames at each R: a warm one each, then `frames` rounds in
    turns."""
    dev = scene.device
    rows = [{"block": b, "frame_ms": [], "launches_per_frame": []}
            for b in blocks]
    first = None
    for row in rows:
        segments, color = block_frame(scene, row["block"], chunk=chunk,
                                      **size)
        first = color if first is None else first
        row["segments"] = segments
        row["rows_differing_from_first_block"] = int(
            (color != first).any(-1).sum())
    for _ in range(frames):
        for row in rows:
            before = flash.flash_intersect_kernel.launches
            a = event(dev)
            block_frame(scene, row["block"], chunk=chunk, **size)
            b = event(dev)
            sync(dev)
            row["frame_ms"].append(elapsed_ms(a, b))
            row["launches_per_frame"].append(
                flash.flash_intersect_kernel.launches - before)
    for row in rows:
        row["best_ms"] = min(row["frame_ms"], default=None)
    return rows


def run(scenes=SCENES, blocks=BLOCKS, *, rays=RAYS, width=800, height=600,
        spp=4, max_bounce=8, seed=7, frames=2, assets=None,
        device="cuda") -> dict:
    """Each scene's camera and bounce-1 rays at each R, and (frames > 0)
    whole frames at each R. Returns the report (cells, frames, gates)."""
    dev = device_of(device)
    gates = Gates()
    size = dict(width=width, height=height, spp=spp, max_bounce=max_bounce,
                seed=seed)
    cells, frame_rows = [], []
    with asset_dir(assets) as adir:
        built = build_scenes(scenes, adir, dev)
    for name, scene in built.items():
        for bounce in (0, 1):
            batch, live = chunk_rays(scene, width=width, height=height,
                                     spp=spp, seed=seed, n=rays,
                                     bounce=bounce)
            label = f"{name}, {'bounce-1' if bounce else 'camera'} rays"
            for row in sweep_rays(gates, label, scene, batch, blocks):
                cells.append({"scene": name, "live_share": live, **row})
        if frames > 0:
            chunk = min(renderer.DEFAULT_CHUNK, width * height * spp)
            for row in frames_in_turns(scene, blocks, frames, size, chunk):
                frame_rows.append({"scene": name, **row})
    return report("torch_profile_blocksize", dev, gates,
                  workload=dict(size, rays=rays, default_block=flash.R,
                                assets=assets_label(assets)),
                  cells=cells, frames=frame_rows,
                  launches=sum(sum(r["launches_per_frame"])
                               for r in frame_rows))


def main(argv=None) -> int:
    ap = parser(__doc__, frames=2)
    ap.add_argument("--scenes", type=names, default=list(SCENES))
    ap.add_argument("--blocks", type=ints, default=list(BLOCKS))
    ap.add_argument("--rays", type=int, default=RAYS,
                    help="rays of the middle chunk each R is measured on")
    opts = ap.parse_args(argv)
    return emit(run(opts.scenes, opts.blocks, rays=opts.rays,
                    frames=opts.frames, assets=opts.assets,
                    device=opts.device, **frame_args(opts)))


if __name__ == "__main__":
    sys.exit(main())
