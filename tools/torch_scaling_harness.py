#!/usr/bin/env python3
"""Sharded frames over 1, 2 and 4 processes on one card, with a
torch.profiler trace of each rank.

    python3 tools/torch_scaling_harness.py --trace           # full run
    python3 tools/torch_scaling_harness.py --device cpu --width 16 \
        --height 16 --spp 1 --max-bounce 2 --worlds 1,2 --trace
                                                             # rehearsal

The port's counterpart of tools/scaling_harness.py (procs mode) with
tools/profile_trace.py's question asked of each rank. Each world is
spawned by potato_tpu_torch/parallel/launch.py::spawn and runs
chip_smoke_ranks.py::measure_render: every rank builds the scene, traces
its contiguous share of the frame's ray ids in chunks, and the frame is
timed on rank 0 from a barrier to a barrier. World 1 joins under nccl and
worlds 2 and 4 under gloo (nccl refuses two ranks on one card).

- Gate: every world's frame (color, aov_normal, aov_hit rows and
  segments) bit-equal to the chunked driver's frame in this process, and
  the scene digest equal on every rank.
- Efficiency(N) = segments/s(N) / (N x segments/s(1)), from each world's
  best frame.
- In this process, in turns: the chunked driver's frame against the
  sharded function without a process group, the ratio of the two.
- `--trace`: one more frame under torch.profiler on every rank and, in
  this process, one frame of each of the two above
  (chip_smoke_ranks.py::traced_call): device busy share, device kernels
  and host syncs a frame, the longest idle gaps of the card with the host
  operation in flight, the top device operations by time. The Chrome
  traces go to chiprun_out/traces/ (gzipped), or `--trace-dir`.
"""

from __future__ import annotations

import os
import sys
import time
from functools import partial

if os.path.dirname(os.path.abspath(__file__)) not in sys.path:
    sys.path.append(os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from torch_common import (  # noqa: E402
    OUT_DIR, Gates, asset_dir, assets_label, build_scenes, device_of, emit,
    factory, frame_args, ints, names, parser, report)

from chip_smoke import one_process_rows  # noqa: E402
from chip_smoke_ranks import frame_ray_ids  # noqa: E402
from chip_smoke_ranks import measure_render, traced_call  # noqa: E402
from potato_tpu_torch.ops import flash  # noqa: E402
from potato_tpu_torch.parallel import launch, make_ray_group  # noqa: E402
from potato_tpu_torch.parallel import make_sharded_render_fn  # noqa: E402
from potato_tpu_torch.render import renderer  # noqa: E402

SCENES = ("more_balls", "bunny")
WORLDS = (1, 2, 4)
TRACE_DIR = os.path.join(OUT_DIR, "traces")
SPAWN_TIMEOUT_S = 900      # traced frames add their export and read


def traced_one_process(name, scene, size, trace_dir):
    """One chunked-driver frame and one frame of the sharded function
    without a process group, each under torch.profiler."""
    dev = scene.device
    fn, starts = renderer.compile_frame(
        scene, size["width"], size["height"], size["spp"],
        size["max_bounce"], aovs=True, driver="chunked", device=dev)
    sharded = make_sharded_render_fn(scene, make_ray_group(dev), **size)
    ids = frame_ray_ids(size["width"], size["height"], size["spp"], dev)
    _, chunked = traced_call(
        lambda: fn(scene.tables, scene.camera, size["seed"], starts), dev,
        os.path.join(trace_dir, f"{name}_main_chunked.json.gz"))
    _, shard = traced_call(
        lambda: sharded(scene.tables, scene.camera, ids), dev,
        os.path.join(trace_dir, f"{name}_main_sharded.json.gz"))
    return {"chunked driver": chunked, "sharded fn, no group": shard}


def run(worlds=WORLDS, scenes=SCENES, *, width=800, height=600, spp=4,
        max_bounce=8, seed=7, frames=2, trace=False, trace_dir=TRACE_DIR,
        assets=None, device="cuda") -> dict:
    """Each world of `worlds` spawned on this device, sharded frames of
    each scene, against this process's frames. Returns the report."""
    dev = device_of(device)
    gates = Gates()
    size = dict(width=width, height=height, spp=spp, max_bounce=max_bounce,
                seed=seed)
    if dev.type == "cuda":
        flash.load_kernel_library()         # the ranks find it by its hash
    out = {"one_process": {}, "worlds": {}}
    launches = 0
    with asset_dir(assets) as adir:
        built = build_scenes(scenes, adir, dev)
        refs = {}
        for name, scene in built.items():
            rows, segments, ms, ms_sharded = one_process_rows(
                scene, frames, **size)
            refs[name] = (rows, segments, renderer.scene_digest(scene))
            row = out["one_process"][name] = {
                "segments": segments, "chunked_ms": ms,
                "sharded_fn_ms": ms_sharded,
                "sharded_fn_over_chunked": (
                    float(np.mean(ms_sharded) / np.mean(ms)) if ms else None)}
            if trace:
                row["traces"] = traced_one_process(name, scene, size,
                                                   trace_dir)
        rank_fn = partial(
            measure_render,
            scenes={n: (factory(n, adir), "flash") for n in scenes},
            frames=frames, trace_dir=trace_dir if trace else None, **size)
        for world in worlds:
            t0 = time.perf_counter()
            got = launch.spawn(rank_fn, world, device=dev,
                               timeout_s=SPAWN_TIMEOUT_S)
            res = got.result
            row = out["worlds"][world] = {
                "backend": got.backend,
                "spawn_to_join_s": time.perf_counter() - t0,
                "cold_start": [dict(s, **c) for s, c in
                               zip(got.startup, res["cold_start"])]}
            for name, r in res["scenes"].items():
                want, segments, digest = refs[name]
                off = {f: int((r[f] != want[f]).reshape(len(want[f]), -1)
                              .any(-1).sum()) for f in want}
                gates(f"world {world}, {name}: sharded rows and segments "
                      "bit-equal to the 1-process frame",
                      f"rows off {off}, segments {r['segments']} / "
                      f"{segments}",
                      not any(off.values()) and r["segments"] == segments,
                      "0 off, equal")
                gates(f"world {world}, {name}: scene digest of every rank "
                      "equals this process's",
                      f"{len(set(r['digests']))} distinct",
                      set(r["digests"]) == {digest}, "1, this process's")
                launches += sum(r["launches"])
                row[name] = {
                    "frame_ms": r["frame_ms"], "host_s": r["host_s"],
                    "segments_per_s": segments / (min(r["frame_ms"]) / 1e3),
                    "launches_by_rank": r["launches"],
                    "traces": r.get("traces")}
    for name in scenes:
        base = out["worlds"][worlds[0]][name]["segments_per_s"]
        one = out["one_process"][name]
        for world in worlds:
            row = out["worlds"][world][name]
            row["efficiency"] = (row["segments_per_s"]
                                 / (world / worlds[0] * base))
            row["best_ms_over_one_process_chunked"] = (
                min(row["frame_ms"]) / min(one["chunked_ms"])
                if one["chunked_ms"] else None)
    return report("torch_scaling_harness", dev, gates,
                  workload=dict(size, frames=frames, trace=trace,
                                host_cores=os.cpu_count(),
                                assets=assets_label(assets)),
                  efficiency_base_world=worlds[0], **out,
                  launches=launches)


def main(argv=None) -> int:
    ap = parser(__doc__, frames=2)
    ap.add_argument("--worlds", type=ints, default=list(WORLDS))
    ap.add_argument("--scenes", type=names, default=list(SCENES))
    ap.add_argument("--trace", action="store_true",
                    help="trace one frame per rank with torch.profiler")
    ap.add_argument("--trace-dir", default=TRACE_DIR)
    opts = ap.parse_args(argv)
    return emit(run(opts.worlds, opts.scenes, frames=opts.frames,
                    trace=opts.trace, trace_dir=opts.trace_dir,
                    assets=opts.assets, device=opts.device,
                    **frame_args(opts)))


if __name__ == "__main__":
    sys.exit(main())
