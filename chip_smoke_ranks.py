"""The rank functions of chip_smoke.py's phase 8 (scale-out), and the
timing marks chip_smoke.py uses throughout.

A spawned rank finds its function by module name, so the functions live
here and not under chip_smoke.py's `__main__`:

    from potato_tpu_torch.parallel import launch
    got = launch.spawn(partial(measure_render, scenes=..., width=800, ...),
                       2, device="cuda")

`measure_render` and `measure_train_step` are the port's counterpart of
tools/scaling_harness.py's procs mode: sharded frames and SGD steps on
each rank, timed from a barrier to a barrier, with each rank's cold start
(kernel library, scene build, first chunk). Marks are CUDA events on the
card and the host clock on the CPU, where the tests rehearse them.
`traced_call` runs one call under torch.profiler and reads its Chrome
trace (`trace_summary`): tools/torch_scaling_harness.py's per-rank trace.
"""

from __future__ import annotations

import gzip
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from potato_tpu_torch.ops import flash
from potato_tpu_torch.parallel import make_sharded_render_fn
from potato_tpu_torch.parallel import make_sharded_train_step
from potato_tpu_torch.parallel.launch import gather_objects
from potato_tpu_torch.parallel.mesh import RayGroup
from potato_tpu_torch.parallel.shard import share
from potato_tpu_torch.render.renderer import (
    DEFAULT_CHUNK,
    chunk_ray_ids,
    make_intersect_fn,
    render_chunk,
    scene_digest,
)


# ---- timing: CUDA events (a host clock only in CPU rehearsals)

def event(device="cuda"):
    """A mark on `device`'s timeline: a recorded CUDA event, or on the CPU
    the host clock."""
    if torch.device(device).type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def elapsed_ms(a, b) -> float:
    """Milliseconds from mark `a` to mark `b` (after `sync` on the card)."""
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


def sync(device):
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---- one call under torch.profiler, read from its Chrome trace

# host calls that wait for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP_OPS, IDLE_GAPS = 10, 5     # device ops and idle gaps a summary lists


def traced_call(fn: Callable, device, path: str):
    """fn() under torch.profiler (the card's activity too where there is
    one), its Chrome trace read back and written to `path` gzipped at the
    fastest level. Returns (fn's result, `trace_summary` plus the seconds
    the profiler's export, the read and the write took)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=activities) as prof:
        h0 = time.perf_counter()
        out = fn()
        sync(device)
        wall_ms = (time.perf_counter() - h0) * 1e3
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    raw = path + ".raw.json"
    t0 = time.perf_counter()
    prof.export_chrome_trace(raw)
    t1 = time.perf_counter()
    with open(raw, "rb") as f:
        data = f.read()
    os.remove(raw)
    events = json.loads(data)["traceEvents"]
    t2 = time.perf_counter()
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(data)
    seconds = {"export_s": t1 - t0, "read_s": t2 - t1,
               "write_s": time.perf_counter() - t2}
    return out, dict(trace_summary(events, wall_ms), trace=path, **seconds)


def _merged(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def trace_summary(events, wall_ms: float) -> dict:
    """What one traced call did on the card and where the card waited.

    `events` are a Chrome trace's complete events (microseconds). The
    card's work is its kernels, copies and fills; busy is their union over
    `wall_ms`, the call's host clock. Host syncs are the runtime calls that
    wait for the card (SYNC_CALLS); device-to-host copies are counted
    beside them. An idle gap is a span between two stretches of device
    work; its host operation is the innermost host op (or runtime call)
    in flight at the gap's middle. No device events (the CPU) gives busy
    None."""
    spans = [e for e in events if e.get("ph") == "X"]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    host = [e for e in spans if e.get("cat") in ("cpu_op", "cuda_runtime")]
    busy = _merged((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy_us = sum(b - a for a, b in busy)
    idle = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:IDLE_GAPS]

    def in_flight(t):
        around = [e for e in host if e["ts"] <= t <= e["ts"] + e["dur"]]
        return max(around, key=lambda e: e["ts"])["name"] if around else None

    by_name = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
    runtime = [e["name"] for e in spans if e.get("cat") == "cuda_runtime"]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3 if device else None,
        "device_busy_share": busy_us / 1e3 / wall_ms if device else None,
        "kernels": sum(e["cat"] == "kernel" for e in device),
        "host_syncs": sum(n in SYNC_CALLS for n in runtime),
        "dtoh_copies": sum(e["cat"] == "gpu_memcpy" and "DtoH" in e["name"]
                           for e in device),
        "host_ops": sum(e["cat"] == "cpu_op" for e in host),
        "idle_gaps": [{"ms": g / 1e3, "host_op": in_flight((a + b) / 2)}
                      for g, a, b in idle],
        "top_device_ops": [
            {"name": n[:120], "ms": us / 1e3, "count": c}
            for n, (us, c) in sorted(by_name.items(),
                                     key=lambda kv: -kv[1][0])[:TOP_OPS]],
    }


def barrier(group: RayGroup) -> None:
    if group.process_group is not None:
        dist.barrier(group=group.process_group)


def frame_ray_ids(width: int, height: int, spp: int, device) -> torch.Tensor:
    """A frame's global ray ids in the chunked driver's order (tile
    swizzled where the tiles apply), so that a sharded TraceResult lines
    up with the chunked driver's stacked rows."""
    total = width * height * spp
    return chunk_ray_ids(0, total, width, height, spp, device)[0]


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _library_cold_start(group: RayGroup) -> dict:
    """Load (or build) the kernel library on a rank on the card."""
    if group.device.type != "cuda":
        return {}
    t0 = time.perf_counter()
    info = flash.load_kernel_library()
    return {"kernel_library_s": time.perf_counter() - t0,
            "kernel_library_built": info["seconds"] > 0}


def measure_render(group: RayGroup, scenes: Dict[str, Tuple[Callable, str]],
                   *, width: int, height: int, spp: int, max_bounce: int,
                   seed: int, frames: int = 1,
                   trace_dir: Optional[str] = None) -> dict:
    """Sharded frames of each scene (name -> (SceneBuilder factory,
    accel)), on every rank of `group`.

    Each rank builds the scene, traces the first chunk of its share
    (timed: the cold start), then `frames` sharded frames of the frame's
    ray ids (`frame_ray_ids`), each timed from a barrier to a barrier.
    Returns, per scene: the last frame's gathered color, aov_normal and
    aov_hit (numpy, rank 0 only), segments, every rank's scene digest and
    kernel launches over the frames, ms a frame (rank 0's device clock)
    and host seconds a frame; and each rank's cold start. With
    `trace_dir`, one more frame runs under torch.profiler on every rank
    (`traced_call`; trace files `<scene>_world<N>_rank<r>.json.gz` there),
    and each rank's `trace_summary` comes back under "traces"."""
    dev = group.device
    cold = _library_cold_start(group)
    out = {}
    for name, (make, accel) in scenes.items():
        t0 = time.perf_counter()
        scene = make().build(accel=accel, device=dev)
        sync(dev)
        cold[f"{name}: scene build s"] = time.perf_counter() - t0
        ids = frame_ray_ids(width, height, spp, dev)
        t0 = time.perf_counter()
        first = render_chunk(
            scene.tables, scene.camera, share(ids, group)[:DEFAULT_CHUNK],
            intersect_fn=make_intersect_fn(scene), width=width,
            height=height, spp=spp, max_bounce=max_bounce, seed=seed,
            features=scene.features)
        sync(dev)
        cold[f"{name}: first chunk s"] = time.perf_counter() - t0
        del first
        fn = make_sharded_render_fn(scene, group, width=width, height=height,
                                    spp=spp, max_bounce=max_bounce, seed=seed)
        launches = flash.flash_intersect_kernel.launches
        ms, host_s = [], []
        for _ in range(frames):
            barrier(group)
            a, h0 = event(dev), time.perf_counter()
            res = fn(scene.tables, scene.camera, ids)
            barrier(group)
            b = event(dev)
            sync(dev)
            host_s.append(time.perf_counter() - h0)
            ms.append(elapsed_ms(a, b))
        launches = flash.flash_intersect_kernel.launches - launches
        summary = None
        if trace_dir is not None:
            barrier(group)
            _, summary = traced_call(
                lambda: fn(scene.tables, scene.camera, ids), dev,
                os.path.join(trace_dir, f"{name}_world{group.world_size}_rank"
                             f"{group.rank}.json.gz"))
        ranks = gather_objects({"digest": scene_digest(scene),
                                "launches": launches, "trace": summary},
                               group)
        row = {"segments": int(res.segments),
               "digests": [r["digest"] for r in ranks],
               "launches": [r["launches"] for r in ranks],
               "frame_ms": ms, "host_s": host_s}
        if trace_dir is not None:
            row["traces"] = [r["trace"] for r in ranks]
        if group.rank == 0:
            row.update(color=_host(res.color),
                       aov_normal=_host(res.aov_normal),
                       aov_hit=_host(res.aov_hit))
        out[name] = row
        del res, scene
    return {"scenes": out, "cold_start": gather_objects(cold, group)}


def measure_train_step(group: RayGroup, make_scene: Callable, *,
                       accel: str = "flash", width: int, height: int,
                       spp: int, max_bounce: int, seed: int, steps: int,
                       learning_rate: float, init: float = 0.5) -> dict:
    """`steps` sharded SGD steps on the atlas from a constant `init`,
    against a target rendered (sharded) with the scene's own atlas.

    Returns: the atlas after the first step and the target (numpy, rank 0
    only), the loss of each step, seconds a step (host clock, barrier to
    barrier), forward, backward and all-reduce ms of each step (rank 0's
    device clock, summed over its chunks), every rank's scene digest and
    kernel launches over the steps, and each rank's cold start (scene
    build, target frame)."""
    dev = group.device
    cold = {}
    t0 = time.perf_counter()
    scene = make_scene().build(accel=accel, device=dev)
    sync(dev)
    cold["train step: scene build s"] = time.perf_counter() - t0
    kw = dict(width=width, height=height, spp=spp, max_bounce=max_bounce,
              seed=seed)
    ids = torch.arange(width * height * spp, device=dev)
    t0 = time.perf_counter()
    target = make_sharded_render_fn(scene, group, **kw)(
        scene.tables, scene.camera, ids).color
    sync(dev)
    cold["train step: target frame s"] = time.perf_counter() - t0
    step = make_sharded_train_step(scene, group, learning_rate=learning_rate,
                                   **kw)
    atlas = torch.full_like(scene.tables.atlas, init)
    launches = flash.flash_intersect_kernel.launches
    row = {"losses": [], "step_s": [], "forward_ms": [], "backward_ms": [],
           "all_reduce_ms": []}
    for i in range(steps):
        marks = []
        barrier(group)
        h0 = time.perf_counter()
        atlas, loss = step(atlas, scene.tables, scene.camera, ids, target,
                           stamp=lambda label: marks.append(
                               (label, event(dev))))
        marks.append(("end", event(dev)))
        loss = float(loss)
        barrier(group)
        sync(dev)
        row["step_s"].append(time.perf_counter() - h0)
        row["losses"].append(loss)
        ms = {"forward": 0.0, "backward": 0.0, "reduce": 0.0}
        for (label, a), (_, b) in zip(marks, marks[1:]):
            if label in ms:
                ms[label] += elapsed_ms(a, b)
        row["forward_ms"].append(ms["forward"])
        row["backward_ms"].append(ms["backward"])
        row["all_reduce_ms"].append(ms["reduce"])
        if i == 0 and group.rank == 0:
            row["atlas_after_first_step"] = _host(atlas)
    ranks = gather_objects({
        "digest": scene_digest(scene),
        "launches": flash.flash_intersect_kernel.launches - launches}, group)
    row.update(digests=[r["digest"] for r in ranks],
               launches=[r["launches"] for r in ranks],
               cold_start=gather_objects(cold, group))
    if group.rank == 0:
        row["target"] = _host(target)
    return row
