"""The benchmark's harness: one run of one cell of `BENCHMARK.json`.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by its name:

- `configs/<config>.json`: the scene's sizes and source; its `builder`
  names `scenes/<builder>.py`, whose `records(cfg)` makes the scene records.
- `traffic/<traffic>.json`: frame size, samples, bounces, and how many
  frames the correctness check and the trace take.
- `metrics/<metric>.py`: `read(run)` returns the metric's value, or None
  where it finds nothing to read; optional `before_window(run)` and
  `after_window(run)` run right before and after the measured window.
- `limits/<cell>.json`: the limit of each number the comparison reads.

A run: make the records, build the port's scene, render one warm frame
(all of that is `setup_s`), then render whole frames through the port's
`render()` in a closed loop for `seconds`, each with its own seed. Then
read the metrics (with `trace`, the per-layer ones, which may render more
frames), free the port's state, and hold a sample of the window's frames
against the reference.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import os
import random
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def frame_seed(run_seed: int, i: int) -> int:
    """The seed of frame `i` of a run (i = -1 is the warm frame): 63 bits
    of a hash of both, so no two frames of a run, or of two runs, repeat."""
    h = hashlib.blake2b(f"{run_seed}/{i}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def cell_metrics(spec: dict, cell: str, kind: str) -> List[dict]:
    """The metrics of `kind` ("end_to_end" or "per_layer") that `cell`
    reports: those that list it, and those that list no cells."""
    return [m for m in spec[kind]
            if cell in m.get("workloads", [cell])]


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(bench: str, name: str):
    return load_module(os.path.join(bench, "metrics", name + ".py"),
                       "benchmark_metric_" + name.replace(".", "_"))


@dataclass
class FrameRecord:
    index: int
    seed: int
    start: float
    end: float
    segments: int
    ok: bool


@dataclass
class Window:
    frames: List[FrameRecord] = field(default_factory=list)

    @property
    def good(self) -> List[FrameRecord]:
        return [f for f in self.frames if f.ok]

    @property
    def seconds(self) -> float:
        return self.frames[-1].end - self.frames[0].start


class Run:
    """What the metric readers see of one run."""

    def __init__(self, cell, config, traffic, seed, device, records, scene):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed = seed
        self.device = torch.device(device)
        self.records = records
        self.scene = scene
        self.window = Window()
        self.setup_s = None
        self.state = {}            # readers' own notes between their hooks
        self._next = 0             # index of the next frame to render
        self._profile = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def render_frame(self, index: Optional[int] = None):
        """One frame of the cell through the timed entry, the port's
        `render()`, with the driver and chunk size at their defaults."""
        from potato_tpu_torch.render.renderer import render

        if index is None:
            index, self._next = self._next, self._next + 1
        t = self.traffic
        return render(self.scene, t["width"], t["height"], spp=t["spp"],
                      max_bounce=t["max_bounce"],
                      seed=frame_seed(self.seed, index), with_aovs=True,
                      device=str(self.device))

    def profile(self) -> dict:
        """`measure.trace_summary` of the traffic's `trace_frames` whole
        frames under torch.profiler, read in this process (taken once).
        Tracing slows the host's side of a frame (1.5x with the device's
        activity alone, 1.8-2.5x with the host's ops too), not the device's
        work: its busy time stands, its wall does not."""
        if self._profile is None:
            from torch.profiler import ProfilerActivity, profile

            from benchmark import measure

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.sync()
            with profile(activities=acts) as prof:
                h0 = time.perf_counter()
                for _ in range(self.traffic["trace_frames"]):
                    self.render_frame()
                self.sync()
                wall_ms = (time.perf_counter() - h0) * 1e3
            events = [{"ph": "X", "cat": category(e), "name": e.name(),
                       "ts": e.start_ns() / 1e3, "dur": e.duration_ns() / 1e3}
                      for e in prof.profiler.kineto_results.events()]
            del prof
            self._profile = measure.trace_summary(events, wall_ms, top_ops=10,
                                                  idle_gaps=10)
        return self._profile

    def frame_ms(self) -> float:
        """The window's mean frame time, untraced (host clock)."""
        return 1e3 * self.window.seconds / len(self.window.frames)


def category(event) -> str:
    """A profiler event's category as a Chrome trace names it, told by its
    device and its name (torch 2.11's events carry no category)."""
    name = event.name()
    if event.device_type() == torch.autograd.DeviceType.CUDA:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name.startswith("cuda"):
        return "cuda_runtime"
    if name.startswith("cu"):
        return "cuda_driver"
    return "cpu_op"


def finite(out) -> bool:
    return bool(np.isfinite(out.color).all() and np.isfinite(out.normal).all()
                and np.isfinite(out.coverage).all())


def measure_window(run: Run, seconds: float, keep: int, sample_seed: int):
    """Frames back to back until `seconds` have passed since the first
    began. Returns the kept sample: `keep` frames drawn uniformly from the
    window's good frames by reservoir sampling, seeded from the run's
    seed, as (frame record, host output)."""
    rng = random.Random(sample_seed)
    sample = []
    good = 0
    w0 = time.perf_counter()
    while True:
        i = run._next
        start = time.perf_counter()
        try:
            out = run.render_frame()
            ok = finite(out)
        except Exception:     # a frame that raises is a failed frame
            traceback.print_exc()
            out, ok = None, False
        end = time.perf_counter()
        rec = FrameRecord(i, frame_seed(run.seed, i), start, end,
                          out.segments if ok else 0, ok)
        run.window.frames.append(rec)
        if ok:
            if good < keep:
                sample.append((rec, out))
            else:
                j = rng.randrange(good + 1)
                if j < keep:
                    sample[j] = (rec, out)
            good += 1
        if end - w0 >= seconds:
            return sample


def reference_numbers(run_records, traffic, sample, device):
    """Each sampled frame against the reference's frame of the same seed;
    the worst reading of each number."""
    from benchmark import compare
    from benchmark.reference import pathtracer

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    scene = pathtracer.scene_tables(run_records, device)
    readings = []
    for rec, out in sample:
        want = pathtracer.render(scene, traffic["width"], traffic["height"],
                                 traffic["spp"], traffic["max_bounce"],
                                 rec.seed)
        readings.append(compare.frame_numbers(out, want))
    return compare.worst(readings)


def build_run(cell_name, seed, device, bench=BENCH, spec=None) -> Run:
    """The records, the port's scene and the run object of a cell."""
    from benchmark import port_scene

    spec = spec or load_json(os.path.join(os.path.dirname(bench),
                                          "BENCHMARK.json"))
    cell = next((w for w in spec["workloads"] if w["name"] == cell_name),
                None)
    if cell is None:
        raise SystemExit(f"no workload named {cell_name!r} in BENCHMARK.json")
    config = load_json(os.path.join(bench, "configs", cell["config"] + ".json"))
    traffic = load_json(os.path.join(bench, "traffic",
                                     cell["traffic"] + ".json"))
    builder = load_module(os.path.join(bench, "scenes",
                                       config["builder"] + ".py"),
                          "benchmark_scene_" + config["builder"])
    records = builder.records(config)
    scene = port_scene.build(records, device)
    return Run(cell, config, traffic, seed, device, records, scene)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             bench: str = BENCH) -> dict:
    """One run of one cell; returns the result line's object."""
    if t_start is None:
        t_start = time.perf_counter()
    os.environ.pop("POTATO_METRICS", None)   # render() would log to it
    spec = load_json(os.path.join(os.path.dirname(bench), "BENCHMARK.json"))
    run = build_run(cell_name, seed, device, bench, spec)
    dev = run.device
    limits = load_json(os.path.join(bench, "limits", cell_name + ".json"))
    kind = "per_layer" if trace else "end_to_end"
    metrics = cell_metrics(spec, cell_name, kind)
    readers = {m["name"]: metric_reader(bench, m["name"]) for m in metrics}

    run.render_frame(-1)                     # the warm frame
    run.sync()
    run.setup_s = time.perf_counter() - t_start
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    for r in readers.values():
        if hasattr(r, "before_window"):
            r.before_window(run)
    sample = measure_window(run, seconds, run.traffic["check_frames"],
                            frame_seed(seed, -2))
    for r in readers.values():
        if hasattr(r, "after_window"):
            r.after_window(run)

    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1,
    }
    result = {"correct": False, "attempted": len(run.window.frames),
              "failed": sum(not f.ok for f in run.window.frames),
              "metrics": values, "device": device_info}
    if trace:
        p = run.profile()
        device_info["busy_s"] = (p["device_busy_ms"] or 0.0) / 1e3
        device_info["window_s"] = p["wall_ms"] / 1e3
        print(f"traced wall {p['wall_ms']:.1f} ms for "
              f"{run.traffic['trace_frames']} frame(s); untraced "
              f"{run.frame_ms():.1f} ms a frame", file=sys.stderr)
        result["breakdown"] = {
            "device_ops": [[o["name"], o["ms"] / 1e3]
                           for o in p["top_device_ops"]],
            "idle_gaps": [[g["host_op"] or "none", g["ms"] / 1e3]
                          for g in p["idle_gaps"]],
        }
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
    device_info["memory_peak_bytes"] = int(peak)

    # the port's state goes before the reference runs
    records, traffic = run.records, run.traffic
    del run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    from benchmark import compare

    if sample:
        numbers = reference_numbers(records, traffic, sample, dev)
    else:
        numbers = {n: 100.0 for n in compare.NAMES}
    ok, checks = compare.judge(numbers, limits)
    result["correct"] = bool(ok and result["failed"] == 0 and sample)
    result["checks"] = checks
    return result


FORBIDDEN = ("jax", "jaxlib", "flax", "potato_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (so `potato_tpu_torch` is not `potato_tpu`)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json "
                                 "on this machine's card and print its result "
                                 "as the last line of standard output.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        print(f"no workload named {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print("JAX or the JAX package was loaded: " + ", ".join(found),
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
