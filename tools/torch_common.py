"""What the port's profilers (tools/torch_*.py) share: the device rule, the
scenes by name with their stand-in assets, whole-frame measurement, gates
and the one JSON line each prints.

Every profiler drives potato_tpu_torch (never JAX or potato_tpu) on the
card unless the caller passes device="cpu" (`--device cpu`), has an
importable `run(..., device="cuda")` and a `main()` that parses arguments
and prints one JSON line. Timing marks are chip_smoke_ranks.py's (CUDA
events on the card, the host clock on the CPU); device times of single
launches are chip_smoke.py's `device_ms`. The asset scenes (bunny,
glass_bunny, earth) read chip_smoke.py's stand-ins (a 5 120-triangle
icosphere as bunny.obj / bunny_flat.obj, a procedural 1024x512
earthmap.tga) unless `--assets DIR` names a directory of real files.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from functools import partial
from typing import Callable, Dict, Iterable, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:        # run as a script: the repository's root
    sys.path.insert(0, REPO)

import torch  # noqa: E402

from potato_tpu_torch.core.types import resolve_device  # noqa: E402
from potato_tpu_torch.ops import flash  # noqa: E402
from potato_tpu_torch.render import renderer  # noqa: E402
from potato_tpu_torch.render.camera import generate_rays  # noqa: E402
from potato_tpu_torch.render.integrator import (  # noqa: E402
    init_state,
    make_bounce_step,
)
from potato_tpu_torch.scene import examples  # noqa: E402

from chip_smoke import device_ms, gpu_line, write_earthmap  # noqa: E402
from chip_smoke import write_standin_assets  # noqa: E402
from chip_smoke_ranks import elapsed_ms, event, sync  # noqa: E402

# the full-size workload of the repository's frames
FRAME = dict(width=800, height=600, spp=4, max_bounce=8)
SEED = 7
ASSET_SCENES = ("bunny", "glass_bunny", "earth")
OUT_DIR = os.path.join(REPO, "chiprun_out")


def device_of(device) -> torch.device:
    """The device a profiler was asked for; a card that is not there
    raises (nothing falls back to the CPU)."""
    return resolve_device(device)


def card(device) -> dict:
    """The device every number of a report was taken on."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"type": "cpu", "name": "cpu", "card": None}
    return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
            "card": gpu_line(), "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


@contextlib.contextmanager
def asset_dir(assets: Optional[str] = None):
    """The directory the asset scenes read: `assets` itself where given,
    else a temporary one holding chip_smoke.py's stand-ins."""
    if assets:
        yield assets
        return
    with tempfile.TemporaryDirectory(prefix="potato_tool_assets_") as tmp:
        write_standin_assets(tmp)
        write_earthmap(tmp)
        yield tmp


def factory(name: str, assets: str) -> Callable:
    """A picklable zero-argument SceneBuilder factory for scene `name`."""
    make = examples.SCENES[name]
    return partial(make, assets) if name in ASSET_SCENES else make


def build_scenes(names: Iterable[str], assets: str, device) -> dict:
    return {n: factory(n, assets)().build(accel="flash", device=device)
            for n in names}


def assets_label(assets: Optional[str]) -> str:
    return assets if assets else "stand-ins (chip_smoke.py)"


def measure_in_turns(scene, cells: List[dict], *, width: int, height: int,
                     spp: int, seed: int, frames: int, device):
    """Whole frames of one scene in several settings, timed in turns.

    Each cell is a dict of render()'s `driver` (None: the scene's default),
    `chunk_size` (None: the default) and `max_bounce`. Every cell renders
    one warm frame through render() (its image comes back for the gates);
    then `frames` rounds, each timing one frame of every cell in turn
    through compile_frame between two marks, so that a change in the
    host's load falls on every cell alike. Returns (rows, images): per cell
    its settings, ms and segments a frame, the best frame's segments/s,
    kernel launches a frame, passes a bounce (compact) and peak device
    memory over its timed frames (the card only)."""
    dev = torch.device(device)
    rows, images, fns = [], [], []
    for cell in cells:
        driver = cell.get("driver") or renderer.default_driver(scene)
        kw = dict(spp=spp, max_bounce=cell["max_bounce"],
                  chunk_size=cell.get("chunk_size"), driver=driver,
                  device=dev)
        images.append(renderer.render(scene, width, height, seed=seed, **kw))
        fns.append(renderer.compile_frame(scene, width, height, **kw))
        rows.append({"driver": driver, "max_bounce": cell["max_bounce"],
                     "chunk_size": min(cell.get("chunk_size")
                                       or renderer.DEFAULT_CHUNK,
                                       width * height * spp),
                     "frame_ms": [], "segments": [],
                     "launches_per_frame": [], "peak_mib": None})
    for _ in range(frames):
        for row, (fn, starts) in zip(rows, fns):
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            before = flash.flash_intersect_kernel.launches
            a = event(dev)
            out = fn(scene.tables, scene.camera, seed, starts)
            b = event(dev)
            sync(dev)
            row["launches_per_frame"].append(
                flash.flash_intersect_kernel.launches - before)
            row["frame_ms"].append(elapsed_ms(a, b))
            row["segments"].append(int(out.segments.sum()))
            if dev.type == "cuda":
                row["peak_mib"] = max(row["peak_mib"] or 0.0,
                                      torch.cuda.max_memory_allocated(dev)
                                      / 2 ** 20)
            del out
    for row, (fn, _) in zip(rows, fns):
        ms, segs = row["frame_ms"], row["segments"]
        row["best_ms"] = min(ms) if ms else None
        row["segments_per_s"] = max(
            (s / (m / 1e3) for s, m in zip(segs, ms)), default=None)
        row["passes_per_bounce"] = (list(fn.passes)
                                    if row["driver"] == "compact" else None)
    return rows, images


def launch_ms(launch, device, reps=20) -> float:
    """ms of one launch(): device time behind a spinning kernel on the
    card (chip_smoke.py's device_ms), the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        return device_ms(launch, reps)
    launch()
    t0 = time.perf_counter()
    for _ in range(reps):
        launch()
    return (time.perf_counter() - t0) * 1e3 / reps


def chunk_rays(scene, *, width: int, height: int, spp: int, seed: int,
               n: int, bounce: int):
    """The rays of a frame's middle chunk of `n` ids: its camera rays
    (bounce 0) or the rays one bounce step of the integrator sends on
    (bounce 1; retired lanes carry t_max < t_min). Returns (rays, live
    share)."""
    total = width * height * spp
    start = (total // n // 2) * n
    ids, live = renderer.chunk_ray_ids(start, n, width, height, spp,
                                       scene.device)
    rays = generate_rays(scene.camera, width, height, spp, ids, seed,
                         lens=scene.features.has_lens)
    state = init_state(rays, live=live)
    if bounce:
        step = make_bounce_step(scene.tables,
                                renderer.make_intersect_fn(scene), seed,
                                features=scene.features, aovs=False)
        state = step(state, 0, ids)
    return state.rays, float(state.active.float().mean())


class Gates:
    """The gates of one profiler run: each with its reading and limit."""

    def __init__(self):
        self.rows: List[dict] = []

    def __call__(self, name: str, reading, ok: bool, limit) -> bool:
        self.rows.append({"name": name, "reading": str(reading),
                          "limit": str(limit), "ok": bool(ok)})
        return bool(ok)

    @property
    def ok(self) -> bool:
        return all(r["ok"] for r in self.rows)


def report(tool: str, device, gates: Gates, **fields) -> dict:
    return {"tool": tool, "device": card(device), **fields,
            "gates": gates.rows, "ok": gates.ok}


def parser(doc: str, frames: Optional[int] = None, depth: bool = True
           ) -> argparse.ArgumentParser:
    """The arguments every profiler takes: `--max-bounce` where the depth
    is not the sweep, `--frames` where frames are timed."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--assets", default=None,
                    help="directory of earthmap.tga / bunny.obj / "
                         "bunny_flat.obj (default: stand-ins)")
    for name, value in FRAME.items():
        if depth or name != "max_bounce":
            ap.add_argument("--" + name.replace("_", "-"), type=int,
                            default=value)
    ap.add_argument("--seed", type=int, default=SEED)
    if frames is not None:
        ap.add_argument("--frames", type=int, default=frames,
                        help="timed frames a cell, after a warm one")
    return ap


def ints(text: str) -> List[int]:
    """'16384,32768' -> [16384, 32768]."""
    return [int(x) for x in text.split(",") if x]


def names(text: str) -> List[str]:
    return [x for x in text.split(",") if x]


def frame_args(opts) -> Dict[str, int]:
    """The frame's size and seed, and its depth where it was an argument."""
    keys = ("width", "height", "spp", "max_bounce", "seed")
    return {k: getattr(opts, k) for k in keys if hasattr(opts, k)}


def emit(rep: dict) -> int:
    """Print the report as one JSON line; exit code 0 when every gate
    held."""
    print(json.dumps(rep), flush=True)
    return 0 if rep["ok"] else 1
