#!/usr/bin/env python3
"""Per-scene throughput matrix on the card: each scene on its default
driver at the full frame.

    python3 tools/torch_perf_scenes.py                       # all scenes
    python3 tools/torch_perf_scenes.py --out chiprun_out/perf_scenes.json
    python3 tools/torch_perf_scenes.py --device cpu --width 16 \
        --height 16 --spp 1 --max-bounce 2                    # rehearsal

The port's counterpart of tools/perf_scenes.py, with its fields:
segments/s (the reference's `rays_per_s_sustained`, live rays summed over
bounces per second, of the best frame), segments a frame, mean path length
(segments over camera rays), triangles, spheres, the sphere path (the
kernel's sphere phase above flash.SPH_BRUTE_MAX spheres, else the dense
test) and the driver; plus ms a frame, kernel launches a frame and the
card's name and power limit. Every scene renders one warm frame through
render() and `--frames` more through compile_frame (best of 3 by default).
bunny, glass_bunny and earth read chip_smoke.py's stand-ins unless
`--assets DIR` holds the real files.

Gates: a finite image, and at least one segment per camera ray. The report
is printed as one JSON line; `--out PATH` also writes it to a new file.
"""

from __future__ import annotations

import json
import os
import sys

if os.path.dirname(os.path.abspath(__file__)) not in sys.path:
    sys.path.append(os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from torch_common import (  # noqa: E402
    Gates, asset_dir, assets_label, build_scenes, device_of, emit,
    frame_args, measure_in_turns, names, parser, report)

from potato_tpu_torch.ops import flash  # noqa: E402

SCENES = ("bunny", "glass_bunny", "more_balls_optimized", "earth",
          "three_balls")


def run(scenes=SCENES, *, width=800, height=600, spp=4, max_bounce=8,
        seed=7, frames=3, assets=None, device="cuda") -> dict:
    """Each scene on its default driver. Returns the report (scenes,
    gates)."""
    dev = device_of(device)
    gates = Gates()
    rows = {}
    camera_rays = width * height * spp
    with asset_dir(assets) as adir:
        built = build_scenes(scenes, adir, dev)
    for name, scene in built.items():
        (row,), (image,) = measure_in_turns(
            scene, [dict(max_bounce=max_bounce)], width=width,
            height=height, spp=spp, seed=seed, frames=frames, device=dev)
        finite = bool(np.isfinite(image.color).all())
        gates(f"{name}: image finite, segments >= camera rays",
              f"{finite}, {image.segments}",
              finite and image.segments >= camera_rays,
              f"True, >= {camera_rays}")
        rows[name] = {
            "segments_per_s": row["segments_per_s"],
            "segments_per_frame": image.segments,
            "mean_path_length": image.segments / camera_rays,
            "num_triangles": scene.num_triangles,
            "num_spheres": scene.num_spheres,
            "sphere_path": ("kernel" if scene.num_spheres
                            > flash.SPH_BRUTE_MAX else "dense"),
            "driver": row["driver"],
            "frame_ms": row["frame_ms"],
            "launches_per_frame": row["launches_per_frame"],
            "passes_per_bounce": row["passes_per_bounce"]}
    return report("torch_perf_scenes", dev, gates,
                  workload=dict(width=width, height=height, spp=spp,
                                max_bounce=max_bounce, seed=seed,
                                frames=frames, best_of=frames,
                                assets=assets_label(assets)),
                  scenes=rows,
                  launches=sum(sum(r["launches_per_frame"])
                               for r in rows.values()))


def main(argv=None) -> int:
    ap = parser(__doc__, frames=3)
    ap.add_argument("--scenes", type=names, default=list(SCENES))
    ap.add_argument("--out", default=None,
                    help="also write the report to this new file")
    opts = ap.parse_args(argv)
    if opts.out and os.path.exists(opts.out):
        ap.error(f"--out {opts.out} exists; the matrix writes new files only")
    rep = run(opts.scenes, frames=opts.frames, assets=opts.assets,
              device=opts.device, **frame_args(opts))
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(rep, f, indent=2)
    return emit(rep)


if __name__ == "__main__":
    sys.exit(main())
