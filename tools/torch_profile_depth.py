#!/usr/bin/env python3
"""Frame time against path depth (max_bounce), on the card.

    python3 tools/torch_profile_depth.py                     # full sweep
    python3 tools/torch_profile_depth.py --device cpu --width 16 \
        --height 16 --spp 1 --depths 1,2                      # rehearsal

The port's counterpart of tools/profile_depth.py: what each bounce of
depth costs a whole frame, on each scene's default driver at the default
chunk (the early-exit bounce loop stops a chunk, or the compact driver a
bounce, once no ray is live). Every (scene, depth) cell renders one warm
frame through render(); then the cells of a scene are timed in turns,
`--frames` rounds through compile_frame (the best kept): ms/frame, the
increment over the previous depth, segments/s, kernel launches a frame,
passes a bounce (compact) and peak device memory.

Gate: segments a frame do not fall as the depth grows (a deeper frame
traces every segment of a shallower one). A miss is reported in the JSON
line and the exit code is 1.
"""

from __future__ import annotations

import os
import sys

if os.path.dirname(os.path.abspath(__file__)) not in sys.path:
    sys.path.append(os.path.dirname(os.path.abspath(__file__)))

from torch_common import (  # noqa: E402
    Gates, asset_dir, assets_label, build_scenes, device_of, emit,
    frame_args, ints, measure_in_turns, names, parser, report)

SCENES = ("more_balls", "glass_bunny", "bunny")
DEPTHS = (1, 2, 3, 4, 8)


def run(scenes=SCENES, depths=DEPTHS, *, width=800, height=600, spp=4,
        seed=7, frames=2, assets=None, device="cuda") -> dict:
    """Each scene at each depth, on its default driver and chunk. Returns
    the report (cells, gates)."""
    dev = device_of(device)
    gates = Gates()
    cells = []
    with asset_dir(assets) as adir:
        built = build_scenes(scenes, adir, dev)
    for name, scene in built.items():
        rows, images = measure_in_turns(
            scene, [dict(max_bounce=d) for d in depths], width=width,
            height=height, spp=spp, seed=seed, frames=frames, device=dev)
        previous = None
        for row, image in zip(rows, images):
            row["ms_over_previous_depth"] = (
                row["best_ms"] - previous["best_ms"]
                if previous and row["best_ms"] is not None else None)
            cells.append({"scene": name, **row,
                          "image_segments": image.segments})
            previous = row
        segs = [image.segments for image in images]
        gates(f"{name}: segments a frame do not fall with depth "
              f"{list(depths)}", segs,
              all(a <= b for a, b in zip(segs, segs[1:])), "non-decreasing")
    launches = sum(sum(c["launches_per_frame"]) for c in cells)
    return report("torch_profile_depth", dev, gates,
                  workload=dict(width=width, height=height, spp=spp,
                                seed=seed, assets=assets_label(assets)),
                  cells=cells, launches=launches)


def main(argv=None) -> int:
    ap = parser(__doc__, frames=2, depth=False)
    ap.add_argument("--scenes", type=names, default=list(SCENES))
    ap.add_argument("--depths", type=ints, default=list(DEPTHS))
    opts = ap.parse_args(argv)
    return emit(run(opts.scenes, opts.depths, frames=opts.frames,
                    assets=opts.assets, device=opts.device,
                    **frame_args(opts)))


if __name__ == "__main__":
    sys.exit(main())
