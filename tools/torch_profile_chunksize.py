#!/usr/bin/env python3
"""Frame time against chunk size, under both frame drivers, on the card.

    python3 tools/torch_profile_chunksize.py                 # full sweep
    python3 tools/torch_profile_chunksize.py --device cpu --width 16 \
        --height 16 --spp 1 --max-bounce 2 --chunks 128,256  # rehearsal

The port's counterpart of tools/profile_chunksize.py. The chunk is the
unit the frame drivers trace at a time (renderer.DEFAULT_CHUNK = 2^15):
a frame's cost is per launch (the frame is host-bound), so larger chunks
mean fewer passes and fewer launches a frame, at the price of device
memory. Every (scene, driver, chunk) cell renders one warm frame through
render(); then the cells of a scene are timed in turns, `--frames` rounds
through compile_frame (the best kept): ms/frame, segments/s, kernel
launches a frame, passes a bounce (compact) and peak device memory.

Gate: under each driver, every chunk size gives the same image and
segments bit for bit (every ray's randomness is a function of the seed and
its id alone). A miss is reported in the JSON line and the exit code is 1.
"""

from __future__ import annotations

import os
import sys

if os.path.dirname(os.path.abspath(__file__)) not in sys.path:
    sys.path.append(os.path.dirname(os.path.abspath(__file__)))

from torch_common import (  # noqa: E402
    Gates, asset_dir, assets_label, build_scenes, device_of, emit,
    frame_args, ints, measure_in_turns, names, parser, report)

from chip_smoke import same_image  # noqa: E402

SCENES = ("more_balls", "glass_bunny", "bunny")
CHUNKS = tuple(1 << s for s in range(14, 19))
DRIVERS = ("chunked", "compact")


def run(scenes=SCENES, chunks=CHUNKS, drivers=DRIVERS, *, width=800,
        height=600, spp=4, max_bounce=8, seed=7, frames=2, assets=None,
        device="cuda") -> dict:
    """Each scene under each driver at each chunk size. Returns the report
    (cells, gates)."""
    dev = device_of(device)
    gates = Gates()
    cells = []
    with asset_dir(assets) as adir:
        built = build_scenes(scenes, adir, dev)
    for name, scene in built.items():
        settings = [dict(driver=d, chunk_size=c, max_bounce=max_bounce)
                    for d in drivers for c in chunks]
        rows, images = measure_in_turns(
            scene, settings, width=width, height=height, spp=spp, seed=seed,
            frames=frames, device=dev)
        cells += [{"scene": name, **r} for r in rows]
        for i, (row, image) in enumerate(zip(rows, images)):
            j = i - i % len(chunks)        # the driver's first chunk size
            if i == j:
                continue
            same = same_image(image, images[j])
            gates(f"{name}, {row['driver']}: image and segments at chunk "
                  f"{row['chunk_size']} equal to chunk "
                  f"{rows[j]['chunk_size']}'s bit for bit",
                  f"{same}, segments {image.segments} / "
                  f"{images[j].segments}", same, True)
    launches = sum(sum(c["launches_per_frame"]) for c in cells)
    return report("torch_profile_chunksize", dev, gates,
                  workload=dict(width=width, height=height, spp=spp,
                                max_bounce=max_bounce, seed=seed,
                                assets=assets_label(assets)),
                  cells=cells, launches=launches)


def main(argv=None) -> int:
    ap = parser(__doc__, frames=2)
    ap.add_argument("--scenes", type=names, default=list(SCENES))
    ap.add_argument("--chunks", type=ints, default=list(CHUNKS))
    ap.add_argument("--drivers", type=names, default=list(DRIVERS))
    opts = ap.parse_args(argv)
    return emit(run(opts.scenes, opts.chunks, opts.drivers,
                    frames=opts.frames, assets=opts.assets,
                    device=opts.device, **frame_args(opts)))


if __name__ == "__main__":
    sys.exit(main())
