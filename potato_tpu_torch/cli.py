"""Command-line renderer.

    python -m potato_tpu_torch.cli render --scene more_balls --width 800 \
        --height 600 --spp 4 --max-bounce 8 --output output.tga
    python -m potato_tpu_torch.cli list-scenes
    python -m potato_tpu_torch.cli bench --scene more_balls

Every command that renders runs on the card (`--device cuda`, the default)
and raises without one; `--device cpu` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="bunny", help="scene name (see list-scenes)")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--spp", type=int, default=4, help="samples per pixel")
    p.add_argument("--max-bounce", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--accel",
                   choices=["auto", "flash", "pallas", "dense", "cluster",
                            "brute"],
                   default="auto",
                   help="acceleration structure (auto = flash, the "
                        "hand-written kernel's path; pallas is another "
                        "name for it; dense = matrix products, cluster = "
                        "Morton clusters, brute = every primitive)")
    p.add_argument("--no-progress", action="store_true",
                   help="single-dispatch render without per-chunk progress")
    p.add_argument("--cluster-size", type=int, default=64,
                   help="primitives per cluster of --accel cluster")
    p.add_argument("--chunk-size", type=int, default=None,
                   help="rays per chunk (default: min(total, 2^15))")
    p.add_argument("--driver", choices=["auto", "chunked", "compact"],
                   default="auto",
                   help="frame driver: chunked (per-chunk bounce loops) or "
                        "compact (breadth-first with live-ray compaction). "
                        "auto = per-scene policy (compact where a "
                        "dielectric is present). Progress/checkpoint "
                        "renders always use chunked.")
    p.add_argument("--no-jitter", action="store_true",
                   help="regular-grid pixel sampling instead of jittered")
    p.add_argument("--assets", default=None, help="assets directory override")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="write structured JSONL metrics (render_start/"
                        "chunk/render_complete) to PATH ('-' = stderr; "
                        "POTATO_METRICS env also works)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda, which raises without "
                        "a card; cpu runs the plain PyTorch path)")


def _build_scene(args):
    from potato_tpu_torch.scene import examples

    make = examples.SCENES[args.scene]
    kw = {}
    if args.assets and "assets_dir" in inspect.signature(make).parameters:
        kw["assets_dir"] = args.assets
    return make(**kw).build(accel=args.accel, device=args.device,
                            cluster_size=args.cluster_size)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="potato_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_render = sub.add_parser("render", help="render a scene to a TGA file")
    _add_render_args(p_render)
    p_render.add_argument("--output", default="output.tga")
    p_render.add_argument("--aov-normal", default=None,
                          help="also write the first-hit normal AOV here")
    p_render.add_argument("--alpha-coverage", action="store_true",
                          help="write foreground coverage into alpha")

    sub.add_parser("list-scenes", help="list available scenes")

    p_bench = sub.add_parser("bench", help="timed render, prints rays/s")
    _add_render_args(p_bench)

    args = parser.parse_args(argv)

    from potato_tpu_torch.scene import examples

    if args.command == "list-scenes":
        for name in examples.SCENES:
            print(name)
        return 0

    if args.scene not in examples.SCENES:
        print(f"unknown scene {args.scene!r}; try list-scenes", file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from potato_tpu_torch.core import color as pcolor
    from potato_tpu_torch.io import tga
    from potato_tpu_torch.render.renderer import render
    from potato_tpu_torch.utils.metrics import MetricsLogger

    t0 = time.time()
    scene = _build_scene(args)
    print(f"scene build: {time.time() - t0:.2f}s "
          f"({scene.num_triangles} tris, {scene.num_spheres} spheres)",
          file=sys.stderr)

    # bench times a single-dispatch frame; render shows per-chunk progress
    show_progress = args.command == "render" and not args.no_progress
    with MetricsLogger(args.metrics) as metrics:
        t0 = time.time()
        out = render(scene, args.width, args.height, spp=args.spp,
                     max_bounce=args.max_bounce, seed=args.seed,
                     chunk_size=args.chunk_size, progress=show_progress,
                     jitter=not args.no_jitter,
                     metrics=metrics if args.metrics else None,
                     driver=None if args.driver == "auto" else args.driver,
                     device=args.device)
        dt = time.time() - t0
    print(f"Rendering done in {dt:.2f} seconds "
          f"({out.segments / dt / 1e6:.1f}M rays/s)", file=sys.stderr)

    if args.command == "bench":
        dev = scene.device
        print(json.dumps({
            "rays_per_s": out.segments / dt, "seconds": dt,
            "segments": out.segments,
            "device": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else str(dev)}))
        return 0

    rgba = out.srgb()
    if args.alpha_coverage:
        rgba[..., 3] = (255.0 * out.coverage).astype(np.uint8)
    tga.save(rgba, args.output)
    print(f"wrote {args.output}", file=sys.stderr)

    if args.aov_normal:
        normal01 = torch.from_numpy(0.5 * out.normal + 0.5)
        tga.save(pcolor.to_u8(normal01).numpy(), args.aov_normal)
        print(f"wrote {args.aov_normal}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
