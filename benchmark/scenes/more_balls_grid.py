"""`more_balls` (example_scenes.rs:63-138 of the path tracer the port follows):
four large spheres on a checkered ground, and a grid of small spheres laid
out draw for draw from ChaCha12 `StdRng::from_seed([seed; 32])`.

The configuration's file gives the grid's extent and the layout seed.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.records import Camera, Emit, Material, SceneRecords, Texture
from benchmark.scenes.stdrng import StdRng


def records(cfg: dict) -> SceneRecords:
    rec = SceneRecords(
        camera=Camera(aspect_ratio=1.0, fov=math.pi / 2, focal_dist=7.5,
                      lens_radius=0.02, position=(6.0, 2.0, 4.0),
                      target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)),
        background=Emit("sky_gradient"))
    rec.textures = [Texture("checker", children=(1, 2)),
                    Texture("solid", (0.2, 0.3, 0.1)),
                    Texture("solid", (0.9, 0.9, 0.9))]
    rec.materials = [
        Material("lambert", absorb="albedo_map", absorb_texture=0),
        Material("lambert", absorb="albedo", absorb_color=(0.1, 0.2, 0.5)),
        Material("metal", 0.0, absorb="albedo", absorb_color=(0.8, 0.6, 0.2)),
        Material("dielectric", 1.5, absorb="white_body"),
    ]
    centers = [(0.0, -1000.0, -1.0), (-4.0, 1.8, 0.0), (4.0, 1.8, 0.0),
               (0.0, 1.8, 0.0)]
    radii = [1000.0, 1.8, 1.8, 1.8]
    mats = [0, 1, 2, 3]

    # draw order of the source: radius, x and z offsets, three albedo
    # components (drawn for glass too), then one or two Bernoullis and a
    # fuzz for metal
    rng = StdRng(bytes([cfg["layout_seed"] & 0xFF]) * 32)
    lo, hi = cfg["grid_min"], cfg["grid_max"]
    for x in range(lo, hi):
        for z in range(lo, hi):
            if z == 0:
                continue
            radius = rng.closed_range(0.1, 0.3)
            center = (x + rng.closed_range(-0.5 + radius, 0.5 - radius),
                      radius,
                      z + rng.closed_range(-0.5 + radius, 0.5 - radius))
            albedo = (rng.gen_f64(), rng.gen_f64(), rng.gen_f64())
            if rng.bernoulli(0.7):
                mat = Material("lambert", absorb="albedo", absorb_color=albedo)
            elif rng.bernoulli(0.7):
                mat = Material("metal", rng.gen_f64(), absorb="albedo",
                               absorb_color=albedo)
            else:
                mat = Material("dielectric", 1.5, absorb="white_body")
            rec.materials.append(mat)
            centers.append(center)
            radii.append(radius)
            mats.append(len(rec.materials) - 1)
    rec.sphere_center = np.asarray(centers, np.float64)
    rec.sphere_radius = np.asarray(radii, np.float64)
    rec.sphere_material = np.asarray(mats, np.int64)
    return rec
