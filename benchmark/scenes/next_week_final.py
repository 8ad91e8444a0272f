"""`next_week_final` (Shirley, Black and Hollasch, *Ray Tracing: The Next
Week*, v4, `final_scene(800, 10000, 40)` of its chapter "A Scene Testing All
New Features"): a floor of 20x20 boxes, an area light, six large spheres and
a turned cloud of 1 000 small ones, as triangles and spheres.

The configuration's file gives the book's numbers: camera, textures,
materials, the floor (box (i, j) spans x0 + w i .. x0 + w (i + 1), z0 + w j
.. z0 + w (j + 1), from y = 0 to a random height), the light quad, the
spheres, and the cloud (centres in [0, extent)^3, turned by `rotate_y` in
degrees, then moved by `translate`). Random numbers come from
`numpy.random.default_rng(layout_seed)`, one draw at a time in the book's
order: the 400 heights, box (i, j) with i outer, then each cloud centre's
x, y and z.

Each box is the book's `box(a, b)`, six sides in its order, each quad the
triangles (Q, Q+u, Q+u+v) and (Q, Q+u+v, Q+v) with its normal pointing
away from the box's centre (the Lambert of the path tracer under test culls
back faces); the light's normal points the way the configuration's `faces`
says. The book's departures that the records cannot express (its media,
motion blur, `earthmap.jpg`, the marble's turbulence) are the
configuration's `reduced` and `assumed`: the earth sphere samples
`earth_image()`, the marble the records' `perlin` kind.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.records import Camera, Emit, Material, SceneRecords, Texture
from benchmark.scenes.cornell_box import (
    _box_sides,
    _corners,
    _mesh,
    _rotate_y,
    _unit_normal,
)


def earth_image(width: int, height: int) -> np.ndarray:
    """The stand-in for `earthmap.jpg`: (height, width, 3) float32 RGB in
    [0, 1], oceans and continents from a few sines of longitude and
    latitude, ice at the poles, computed in float64, then cast."""
    v, u = np.mgrid[0:height, 0:width].astype(np.float64)
    lon = 2.0 * np.pi * (u + 0.5) / width
    lat = np.pi * ((v + 0.5) / height - 0.5)
    land = (np.sin(3.0 * lon + 1.0) * np.cos(2.0 * lat)
            + 0.5 * np.sin(5.0 * lon - 3.0 * lat + 2.0)
            + 0.25 * np.cos(9.0 * lon + 4.0 * lat))
    coast = np.clip(0.5 + 2.0 * land, 0.0, 1.0)[..., None]
    ocean = np.array([0.05, 0.15, 0.45])
    ground = np.array([0.25, 0.45, 0.15])
    img = ocean + coast * (ground - ocean)
    ice = np.clip((np.abs(lat) - 1.2) / 0.2, 0.0, 1.0)[..., None]
    img = img + ice * (0.9 - img)
    return img.astype(np.float32)


def _box_faces(a, b):
    """The six (corners, normal) of the book's `box(a, b)`."""
    centre = 0.5 * (a + b)
    return [(_corners(q, u, v), _unit_normal(u, v, centre - q))
            for q, u, v in _box_sides(a, b)]


def records(cfg: dict) -> SceneRecords:
    if cfg["defocus_angle"] != 0 or any(cfg["background"]):
        raise ValueError("the records take a pinhole camera and a black "
                         "background only")
    rec = SceneRecords(
        camera=Camera(aspect_ratio=float(cfg["aspect_ratio"]),
                      fov=math.radians(cfg["vfov"]),
                      focal_dist=float(cfg["focus_dist"]), lens_radius=0.0,
                      position=tuple(cfg["lookfrom"]),
                      target=tuple(cfg["lookat"]), up=tuple(cfg["vup"])),
        background=Emit("none"))
    tex_ids = {}
    for name, kind in cfg["textures"].items():
        (what, params), = kind.items()
        tex_ids[name] = len(rec.textures)
        if what == "image":
            rec.textures.append(Texture("image", image=earth_image(
                params["width"], params["height"])))
        elif what == "perlin":
            rec.textures.append(Texture("perlin", seed=int(params["seed"])))
        else:
            raise ValueError(f"texture kind {what!r}")
    ids = {}
    for name, kind in cfg["materials"].items():
        (what, arg), = kind.items()
        ids[name] = len(rec.materials)
        if what == "lambertian":
            m = Material("lambert", absorb="albedo", absorb_color=tuple(arg))
        elif what == "lambertian_texture":
            m = Material("lambert", absorb="albedo_map",
                         absorb_texture=tex_ids[arg])
        elif what == "diffuse_light":
            m = Material("none", absorb="black_body",
                         emit=Emit("color", tuple(arg)))
        elif what == "dielectric":
            m = Material("dielectric", float(arg), absorb="white_body")
        elif what == "metal":
            m = Material("metal", float(arg["fuzz"]), absorb="albedo",
                         absorb_color=tuple(arg["albedo"]))
        else:
            raise ValueError(f"material kind {what!r}")
        rec.materials.append(m)

    rng = np.random.default_rng(cfg["layout_seed"])
    g = cfg["ground"]
    n, w = g["boxes_per_side"], float(g["box_width"])
    faces = []
    for i in range(n):
        for j in range(n):
            x0 = g["x0"] + w * i
            z0 = g["z0"] + w * j
            y1 = rng.uniform(g["height_min"], g["height_max"])
            faces += _box_faces(np.array([x0, 0.0, z0]),
                                np.array([x0 + w, y1, z0 + w]))
    rec.meshes.append(_mesh(faces, ids[g["material"]]))
    light = cfg["light"]
    q, u, v = (np.asarray(light[k], np.float64) for k in ("Q", "u", "v"))
    away = -np.asarray(light["faces"], np.float64)
    rec.meshes.append(_mesh([(_corners(q, u, v), _unit_normal(u, v, away))],
                            ids[light["material"]]))

    centres = [np.asarray(s["center"], np.float64) for s in cfg["spheres"]]
    radii = [float(s["radius"]) for s in cfg["spheres"]]
    mats = [ids[s["material"]] for s in cfg["spheres"]]
    cloud = cfg["sphere_cloud"]
    turn = _rotate_y(cloud["rotate_y"])
    move = np.asarray(cloud["translate"], np.float64)
    for _ in range(cloud["count"]):
        p = np.array([rng.uniform(0.0, cloud["extent"]) for _ in range(3)])
        centres.append(turn(p) + move)
        radii.append(float(cloud["radius"]))
        mats.append(ids[cloud["material"]])
    rec.sphere_center = np.asarray(centres, np.float64)
    rec.sphere_radius = np.asarray(radii, np.float64)
    rec.sphere_material = np.asarray(mats, np.int64)
    return rec
