"""`cornell_box` (Shirley, Black and Hollasch, *Ray Tracing: The Next Week*,
v4, `cornell_box()` of its chapters "Lights" and "Instances"): five walls,
an area light and two turned blocks, all quads, as triangles.

The configuration's file gives the book's numbers: camera, materials, the
quads (corner Q, edges u and v) and the boxes (corners a and b, then
`rotate_y` in degrees, then `translate`). Each quad becomes the triangles
(Q, Q+u, Q+u+v) and (Q, Q+u+v, Q+v). A box's six sides are the book's
`box()` sides in its order, each corner turned as `rotate_y` maps object
space to world space and moved, in float64, then cast to float32.

The book's quads are two-sided; the Lambert of the path tracer under test
culls back faces. So each quad's normal points to the side a ray reaches
it from: a wall's or the light's towards the room's centre, a block's
side away from the block's centre.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.records import Camera, Emit, Material, Mesh, SceneRecords


def _unit_normal(u, v, away_from):
    """cross(u, v) made unit, turned to point away from `away_from`
    (a vector from the quad towards the point it must face away from)."""
    n = np.cross(u, v)
    n = n / np.linalg.norm(n)
    return -n if float(np.dot(n, away_from)) > 0.0 else n


def _corners(q, u, v):
    return [q, q + u, q + u + v, q + v]


def _box_sides(a, b):
    """The book's `box(a, b)`: (corner, u, v) of its sides front, right,
    back, left, top, bottom."""
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    dx = np.array([hi[0] - lo[0], 0.0, 0.0])
    dy = np.array([0.0, hi[1] - lo[1], 0.0])
    dz = np.array([0.0, 0.0, hi[2] - lo[2]])
    return [(np.array([lo[0], lo[1], hi[2]]), dx, dy),
            (np.array([hi[0], lo[1], hi[2]]), -dz, dy),
            (np.array([hi[0], lo[1], lo[2]]), -dx, dy),
            (np.array([lo[0], lo[1], lo[2]]), dz, dy),
            (np.array([lo[0], hi[1], hi[2]]), dx, -dz),
            (np.array([lo[0], lo[1], lo[2]]), dx, dz)]


def _rotate_y(degrees):
    """Object space to world space as the book's `rotate_y` maps a hit
    point back: x' = cos x + sin z, z' = -sin x + cos z."""
    th = math.radians(degrees)
    c, s = math.cos(th), math.sin(th)
    return lambda p: np.array([c * p[0] + s * p[2], p[1],
                               -s * p[0] + c * p[2]])


def _mesh(faces, material: int) -> Mesh:
    """Faces of (four float64 corners, normal) as one mesh of two
    triangles a face."""
    pos, nrm, idx = [], [], []
    for k, (corners, n) in enumerate(faces):
        pos.extend(corners)
        nrm.extend([n] * 4)
        base = 4 * k
        idx.extend([(base, base + 1, base + 2), (base, base + 2, base + 3)])
    uv = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)] * len(faces)
    return Mesh(positions=np.array(pos, np.float64).astype(np.float32),
                normals=np.array(nrm, np.float64).astype(np.float32),
                uvs=np.array(uv, np.float32),
                indices=np.array(idx, np.int32), material=material)


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
    ids = {}
    for name, kind in cfg["materials"].items():
        (what, color), = kind.items()
        ids[name] = len(rec.materials)
        if what == "lambertian":
            rec.materials.append(Material("lambert", absorb="albedo",
                                          absorb_color=tuple(color)))
        elif what == "diffuse_light":
            rec.materials.append(Material("none", absorb="black_body",
                                          emit=Emit("color", tuple(color))))
        else:
            raise ValueError(f"material kind {what!r}")

    # the book's order of world.add(); consecutive faces of one material
    # share a mesh
    quads = [[np.asarray(x[k], np.float64) for k in ("Q", "u", "v")]
             for x in cfg["quads"]]
    room = np.concatenate([_corners(*q) for q in quads])
    room_centre = 0.5 * (room.min(axis=0) + room.max(axis=0))
    faces = []
    for (q, u, v), quad in zip(quads, cfg["quads"]):
        n = _unit_normal(u, v, q - room_centre)
        faces.append((quad["material"], _corners(q, u, v), n))
    for box in cfg["boxes"]:
        a, b = (np.asarray(box[k], np.float64) for k in ("a", "b"))
        centre = 0.5 * (a + b)
        turn = _rotate_y(box["rotate_y"])
        move = np.asarray(box["translate"], np.float64)
        for q, u, v in _box_sides(a, b):
            n = _unit_normal(u, v, centre - q)
            faces.append((box["material"],
                          [turn(p) + move for p in _corners(q, u, v)],
                          turn(n)))
    groups = []
    for mat, corners, n in faces:
        if not groups or groups[-1][0] != mat:
            groups.append((mat, []))
        groups[-1][1].append((corners, n))
    rec.meshes = [_mesh(fs, ids[mat]) for mat, fs in groups]
    return rec
