"""The example scene library, as data.

The example scenes (cameras, material/texture tables, geometry):

- `more_balls` reproduces its seeded random grid draw for draw:
  core/stdrng.py carries the ChaCha12 `StdRng` stream it is laid out with.
- `cornell_box` is the Cornell box of *Ray Tracing: The Next Week*, as
  triangles, and `next_week_final` that book's final scene without its
  media, motion blur and turbulence marble (boxes as triangles, spheres, a
  Perlin and a procedural image texture); the other scenes come from the
  upstream's example_scenes.rs.
- `glass_bunny` / `bunny`: the SkySphere environment is a procedurally
  generated equirect panorama (sun + horizon gradient) baked into an image
  texture.
- `earth`, `bunny` and `glass_bunny` read an asset (`earthmap.tga`,
  `bunny.obj`, `bunny_flat.obj`) from `assets_dir`, else from
  `POTATO_ASSETS`, else from `assets/`; without the file they raise
  FileNotFoundError.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Union

import numpy as np

from potato_tpu_torch.core.stdrng import StdRng
from potato_tpu_torch.io import obj, tga
from potato_tpu_torch.scene.description import (
    Absorb,
    Camera,
    Emit,
    Material,
    MeshData,
    Scatter,
    SceneBuilder,
    Texture,
)

ASSETS_DIR = os.environ.get("POTATO_ASSETS", "assets")

FRAC_PI_2 = np.pi / 2
FRAC_PI_4 = np.pi / 4


def procedural_sky_panorama(width: int = 512, height: int = 256) -> np.ndarray:
    """Equirect sky with horizon gradient + sun disc (sky_panorama.tga stand-in)."""
    v, u = np.mgrid[0:height, 0:width].astype(np.float32)
    u = (u + 0.5) / width
    v = (v + 0.5) / height
    # equirect -> direction (inverse of core.math.equirect_uv)
    phi = (0.5 - u) * 2.0 * np.pi
    theta = (v - 0.5) * np.pi  # -pi/2 (down) .. pi/2 (up)
    y = np.sin(theta)
    x = np.cos(theta) * np.cos(phi)
    z = np.cos(theta) * np.sin(phi)

    t = 0.5 * (y + 1.0)
    sky = ((1 - t)[..., None] * np.array([1.0, 1.0, 1.0])
           + t[..., None] * np.array([0.35, 0.55, 0.95]))
    sun_dir = np.array([0.45, 0.65, 0.6])
    sun_dir /= np.linalg.norm(sun_dir)
    cosang = x * sun_dir[0] + y * sun_dir[1] + z * sun_dir[2]
    sun = np.clip((cosang - 0.995) / 0.005, 0.0, 1.0) ** 2
    ground = np.clip(-y * 2.0, 0.0, 1.0)[..., None] * np.array([0.25, 0.22, 0.2])
    img = sky * (1 - np.clip(-y * 2, 0, 1))[..., None] + ground
    img = img + sun[..., None] * np.array([3.0, 2.7, 2.2])
    return np.clip(img, 0.0, 4.0).astype(np.float32)


def three_balls() -> SceneBuilder:
    """example_scenes.rs:22-60."""
    s = SceneBuilder()
    s.camera = Camera(aspect_ratio=1.0, fov=FRAC_PI_2, focal_dist=3.46,
                      lens_radius=0.1, position=(-2.0, 2.0, 1.0),
                      target=(0.0, 0.0, -1.0), up=(0.0, 1.0, 0.0))
    t0 = s.add_texture(Texture.solid(0.8, 0.8, 0.0))
    t1 = s.add_texture(Texture.solid(0.1, 0.2, 0.5))
    m0 = s.add_material(Material(Scatter.lambert(), Absorb.albedo_map(t0), Emit.none()))
    m1 = s.add_material(Material(Scatter.lambert(), Absorb.albedo_map(t1), Emit.none()))
    m2 = s.add_material(Material(Scatter.dielectric(1.5), Absorb.white_body(), Emit.none()))
    m3 = s.add_material(Material(Scatter.metal(0.0), Absorb.albedo(0.8, 0.6, 0.2), Emit.none()))
    s.add_sphere((0.0, -100.5, -1.0), 100.0, m0)
    s.add_sphere((0.0, 0.0, -1.0), 0.5, m1)
    s.add_sphere((-1.0, 0.0, -1.0), 0.5, m2)
    s.add_sphere((1.0, 0.0, -1.0), 0.5, m3)
    s.background = Emit.sky_gradient()
    return s


def more_balls(seed: int = 249) -> SceneBuilder:
    """example_scenes.rs:63-138, sphere-for-sphere exact.

    The grid is laid out from `StdRng::from_seed([249; 32])`
    (example_scenes.rs:98); core/stdrng.py carries that exact rand-0.8
    StdRng (ChaCha12) stream, so the grid layout, albedos, fuzz values
    and material choices are reproduced, not just statistically
    equivalent."""
    s = SceneBuilder()
    s.camera = Camera(aspect_ratio=1.0, fov=FRAC_PI_2, focal_dist=7.5,
                      lens_radius=0.02, position=(6.0, 2.0, 4.0),
                      target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0))
    t_checker = s.add_texture(Texture.checker(1, 2))
    s.add_texture(Texture.solid(0.2, 0.3, 0.1))
    s.add_texture(Texture.solid(0.9, 0.9, 0.9))
    m_ground = s.add_material(Material(Scatter.lambert(), Absorb.albedo_map(t_checker), Emit.none()))
    m_diffuse = s.add_material(Material(Scatter.lambert(), Absorb.albedo(0.1, 0.2, 0.5), Emit.none()))
    m_metal = s.add_material(Material(Scatter.metal(0.0), Absorb.albedo(0.8, 0.6, 0.2), Emit.none()))
    m_glass = s.add_material(Material(Scatter.dielectric(1.5), Absorb.white_body(), Emit.none()))
    s.add_sphere((0.0, -1000.0, -1.0), 1000.0, m_ground)
    s.add_sphere((-4.0, 1.8, 0.0), 1.8, m_diffuse)
    s.add_sphere((4.0, 1.8, 0.0), 1.8, m_metal)
    s.add_sphere((0.0, 1.8, 0.0), 1.8, m_glass)

    # exact reference draw order (example_scenes.rs:99-131): radius,
    # x-offset, z-offset, 3 albedo components, then 1-2 Bernoullis
    # (+ fuzz for metal); the albedo is drawn even for glass spheres
    rng = StdRng(bytes([seed & 0xFF]) * 32)
    for x in range(-31, 31):
        for z in range(-31, 31):
            if z == 0:
                continue
            radius = rng.closed_range(0.1, 0.3)
            center = (x + rng.closed_range(-0.5 + radius, 0.5 - radius),
                      radius,
                      z + rng.closed_range(-0.5 + radius, 0.5 - radius))
            albedo = (rng.gen_f64(), rng.gen_f64(), rng.gen_f64())
            if rng.bernoulli(0.7):
                mat = Material(Scatter.lambert(), Absorb.albedo(*albedo), Emit.none())
            elif rng.bernoulli(0.7):
                mat = Material(Scatter.metal(rng.gen_f64()), Absorb.albedo(*albedo), Emit.none())
            else:
                mat = Material(Scatter.dielectric(1.5), Absorb.white_body(), Emit.none())
            s.add_sphere(center, radius, s.add_material(mat))
    s.background = Emit.sky_gradient()
    return s


# more_balls_optimized (example_scenes.rs:141-150) only re-wraps the list
# in a BVH; here acceleration is a build() argument.
more_balls_optimized = more_balls


def two_balls() -> SceneBuilder:
    """example_scenes.rs:153-187 (checker + Perlin)."""
    s = SceneBuilder()
    s.camera = Camera(aspect_ratio=1.0, fov=FRAC_PI_2, focal_dist=7.5,
                      lens_radius=0.0, position=(6.0, 0.0, 4.0),
                      target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0))
    s.add_texture(Texture.solid(0.2, 0.2, 0.2))
    s.add_texture(Texture.solid(0.9, 0.0, 0.5))
    t_checker = s.add_texture(Texture.checker(0, 1))
    t_perlin = s.add_texture(Texture.perlin(0))
    m0 = s.add_material(Material(Scatter.lambert(), Absorb.albedo_map(t_checker), Emit.none()))
    m1 = s.add_material(Material(Scatter.lambert(), Absorb.albedo_map(t_perlin), Emit.none()))
    s.add_sphere((0.0, -10.0, 0.0), 10.0, m0)
    s.add_sphere((0.0, 10.0, 0.0), 10.0, m1)
    s.background = Emit.sky_gradient()
    return s


def earth(assets_dir: Optional[str] = None) -> SceneBuilder:
    """example_scenes.rs:190-219 (earthmap.tga textured sphere)."""
    s = SceneBuilder()
    s.camera = Camera(aspect_ratio=1.0, fov=np.pi / 9.0, focal_dist=1.0,
                      lens_radius=0.0, position=(13.0, 7.0, 3.0),
                      target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0))
    img = tga.load(os.path.join(assets_dir or ASSETS_DIR, "earthmap.tga"))
    t0 = s.add_texture(Texture.image_(img))
    m0 = s.add_material(Material(Scatter.lambert(), Absorb.albedo_map(t0), Emit.none()))
    s.add_sphere((0.0, 0.0, 0.0), 2.0, m0)
    s.background = Emit.sky_gradient()
    return s


def one_triangle() -> SceneBuilder:
    """example_scenes.rs:222-262 (DebugNormals emitter — a 'unit test' scene)."""
    s = SceneBuilder()
    s.camera = Camera(aspect_ratio=1.0, fov=FRAC_PI_2, focal_dist=1.0,
                      lens_radius=0.0, position=(2.0, 0.5, 1.0),
                      target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0))
    m0 = s.add_material(Material(Scatter.none(), Absorb.black_body(), Emit.debug_normals()))
    m1 = s.add_material(Material(Scatter.lambert(), Absorb.albedo(0.1, 0.2, 0.5), Emit.none()))
    n = (np.ones(3) / np.sqrt(3.0)).astype(np.float32)
    mesh = MeshData(
        positions=np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32),
        normals=np.stack([n, n, n]),
        uvs=np.zeros((3, 2), np.float32),
        indices=np.array([[0, 1, 2]], np.int32),
    )
    s.add_mesh(mesh, m0)
    s.add_sphere((0.0, -1000.0, -1.0), 1000.0, m1)
    s.background = Emit.sky_gradient()
    return s


def _bunny_scene(mesh: Union[str, MeshData], bunny_material: Material,
                 assets_dir: Optional[str] = None) -> SceneBuilder:
    """The bunny stage: camera, sky panorama, metal ground sphere, and a
    mesh given by asset file name or directly as MeshData."""
    s = SceneBuilder()
    s.camera = Camera(aspect_ratio=1.0, fov=FRAC_PI_4, focal_dist=1.0,
                      lens_radius=0.0, position=(-1.5, 1.5, 2.5),
                      target=(0.0, 0.5, 0.0), up=(0.0, 1.0, 0.0))
    t_sky = s.add_texture(Texture.image_(procedural_sky_panorama()))
    m_bunny = s.add_material(bunny_material)
    m_ground = s.add_material(Material(Scatter.metal(0.05), Absorb.albedo(0.8, 0.8, 0.8), Emit.none()))
    if isinstance(mesh, str):
        mesh = obj.load(os.path.join(assets_dir or ASSETS_DIR, mesh))
    s.add_mesh(mesh, m_bunny)
    s.add_sphere((0.0, -1000.0, -1.0), 1000.0, m_ground)
    s.background = Emit.sky_sphere(t_sky)
    return s


def glass_bunny(assets_dir: Optional[str] = None) -> SceneBuilder:
    """example_scenes.rs:265-306."""
    return _bunny_scene(
        "bunny_flat.obj",
        Material(Scatter.dielectric(1.5), Absorb.albedo(0.7, 0.8, 0.7), Emit.none()),
        assets_dir)


def bunny(assets_dir: Optional[str] = None) -> SceneBuilder:
    """example_scenes.rs:309-350 — the flagship / benchmark scene."""
    return _bunny_scene(
        "bunny.obj",
        Material(Scatter.none(), Absorb.black_body(), Emit.debug_normals()),
        assets_dir)


def _quad(q, u, v, n):
    """The book's quad (corner q, edges u and v) as its four corners q,
    q+u, q+u+v, q+v in float64, with the normal n of its reachable side."""
    q, u, v = (np.asarray(x, np.float64) for x in (q, u, v))
    return [q, q + u, q + u + v, q + v], np.asarray(n, np.float64)


def _quads_mesh(quads) -> MeshData:
    """Quads from `_quad` as one mesh: four vertices a quad with uvs (0,0),
    (1,0), (1,1), (0,1) as the book's quad parameterises it, split into
    the triangles (0, 1, 2) and (0, 2, 3)."""
    pos, nrm, idx = [], [], []
    for k, (corners, n) in enumerate(quads):
        pos += corners
        nrm += [n] * 4
        idx += [[4 * k, 4 * k + 1, 4 * k + 2], [4 * k, 4 * k + 2, 4 * k + 3]]
    uvs = np.tile(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                  (len(quads), 1))
    return MeshData(positions=np.asarray(pos).astype(np.float32),
                    normals=np.asarray(nrm).astype(np.float32),
                    uvs=uvs, indices=np.asarray(idx, np.int32))


def _box_quads(size, degrees: float, offset):
    """The book's `box((0,0,0), size)` turned by `rotate_y(degrees)` and
    moved by `translate(offset)`: its sides front, right, back, left, top
    and bottom with outward normals, each corner and normal turned as
    `rotate_y` maps object space to world space (x' = cos x + sin z,
    z' = -sin x + cos z), then the corners moved."""
    a, b, c = (float(x) for x in size)
    dx, dy, dz = np.diag([a, b, c])
    sides = [_quad((0, 0, c), dx, dy, (0, 0, 1)),
             _quad((a, 0, c), -dz, dy, (1, 0, 0)),
             _quad((a, 0, 0), -dx, dy, (0, 0, -1)),
             _quad((0, 0, 0), dz, dy, (-1, 0, 0)),
             _quad((0, b, c), dx, -dz, (0, 1, 0)),
             _quad((0, 0, 0), dx, dz, (0, -1, 0))]
    th = np.radians(degrees)
    cos, sin = np.cos(th), np.sin(th)

    def turn(p):
        return np.array([cos * p[0] + sin * p[2], p[1],
                         -sin * p[0] + cos * p[2]])

    move = np.asarray(offset, np.float64)
    return [([turn(p) + move for p in corners], turn(n))
            for corners, n in sides]


def cornell_box() -> SceneBuilder:
    """The Cornell box of Shirley, Black and Hollasch, *Ray Tracing: The
    Next Week* (v4), `cornell_box()` of its chapters "Lights" and
    "Instances": five 555-unit walls (green at x = 555, red at x = 0,
    white floor, ceiling and back), a 130x105 light of (15, 15, 15) under
    the ceiling, two white blocks turned by 15 and -18 degrees about y, a
    black background; vfov 40 degrees from (278, 278, -800), no defocus.
    The book renders it at 600x600, 200 samples a pixel, `max_depth` 50:
    the caller's to pass.

    The port has no instancing, so each quad is two triangles and the
    turned blocks are baked into their vertices (float64, then float32):
    36 triangles, no spheres, no asset.

    Departure from the book: its quads are two-sided, and the port's
    Lambert culls back faces (as the upstream's does). So each face's
    vertex normals point to the side a ray can reach it from: the walls
    inward, the blocks outward, the light down."""
    s = SceneBuilder()
    s.camera = Camera(aspect_ratio=1.0, fov=2.0 * np.pi / 9.0,
                      focal_dist=10.0, lens_radius=0.0,
                      position=(278.0, 278.0, -800.0),
                      target=(278.0, 278.0, 0.0), up=(0.0, 1.0, 0.0))
    red = s.add_material(Material(Scatter.lambert(), Absorb.albedo(0.65, 0.05, 0.05), Emit.none()))
    white = s.add_material(Material(Scatter.lambert(), Absorb.albedo(0.73, 0.73, 0.73), Emit.none()))
    green = s.add_material(Material(Scatter.lambert(), Absorb.albedo(0.12, 0.45, 0.15), Emit.none()))
    light = s.add_material(Material(Scatter.none(), Absorb.black_body(), Emit.color_(15.0, 15.0, 15.0)))
    s.add_mesh(_quads_mesh([_quad((555, 0, 0), (0, 555, 0), (0, 0, 555), (-1, 0, 0))]), green)
    s.add_mesh(_quads_mesh([_quad((0, 0, 0), (0, 555, 0), (0, 0, 555), (1, 0, 0))]), red)
    s.add_mesh(_quads_mesh([_quad((343, 554, 332), (-130, 0, 0), (0, 0, -105), (0, -1, 0))]), light)
    s.add_mesh(_quads_mesh(
        [_quad((0, 0, 0), (555, 0, 0), (0, 0, 555), (0, 1, 0)),
         _quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), (0, -1, 0)),
         _quad((0, 0, 555), (555, 0, 0), (0, 555, 0), (0, 0, -1))]
        + _box_quads((165, 330, 165), 15.0, (265, 0, 295))
        + _box_quads((165, 165, 165), -18.0, (130, 0, 65))), white)
    s.background = Emit.none()
    return s


def earth_standin_image(width: int = 1024, height: int = 512) -> np.ndarray:
    """A smooth procedural stand-in for the book's `earthmap.jpg`, at that
    file's size: (height, width, 3) float32 RGB in [0, 1], oceans and
    continents from a few sines of longitude and latitude, ice at the
    poles. Computed in float64, then cast."""
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


def next_week_final(layout_seed: int = 2024) -> SceneBuilder:
    """The final scene of Shirley, Black and Hollasch, *Ray Tracing: The
    Next Week* (v4), `final_scene(800, 10000, 40)` of its chapter "A Scene
    Testing All New Features", as far as the port renders it (the
    departures are listed below; they change what a frame computes, so
    this is not the book's scene): a floor of 20x20 boxes of random height, a
    300x265 light of (7, 7, 7) at y = 554, a brown, a glass, a fuzzed metal,
    a glass-bounded, an earth-textured and a marble sphere, and a cloud of
    1 000 white spheres of radius 10 turned by 15 degrees about y and
    moved; vfov 40 degrees from (478, 278, -600), no defocus, a black
    background. The book renders it at 800x800, 10 000 samples a pixel,
    `max_depth` 40: the caller's to pass.

    As the port takes it: each box is the book's `box()`, six quads of two
    triangles with outward normals (4 800 triangles), the light two
    triangles facing down, and 1 006 spheres. The box heights and the
    white spheres' centres come from `numpy.random.default_rng(
    layout_seed)`, drawn in the book's order (400 heights, box (i, j) with
    i outer, then 1 000 x (x, y, z)); the book's `std::rand` layout is not
    reproducible. The cloud's centres are turned as `rotate_y` maps object
    space to world space (x' = cos x + sin z, z' = -sin x + cos z) and
    moved, in float64, then cast.

    Departures from the book (the port has none of these features):
    - both constant media go (the blue one inside the glass sphere at
      (360, 150, 145), which stays as a glass sphere, and the global fog);
    - the moving sphere stands at its time-0 centre (400, 400, 200);
    - `earthmap.jpg` is not in the repository: the earth sphere samples
      `earth_standin_image()`, 1024x512;
    - the marble `noise_texture(0.2)` (a sine of turbulence) becomes the
      port's Perlin texture at unit frequency;
    - the book's quads are two-sided and the port's Lambert culls back
      faces, so every normal faces outward and the light faces down."""
    s = SceneBuilder()
    s.camera = Camera(aspect_ratio=1.0, fov=2.0 * np.pi / 9.0,
                      focal_dist=10.0, lens_radius=0.0,
                      position=(478.0, 278.0, -600.0),
                      target=(278.0, 278.0, 0.0), up=(0.0, 1.0, 0.0))
    t_earth = s.add_texture(Texture.image_(earth_standin_image()))
    t_marble = s.add_texture(Texture.perlin(0))
    ground = s.add_material(Material(Scatter.lambert(), Absorb.albedo(0.48, 0.83, 0.53), Emit.none()))
    light = s.add_material(Material(Scatter.none(), Absorb.black_body(), Emit.color_(7.0, 7.0, 7.0)))
    brown = s.add_material(Material(Scatter.lambert(), Absorb.albedo(0.7, 0.3, 0.1), Emit.none()))
    glass = s.add_material(Material(Scatter.dielectric(1.5), Absorb.white_body(), Emit.none()))
    metal = s.add_material(Material(Scatter.metal(1.0), Absorb.albedo(0.8, 0.8, 0.9), Emit.none()))
    earth = s.add_material(Material(Scatter.lambert(), Absorb.albedo_map(t_earth), Emit.none()))
    marble = s.add_material(Material(Scatter.lambert(), Absorb.albedo_map(t_marble), Emit.none()))
    white = s.add_material(Material(Scatter.lambert(), Absorb.albedo(0.73, 0.73, 0.73), Emit.none()))

    rng = np.random.default_rng(layout_seed)
    heights = rng.uniform(1.0, 101.0, 400)
    boxes = []
    for k, y1 in enumerate(heights):
        i, j = divmod(k, 20)
        boxes += _box_quads((100.0, y1, 100.0), 0.0,
                            (-1000.0 + 100.0 * i, 0.0, -1000.0 + 100.0 * j))
    s.add_mesh(_quads_mesh(boxes), ground)
    s.add_mesh(_quads_mesh([_quad((123, 554, 147), (300, 0, 0), (0, 0, 265), (0, -1, 0))]), light)

    s.add_sphere((400.0, 400.0, 200.0), 50.0, brown)
    s.add_sphere((260.0, 150.0, 45.0), 50.0, glass)
    s.add_sphere((0.0, 150.0, 145.0), 50.0, metal)
    s.add_sphere((360.0, 150.0, 145.0), 70.0, glass)
    s.add_sphere((400.0, 200.0, 400.0), 100.0, earth)
    s.add_sphere((220.0, 280.0, 300.0), 80.0, marble)
    cloud = rng.uniform(0.0, 165.0, (1000, 3))
    th = math.radians(15.0)
    cos, sin = math.cos(th), math.sin(th)
    turned = np.stack([cos * cloud[:, 0] + sin * cloud[:, 2], cloud[:, 1],
                       -sin * cloud[:, 0] + cos * cloud[:, 2]], axis=1)
    for c in turned + np.array([-100.0, 270.0, 395.0]):
        s.add_sphere(c, 10.0, white)
    s.background = Emit.none()
    return s


SCENES = {
    "three_balls": three_balls,
    "more_balls": more_balls,
    "more_balls_optimized": more_balls_optimized,
    "two_balls": two_balls,
    "earth": earth,
    "one_triangle": one_triangle,
    "glass_bunny": glass_bunny,
    "bunny": bunny,
    "cornell_box": cornell_box,
    "next_week_final": next_week_final,
}
