"""The example scene library, as data.

The seven example scenes (cameras, material/texture tables, geometry):

- `more_balls` reproduces its seeded random grid draw for draw:
  core/stdrng.py carries the ChaCha12 `StdRng` stream it is laid out with.
- `glass_bunny` / `bunny`: the SkySphere environment is a procedurally
  generated equirect panorama (sun + horizon gradient) baked into an image
  texture.
- `earth`, `bunny` and `glass_bunny` read an asset (`earthmap.tga`,
  `bunny.obj`, `bunny_flat.obj`) from `assets_dir`, else from
  `POTATO_ASSETS`, else from `assets/`; without the file they raise
  FileNotFoundError.
"""

from __future__ import annotations

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


SCENES = {
    "three_balls": three_balls,
    "more_balls": more_balls,
    "more_balls_optimized": more_balls_optimized,
    "two_balls": two_balls,
    "earth": earth,
    "one_triangle": one_triangle,
    "glass_bunny": glass_bunny,
    "bunny": bunny,
}
