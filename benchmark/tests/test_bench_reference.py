"""The reference against the port on the CPU, at tiny frames: the port's
`render()` agrees with it under the comparison, a reference computed in
float16 or bfloat16 does not, and the benchmark's frozen scene code makes
the scenes the port's own library makes."""

from __future__ import annotations

import json
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import compare, port_scene
from benchmark.records import Camera, Emit, Material, Mesh, SceneRecords, Texture
from benchmark.reference import pathtracer
from benchmark.scenes import more_balls_grid

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SIZE = (32, 16, 2, 4)     # width, height, spp, bounces
SEEDS = (5, 2 ** 31 + 11, 2 ** 62 + 3)


def config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


def textures_scene() -> SceneRecords:
    """Every texture, emitter and scatter kind the reference knows, on a
    few spheres and one triangle."""
    rng = np.random.default_rng(4)
    rec = SceneRecords(
        camera=Camera(1.0, math.pi / 2, 4.0, 0.05, (0.0, 1.0, 4.0),
                      (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
        background=Emit("sky_gradient"))
    rec.textures = [Texture("solid", (0.2, 0.4, 0.6)),
                    Texture("perlin", seed=3), Texture("checker", children=(0, 1)),
                    Texture("noise", seed=9), Texture("debug_uvs"),
                    Texture("image", image=rng.random((8, 16, 3), np.float32))]
    rec.materials = [
        Material("lambert", absorb="albedo_map", absorb_texture=2),
        Material("metal", 0.3, absorb="albedo_map", absorb_texture=3),
        Material("dielectric", 1.5, absorb="white_body"),
        Material("lambert", absorb="albedo_map", absorb_texture=4),
        Material("none", emit=Emit("color", (2.0, 1.5, 1.0))),
        Material("lambert", absorb="albedo_map", absorb_texture=5,
                 emit=Emit("sky_sphere", texture=5)),
        Material("none", emit=Emit("debug_normals")),
    ]
    rec.sphere_center = np.asarray([(0, -100.5, 0), (-1.1, 0, 0), (0, 0, 0),
                                    (1.1, 0, 0), (0, 1.2, -1), (0, 0, -2),
                                    (-1.2, 1.1, -1.2)], np.float64)
    rec.sphere_radius = np.asarray([100, 0.5, 0.5, 0.5, 0.3, 0.6, 0.4],
                                   np.float64)
    rec.sphere_material = np.asarray([0, 1, 2, 3, 4, 5, 6], np.int64)
    rec.meshes = [Mesh(positions=np.asarray([(-2, -0.5, -1), (2, -0.5, -1),
                                             (0, 2, -1.5)], np.float32),
                       normals=np.asarray([(0, 0, 1)] * 3, np.float32),
                       uvs=np.asarray([(0, 0), (1, 0), (0.5, 1)], np.float32),
                       indices=np.asarray([(0, 1, 2)], np.int32), material=3)]
    return rec


SCENES = {
    "more_balls": lambda: more_balls_grid.records(config("more_balls")),
    "textures": textures_scene,
}
_cache = {}


def records(name):
    if name not in _cache:
        _cache[name] = SCENES[name]()
    return _cache[name]


def reference(name, seed, dtype=torch.float32):
    key = (name, seed, dtype)
    if key not in _cache:
        scene = pathtracer.scene_tables(records(name), "cpu", dtype)
        _cache[key] = pathtracer.render(scene, *SIZE, seed, block=256)
    return _cache[key]


def port(name, seed):
    from potato_tpu_torch.render.renderer import render

    key = ("port", name, seed)
    if key not in _cache:
        scene = port_scene.build(records(name), "cpu")
        w, h, spp, bounces = SIZE
        _cache[key] = render(scene, w, h, spp=spp, max_bounce=bounces,
                             seed=seed, device="cpu")
    return _cache[key]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_port_render_agrees_with_reference(name, seed):
    """At most 2 of the 512 pixels off: a grazed sphere or a root near t_min
    may send one sample's path another way in one and not the other."""
    got = compare.frame_numbers(port(name, seed), reference(name, seed))
    assert got["color_off_pct"] <= 0.4, got
    assert got["normal_off_pct"] <= 0.4, got
    assert got["coverage_off_pct"] <= 0.4, got
    assert got["segments_off_pct"] <= 1.0, got


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_lower_precision_reference_fails_the_comparison(name, dtype):
    """The control: the reference one precision down, in the port's place,
    reads far beyond every cell's limit."""
    seed = SEEDS[0]
    got = compare.frame_numbers(reference(name, seed, dtype),
                                reference(name, seed))
    for path in limits_files():
        with open(path) as f:
            ok, _ = compare.judge(got, json.load(f))
        assert not ok, (path, got)
    assert got["color_off_pct"] > 10.0, got


def limits_files():
    top = os.path.join(ROOT, "benchmark", "limits")
    return [os.path.join(top, f) for f in sorted(os.listdir(top))]


def chunk_pixels(width, height, spp, chunk, k):
    """The pixels that chunk `k` of `chunk` rays covers in the port's
    tiled ray order."""
    from potato_tpu_torch.render.renderer import tile_unswizzle_perm

    rays = tile_unswizzle_perm(width, height, spp)[k * chunk:(k + 1) * chunk]
    return np.unique(rays // spp)


@pytest.mark.parametrize("k", [0, 29, 57])
def test_committed_limits_catch_one_altered_chunk(k):
    """A frame off the reference on 1 % of its pixels, scattered, passes
    the committed limits of `more_balls.final`; the same frame with one
    chunk of 2^15 rays altered (8 192 pixels, 1.7 % of the frame: under
    the whole-frame limit) fails them."""
    width, height, spp = 800, 600, 4
    rng = np.random.default_rng(k)
    want = SimpleNamespace(color=rng.random((height, width, 3)),
                           normal=rng.random((height, width, 3)),
                           coverage=np.ones((height, width)), segments=5e6)
    color = want.color.copy()
    flat = color.reshape(-1, 3)
    flat[rng.choice(width * height, width * height // 100, replace=False)] \
        += 0.1
    sound = SimpleNamespace(color=color, normal=want.normal,
                            coverage=want.coverage, segments=want.segments)
    with open(os.path.join(ROOT, "benchmark", "limits",
                           "more_balls.final.json")) as f:
        limits = json.load(f)
    assert compare.judge(compare.frame_numbers(sound, want), limits)[0]
    pixels = chunk_pixels(width, height, spp, 1 << 15, k)
    assert len(pixels) == 8192
    flat[pixels] += 0.05          # as `faults.one_chunk_altered` does
    got = compare.frame_numbers(sound, want)
    assert got["color_off_pct"] < limits["color_off_pct"]["limit"]
    assert not compare.judge(got, limits)[0], got


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_draws_the_ports_random_numbers(seed):
    from potato_tpu_torch.core import rng

    ids = torch.arange(4096, dtype=torch.int64) * 7919 + 3
    for salt in (0, 1, 2 * 8 + 3, 7 * 8 + 2):
        a = rng.uniform2(seed, salt, ids)
        b = pathtracer.uniforms(seed, salt, ids, torch.float32)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_frozen_more_balls_is_the_ports_more_balls():
    from potato_tpu_torch.scene import examples

    want = examples.more_balls()
    got = port_scene.scene_builder(records("more_balls"))
    assert got.sphere_center == want.sphere_center
    assert got.sphere_radius == want.sphere_radius
    assert got.sphere_material == want.sphere_material
    assert got.materials == want.materials
    assert got.textures == want.textures
    assert got.camera == want.camera and got.background == want.background
