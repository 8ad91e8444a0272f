"""The final scene of *Ray Tracing: The Next Week* on the port
(`scene/examples.py::next_week_final`) and its benchmark cell
(`next_week_final.book_final`): the 4 802 triangles and 1 006 spheres
against the book's numbers, the port's scene against the benchmark's
records, the sphere test in the sphere's own frame (no self-hits where a
bounce ray leaves a small sphere far from the origin), the port's frames
against the benchmark's plain reference under the cell's committed limits,
and the texture counters that `shading.texture_hit_pct` reads.

The JAX package has no such scene; nothing here imports it.
"""

import json
import math
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import potato_tpu_torch.ops
from benchmark import compare, harness, port_scene
from benchmark.reference import pathtracer
from potato_tpu_torch import cli
from potato_tpu_torch.core.types import BIG, RAY_EPSILON, RayBatch
from potato_tpu_torch.ops import flash, material
from potato_tpu_torch.ops import texture as ttexture
from potato_tpu_torch.render import bounce_graphs, integrator
from potato_tpu_torch.render import camera as tcamera
from potato_tpu_torch.render import renderer as trenderer
from potato_tpu_torch.render.camera import chunk_ray_ids, generate_rays
from potato_tpu_torch.scene import description as d
from potato_tpu_torch.scene import examples as texamples
from potato_tpu_torch.utils.metrics import MetricsLogger

from host_images import assert_host_images_bit_equal

BENCH = harness.BENCH
CELL = "next_week_final.book_final"
CFG = harness.load_json(os.path.join(BENCH, "configs", "next_week_final.json"))
LIMITS = harness.load_json(os.path.join(BENCH, "limits", CELL + ".json"))
W, H, SPP, BOUNCES = 48, 48, 1, 40
SEEDS = [2 ** 31 + 11, 4_200_001_407, 9_007_199_254_740_993]
SIDES = ["front", "right", "back", "left", "top", "bottom"]
# the book's box(a, b) side by side: the axis it is flat on, at a's or b's
# coordinate, and its outward normal
SIDE_PLANES = {"front": (2, 1, (0, 0, 1)), "right": (0, 1, (1, 0, 0)),
               "back": (2, 0, (0, 0, -1)), "left": (0, 0, (-1, 0, 0)),
               "top": (1, 1, (0, 1, 0)), "bottom": (1, 0, (0, -1, 0))}
_cache = {}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every case on one torch thread, restored after the file: the inputs
    are small, and under the suite's other test workers a pool of every
    core waits on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    """The card, or a skip: decided when the case runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run there: python -m pytest "
                    "tests/test_torch_next_week.py -m card)")
    return torch.device("cuda")


def _builder():
    if "builder" not in _cache:
        _cache["builder"] = texamples.next_week_final()
    return _cache["builder"]


def _port_scene(device="cpu"):
    if ("scene", device) not in _cache:
        _cache["scene", device] = _builder().build(device=device)
    return _cache["scene", device]


def _records():
    if "records" not in _cache:
        _cache["records"] = harness.load_module(
            os.path.join(BENCH, "scenes", "next_week_final.py"),
            "benchmark_scene_next_week_final").records(CFG)
    return _cache["records"]


def _reference(seed):
    if seed not in _cache:
        tables = pathtracer.scene_tables(_records(), "cpu")
        _cache[seed] = pathtracer.render(tables, W, H, SPP, BOUNCES, seed)
    return _cache[seed]


def _boxes():
    """(corners (400, 6, 4, 3), normals (400, 6, 4, 3)) of the floor's
    boxes in mesh order: box (i, j) with i outer, sides in the book's
    order, each quad's four corners from its two triangles."""
    if "boxes" not in _cache:
        mesh = _builder().meshes[0]
        tri = mesh.indices.reshape(-1, 2, 3)
        # a quad's two triangles share its first and third corner
        assert (tri[:, 0, 0] == tri[:, 1, 0]).all()
        assert (tri[:, 0, 2] == tri[:, 1, 1]).all()
        ids = np.stack([tri[:, 0, 0], tri[:, 0, 1], tri[:, 0, 2],
                        tri[:, 1, 2]], axis=1)
        _cache["boxes"] = (
            mesh.positions[ids].astype(np.float64).reshape(400, 6, 4, 3),
            mesh.normals[ids].astype(np.float64).reshape(400, 6, 4, 3))
    return _cache["boxes"]


def _layout():
    """The book's random numbers as the scene draws them: 400 heights,
    then 1 000 centres, one draw at a time."""
    rng = np.random.default_rng(CFG["layout_seed"])
    heights = np.array([rng.uniform(1.0, 101.0) for _ in range(400)])
    cloud = np.array([[rng.uniform(0.0, 165.0) for _ in range(3)]
                      for _ in range(1000)])
    return heights, cloud


# ------------------------------------------------------------ the scene

def test_scene_is_4802_triangles_and_1006_spheres():
    s = _builder()
    scene = _port_scene()
    assert scene.num_triangles == 4802 and scene.num_spheres == 1006
    assert [m.num_triangles for m in s.meshes] == [4800, 2]
    assert scene.accel.sph_brute.numel() == flash.SPH_BRUTE_MAX
    # the kernel's sphere phase gets the other 990, and the triangle phase
    # the 4 802 triangles: one launch runs both phases
    assert int((scene.accel.sph_feats[:, 4] > 0.5).sum()) == 990
    kinds = [(m.scatter.kind, m.absorb.kind, m.emit.kind)
             for m in s.materials]
    assert kinds == [
        (d.SCATTER_LAMBERT, d.ABSORB_ALBEDO, d.EMIT_NONE),
        (d.SCATTER_NONE, d.ABSORB_BLACK_BODY, d.EMIT_COLOR),
        (d.SCATTER_LAMBERT, d.ABSORB_ALBEDO, d.EMIT_NONE),
        (d.SCATTER_DIELECTRIC, d.ABSORB_WHITE_BODY, d.EMIT_NONE),
        (d.SCATTER_METAL, d.ABSORB_ALBEDO, d.EMIT_NONE),
        (d.SCATTER_LAMBERT, d.ABSORB_ALBEDO_MAP, d.EMIT_NONE),
        (d.SCATTER_LAMBERT, d.ABSORB_ALBEDO_MAP, d.EMIT_NONE),
        (d.SCATTER_LAMBERT, d.ABSORB_ALBEDO, d.EMIT_NONE)]
    assert s.materials[4].scatter.param == 1.0
    assert s.materials[4].absorb.color == (0.8, 0.8, 0.9)
    assert s.materials[1].emit.color == (7.0, 7.0, 7.0)
    assert [t.kind for t in s.textures] == [d.TEX_IMAGE, d.TEX_PERLIN]
    assert s.textures[0].image.shape == (512, 1024, 3)
    assert s.background.kind == d.EMIT_NONE
    assert s.camera.fov == pytest.approx(math.radians(40.0))
    assert s.camera.lens_radius == 0.0
    assert s.camera.position == (478.0, 278.0, -600.0)
    # dielectrics: the compact driver; 800 is a multiple of 16: tiles
    assert trenderer.default_driver(scene) == "compact"
    assert tcamera._tiles_apply(800, 800)


def test_floor_boxes_span_the_books_grid_and_heights():
    corners, _ = _boxes()
    heights, _ = _layout()
    lo, hi = corners.min(axis=(1, 2)), corners.max(axis=(1, 2))
    k = np.arange(400)
    i, j = k // 20, k % 20
    np.testing.assert_array_equal(lo[:, 0], -1000.0 + 100.0 * i)
    np.testing.assert_array_equal(hi[:, 0], -900.0 + 100.0 * i)
    np.testing.assert_array_equal(lo[:, 2], -1000.0 + 100.0 * j)
    np.testing.assert_array_equal(hi[:, 2], -900.0 + 100.0 * j)
    np.testing.assert_array_equal(lo[:, 1], 0.0)
    np.testing.assert_array_equal(hi[:, 1], heights.astype(np.float32))
    assert (heights >= 1.0).all() and (heights < 101.0).all()


@pytest.mark.parametrize("side", range(6), ids=SIDES)
def test_every_box_side_is_flat_and_faces_outward(side):
    corners, normals = _boxes()
    axis, at_b, n = SIDE_PLANES[SIDES[side]]
    lo, hi = corners.min(axis=(1, 2)), corners.max(axis=(1, 2))
    quad = corners[:, side]                      # (400, 4, 3)
    want = (hi if at_b else lo)[:, axis]
    np.testing.assert_array_equal(quad[:, :, axis],
                                  np.repeat(want[:, None], 4, axis=1))
    np.testing.assert_array_equal(normals[:, side],
                                  np.broadcast_to(n, (400, 4, 3)))
    centre = 0.5 * (lo + hi)
    assert (np.einsum("bd,d->b", quad.mean(axis=1) - centre, n) > 0).all()
    # the quad is the book's: Q, Q+u, Q+u+v, Q+v, a parallelogram
    np.testing.assert_array_equal(quad[:, 0] + quad[:, 2],
                                  quad[:, 1] + quad[:, 3])


def test_light_is_the_books_quad_facing_down():
    s = _builder()
    light = s.meshes[1]
    assert s.mesh_materials[1] == 1
    q, u, v = (np.array(x, np.float64) for x in
               ((123, 554, 147), (300, 0, 0), (0, 0, 265)))
    np.testing.assert_array_equal(light.positions,
                                  [q, q + u, q + u + v, q + v])
    np.testing.assert_array_equal(light.normals, [(0, -1, 0)] * 4)
    np.testing.assert_array_equal(light.indices, [(0, 1, 2), (0, 2, 3)])


def test_spheres_are_the_books_and_the_cloud_is_turned_and_moved():
    s = _builder()
    centres = np.array(s.sphere_center)
    radii = np.array(s.sphere_radius)
    np.testing.assert_array_equal(centres[:6], [
        (400, 400, 200), (260, 150, 45), (0, 150, 145), (360, 150, 145),
        (400, 200, 400), (220, 280, 300)])
    np.testing.assert_array_equal(radii[:6], [50, 50, 50, 70, 100, 80])
    assert s.sphere_material[:6] == [2, 3, 4, 3, 5, 6]
    assert s.sphere_material[6:] == [7] * 1000
    np.testing.assert_array_equal(radii[6:], 10.0)
    _, cloud = _layout()
    th = math.radians(15.0)
    want = np.stack([math.cos(th) * cloud[:, 0] + math.sin(th) * cloud[:, 2],
                     cloud[:, 1],
                     -math.sin(th) * cloud[:, 0] + math.cos(th) * cloud[:, 2]],
                    axis=1) + [-100.0, 270.0, 395.0]
    np.testing.assert_array_equal(centres[6:], want)
    # the cloud lies where the book puts it: 500-700 from the origin
    dist = np.linalg.norm(centres[6:], axis=1)
    assert 400 < dist.min() and dist.max() < 800


def test_port_scene_equals_the_benchmark_records_build():
    theirs = port_scene.build(_records(), "cpu")
    ours = _port_scene()
    assert theirs.features == ours.features
    for mine, other in ((ours.tables, theirs.tables),
                        (ours.camera, theirs.camera),
                        (ours.accel, theirs.accel)):
        for f in mine._fields:
            x, y = getattr(mine, f), getattr(other, f)
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x, y), f


# ------------------------------------- the sphere test in the sphere's frame

def _rays_leaving(centres, radii, n, seed):
    """`n` Lambert bounce rays leaving the given spheres: float32 origins on
    the surface, directions cosine-distributed about the normal."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, len(radii), n)
    normal = rng.normal(size=(n, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    c = centres[pick].astype(np.float32)
    r = radii[pick].astype(np.float32)
    origin = (c + r[:, None] * normal.astype(np.float32)).astype(np.float32)
    ball = rng.normal(size=(n, 3))
    ball /= np.linalg.norm(ball, axis=1, keepdims=True)
    direction = normal + ball
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    return pick, torch.from_numpy(origin), \
        torch.from_numpy(direction.astype(np.float32))


def _self_hits(scene, first, n, seed):
    """Rays leaving the kernel's spheres of `scene` (ids `first`...):
    (the rays whose test against the sphere they leave finds a root at
    t >= RAY_EPSILON, through the plain `_sphere_keys` on the scene's own
    sphere rows; the same through the reference's formulas)."""
    accel = scene.accel
    perm = accel.sph_perm.numpy()
    real = accel.sph_feats[:, 4].numpy() > 0.5
    row_of = {int(p): k for k, p in enumerate(perm) if real[k]}
    ids = np.array([i for i in range(first, scene.num_spheres)
                    if i in row_of])
    centres = scene.tables.s_center.numpy()[ids]
    radii = scene.tables.s_radius.numpy()[ids]
    pick, o, dirs = _rays_leaving(centres, radii, n, seed)
    tile = accel.sph_feats[[row_of[int(i)] for i in ids[pick]]][:, None, :]

    def lanes(x):
        return tuple(x[:, i].reshape(n, 1, 1) for i in range(3))

    key, _ = flash._sphere_keys(lanes(o), lanes(dirs),
                                torch.full((n, 1, 1), RAY_EPSILON),
                                torch.full((n, 1, 1), BIG), tile)
    port = key.reshape(n) < BIG
    c = torch.from_numpy(centres[pick].astype(np.float32))
    r = torch.from_numpy(radii[pick].astype(np.float32))
    oc = o - c
    a = pathtracer.dot(dirs, dirs)
    hb = pathtracer.dot(oc, dirs)
    delta = hb * hb - a * (pathtracer.dot(oc, oc) - r * r)
    sq = torch.sqrt(torch.where(delta > 0, delta, torch.ones_like(delta)))
    ref = (delta > 0) & (((-hb - sq) / a >= RAY_EPSILON)
                         | ((-hb + sq) / a >= RAY_EPSILON))
    return port, ref


@pytest.mark.parametrize("name,first", [("next_week_final", 6),
                                        ("more_balls", 4)])
def test_rays_leaving_a_sphere_do_not_hit_it_again(name, first):
    """10^5 bounce rays leaving the scene's kernel spheres (the white
    spheres of radius 10 500-700 from the origin; more_balls' spheres of
    radius 0.1-0.3). In the expanded form |o|^2 - 2 o.c + |c|^2 - r^2 the
    c term of such a ray cancels to its rounding error and 30 % of the
    white spheres' rays found their own sphere again from inside; in the
    sphere's frame they find it on as few rays as the reference's
    formulas do (a float32 origin a rounding inside the surface, and a
    ray that leaves nearly tangent): 4 of 10^5 here."""
    scene = (_port_scene() if name == "next_week_final"
             else texamples.more_balls().build(device="cpu"))
    port, ref = _self_hits(scene, first, 100_000, seed=19)
    assert int(port.sum()) <= 10, int(port.sum())
    assert int((port & ~ref).sum()) == 0
    assert int(port.sum()) == int(ref.sum())


def _face_self_hits(scene, n, seed):
    """Lambert bounce rays leaving the faces of `scene`'s triangles, as a
    path makes them: a ray from 50-800 away hits a random point of a
    triangle, its hit point is o + t d in float32, and the bounce leaves
    it cosine-distributed about the face's normal on the side it came
    from. (the rays whose test against the triangle they leave finds it
    again at t >= RAY_EPSILON, through the plain `_triangle_keys` on the
    scene's own rows; the same through the reference's Cramer formulas)."""
    tf = scene.accel.tri_flat
    perm = scene.accel.tri_perm.numpy()
    real = np.nonzero(tf[:, 18:21].abs().sum(1).numpy() > 0)[0]
    real = real[perm[real] < scene.num_triangles]
    rng = np.random.default_rng(seed)
    rows = real[rng.integers(0, len(real), n)]
    tri = tf[rows][:, None, :]
    ids = perm[rows]
    a, b, c = (getattr(scene.tables, k).numpy()[ids].astype(np.float64)
               for k in ("tri_pa", "tri_pb", "tri_pc"))
    s1, s2 = np.sqrt(rng.random(n)), rng.random(n)
    p = ((1 - s1)[:, None] * a + (s1 * (1 - s2))[:, None] * b
         + (s1 * s2)[:, None] * c)
    normal = np.cross(b - a, c - a)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    away = rng.normal(size=(n, 3))
    away /= np.linalg.norm(away, axis=1, keepdims=True)
    away *= np.sign((away * normal).sum(1))[:, None]
    o = torch.from_numpy(
        (p + away * rng.uniform(50, 800, n)[:, None]).astype(np.float32))
    d_in = torch.from_numpy(p) - o.double()
    d_in = (d_in / d_in.norm(dim=1, keepdim=True)).float()
    side = torch.from_numpy(
        normal * np.sign((away * normal).sum(1))[:, None])
    ball = rng.normal(size=(n, 3))
    ball /= np.linalg.norm(ball, axis=1, keepdims=True)
    bounce = side + torch.from_numpy(ball)
    bounce = (bounce / bounce.norm(dim=1, keepdim=True)).float()

    def port_t(orig, dirs):
        def lanes(x):
            return tuple(x[:, i].reshape(n, 1, 1) for i in range(3))
        m = torch.linalg.cross(dirs, orig)
        key, _ = flash._triangle_keys(lanes(orig), lanes(dirs), lanes(m),
                                      torch.full((n, 1, 1), RAY_EPSILON),
                                      torch.full((n, 1, 1), BIG), tri)
        return key.reshape(n)

    def ref_t(orig, dirs):
        pa, pb, pc = (torch.from_numpy(x.astype(np.float32))
                      for x in (a, b, c))
        ba, ca = pa - pb, pa - pc
        po = pa - orig
        cxd = pathtracer.cross(ca, dirs)
        det = pathtracer.dot(ba, cxd)
        t = pathtracer.dot(po, pathtracer.cross(ba, ca)) / det
        u = pathtracer.dot(po, cxd) / det
        v = pathtracer.dot(dirs, pathtracer.cross(ba, po)) / det
        ok = ((t >= RAY_EPSILON) & (u >= 0) & (v >= 0) & (u + v <= 1)
              & (det.abs() >= pathtracer.SMOL))
        return torch.where(ok, t, torch.full_like(t, BIG))

    out = []
    for t_of in (port_t, ref_t):
        t_in = t_of(o, d_in)
        hit = t_in < BIG
        origin = o + t_in[:, None] * d_in
        out.append(hit & (t_of(origin, bounce) < BIG))
    return out


@pytest.mark.parametrize("name", ["next_week_final", "cornell_box"])
def test_rays_leaving_a_face_do_not_hit_it_again(name):
    """10^5 bounce rays leaving the triangles of the floor's boxes (faces
    up to 1 000 from the origin) or of the Cornell box (up to 555). With t
    divided by det = U + V + W, whose terms are each the size of |a x b|,
    the incoming hit points landed up to 5e-2 off the face and about 3 %
    of such rays found their face again from behind (a Lambert path then
    ends); with t = (a - o).n / d.n they do so about as rarely as through
    the reference's formulas (a float32 hit point a rounding behind the
    face, and a ray that leaves nearly along it)."""
    scene = (_port_scene() if name == "next_week_final"
             else texamples.cornell_box().build(device="cpu"))
    port, ref = _face_self_hits(scene, 100_000, seed=23)
    assert int(port.sum()) <= 2 * int(ref.sum()) + 10, \
        (int(port.sum()), int(ref.sum()))


def test_sphere_rows_carry_r_squared():
    accel = _port_scene().accel
    feats = accel.sph_feats.numpy()
    real = feats[:, 4] > 0.5
    r = _port_scene().tables.s_radius.numpy()[accel.sph_perm.numpy()[real]]
    np.testing.assert_array_equal(feats[real, 3], r * r)
    np.testing.assert_array_equal(feats[~real], 0.0)


# --------------------------------------------- frames against the reference

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("driver", ["chunked", "compact"])
def test_port_frame_matches_the_reference_under_the_cells_limits(driver,
                                                                 seed):
    got = trenderer.render(_port_scene(), W, H, spp=SPP, max_bounce=BOUNCES,
                           seed=seed, driver=driver, device="cpu")
    ok, checks = compare.judge(compare.frame_numbers(got, _reference(seed)),
                               LIMITS)
    assert ok, checks
    assert got.segments > 2 * W * H       # paths of several segments


# ------------------------------------------------------ the texture counters

def _direct_count(monkeypatch):
    """Lanes and hits of the Perlin, value-noise and image samplers counted
    apart from the counters: every shading call's lanes, and its live hit
    lanes on a material that maps the earth image or the marble."""
    seen = {"lanes": 0, "earth": 0, "marble": 0}
    real = material.eval_absorb

    def absorb(tables, kind, color, tex, hit, features=None):
        seen["lanes"] += hit.valid.numel()
        seen["earth"] += int((hit.valid & (hit.material == 5)).sum())
        seen["marble"] += int((hit.valid & (hit.material == 6)).sum())
        return real(tables, kind, color, tex, hit, features)

    monkeypatch.setattr(material, "eval_absorb", absorb)
    return seen


@pytest.mark.parametrize("driver", ["chunked", "compact"])
def test_texture_counters_equal_a_direct_count(driver, monkeypatch):
    seen = _direct_count(monkeypatch)
    counts = ttexture.texture_counts
    lanes = flash.intersect_flash.lanes
    hits = counts.hits_clone()
    out = trenderer.render(_port_scene(), 24, 24, spp=1, max_bounce=8,
                           seed=SEEDS[0], driver=driver, device="cpu")
    # perlin, noise, image: the scene has no value noise
    assert counts.hits_since(hits) == (seen["marble"], 0, seen["earth"])
    assert seen["earth"] > 0 and seen["marble"] > 0
    assert {d.TEX_PERLIN, d.TEX_IMAGE} <= counts.kinds_run
    # the samplers ran on every lane handed to the intersector: the
    # reader's lanes
    assert flash.intersect_flash.lanes - lanes == seen["lanes"]
    assert out.segments > 0


@pytest.mark.parametrize("name", ["more_balls", "cornell_box"])
def test_scenes_without_those_kinds_count_nothing(name, monkeypatch):
    scene = texamples.SCENES[name]().build(device="cpu")
    counts = ttexture.texture_counts
    calls = []
    monkeypatch.setattr(counts, "count",
                        lambda kind, reads, kinds: calls.append(reads))
    trenderer.render(scene, 16, 16, spp=1, max_bounce=3, seed=SEEDS[1],
                     device="cpu")
    # more_balls samples its checker, but builds no read mask for it
    assert all(reads is None for reads in calls)


def _fake_capture(seen):
    """torch.cuda's graph capture as a CPU can run it: the captured bodies
    run eagerly once, and a replay does nothing. `seen` receives the
    devices of the texture hits' accumulators as the capture starts."""
    class Graph:
        def replay(self):
            pass

    class Capture:
        def __init__(self, graph, pool=None):
            pass

        def __enter__(self):
            seen.append(set(ttexture.texture_counts._hits))
            return self

        def __exit__(self, *exc):
            return False

    return (mock.patch.object(torch.cuda, "CUDAGraph", Graph),
            mock.patch.object(torch.cuda, "graph", Capture))


def test_a_capture_finds_the_hits_accumulator_made():
    """The accumulator is made before a pass's graphs are captured, which
    would otherwise capture its zeroing and zero it on every replay."""
    bounce_graphs._SCENES.clear()          # no variant of an earlier case
    ttexture.texture_counts._hits.clear()
    scene = _port_scene()
    ids, live = chunk_ray_ids(0, 512, 24, 24, 1, "cpu")
    rays = generate_rays(scene.camera, 24, 24, 1, ids, SEEDS[1], lens=False)
    state = integrator.init_state(rays, live=live)
    step = bounce_graphs.GraphedStep(scene.tables, scene.accel, SEEDS[1],
                                     features=scene.features)
    state = step(state, 0, ids)               # the bodies, eagerly
    step(state, 1, ids)
    ttexture.texture_counts._hits.clear()
    v = step.mine[512, False]
    sg = bounce_graphs._scene_graphs(scene.accel)
    seen = []
    graph, capture = _fake_capture(seen)
    with graph, capture:
        v.capture(scene.tables, scene.accel, sg.words, sg.bounce, None)
    assert seen and all(devs == {torch.device("cpu")} for devs in seen)


def test_render_complete_logs_the_texture_counters(tmp_path):
    p = tmp_path / "m.jsonl"
    with MetricsLogger(str(p)) as m:
        trenderer.render(_port_scene(), 16, 16, spp=1, max_bounce=4,
                         seed=SEEDS[2], metrics=m, device="cpu")
        trenderer.render(texamples.cornell_box().build(device="cpu"), 8, 8,
                         spp=1, max_bounce=2, seed=SEEDS[2], metrics=m,
                         device="cpu")
    done = [e for e in map(json.loads, open(p))
            if e["event"] == "render_complete"]
    assert done[0]["texture_hits"]["noise"] == 0
    assert 0 < done[0]["texture_hits"]["image"] < done[0]["lanes"]
    assert 0 < done[0]["texture_hits"]["perlin"] < done[0]["lanes"]
    assert "texture_hits" not in done[1]     # no counted kind in the scene


def test_texture_hit_reader_reads_hits_over_lanes(monkeypatch):
    reader = harness.metric_reader(BENCH, "shading.texture_hit_pct")
    run = mock.Mock(state={})
    counts = ttexture.texture_counts
    monkeypatch.setattr(counts, "kinds_run", set())
    acc = counts.hits_on("cpu")
    reader.before_window(run)
    reader.after_window(run)
    assert reader.read(run) is None          # nothing ran in the window
    reader.before_window(run)
    counts.kinds_run.update({d.TEX_PERLIN, d.TEX_IMAGE})
    flash.intersect_flash.lanes += 400
    acc[d.TEX_PERLIN] += 6
    acc[d.TEX_IMAGE] += 10
    acc[d.TEX_CHECKER] += 99                 # not a counted kind
    reader.after_window(run)
    acc[d.TEX_IMAGE] += 50                   # after the window: not read
    # 16 hits over 400 lanes, each sampled by 2 counted kinds
    assert reader.read(run) == pytest.approx(2.0)


def test_texture_hit_reader_returns_none_without_the_counters(monkeypatch):
    reader = harness.metric_reader(BENCH, "shading.texture_hit_pct")
    run = mock.Mock(state={})
    with mock.patch.object(ttexture, "texture_counts", None):
        reader.before_window(run)
        flash.intersect_flash.lanes += 100
        reader.after_window(run)
        assert reader.read(run) is None      # a program without the counter
    monkeypatch.delattr(potato_tpu_torch.ops, "texture")
    monkeypatch.setitem(sys.modules, "potato_tpu_torch.ops.texture", None)
    reader.before_window(run)
    reader.after_window(run)
    assert reader.read(run) is None


def test_cli_renders_next_week_final(tmp_path):
    out_path = str(tmp_path / "final.tga")
    assert cli.main(["render", "--scene", "next_week_final", "--width", "8",
                     "--height", "8", "--spp", "1", "--max-bounce", "4",
                     "--device", "cpu", "--output", out_path]) == 0
    assert os.path.getsize(out_path) > 8 * 8 * 3


# --------------------------------------------------------- on the card only

@pytest.mark.card
@pytest.mark.parametrize("rays", ["leaving_white_spheres", "camera"])
def test_kernel_sphere_phase_equals_the_plain_version(card, rays):
    """Both kernel phases in one launch; the sphere phase's results bit
    for bit the plain version's, the triangle phase's within the kernel's
    fused multiply-adds."""
    scene = _port_scene("cuda")
    n = 1 << 15
    if rays == "camera":
        # the first chunk of the tiled frame: its bottom rows, the floor
        ids, live = chunk_ray_ids(0, n, 800, 800, 4, card)
        batch = integrator.init_state(generate_rays(
            scene.camera, 800, 800, 4, ids, SEEDS[0], lens=False),
            live=live).rays
    else:
        ids = np.arange(6, 1006)
        _, o, dirs = _rays_leaving(scene.tables.s_center.cpu().numpy()[ids],
                                   scene.tables.s_radius.cpu().numpy()[ids],
                                   n, seed=23)
        batch = RayBatch(o.to(card), dirs.to(card),
                         torch.full((n,), RAY_EPSILON, device=card),
                         torch.full((n,), BIG, device=card))
    inp = flash.prepare_flash(scene.accel, scene.tables, batch)
    assert inp.has_sph
    args = (inp.packed_rays, inp.queues, scene.accel.tri_flat,
            scene.accel.sph_feats, flash.R, inp.has_sph)
    got = flash.flash_intersect_kernel(*args)
    want = flash.flash_intersect_plain(*args)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    tri_hit = (got[0] < BIG) & (want[0] < BIG)
    assert int(tri_hit.sum()) > 0
    np.testing.assert_allclose(got[0][tri_hit].cpu().numpy(),
                               want[0][tri_hit].cpu().numpy(), rtol=1e-3)


@pytest.mark.card
@pytest.mark.parametrize("strided", [False, True])
def test_host_images_on_the_card_equal_scatter_then_mean(card, strided):
    """The cell's tiled 800x800, 4 spp frame: the spp mean and the tile
    transpose run on the card, bit-equal to the host permutation's scatter
    and mean on the CPU; `strided` as the pool driver hands its rows over."""
    assert_host_images_bit_equal(800, 800, 4, 1 << 15, card,
                                 strided=strided)
