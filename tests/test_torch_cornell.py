"""The Cornell box of *Ray Tracing: The Next Week* on the port
(`scene/examples.py::cornell_box`) and its benchmark cell
(`cornell_box.book`): the 36 triangles against the book's numbers, the
port's scene against the benchmark's records, the port's frames against the
benchmark's plain reference under the cell's committed limits, and the
`lanes` counter that `integrator.live_lane_pct` reads.

The JAX package has no such scene; nothing here imports it.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from benchmark import compare, harness, port_scene
from benchmark.reference import pathtracer
from potato_tpu_torch import cli
from potato_tpu_torch.ops import flash
from potato_tpu_torch.render import camera as tcamera
from potato_tpu_torch.render import renderer as trenderer
from potato_tpu_torch.scene import description as d
from potato_tpu_torch.scene import examples as texamples
from potato_tpu_torch.utils.metrics import MetricsLogger

BENCH = harness.BENCH
CFG = harness.load_json(os.path.join(BENCH, "configs", "cornell_box.json"))
LIMITS = harness.load_json(os.path.join(BENCH, "limits",
                                        "cornell_box.book.json"))
W, H, SPP, BOUNCES = 24, 16, 1, 50
SEEDS = [2 ** 31 + 11, 4_200_001_407, 9_007_199_254_740_993]
ROOM_CENTRE = np.array([277.5, 277.5, 277.5])

# the book's quads (corner Q, edges u and v) in the order of its world.add()
# and the unit normal of the side a ray reaches each from
WALLS = {
    "green": ((555, 0, 0), (0, 555, 0), (0, 0, 555), (-1, 0, 0)),
    "red": ((0, 0, 0), (0, 555, 0), (0, 0, 555), (1, 0, 0)),
    "light": ((343, 554, 332), (-130, 0, 0), (0, 0, -105), (0, -1, 0)),
    "floor": ((0, 0, 0), (555, 0, 0), (0, 0, 555), (0, 1, 0)),
    "ceiling": ((555, 555, 555), (-555, 0, 0), (0, 0, -555), (0, -1, 0)),
    "back": ((0, 0, 555), (555, 0, 0), (0, 555, 0), (0, 0, -1)),
}
BOXES = {"tall": ((165, 330, 165), 15.0, (265, 0, 295)),
         "short": ((165, 165, 165), -18.0, (130, 0, 65))}
SIDES = ["front", "right", "back", "left", "top", "bottom"]
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


def _faces():
    """(corners (4, 3), normals (4, 3)) of each quad of the port's scene,
    in mesh order: green, red, light, then the white floor, ceiling, back,
    and the tall and the short block's six sides each."""
    if "faces" not in _cache:
        faces = []
        for mesh in texamples.cornell_box().meshes:
            for a, b in mesh.indices.reshape(-1, 2, 3):
                # a quad's two triangles share its first and third corner
                assert a[0] == b[0] and a[2] == b[1]
                ids = [a[0], a[1], a[2], b[2]]
                faces.append((mesh.positions[ids].astype(np.float64),
                              mesh.normals[ids].astype(np.float64)))
        _cache["faces"] = faces
    return _cache["faces"]


def _port_scene():
    if "scene" not in _cache:
        _cache["scene"] = texamples.cornell_box().build(device="cpu")
    return _cache["scene"]


def _reference(seed):
    if seed not in _cache:
        rec = harness.load_module(os.path.join(BENCH, "scenes",
                                               "cornell_box.py"),
                                  "benchmark_scene_cornell_box").records(CFG)
        tables = pathtracer.scene_tables(rec, "cpu")
        _cache[seed] = pathtracer.render(tables, W, H, SPP, BOUNCES, seed)
    return _cache[seed]


def test_scene_is_36_lambert_triangles_a_light_and_no_sphere():
    s = texamples.cornell_box()
    scene = _port_scene()
    assert scene.num_triangles == 36 and scene.num_spheres == 0
    assert [m.num_triangles for m in s.meshes] == [2, 2, 2, 30]
    kinds = [(m.scatter.kind, m.emit.kind) for m in s.materials]
    assert kinds == [(d.SCATTER_LAMBERT, d.EMIT_NONE)] * 3 \
        + [(d.SCATTER_NONE, d.EMIT_COLOR)]
    assert s.background.kind == d.EMIT_NONE
    assert s.camera.fov == pytest.approx(math.radians(40.0))
    assert s.camera.lens_radius == 0.0
    assert trenderer.default_driver(scene) == "chunked"
    # 600 is no multiple of the 16-pixel tile: the book's frame takes
    # scanline ray order
    assert not tcamera._tiles_apply(600, 600)


@pytest.mark.parametrize("k,name", enumerate(WALLS), ids=list(WALLS))
def test_wall_and_light_quads_are_the_books(k, name):
    corners, normals = _faces()[k]
    q, u, v, n = (np.asarray(x, np.float64) for x in WALLS[name])
    np.testing.assert_array_equal(corners, [q, q + u, q + u + v, q + v])
    np.testing.assert_array_equal(normals, [n] * 4)
    # the normal faces the room: the side a ray reaches the quad from
    assert np.dot(n, ROOM_CENTRE - q) > 0
    assert abs(np.dot(n, np.cross(u, v))) == np.linalg.norm(np.cross(u, v))


@pytest.mark.parametrize("box", list(BOXES))
@pytest.mark.parametrize("side", range(6), ids=SIDES)
def test_block_sides_are_turned_as_rotate_y_maps_them(box, side):
    (a, b, c), degrees, offset = BOXES[box]
    corners, normals = _faces()[6 + 6 * list(BOXES).index(box) + side]
    th = math.radians(degrees)
    turn = np.array([[math.cos(th), 0, math.sin(th)], [0, 1, 0],
                     [-math.sin(th), 0, math.cos(th)]])
    obj = (corners - np.asarray(offset, np.float64)) @ turn   # turned back
    # every corner is a corner of the box (0,0,0)-(a,b,c) in object space
    np.testing.assert_allclose(
        np.minimum(np.abs(obj), np.abs(obj - [a, b, c])), 0, atol=1e-3)
    # the four corners span one side: one axis is constant over them
    flat = np.ptp(obj, axis=0) < 1e-3
    assert flat.sum() == 1
    n_obj = normals[0] @ turn
    np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1, atol=1e-6)
    assert (normals == normals[0]).all()
    # outward: from the block's centre towards the side
    np.testing.assert_allclose(np.abs(n_obj), flat.astype(float), atol=1e-6)
    centre = np.array([a, b, c]) / 2
    assert np.dot(n_obj, obj.mean(axis=0) - centre) > 0


def test_port_scene_equals_the_benchmark_records_build():
    rec = harness.load_module(os.path.join(BENCH, "scenes", "cornell_box.py"),
                              "benchmark_scene_cornell_box").records(CFG)
    theirs = port_scene.build(rec, "cpu")
    ours = _port_scene()
    assert theirs.features == ours.features
    for mine, other in ((ours.tables, theirs.tables),
                        (ours.camera, theirs.camera),
                        (ours.accel, theirs.accel)):
        for f in mine._fields:
            x, y = getattr(mine, f), getattr(other, f)
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x, y), f


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("driver", ["chunked", "compact"])
def test_port_frame_matches_the_reference_under_the_cells_limits(driver,
                                                                 seed):
    got = trenderer.render(_port_scene(), W, H, spp=SPP, max_bounce=BOUNCES,
                           seed=seed, driver=driver, device="cpu")
    ok, checks = compare.judge(compare.frame_numbers(got, _reference(seed)),
                               LIMITS)
    assert ok, checks
    assert got.segments > 3 * W * H       # paths of several segments


@pytest.mark.parametrize("driver", ["chunked", "compact"])
def test_lanes_counter_sums_the_lanes_each_pass_hands_on(driver,
                                                         monkeypatch):
    handed = []
    real = flash.prepare_flash

    def counting(accel, tables, rays, block=flash.R):
        handed.append(rays.origin.shape[0])
        return real(accel, tables, rays, block)

    monkeypatch.setattr(flash, "prepare_flash", counting)
    before = flash.intersect_flash.lanes
    out = trenderer.render(_port_scene(), W, H, spp=SPP, max_bounce=BOUNCES,
                           seed=SEEDS[0], driver=driver, chunk_size=128,
                           device="cpu")
    assert flash.intersect_flash.lanes - before == sum(handed)
    # three chunks of 128 lanes; the chunked driver runs each to its end
    assert set(handed) == {128} and len(handed) >= 3
    assert out.segments < sum(handed)


def test_render_complete_logs_the_lanes(tmp_path):
    p = tmp_path / "m.jsonl"
    before = flash.intersect_flash.lanes
    with MetricsLogger(str(p)) as m:
        out = trenderer.render(_port_scene(), W, H, spp=SPP,
                               max_bounce=BOUNCES, seed=SEEDS[1], metrics=m,
                               device="cpu")
    done = [json.loads(line) for line in open(p)][-1]
    assert done["event"] == "render_complete"
    assert done["segments"] == out.segments
    assert done["lanes"] == flash.intersect_flash.lanes - before
    assert 0 < done["segments"] < done["lanes"]


class _Run:
    """What a metric reader sees of a run: its state and window."""

    def __init__(self, segments):
        self.state = {}
        self.window = harness.Window(
            [harness.FrameRecord(i, i, 0.0, 1.0, s, True)
             for i, s in enumerate(segments)])


def test_live_lane_reader_reads_segments_over_lanes():
    reader = harness.metric_reader(BENCH, "integrator.live_lane_pct")
    run = _Run([300, 500])
    reader.before_window(run)
    flash.intersect_flash.lanes += 4000
    reader.after_window(run)
    assert reader.read(run) == pytest.approx(20.0)


def test_live_lane_reader_returns_none_without_the_counter(monkeypatch):
    reader = harness.metric_reader(BENCH, "integrator.live_lane_pct")
    monkeypatch.delattr(flash.intersect_flash, "lanes")
    run = _Run([300])
    reader.before_window(run)
    reader.after_window(run)
    assert reader.read(run) is None


def test_cli_renders_the_cornell_box(tmp_path):
    out_path = str(tmp_path / "cornell.tga")
    assert cli.main(["render", "--scene", "cornell_box", "--width", "8",
                     "--height", "8", "--spp", "1", "--max-bounce", "4",
                     "--device", "cpu", "--output", out_path]) == 0
    assert os.path.getsize(out_path) > 8 * 8 * 3
