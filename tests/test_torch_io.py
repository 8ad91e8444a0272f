"""potato_tpu_torch's asset IO (TGA, OBJ, native bindings), metrics stream,
render checkpoints and CLI, against the JAX package where it has the same
function.

TGA bytes and OBJ arrays are held bit for bit. The one image (`earth` from
a written earthmap.tga) uses the gate of
tests/test_render_oracle.py::_compare: per-pixel 2e-3, at most
max(1, 0.2 %) pixels off.
"""

import json
import struct

import numpy as np
import pytest
import torch

from potato_tpu.io import obj as jobj
from potato_tpu.io import tga as jtga
from potato_tpu.render.renderer import render as jrender
from potato_tpu.render.renderer import scene_digest as jscene_digest
from potato_tpu.scene import examples as jexamples

from potato_tpu_torch import cli
from potato_tpu_torch.io import native, obj, tga
from potato_tpu_torch.render import renderer as trenderer
from potato_tpu_torch.scene import examples as texamples
from potato_tpu_torch.utils.metrics import (
    MetricsLogger,
    from_env_or,
    null_metrics,
)

OBJ_MIXED = """
# comment line that must be skipped
v 0.0 0.0 0.0
v 1.0 0.0 0.0
v 0.0 1.0 0.0
vn 0.0 0.0 1.0
vt 0.5 0.5
junk line
f 1//1 2//1 3//1
f 1/1/1 2/1/1 3/1/1
"""

OBJ_SHARED = """
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0.5
vt 0 0
vt 1 1
f 1/1 2/2 3/1
f 2/2 4/1 3/1
f 3 2 4
"""

QUAD = "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3 4\n"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every case on one torch thread, restored after the file: the inputs
    are small, and under the suite's other test workers a pool of every
    core waits on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sphere_mesh_text(subdivisions=2, radius=0.5, center=(0.0, 0.5, 0.0)):
    """An octahedron subdivided `subdivisions` times, as `v//vn` OBJ text
    (8 * 4^n triangles), every float written so it reads back exactly."""
    verts = [np.array(v, np.float64) for v in
             ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
              (0, 0, -1))]
    faces = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
             (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    for _ in range(subdivisions):
        mid = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mid[key] = len(verts) - 1
            return mid[key]

        split = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            split += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = split
    normals = np.asarray(verts, np.float32)
    positions = normals * np.float32(radius) + np.asarray(center, np.float32)
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in positions]
    lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in normals]
    lines += [f"f {a + 1}//{a + 1} {b + 1}//{b + 1} {c + 1}//{c + 1}"
              for a, b, c in faces]
    return "\n".join(lines) + "\n"


def write_assets(directory):
    """bunny.obj and bunny_flat.obj (a small sphere mesh) and earthmap.tga
    (a seeded 32x16 image) in `directory`; returns it."""
    text = sphere_mesh_text()
    for name in ("bunny.obj", "bunny_flat.obj"):
        (directory / name).write_text(text)
    img = np.random.default_rng(8).integers(0, 256, (16, 32, 4), np.uint8)
    tga.save(img, str(directory / "earthmap.tga"))
    return directory


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


_scenes = {}


def _scene(name="three_balls"):
    if name not in _scenes:
        _scenes[name] = texamples.SCENES[name]().build(accel="brute",
                                                       device="cpu")
    return _scenes[name]


# ----------------------------------------------------------------------- TGA

@pytest.mark.parametrize("use_native", [True, False])
def test_tga_roundtrip(tmp_path, use_native):
    img = np.random.default_rng(0).integers(0, 256, (13, 17, 4), np.uint8)
    path = str(tmp_path / "t.tga")
    tga.save(img, path)
    np.testing.assert_array_equal(tga.load(path, use_native=use_native), img)


def test_tga_rgb_gets_opaque_alpha(tmp_path):
    path = str(tmp_path / "t.tga")
    tga.save(np.zeros((4, 4, 3), np.uint8), path)
    back = tga.load(path)
    assert back.shape == (4, 4, 4)
    np.testing.assert_array_equal(back[..., 3], 255)


@pytest.mark.parametrize("use_native", [True, False])
def test_tga_rejects_compressed(use_native):
    # datatype 10 = RLE true-color
    hdr = struct.pack("<BBB5sHHHHBB", 0, 0, 10, b"\0" * 5, 0, 0, 2, 2, 24, 0)
    with pytest.raises(tga.TgaError):
        tga.load(hdr + b"\0" * 12, use_native=use_native)


@pytest.mark.parametrize("use_native", [True, False])
def test_tga_vertical_flip_bit(use_native):
    # a 1x2 24bpp file with the flip bit set (bit 5 of the descriptor);
    # rows in file order: red (BGR 0,0,255), then blue (255,0,0)
    hdr = struct.pack("<BBB5sHHHHBB", 0, 0, 2, b"\0" * 5, 0, 0, 1, 2, 24,
                      1 << 5)
    img = tga.load(hdr + bytes([0, 0, 255, 255, 0, 0]),
                   use_native=use_native)
    np.testing.assert_array_equal(img[0, 0], [0, 0, 255, 255])  # blue first
    np.testing.assert_array_equal(img[1, 0], [255, 0, 0, 255])


@pytest.mark.parametrize("shape", [(13, 17, 4), (9, 5, 3), (1, 64, 4)])
def test_tga_bytes_equal_jax(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    ours, theirs = str(tmp_path / "port.tga"), str(tmp_path / "jax.tga")
    tga.save(img, ours)
    jtga.save(img, theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    # and both loaders read a 24bpp file alike
    hdr = struct.pack("<BBB5sHHHHBB", 0, 0, 2, b"\0" * 5, 0, 0, shape[1],
                      shape[0], 24, 0)
    data = hdr + img[..., :3].tobytes()
    np.testing.assert_array_equal(tga.load(data, use_native=False),
                                  jtga.load(data, use_native=False))


# ----------------------------------------------------------------------- OBJ

@pytest.mark.parametrize("text", [OBJ_MIXED, OBJ_SHARED, sphere_mesh_text(1)],
                         ids=["mixed", "shared", "sphere"])
@pytest.mark.parametrize("use_native", [True, False])
def test_obj_matches_jax(text, use_native):
    want = jobj.load(text, use_native=False)
    got = obj.load(text, use_native=use_native)
    assert type(got) is texamples.MeshData
    for f in ("positions", "normals", "uvs", "indices"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_obj_parse_and_dedup():
    mesh = obj.load(OBJ_MIXED)
    # triples (v,-1,n) and (v,t,n) differ: no dedup across the two faces
    assert mesh.num_triangles == 2 and mesh.num_vertices == 6
    np.testing.assert_allclose(mesh.uvs[0], [0, 0])   # v//vn: uv is 0
    np.testing.assert_allclose(mesh.uvs[3], [0.5, 0.5])
    shared = obj.load(OBJ_SHARED)
    # 2/2 and 3/1 are shared by the first two faces; a bare `3` is another
    # triple than `3/1`
    assert shared.num_vertices == 7
    np.testing.assert_array_equal(shared.indices, [[0, 1, 2], [1, 3, 2],
                                                   [4, 5, 6]])


@pytest.mark.parametrize("use_native", [True, False])
def test_obj_rejects_quads(use_native):
    with pytest.raises(obj.ObjError):
        obj.load(QUAD, use_native=use_native)


def test_native_library_matches_numpy_paths():
    if native.get_lib() is None:
        pytest.fail(f"{native.LIB_PATH} did not load or build")
    text = sphere_mesh_text(2)
    parsed = native.obj_parse(text)
    py = obj.load(text, use_native=False)
    for a, b in zip(parsed, (py.positions, py.normals, py.uvs, py.indices)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    img = np.random.default_rng(1).integers(0, 256, (11, 7, 4), np.uint8)
    enc = native.tga_encode(img)
    assert enc == tga.encode(img)
    np.testing.assert_array_equal(native.tga_decode(enc), img)
    assert native.tga_decode(b"\0" * 5) is None   # the numpy path raises


# ------------------------------------------------------------------- metrics

def test_logger_writes_jsonl(tmp_path):
    p = tmp_path / "m.jsonl"
    with MetricsLogger(str(p), run="r1", host=0) as m:
        assert m.enabled
        m.log("hello", value=3)
        m.log("world", value=4.5, note="x")
    recs = _read_jsonl(p)
    assert [r["event"] for r in recs] == ["hello", "world"]
    assert recs[0]["value"] == 3 and recs[0]["run"] == "r1"
    assert recs[0]["host"] == 0 and "t" in recs[0] and "dt" in recs[0]


def test_null_logger_is_noop():
    m = null_metrics()
    assert not m.enabled
    m.log("anything", x=1)


def test_env_resolution(tmp_path, monkeypatch):
    p = tmp_path / "env.jsonl"
    monkeypatch.setenv("POTATO_METRICS", str(p))
    m = from_env_or(None)
    assert m.enabled
    m.log("via_env")
    m.close()
    assert _read_jsonl(p)[0]["event"] == "via_env"
    monkeypatch.delenv("POTATO_METRICS")
    assert not from_env_or(None).enabled


def test_render_emits_metrics(tmp_path, monkeypatch):
    p = tmp_path / "render.jsonl"
    monkeypatch.setenv("POTATO_METRICS", str(p))     # render owns this one
    out = trenderer.render(_scene(), 16, 16, spp=1, max_bounce=2,
                           device="cpu")
    recs = _read_jsonl(p)
    assert [r["event"] for r in recs] == ["render_start", "render_complete"]
    start, done = recs
    assert start["width"] == 16 and start["num_chunks"] == 1
    assert start["driver"] == "compact" and not start["per_chunk"]
    assert done["segments"] == out.segments > 0
    assert done["rays_per_s"] > 0 and done["seconds"] > 0


def test_render_per_chunk_metrics(tmp_path):
    p = tmp_path / "chunks.jsonl"
    with MetricsLogger(str(p)) as m:
        trenderer.render(_scene(), 16, 16, spp=2, max_bounce=2,
                         chunk_size=128, device="cpu", metrics=m,
                         checkpoint_path=str(tmp_path / "ck.npz"),
                         checkpoint_every=2)
    recs = _read_jsonl(p)
    assert recs[0]["driver"] == "chunked" and recs[0]["per_chunk"]
    chunk_events = [r for r in recs if r["event"] == "chunk"]
    assert [r["chunk"] for r in chunk_events] == [0, 1, 2, 3]
    assert all(r["seconds"] >= 0 for r in chunk_events)
    saved = [r["chunks_done"] for r in recs if r["event"] == "checkpoint"]
    assert saved == [2, 4]


# --------------------------------------------------------------- checkpoints

def _truncate_checkpoint(path, keep):
    """Rewrite the checkpoint as if the process had died after `keep`
    chunks were saved."""
    ckpt = dict(np.load(path))
    ckpt["chunks_done"] = keep
    for k in ("color", "aov_normal", "aov_hit", "segments"):
        ckpt[k] = ckpt[k][:keep]
    with open(path, "wb") as f:
        np.savez(f, **ckpt)


def test_checkpoint_resume_bit_identical(tmp_path):
    kw = dict(width=16, height=12, spp=2, max_bounce=3, seed=11,
              chunk_size=96, device="cpu")        # 384 rays, 4 chunks
    straight = trenderer.render(_scene(), **kw)
    path = str(tmp_path / "render.ckpt.npz")
    trenderer.render(_scene(), **kw, checkpoint_path=path)
    _truncate_checkpoint(path, keep=2)
    calls = []
    resumed = trenderer.render(
        _scene(), **kw, checkpoint_path=path,
        metrics=MetricsLogger(stream=_Lines(calls)))
    assert [c["chunk"] for c in calls if c["event"] == "chunk"] == [2, 3]
    np.testing.assert_array_equal(resumed.color, straight.color)
    np.testing.assert_array_equal(resumed.normal, straight.normal)
    np.testing.assert_array_equal(resumed.coverage, straight.coverage)
    assert resumed.segments == straight.segments


class _Lines:
    """A stream that keeps each JSON line written to it."""

    def __init__(self, into):
        self.into = into

    def write(self, line):
        self.into.append(json.loads(line))


def test_checkpoint_signature_mismatch_restarts(tmp_path):
    kw = dict(width=16, height=12, spp=2, max_bounce=3, chunk_size=96,
              device="cpu")
    path = str(tmp_path / "render.ckpt.npz")
    trenderer.render(_scene(), seed=11, checkpoint_path=path, **kw)
    out = trenderer.render(_scene(), seed=12, checkpoint_path=path, **kw)
    want = trenderer.render(_scene(), seed=12, **kw)
    np.testing.assert_array_equal(out.color, want.color)
    # another scene at the same path restarts too
    other = trenderer.render(_scene("two_balls"), seed=12,
                             checkpoint_path=path, **kw)
    np.testing.assert_array_equal(
        other.color, trenderer.render(_scene("two_balls"), seed=12,
                                      **kw).color)


def test_scene_digest_changes_with_the_scene():
    base = trenderer.scene_digest(_scene())
    assert base == trenderer.scene_digest(
        texamples.three_balls().build(accel="flash", device="cpu"))
    moved = texamples.three_balls()
    moved.add_sphere((3.0, 0.0, 0.0), 0.1, 0)
    assert trenderer.scene_digest(moved.build(accel="brute",
                                              device="cpu")) != base
    assert trenderer.scene_digest(_scene("two_balls")) != base
    assert 0 <= base < 2 ** 63


@pytest.mark.parametrize("name", ["three_balls", "one_triangle"])
def test_scene_digest_equals_jax(name):
    assert trenderer.scene_digest(_scene(name)) == \
        jscene_digest(jexamples.SCENES[name]().build(accel="brute"))


# ----------------------------------------------------------------------- CLI

def test_cli_list_scenes(capsys):
    assert cli.main(["list-scenes"]) == 0
    assert capsys.readouterr().out.split() == list(texamples.SCENES)


def test_cli_render_writes_the_srgb_image(tmp_path):
    out_path = str(tmp_path / "out.tga")
    args = ["--scene", "three_balls", "--width", "16", "--height", "16",
            "--spp", "1", "--max-bounce", "3", "--seed", "4",
            "--device", "cpu"]
    metrics = str(tmp_path / "m.jsonl")
    assert cli.main(["render", *args, "--output", out_path,
                     "--metrics", metrics]) == 0
    want = trenderer.render(
        texamples.three_balls().build(device="cpu"), 16, 16, spp=1,
        max_bounce=3, seed=4, device="cpu").srgb()
    np.testing.assert_array_equal(tga.load(out_path), want)
    events = [r["event"] for r in _read_jsonl(metrics)]
    assert events[0] == "render_start" and events[-1] == "render_complete"
    assert "chunk" in events        # the render command shows progress


def test_cli_bench_prints_one_json_line(capsys):
    assert cli.main(["bench", "--scene", "two_balls", "--width", "16",
                     "--height", "8", "--spp", "1", "--max-bounce", "2",
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["segments"] > 0 and rec["rays_per_s"] > 0
    assert rec["device"] == "cpu"


@pytest.mark.parametrize("accel", ["dense", "cluster"])
def test_cli_unported_accels_name_the_roadmap(accel, capsys):
    """ROADMAP item 11 is done: --accel dense|cluster render, and bench
    counts the same segments as the flash path on the same frame."""
    args = ["bench", "--scene", "two_balls", "--width", "16", "--height",
            "8", "--spp", "1", "--max-bounce", "2", "--device", "cpu"]
    assert cli.main(args + ["--accel", accel]) == 0
    assert cli.main(args + ["--accel", "flash"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    got, want = (json.loads(line)["segments"] for line in lines[-2:])
    assert got == want > 0


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["bench", "--scene", "two_balls", "--width", "8",
                  "--height", "8", "--spp", "1"])


# -------------------------------------------------------------- asset scenes

def test_earth_from_a_written_texture_matches_jax(tmp_path):
    assets = str(write_assets(tmp_path))
    kw = dict(spp=2, max_bounce=4, seed=7)
    want = jrender(jexamples.earth(assets).build(accel="brute"), 24, 24,
                   driver="chunked", **kw)
    got = trenderer.render(texamples.earth(assets).build(device="cpu"),
                           24, 24, device="cpu", **kw)
    bad = (np.abs(got.color.astype(np.float64) - want.color) > 2e-3).any(-1)
    assert bad.sum() <= max(1, round(0.002 * bad.size))
    assert got.coverage.mean() > 0.1         # the textured sphere is seen
    np.testing.assert_array_equal(got.coverage, want.coverage)


@pytest.mark.parametrize("name", ["bunny", "glass_bunny"])
def test_mesh_scenes_load_the_written_obj(tmp_path, name):
    assets = str(write_assets(tmp_path))
    ts = texamples.SCENES[name](assets).build(device="cpu")
    js = jexamples.SCENES[name](assets).build(accel="flash")
    for f in ("tri_pa", "tri_pb", "tri_pc", "tri_na", "tri_material"):
        np.testing.assert_array_equal(getattr(ts.tables, f).numpy(),
                                      np.asarray(getattr(js.tables, f)))
    assert ts.num_triangles == 128
