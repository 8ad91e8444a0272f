"""potato_tpu_torch shading, camera, integrator and renderer against the JAX
package on the same numpy inputs and the same tables (CPU, so the flash
kernel's plain PyTorch version runs).

Float tolerances: 1e-5 absolute on shading outputs and one bounce step,
1e-6 on camera rays (same float32 formulas; the frameworks' sqrt, cos,
atan2 and pow differ in the last ulp). Whole images use the gate of
tests/test_render_oracle.py::_compare: per-pixel 2e-3, at most
max(1, 0.2 %) pixels off, because a last-ulp difference at a first hit can
reroute a later segment of a multi-bounce path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from potato_tpu.core import rng as jrng
from potato_tpu.core import sampling as jsampling
from potato_tpu.core.types import HitBatch as JHitBatch
from potato_tpu.ops import material as jmaterial
from potato_tpu.ops import texture as jtexture
from potato_tpu.ops.intersect import intersect_brute_force as jbrute
from potato_tpu.render import integrator as jintegrator
from potato_tpu.render.camera import generate_rays as jgenerate_rays
from potato_tpu.render.renderer import render as jrender
from potato_tpu.scene import description as jd
from potato_tpu.scene import examples as jexamples

from potato_tpu_torch.core import sampling as tsampling
from potato_tpu_torch.core.types import HitBatch
from potato_tpu_torch.ops import material as tmaterial
from potato_tpu_torch.ops import texture as ttexture
from potato_tpu_torch.render import integrator as tintegrator
from potato_tpu_torch.render import renderer as trenderer
from potato_tpu_torch.render.camera import generate_rays as tgenerate_rays
from potato_tpu_torch.scene import examples as texamples

from test_torch_scene import port_scene_from_jax

N = 4096


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every case on one torch thread, restored after the file: the inputs
    are small, and under the suite's other test workers a pool of every
    core waits on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------ shading on random hits

def _all_kinds_scene():
    """Every scatter, absorb, emit and texture kind, each reachable."""
    s = jd.SceneBuilder()
    rng = np.random.default_rng(5)
    t_missing = s.add_texture(jd.Texture.missing())
    t_uvs = s.add_texture(jd.Texture.debug_uvs())
    t_solid = s.add_texture(jd.Texture.solid(0.8, 0.3, 0.1))
    t_image = s.add_texture(jd.Texture.image_(
        rng.uniform(0, 1, (8, 16, 3)).astype(np.float32)))
    t_perlin = s.add_texture(jd.Texture.perlin(3))
    t_noise = s.add_texture(jd.Texture.noise(11))
    t_checker = s.add_texture(jd.Texture.checker(t_solid, t_perlin))
    t_checker2 = s.add_texture(jd.Texture.checker(t_checker, t_image))
    textures = [t_missing, t_uvs, t_solid, t_image, t_perlin, t_noise,
                t_checker, t_checker2]
    scatters = [jd.Scatter.none(), jd.Scatter.lambert(),
                jd.Scatter.metal(0.3), jd.Scatter.metal(0.0),
                jd.Scatter.dielectric(1.5)]
    absorbs = [jd.Absorb.black_body(), jd.Absorb.white_body(),
               jd.Absorb.albedo(0.2, 0.5, 0.9)] + \
        [jd.Absorb.albedo_map(t) for t in textures]
    emits = [jd.Emit.none(), jd.Emit.debug_normals(),
             jd.Emit.color_(2.0, 1.0, 0.5), jd.Emit.sky_gradient(),
             jd.Emit.sky_sphere(t_image), jd.Emit.sky_sphere(t_checker)]
    for i in range(max(len(absorbs), len(emits)) * len(scatters)):
        s.add_material(jd.Material(scatters[i % len(scatters)],
                                   absorbs[i % len(absorbs)],
                                   emits[i % len(emits)]))
    s.add_sphere((0, 0, 0), 1.0, 0)
    s.background = jd.Emit.sky_sphere(t_image)
    return s


_shading = {}


def _shading_case():
    """Both packages' eval_material and sample_texture on the same random
    hits, computed once."""
    if _shading:
        return _shading
    js = _all_kinds_scene().build(accel="brute")
    ts = port_scene_from_jax(js)
    rng = np.random.default_rng(6)

    def unit(v):
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)) \
            .astype(np.float32)

    m = int(js.tables.m_scatter_kind.shape[0])
    nt = int(js.tables.t_kind.shape[0])
    u = [rng.uniform(0, 1, N).astype(np.float32) for _ in range(4)]
    # unit_sphere takes sin from sqrt(1 - cos^2), which magnifies a
    # last-ulp difference of cos by 1/|sin|: keep |sin(2 pi u2)| >= 0.06 so
    # the 1e-5 tolerance speaks about the port, not about that formula
    u[1] = (0.01 + 0.48 * u[1] + 0.5 * (rng.uniform(0, 1, N) < 0.5)) \
        .astype(np.float32)
    data = dict(
        position=rng.uniform(-10, 10, (N, 3)).astype(np.float32),
        normal=unit(rng.normal(size=(N, 3))),
        uv=rng.uniform(0, 1, (N, 2)).astype(np.float32),
        direction=unit(rng.normal(size=(N, 3))),
        material=rng.integers(0, m, N).astype(np.int32),
        tex=rng.integers(0, nt, N).astype(np.int32),
        t=rng.uniform(0.1, 20, N).astype(np.float32))

    jhit = JHitBatch(t=jnp.asarray(data["t"]),
                     position=jnp.asarray(data["position"]),
                     normal=jnp.asarray(data["normal"]),
                     uv=jnp.asarray(data["uv"]),
                     material=jnp.asarray(data["material"]),
                     valid=jnp.ones(N, bool))
    T = torch.from_numpy
    thit = HitBatch(t=T(data["t"]), position=T(data["position"]),
                    normal=T(data["normal"]), uv=T(data["uv"]),
                    material=T(data["material"]).long(),
                    valid=torch.ones(N, dtype=torch.bool))

    jm = jmaterial.eval_material(
        js.tables, jhit.material, jnp.asarray(data["direction"]), jhit,
        *(jnp.asarray(x) for x in u), features=js.features)
    tm = tmaterial.eval_material(
        ts.tables, thit.material, T(data["direction"]), thit,
        *(T(x) for x in u), features=ts.features)
    jt = jtexture.sample_texture(
        js.tables, jnp.asarray(data["tex"]), jhit.position, jhit.uv,
        depth=js.features.checker_depth, kinds=js.features.texture_kinds)
    tt = ttexture.sample_texture(
        ts.tables, T(data["tex"]), thit.position, thit.uv,
        depth=ts.features.checker_depth, kinds=ts.features.texture_kinds)
    # the background: every lane evaluated as a miss
    bk = dict(features=js.features)
    jbg = jmaterial.eval_emit(
        js.tables, jnp.broadcast_to(js.tables.bg_kind, (N,)),
        jnp.broadcast_to(js.tables.bg_color, (N, 3)),
        jnp.broadcast_to(js.tables.bg_tex, (N,)),
        jnp.asarray(data["direction"]), jhit, **bk)
    tbg = tmaterial.eval_emit(
        ts.tables, ts.tables.bg_kind.expand(N),
        ts.tables.bg_color.expand(N, 3), ts.tables.bg_tex.expand(N),
        T(data["direction"]), thit, features=ts.features)

    tab = js.tables
    mid = data["material"]
    _shading.update(
        js=js, ts=ts, jm=jm, tm=tm, jt=_np(jt), tt=_np(tt),
        thit=thit, tu=[T(x) for x in u], tdir=T(data["direction"]),
        jbg=_np(jbg), tbg=_np(tbg),
        scatter_kind=_np(tab.m_scatter_kind)[mid],
        absorb_kind=_np(tab.m_absorb_kind)[mid],
        emit_kind=_np(tab.m_emit_kind)[mid],
        tex_kind=_np(tab.t_kind)[data["tex"]])
    return _shading


@pytest.mark.parametrize("kind", [jd.SCATTER_NONE, jd.SCATTER_LAMBERT,
                                  jd.SCATTER_METAL, jd.SCATTER_DIELECTRIC])
def test_eval_material_scatter_matches_jax(kind):
    c = _shading_case()
    lanes = c["scatter_kind"] == kind
    assert lanes.sum() > 100
    jv = _np(c["jm"].scatter.valid)[lanes]
    tv = _np(c["tm"].scatter.valid)[lanes]
    # a validity test or a Bernoulli draw that sits within an ulp of its
    # threshold may fall the other way
    assert (jv == tv).mean() >= 0.999
    jdir = _np(c["jm"].scatter.direction)[lanes]
    tdir = _np(c["tm"].scatter.direction)[lanes]
    close = np.abs(jdir - tdir).max(axis=-1) <= 1e-5
    assert close.mean() >= (0.999 if kind == jd.SCATTER_DIELECTRIC else 1.0)


@pytest.mark.parametrize("kind", [jd.ABSORB_BLACK_BODY, jd.ABSORB_WHITE_BODY,
                                  jd.ABSORB_ALBEDO, jd.ABSORB_ALBEDO_MAP])
def test_eval_material_absorb_matches_jax(kind):
    c = _shading_case()
    lanes = c["absorb_kind"] == kind
    assert lanes.sum() > 100
    np.testing.assert_allclose(_np(c["tm"].absorb)[lanes],
                               _np(c["jm"].absorb)[lanes], rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", [jd.EMIT_NONE, jd.EMIT_DEBUG_NORMALS,
                                  jd.EMIT_COLOR, jd.EMIT_SKY_GRADIENT,
                                  jd.EMIT_SKY_SPHERE])
def test_eval_material_emit_matches_jax(kind):
    c = _shading_case()
    lanes = c["emit_kind"] == kind
    assert lanes.sum() > 100
    np.testing.assert_allclose(_np(c["tm"].emit)[lanes],
                               _np(c["jm"].emit)[lanes], rtol=0, atol=1e-5)


def test_eval_emit_background_matches_jax():
    c = _shading_case()
    np.testing.assert_allclose(c["tbg"], c["jbg"], rtol=0, atol=1e-5)
    assert np.abs(c["tbg"]).sum() > 0


@pytest.mark.parametrize("kind", [jd.TEX_MISSING, jd.TEX_DEBUG_UVS,
                                  jd.TEX_SOLID, jd.TEX_IMAGE, jd.TEX_CHECKER,
                                  jd.TEX_NOISE, jd.TEX_PERLIN])
def test_sample_texture_matches_jax(kind):
    c = _shading_case()
    lanes = c["tex_kind"] == kind
    assert lanes.sum() > 100
    np.testing.assert_allclose(c["tt"][lanes], c["jt"][lanes],
                               rtol=0, atol=1e-5)
    if kind != jd.TEX_MISSING:
        assert np.abs(c["tt"][lanes]).sum() > 0


def test_out_of_range_ids_read_the_clamped_row():
    """torch indexing raises or wraps on an out-of-range id; the port
    clamps, as the reference's gather path does."""
    c = _shading_case()
    ts = c["ts"]
    nt = ts.tables.t_kind.shape[0]
    pos = torch.zeros(3, 3)
    uv = torch.full((3, 2), 0.5)
    ids = torch.tensor([-7, nt - 1, nt + 100])
    out = ttexture.sample_texture(ts.tables, ids, pos, uv, depth=2)
    first = ttexture.sample_texture(ts.tables, torch.tensor([0]), pos[:1],
                                    uv[:1], depth=2)
    assert torch.equal(out[0], first[0])
    assert torch.equal(out[1], out[2])


def test_ior_score_waits_for_the_differentiable_slice():
    """The differentiable slice has come: ior_score=True leaves every
    forward value as it is (the score weight is exactly 1) on every
    material of the all-kinds scene; tests/test_torch_diff.py holds its
    gradient."""
    c = _shading_case()
    ts, thit, tu = c["ts"], c["thit"], c["tu"]
    args = (ts.tables, thit.material, c["tdir"], thit, *tu)
    plain = tmaterial.eval_material(*args)
    scored = tmaterial.eval_material(*args, ior_score=True)
    assert torch.equal(scored.scatter.weight, torch.ones_like(tu[0]))
    for a, b in ((plain.absorb, scored.absorb), (plain.emit, scored.emit),
                 (plain.scatter.direction, scored.scatter.direction),
                 (plain.scatter.valid, scored.scatter.valid)):
        assert torch.equal(a, b)


# ------------------------------------------------------- camera, a bounce

@pytest.mark.parametrize("scene,jitter", [("three_balls", True),
                                          ("three_balls", False),
                                          ("two_balls", True)])
def test_generate_rays_matches_jax(scene, jitter):
    js = jexamples.SCENES[scene]().build(accel="brute")
    ts = port_scene_from_jax(js)
    ids = np.random.default_rng(1).integers(0, 40 * 30 * 3, 2048)
    lens = js.features.has_lens
    want = jgenerate_rays(js.camera, 40, 30, 3, jnp.asarray(ids, jnp.uint32),
                          17, jitter=jitter, lens=lens)
    got = tgenerate_rays(ts.camera, 40, 30, 3, torch.from_numpy(ids), 17,
                         jitter=jitter, lens=lens)
    for f in ("origin", "direction", "t_min", "t_max"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   _np(getattr(want, f)), rtol=0, atol=1e-6,
                                   err_msg=f)


def _ulps(a, b):
    """Distance of two float32 arrays in units in the last place (same
    sign; the bit patterns of positive floats count up with the value)."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


@pytest.mark.parametrize("scene", ["three_balls", "more_balls",
                                   "two_balls"])
def test_camera_rays_bit_equal_to_jax_eager(scene):
    """Camera rays against the reference's eager generate_rays, bit for
    bit wherever the port's own arithmetic decides them: the integer
    pixel and sample split, the threefry draws, and every square root
    (core/math.py::sqrt is correctly rounded, as XLA's is; torch's float32
    square root on the CPU is one ulp off on about a fifth of inputs on
    some CPUs). What is left is the lens disk's sin and cos (libm against
    XLA's polynomial, each within an ulp or two of the true value): where
    the two disk samples differ, the ray may differ by 4 ulps at most
    (reading: 1 in the origin, 4 in the direction, 38 of 12 288 lanes). A
    pinhole camera draws no disk, so every lane is bit-equal."""
    js = jexamples.SCENES[scene]().build(accel="brute")
    ts = port_scene_from_jax(js)
    w, h, spp, seed = 64, 48, 4, 7
    ids = np.arange(w * h * spp)
    jids, tids = jnp.asarray(ids, jnp.uint32), torch.from_numpy(ids)
    lens = js.features.has_lens
    want = jgenerate_rays(js.camera, w, h, spp, jids, seed, lens=lens)
    got = tgenerate_rays(ts.camera, w, h, spp, tids, seed, lens=lens)
    same_disk = np.ones(ids.size, bool)
    if lens:
        u = jrng.uniform2(seed, jrng.STREAM_LENS, jids)
        same_disk = (_np(jsampling.unit_disk(*u)) == _np(
            tsampling.unit_disk(*(torch.from_numpy(_np(x)) for x in u)))
        ).all(-1)
        assert 0.8 < same_disk.mean() < 1.0
    for f in ("origin", "direction", "t_min", "t_max"):
        a, b = _np(getattr(got, f)), _np(getattr(want, f))
        off = a != b
        off = off.any(-1) if off.ndim > 1 else off
        assert not (off & same_disk).any(), f
        assert _ulps(a, b).max() <= 4, f


def test_one_bounce_step_matches_jax():
    """Two transitions of the bounce loop on three_balls (lambert, metal,
    dielectric, thin lens): same rays in, state to 1e-5 out."""
    js = jexamples.three_balls().build(accel="brute")
    ts = port_scene_from_jax(jexamples.three_balls().build(accel="flash"))
    ids = np.arange(24 * 24 * 2)
    jids, tids = jnp.asarray(ids, jnp.uint32), torch.from_numpy(ids)
    jstate = jintegrator.init_state(
        jgenerate_rays(js.camera, 24, 24, 2, jids, 7))
    tstate = tintegrator.init_state(
        tgenerate_rays(ts.camera, 24, 24, 2, tids, 7))
    jstep = jintegrator.make_bounce_step(js.tables, jbrute, 7,
                                         features=js.features)
    tstep = tintegrator.make_bounce_step(
        ts.tables, trenderer.make_intersect_fn(ts), 7, features=ts.features)
    for bounce in range(2):
        jstate = jstep(jstate, bounce, jids)
        tstate = tstep(tstate, bounce, tids)
        same = _np(jstate.active) == _np(tstate.active)
        assert same.mean() >= 0.998, bounce   # edge-grazing lanes may flip
        for name in ("radiance", "throughput", "aov_normal"):
            np.testing.assert_allclose(
                _np(getattr(tstate, name))[same],
                _np(getattr(jstate, name))[same], rtol=0, atol=1e-5,
                err_msg=f"{name} after bounce {bounce}")
        live = same & _np(jstate.active)
        # hit points lie up to ~10 units out: 1e-5 relative to that
        np.testing.assert_allclose(_np(tstate.rays.origin)[live],
                                   _np(jstate.rays.origin)[live],
                                   rtol=1e-5, atol=1e-5)
        close = np.abs(_np(tstate.rays.direction)[live]
                       - _np(jstate.rays.direction)[live]).max(-1) <= 1e-4
        assert close.mean() >= 0.998
        assert abs(int(tstate.segments) - int(jstate.segments)) <= 2
    assert int(tstate.segments) > ids.size


# ------------------------------------------------------------------ images

@pytest.mark.parametrize("name,jax_accel,size,bounces", [
    ("three_balls", "brute", 24, 4),
    ("two_balls", "brute", 24, 4),
    ("one_triangle", "flash", 24, 4),
    ("more_balls", "brute", 16, 4),
])
def test_image_matches_jax_render(name, jax_accel, size, bounces,
                                  tol=2e-3, mismatch_frac=0.002):
    spp, seed = 2, 7
    js = jexamples.SCENES[name]().build(accel=jax_accel)
    want = jrender(js, size, size, spp=spp, max_bounce=bounces, seed=seed,
                   driver="chunked")
    ts = _port_scene(name)
    got = trenderer.render(ts, size, size, spp=spp, max_bounce=bounces,
                           seed=seed, driver="chunked", device="cpu")
    assert got.color.shape == (size, size, 3)
    assert np.isfinite(got.color).all()
    bad = (np.abs(got.color.astype(np.float64) - want.color) > tol).any(-1)
    allowed = max(1, round(mismatch_frac * bad.size))
    assert bad.sum() <= allowed, f"{bad.sum()} pixels off > {allowed}"
    # a flipped sample changes the length of one path
    assert abs(got.segments - want.segments) <= allowed * spp * bounces
    np.testing.assert_allclose(got.coverage, want.coverage, atol=0.5 / spp
                               if bad.sum() else 0)


def _port_scene(name):
    """The port's own build (flash accel) of an example scene."""
    return texamples.SCENES[name]().build(accel="flash", device="cpu")


@pytest.mark.parametrize("width,height,chunk", [(16, 12, 100), (16, 16, 200)])
def test_chunk_size_invariance(width, height, chunk):
    """Chunking is an implementation detail: a chunk size that does not
    divide the frame (tail lanes born dead) gives a bit-identical image and
    the same segment count; 16x16 also runs the tile-swizzled ray order."""
    ts = _port_scene("three_balls")
    kw = dict(spp=2, max_bounce=3, seed=5, driver="chunked", device="cpu")
    a = trenderer.render(ts, width, height, **kw)
    b = trenderer.render(ts, width, height, chunk_size=chunk, **kw)
    np.testing.assert_array_equal(a.color, b.color)
    np.testing.assert_array_equal(a.normal, b.normal)
    assert a.segments == b.segments >= width * height * 2


def test_compile_frame_runs_the_same_frame_on_the_device():
    ts = _port_scene("one_triangle")
    frame_fn, starts = trenderer.compile_frame(
        ts, 16, 8, spp=2, max_bounce=3, chunk_size=100, driver="chunked",
        device="cpu")
    out = frame_fn(ts.tables, ts.camera, 9, starts)
    assert out.color.shape == (3, 100, 3) and starts.tolist() == [0, 100, 200]
    ref = trenderer.render(ts, 16, 8, spp=2, max_bounce=3, seed=9,
                           chunk_size=100, driver="chunked", device="cpu")
    assert int(out.segments.sum()) == ref.segments
    srgb = ref.srgb()
    assert srgb.shape == (8, 16, 4) and srgb.dtype == np.uint8
