"""potato_tpu_torch's alternative accelerators (ops/dense.py, scene/bvh.py +
ops/traverse.py) and the regeneration-pool driver (render/wavefront.py)
against brute force, the chunked driver and the JAX package, on the same
numpy-seeded scenes and rays (CPU).

- The accel builds are host numpy in both packages: arrays equal bit for
  bit.
- Dense against brute force: the gates of tests/test_dense.py (valid-mask
  agreement > 99.5 %, t rtol 1e-3 atol 2e-3, material > 99.5 %): the
  matrix product sums the pair terms in another order than the brute-force
  formulas, so near-tangent hits may flip on a tiny fraction of rays.
- Clustered against brute force: the gates of tests/test_traverse.py
  (valid equal, t rtol 1e-4 atol 1e-3, material equal): both run the same
  pair formulas.
- Against the JAX functions on the same rays: the same gates.
- Images through dense / cluster against the flash image: the gate of
  tests/test_render_oracle.py::_compare (per-pixel 2e-3, at most
  max(1, 0.2 %) pixels off).
- The pool driver against the chunked driver: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from potato_tpu.core.types import RayBatch as JRayBatch
from potato_tpu.ops.dense import intersect_dense as jintersect_dense
from potato_tpu.ops.traverse import intersect_clustered as jclustered
from potato_tpu.scene import bvh as jbvh
from potato_tpu.scene import description as jd
from potato_tpu.scene import examples as jexamples

from potato_tpu_torch import cli
from potato_tpu_torch.core.types import BIG, RAY_EPSILON, RayBatch
from potato_tpu_torch.ops import dense as tdense
from potato_tpu_torch.ops.intersect import intersect_brute_force
from potato_tpu_torch.ops.traverse import intersect_clustered
from potato_tpu_torch.render import renderer as trenderer
from potato_tpu_torch.render.wavefront import render_pool
from potato_tpu_torch.scene import bvh as tbvh
from potato_tpu_torch.scene import description as td
from potato_tpu_torch.scene import examples as texamples


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every case on one torch thread, restored after the file: the inputs
    are small, and under the suite's other test workers a pool of every
    core waits on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------- seeded scenes, rays

def sphere_scene(d, seed, n):
    rng = np.random.default_rng(seed)
    s = d.SceneBuilder()
    for _ in range(4):
        s.add_material(d.Material(d.Scatter.lambert(),
                                  d.Absorb.albedo(0.5, 0.5, 0.5),
                                  d.Emit.none()))
    for _ in range(n):
        s.add_sphere(rng.uniform(-5, 5, 3), rng.uniform(0.1, 1.5),
                     rng.integers(0, 4))
    return s


def tri_scene(d, seed, n):
    rng = np.random.default_rng(seed)
    s = d.SceneBuilder()
    s.add_material(d.Material(d.Scatter.lambert(),
                              d.Absorb.albedo(0.5, 0.5, 0.5), d.Emit.none()))
    base = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    idx = np.arange(n, dtype=np.int32)
    s.add_mesh(d.MeshData(
        positions=np.concatenate([base, base + e1, base + e2]),
        normals=rng.normal(size=(3 * n, 3)).astype(np.float32),
        uvs=rng.uniform(0, 1, (3 * n, 2)).astype(np.float32),
        indices=np.stack([idx, idx + n, idx + 2 * n], axis=1)), 0)
    return s


def mixed_scene(d, seed, n):
    s = sphere_scene(d, seed, n)
    tri = tri_scene(d, seed + 1, n + n // 2)
    s.meshes, s.mesh_materials = tri.meshes, tri.mesh_materials
    return s


KINDS = {"spheres": sphere_scene, "triangles": tri_scene,
         "mixed": mixed_scene}
CASES = [("spheres", 4), ("spheres", 100), ("triangles", 5),
         ("triangles", 333), ("mixed", 60)]


def random_rays(seed, b=512):
    rng = np.random.default_rng(seed)
    origin = rng.uniform(-8, 8, (b, 3)).astype(np.float32)
    direction = rng.normal(size=(b, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    tmin = np.full(b, RAY_EPSILON, np.float32)
    tmax = np.full(b, BIG, np.float32)
    port = RayBatch(*(torch.from_numpy(a) for a in
                      (origin, direction, tmin, tmax)))
    ref = JRayBatch(*(jnp.asarray(a) for a in
                      (origin, direction, tmin, tmax)))
    return port, ref


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_dense_gate(got, want, atol=2e-3):
    """tests/test_dense.py::_assert_same."""
    same_valid = _np(got.valid) == _np(want.valid)
    assert same_valid.mean() > 0.995, f"{(~same_valid).sum()} valid flips"
    v = _np(want.valid) & same_valid
    np.testing.assert_allclose(_np(got.t)[v], _np(want.t)[v], rtol=1e-3,
                               atol=atol)
    assert (_np(got.material)[v] == _np(want.material)[v]).mean() > 0.995


def assert_cluster_gate(got, want, atol=1e-3):
    """tests/test_traverse.py::_assert_same_hits."""
    np.testing.assert_array_equal(_np(got.valid), _np(want.valid))
    v = _np(want.valid)
    np.testing.assert_allclose(_np(got.t)[v], _np(want.t)[v], rtol=1e-4,
                               atol=atol)
    np.testing.assert_array_equal(_np(got.material)[v], _np(want.material)[v])
    np.testing.assert_allclose(_np(got.normal)[v], _np(want.normal)[v],
                               rtol=1e-3, atol=atol)
    np.testing.assert_allclose(_np(got.uv)[v], _np(want.uv)[v], rtol=1e-3,
                               atol=atol)


def assert_records_equal(jrec, trec):
    for f in trec._fields:
        got = getattr(trec, f)
        if not isinstance(got, torch.Tensor):
            assert got == getattr(jrec, f), f
            continue
        want = np.asarray(getattr(jrec, f))
        assert got.numpy().dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


def _pair(kind, n, accel, **kw):
    make = KINDS[kind]
    return (make(jd, n + 7, n).build(accel=accel, **kw),
            make(td, n + 7, n).build(accel=accel, device="cpu", **kw))


# ------------------------------------------------------------ the builds

@pytest.mark.parametrize("name", ["three_balls", "more_balls",
                                  "one_triangle", "mixed"])
def test_dense_accel_equals_jax_build(name):
    if name == "mixed":
        js, ts = _pair("mixed", 60, "dense")
    else:
        js = jexamples.SCENES[name]().build(accel="dense")
        ts = texamples.SCENES[name]().build(accel="dense", device="cpu")
    assert_records_equal(js.accel, ts.accel)


@pytest.mark.parametrize("name,cluster_size", [("more_balls", 32),
                                               ("one_triangle", 32),
                                               ("mixed", 8), ("mixed", 64)])
def test_cluster_accel_equals_jax_build(name, cluster_size):
    if name == "mixed":
        js, ts = _pair("mixed", 60, "cluster", cluster_size=cluster_size)
    else:
        js = jexamples.SCENES[name]().build(accel="cluster",
                                            cluster_size=cluster_size)
        ts = texamples.SCENES[name]().build(
            accel="cluster", device="cpu", cluster_size=cluster_size)
    assert_records_equal(js.accel, ts.accel)
    assert ts.accel.num_clusters == js.accel.num_clusters
    assert ts.accel.cluster_size == cluster_size


def test_morton_codes_equal_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-3, 7, (5000, 3)).astype(np.float32)
    lo, hi = pts.min(0), pts.max(0)
    want = jbvh.morton_codes(pts, lo, hi)
    got = tbvh.morton_codes(pts, lo, hi)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # degenerate extent (every point equal) quantizes to code 0
    np.testing.assert_array_equal(
        tbvh.morton_codes(pts[:1].repeat(4, 0), pts[0], pts[0]), 0)


# ---------------------------------------------------------- the intersectors

@pytest.mark.parametrize("kind,n", CASES)
def test_intersect_dense_equals_brute_and_jax(kind, n):
    js, ts = _pair(kind, n, "dense")
    rays, jrays = random_rays(n)
    got = tdense.intersect_dense(ts.accel, ts.tables, rays)
    assert_dense_gate(got, intersect_brute_force(ts.tables, rays))
    assert_dense_gate(got, jintersect_dense(js.accel, js.tables, jrays))
    # blocks of rays give each ray the answer of one whole product
    blocked = tdense.intersect_dense(ts.accel, ts.tables, rays,
                                     block_rays=96)
    for f in ("t", "valid", "material"):
        np.testing.assert_array_equal(_np(getattr(blocked, f)),
                                      _np(getattr(got, f)), err_msg=f)


@pytest.mark.parametrize("kind,n", CASES)
def test_intersect_clustered_equals_brute_and_jax(kind, n):
    js, ts = _pair(kind, n, "cluster")
    rays, jrays = random_rays(n + 1)
    got = intersect_clustered(ts.accel, rays)
    assert_cluster_gate(got, intersect_brute_force(ts.tables, rays))
    assert_cluster_gate(got, jclustered(js.accel, jrays))


def test_dense_products_refuse_tf32():
    """The products run in full float32: the switch is read at the call
    (on a CUDA tensor a TF32 setting raises); nothing flips it."""
    matmul = torch.backends.cuda.matmul
    before = (matmul.allow_tf32, torch.get_float32_matmul_precision())
    assert not tdense._tf32_allowed()
    try:
        torch.set_float32_matmul_precision("high")
        assert tdense._tf32_allowed()
    finally:
        torch.set_float32_matmul_precision(before[1])
    assert (matmul.allow_tf32, torch.get_float32_matmul_precision()) \
        == before
    assert not tdense._tf32_allowed()


# ------------------------------------------------------------ whole images

def _compare(got, want):
    """tests/test_render_oracle.py::_compare."""
    bad = (np.abs(got.color.astype(np.float64) - want.color) > 2e-3).any(-1)
    assert bad.sum() <= max(1, round(0.002 * bad.size)), bad.sum()


_flash = {}


def _flash_image(name, size, spp, bounces):
    key = (name, size, spp, bounces)
    if key not in _flash:
        s = texamples.SCENES[name]().build(accel="flash", device="cpu")
        _flash[key] = trenderer.render(s, size, size, spp=spp,
                                       max_bounce=bounces, seed=5,
                                       device="cpu")
    return _flash[key]


@pytest.mark.parametrize("name,accel", [("three_balls", "dense"),
                                        ("three_balls", "cluster"),
                                        ("more_balls", "dense"),
                                        ("more_balls", "cluster")])
def test_render_through_alternative_accels_matches_flash(name, accel):
    size, spp, bounces = 32, 2, 4
    s = texamples.SCENES[name]().build(accel=accel, device="cpu")
    got = trenderer.render(s, size, size, spp=spp, max_bounce=bounces,
                           seed=5, device="cpu")
    want = _flash_image(name, size, spp, bounces)
    _compare(got, want)
    np.testing.assert_array_equal(got.coverage, want.coverage)
    assert np.isfinite(got.color).all()


@pytest.mark.parametrize("accel", ["dense", "cluster"])
def test_cli_renders_with_alternative_accels(accel, tmp_path, capsys):
    out = tmp_path / f"{accel}.tga"
    assert cli.main(["render", "--scene", "two_balls", "--width", "16",
                     "--height", "8", "--spp", "1", "--max-bounce", "2",
                     "--accel", accel, "--cluster-size", "16",
                     "--device", "cpu", "--output", str(out)]) == 0
    assert out.stat().st_size > 18
    assert cli.main(["bench", "--scene", "two_balls", "--width", "16",
                     "--height", "8", "--spp", "1", "--max-bounce", "2",
                     "--accel", accel, "--device", "cpu"]) == 0
    assert '"segments"' in capsys.readouterr().out


# -------------------------------------------------------------- the pool

@pytest.mark.parametrize("name,accel,w,h,spp,pool,bounces", [
    # 1024 rays through a 512-lane pool: at least one full regeneration
    ("three_balls", "brute", 16, 16, 4, 512, 4),
    # the flash path under the pool loop, swizzled frame
    ("one_triangle", "flash", 16, 16, 2, 512, 4),
    ("two_balls", "brute", 12, 12, 2, 512, 4),      # pool larger than frame
    # the kernel's sphere phase, long paths, a pool that is no power of two
    ("more_balls", "flash", 32, 16, 2, 300, 8),
])
def test_render_pool_equals_chunked(name, accel, w, h, spp, pool, bounces):
    s = texamples.SCENES[name]().build(accel=accel, device="cpu")
    kw = dict(spp=spp, max_bounce=bounces, seed=9, device="cpu")
    want = trenderer.render(s, w, h, driver="chunked", **kw)
    got = render_pool(s, w, h, pool=pool, **kw)
    np.testing.assert_array_equal(got.color, want.color)
    np.testing.assert_array_equal(got.normal, want.normal)
    np.testing.assert_array_equal(got.coverage, want.coverage)
    assert got.segments == want.segments


def test_render_pool_defaults_to_the_card():
    s = texamples.two_balls().build(accel="brute", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        render_pool(s, 8, 8, spp=1)
