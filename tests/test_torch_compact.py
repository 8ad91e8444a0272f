"""potato_tpu_torch's compacted breadth-first driver (render/compact.py).

The compact driver must equal the port's chunked driver BIT for bit: a
path's radiance is a per-lane function of (seed, ray id, bounce) and of the
state the pool copies exactly, and the intersector returns each ray's
nearest hit whatever rays share its block. Any difference means the
compaction leaked into the math (a wrong ray id carried, a stale row not
masked, a retirement written twice or never).

Against the JAX package: the survivor sort key bit for bit on the same
numpy inputs, and one image of the JAX compact driver under the gate of
tests/test_render_oracle.py::_compare (per-pixel 2e-3, at most
max(1, 0.2 %) pixels off; the frameworks' transcendental functions differ
in the last ulp, which a multi-bounce path can magnify), segments equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from potato_tpu.render.renderer import render as jrender
from potato_tpu.scene import examples as jexamples

from potato_tpu_torch.render import compact as tcompact
from potato_tpu_torch.render import renderer as trenderer
from potato_tpu_torch.scene import examples as texamples

from test_torch_io import write_assets

_scenes = {}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every case on one torch thread, restored after the file: the inputs
    are small, and under the suite's other test workers a pool of every
    core waits on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(name, accel):
    if (name, accel) not in _scenes:
        _scenes[name, accel] = texamples.SCENES[name]().build(
            accel=accel, device="cpu")
    return _scenes[name, accel]


def _assert_identical(a, b):
    assert a.segments == b.segments
    np.testing.assert_array_equal(a.color, b.color)
    np.testing.assert_array_equal(a.normal, b.normal)
    np.testing.assert_array_equal(a.coverage, b.coverage)


def _both(scene, width, height, **kw):
    kw.setdefault("device", "cpu")
    a = trenderer.render(scene, width, height, driver="chunked", **kw)
    b = trenderer.render(scene, width, height, driver="compact", **kw)
    return a, b


# ------------------------------------------- compact equals chunked, exactly

@pytest.mark.parametrize("name,accel,width,height,kw", [
    # dielectric: paths diverge in length, so the pool shrinks gradually
    # and partial passes, retirement scatters and the flush all run
    ("three_balls", "brute", 64, 32,
     dict(spp=2, max_bounce=8, seed=3, chunk_size=512)),
    # max_bounce=1: no bounce pass at all, survivors go straight to the
    # flush; an odd frame turns the tile swizzle off and leaves a
    # partially dead tail chunk
    ("two_balls", "brute", 33, 17,
     dict(spp=3, max_bounce=1, seed=7, chunk_size=500)),
    # the flash intersector (its kernel's plain version on the CPU): the
    # blocks hold other rays under each driver, the results may not differ
    ("three_balls", "flash", 32, 16,
     dict(spp=2, max_bounce=6, seed=1, chunk_size=512)),
    # thousands of spheres: the kernel's sphere phase and the dense split
    ("more_balls", "flash", 24, 16,
     dict(spp=2, max_bounce=8, seed=5, chunk_size=256)),
])
def test_compact_equals_chunked(name, accel, width, height, kw):
    a, b = _both(_scene(name, accel), width, height, **kw)
    _assert_identical(a, b)
    assert a.segments >= width * height * kw["spp"]


@pytest.mark.parametrize("seed,chunk", [(0, 100), (11, 333), (4, 4096)])
def test_compact_equals_chunked_across_seeds_and_chunks(seed, chunk):
    """A chunk size that does not divide the frame, one that is a lane
    short of whole blocks, and one larger than the frame."""
    a, b = _both(_scene("three_balls", "flash"), 16, 16, spp=3,
                 max_bounce=5, seed=seed, chunk_size=chunk)
    _assert_identical(a, b)


def test_default_render_of_a_dielectric_scene_is_compact():
    """render() without `driver` takes the compact driver on a dielectric
    scene and gives the chunked image."""
    scene = texamples.three_balls().build(device="cpu")
    assert trenderer.default_driver(scene) == "compact"
    got = trenderer.render(scene, 64, 32, spp=2, device="cpu")
    want = trenderer.render(scene, 64, 32, spp=2, driver="chunked",
                            device="cpu")
    _assert_identical(got, want)


def test_compile_frame_compact_stacks_chunks_and_counts_passes():
    scene = _scene("three_balls", "flash")
    frame_fn, starts = trenderer.compile_frame(
        scene, 16, 8, spp=2, max_bounce=4, chunk_size=100, driver="compact",
        device="cpu")
    out = frame_fn(scene.tables, scene.camera, 9, starts)
    assert out.color.shape == (3, 100, 3) and out.aov_hit.shape == (3, 100)
    # the frame's segments sit in element 0
    assert int(out.segments[0]) > 0 and not out.segments[1:].any()
    ref = trenderer.render(scene, 16, 8, spp=2, max_bounce=4, seed=9,
                           chunk_size=100, driver="chunked", device="cpu")
    assert int(out.segments.sum()) == ref.segments
    # bounce 0 over the three chunks, then never more passes than chunks,
    # then the flush
    passes = frame_fn.passes
    assert passes[0] == 3 and len(passes) <= 4 + 1
    assert all(p <= 3 for p in passes[1:])


@pytest.mark.parametrize("name", ["three_balls", "more_balls"])
def test_every_scatter_index_is_distinct_and_in_range(name, monkeypatch):
    """index_copy_ with a repeated index keeps an unspecified write, and an
    index out of range is a device assert on CUDA: every scatter of the
    driver (pool packing, retirement, flush) must have neither."""
    scene = _scene(name, "flash")
    calls = []
    original = torch.Tensor.index_copy_

    def checked(self, dim, index, source):
        assert dim == 0 and index.dtype == torch.int64
        assert int(index.min()) >= 0 and int(index.max()) < self.shape[0]
        assert torch.unique(index).numel() == index.numel()
        calls.append(index.numel())
        return original(self, dim, index, source)

    monkeypatch.setattr(torch.Tensor, "index_copy_", checked)
    trenderer.render(scene, 16, 16, spp=2, max_bounce=8, seed=2,
                     chunk_size=200, driver="compact", device="cpu")
    assert len(calls) > 5 * 2


# ---------------------------------------------- the survivor key, bit exact

def _reference_key(keep, p, d):
    """The key of potato_tpu/render/compact.py::compact_into (:136-155),
    as the reference computes it, in JAX."""
    i32 = jnp.int32
    octant = ((d[:, 0] < 0).astype(i32) * 4 +
              (d[:, 1] < 0).astype(i32) * 2 +
              (d[:, 2] < 0).astype(i32))
    lo = jnp.min(p, axis=0)
    hi = jnp.max(p, axis=0)
    q = jnp.clip((p - lo) / jnp.maximum(hi - lo, 1e-6) * 15.999,
                 0, 15).astype(i32)
    morton = jnp.zeros(p.shape[0], i32)
    for bit in range(4):
        for axis in range(3):
            morton = morton | (((q[:, axis] >> bit) & 1) << (3 * bit + axis))
    key = ((~keep).astype(i32) * (8 << 12) + octant * (1 << 12) + morton)
    _, order = jax.lax.sort((key, jax.lax.iota(i32, p.shape[0])),
                            num_keys=1, is_stable=True)
    return np.asarray(key), np.asarray(order)


def _key_inputs(case, n=1000, seed=3):
    rng = np.random.default_rng(seed)
    origin = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    direction = rng.normal(size=(n, 3)).astype(np.float32)
    keep = rng.uniform(size=n) < 0.6
    if case == "dead_at_origin":       # what the bounce step leaves
        origin[~keep] = 0.0
    elif case == "stale_nan_big":      # stale rows: NaN, +-BIG, garbage
        dead = np.flatnonzero(~keep)
        origin[dead[0::4]] = np.nan
        origin[dead[1::4]] = 3e38
        origin[dead[2::4]] = -3e38
        direction[dead[3::4]] = np.nan
    elif case == "big_only":           # overflowing box, no NaN input
        dead = np.flatnonzero(~keep)
        origin[dead[0::2]] = 3e38
        origin[dead[1::2]] = -3e38
    elif case == "flat_box":           # every origin equal: 1e-6 extent
        origin[:] = origin[0]
    return keep, origin, direction


@pytest.mark.parametrize("case", ["random", "dead_at_origin",
                                  "stale_nan_big", "big_only", "flat_box"])
def test_survivor_key_equals_the_reference_key(case):
    keep, origin, direction = _key_inputs(case)
    want_key, want_order = _reference_key(
        jnp.asarray(keep), jnp.asarray(origin), jnp.asarray(direction))
    got = tcompact.survivor_key(torch.from_numpy(keep),
                                torch.from_numpy(origin),
                                torch.from_numpy(direction))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_key)
    order = torch.sort(got, stable=True)[1].numpy()
    np.testing.assert_array_equal(order, want_order)
    # every survivor before every dead lane
    kept = int(keep.sum())
    assert keep[order[:kept]].all() and not keep[order[kept:]].any()


def test_compact_into_packs_survivors_in_key_order():
    keep, origin, direction = _key_inputs("stale_nan_big", n=256)
    C, n_out = 256, 40
    pool = tcompact.new_pool(C + n_out, "cpu")
    st = tcompact.unpack(tcompact.new_pool(C, "cpu"), 0, C, C)._replace(
        active=torch.from_numpy(keep))
    st = st._replace(rays=st.rays._replace(
        origin=torch.from_numpy(origin), direction=torch.from_numpy(direction)))
    raw = torch.arange(1000, 1000 + C)
    n = tcompact.compact_into(pool, st, raw, torch.tensor(n_out))
    kept = int(keep.sum())
    assert int(n) == n_out + kept
    order = torch.sort(tcompact.survivor_key(
        st.active, st.rays.origin, st.rays.direction), stable=True)[1]
    np.testing.assert_array_equal(pool.raw[n_out:n_out + C].numpy(),
                                  raw[order].numpy())
    assert not pool.raw[:n_out].any()       # rows before n_out untouched
    np.testing.assert_array_equal(
        pool.direction[n_out:n_out + kept].numpy(),
        direction[order[:kept].numpy()])


# ------------------------------------------------------ driver policy, JAX

@pytest.mark.parametrize("name,want", [
    ("three_balls", "compact"), ("two_balls", "chunked"),
    ("one_triangle", "chunked"), ("glass_bunny", "compact"),
    ("earth", "chunked")])
def test_default_driver_policy(name, want, tmp_path):
    assets = write_assets(tmp_path)
    make = texamples.SCENES[name]
    builder = make(str(assets)) if name in ("glass_bunny", "earth") \
        else make()
    assert trenderer.default_driver(builder.build(accel="brute",
                                                  device="cpu")) == want


def test_compact_image_matches_jax_compact_driver():
    kw = dict(spp=2, max_bounce=8, seed=3, chunk_size=512)
    want = jrender(jexamples.three_balls().build(accel="brute"), 64, 32,
                   driver="compact", **kw)
    got = trenderer.render(_scene("three_balls", "brute"), 64, 32,
                           driver="compact", device="cpu", **kw)
    bad = (np.abs(got.color.astype(np.float64) - want.color) > 2e-3).any(-1)
    allowed = max(1, round(0.002 * bad.size))
    assert bad.sum() <= allowed, f"{bad.sum()} pixels off > {allowed}"
    assert got.segments == want.segments
    np.testing.assert_array_equal(got.coverage, want.coverage)
