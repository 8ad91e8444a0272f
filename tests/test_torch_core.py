"""potato_tpu_torch.core against potato_tpu.core on the same numpy inputs.

Integer paths (Threefry, the lattice hash, the ChaCha StdRng stream, the
tile swizzle) must agree bit for bit; float helpers to 1e-6 (the two
frameworks' transcendentals differ in the last ulp, nothing more).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from potato_tpu.core import color as jcolor
from potato_tpu.core import math as jmath
from potato_tpu.core import noise as jnoise
from potato_tpu.core import rng as jrng
from potato_tpu.core import sampling as jsampling
from potato_tpu.core.stdrng import StdRng as JStdRng
from potato_tpu.render import renderer as jrenderer

from potato_tpu_torch.core import color as tcolor
from potato_tpu_torch.core import math as tmath
from potato_tpu_torch.core import noise as tnoise
from potato_tpu_torch.core import rng as trng
from potato_tpu_torch.core import sampling as tsampling
from potato_tpu_torch.core.stdrng import StdRng as TStdRng
from potato_tpu_torch.ops import rng_kernel
from potato_tpu_torch.render import camera as tcamera

ONES = 0xFFFFFFFF


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every case on one torch thread, restored after the file: the inputs
    are small, and under the suite's other test workers a pool of every
    core waits on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ rng

# Published Threefry-2x32-20 vectors (Random123) and the 13-round fixture
# of tests/test_rng.py.
@pytest.mark.parametrize("word,rounds,want", [
    (0, 20, (0x6B200159, 0x99BA4EFE)),
    (ONES, 20, (0x1CB996FC, 0xBB002BE7)),
    (0, 13, (0x9D1C5EC6, 0xA7A6230F)),
    (ONES, 13, (0xFD36D047, 0x48E8430A)),
])
def test_threefry_known_answers(word, rounds, want):
    a, b = trng.threefry2x32(word, word, word, word, rounds=rounds)
    assert (int(a), int(b)) == want, (hex(int(a)), hex(int(b)))


@pytest.mark.parametrize("rounds", [20, 13])
def test_threefry_equals_jax_bit_for_bit(rounds):
    rng = np.random.default_rng(rounds)
    k0, k1 = (int(x) for x in rng.integers(0, 1 << 32, 2))
    c0 = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    c1 = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    j0, j1 = jrng.threefry2x32(
        jnp.uint32(k0), jnp.uint32(k1), jnp.asarray(c0, jnp.uint32),
        jnp.asarray(c1, jnp.uint32), rounds=rounds)
    t0, t1 = trng.threefry2x32(
        k0, k1, torch.from_numpy(c0.astype(np.int64)),
        torch.from_numpy(c1.astype(np.int64)), rounds=rounds)
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))


@pytest.mark.parametrize("seed,salt", [(0, 0), (1234, 19), ((7 << 32) | 5, 3)])
def test_uniform2_equals_jax_bit_for_bit(seed, salt):
    ids = np.random.default_rng(salt).integers(0, 1 << 22, 2048)
    j0, j1 = jrng.uniform2(seed, salt, jnp.asarray(ids, jnp.uint32))
    t0, t1 = trng.uniform2(seed, salt, torch.from_numpy(ids))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    assert t0.dtype == torch.float32
    assert float(t0.min()) >= 0.0 and float(t0.max()) < 1.0


def test_uniform1_and_bounce_salt_equal_jax():
    ids = np.arange(1024)
    salt = trng.bounce_salt(5, trng.STREAM_SCATTER_B)
    assert salt == jrng.bounce_salt(5, jrng.STREAM_SCATTER_B)
    j = jrng.uniform1(99, salt, jnp.asarray(ids, jnp.uint32))
    t = trng.uniform1(99, salt, torch.from_numpy(ids))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("bounce", [0, 7, "per_lane"])
def test_one_draw_of_two_streams_equals_jax_bit_for_bit(bounce):
    """The draw of a bounce pass (SCATTER_A and SCATTER_B, as
    integrator.advance makes it) on CPU tensors: the plain version, equal
    to the reference's two uniform2 draws."""
    ids = np.random.default_rng(11).integers(0, 1 << 22, 2048)
    lane_bounce = (np.arange(2048) % 9 if bounce == "per_lane"
                   else np.full(2048, bounce))
    streams = (trng.STREAM_SCATTER_A, trng.STREAM_SCATTER_B)
    got = rng_kernel.uniforms(
        (5 << 32) | 77,
        torch.from_numpy(lane_bounce) if bounce == "per_lane" else bounce,
        streams, torch.from_numpy(ids))
    want = []
    for s in streams:
        want.extend(jrng.uniform2(
            (5 << 32) | 77,
            jnp.asarray(jrng.bounce_salt(lane_bounce, s), jnp.uint32),
            jnp.asarray(ids, jnp.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def test_random_bits_chunk_invariant():
    ids = torch.arange(4096)
    a0, a1 = trng.random_bits2(1234, 7, ids)
    h0, h1 = trng.random_bits2(1234, 7, ids[2048:])
    assert torch.equal(a0[2048:], h0) and torch.equal(a1[2048:], h1)


# ---------------------------------------------------------------- noise

_M64 = (1 << 64) - 1


def _hash_model(x, y, z, seed):
    """Pure-Python model of the wrapping 64-bit lattice hash (the model of
    tests/test_noise.py)."""
    A = 0x369E6D3B899E43CF
    B = 0x53F89E7FFDA3B07D
    C = 0x3B13C1CA4937E629
    D = 0x577C2C6E4019D645
    x, y, z, seed = int(x), int(y), int(z), int(seed)
    h = (A * (x & _M64) + B * (y & _M64) + C * (z & _M64)
         + D * (seed & _M64)) & _M64
    hs = h - (1 << 64) if h >> 63 else h
    h = ((hs >> 13) ^ hs) & _M64
    h = (h * ((h * h * 60493 + 19990303) & _M64) + 1376312589) & _M64
    return h - (1 << 64) if h >> 63 else h


def test_noise_i64_matches_integer_model_bit_for_bit():
    pts = np.random.default_rng(0).integers(-100000, 100000, size=(256, 4))
    got = tnoise.noise_i64(*(torch.from_numpy(pts[:, i]) for i in range(4)))
    want = np.array([_hash_model(*p) for p in pts], np.int64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("point", [(0, 0, 0, 0), (1, 0, 0, 0), (-1, 2, -3, 4)])
def test_noise_i64_known_vectors(point):
    got = int(tnoise.noise_i64(*(torch.tensor(v) for v in point)))
    assert got == _hash_model(*point)
    if point == (0, 0, 0, 0):
        assert got == 1376312589


def test_noise_i64_equals_jax_word_pair():
    pts = np.random.default_rng(1).integers(-5000, 5000, size=(512, 4))
    lo, hi = jnoise.noise_i64(*(jnp.asarray(pts[:, i], jnp.int32)
                                for i in range(4)))
    got = tnoise.noise_i64(*(torch.from_numpy(pts[:, i]) for i in range(4)))
    want = ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64)).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------- stdrng

def test_stdrng_stream_equals_reference_port():
    a, b = JStdRng(bytes([249]) * 32), TStdRng(bytes([249]) * 32)
    assert [a.next_u64() for _ in range(100)] == \
        [b.next_u64() for _ in range(100)]
    assert [a.closed_range(0.1, 0.3) for _ in range(50)] == \
        [b.closed_range(0.1, 0.3) for _ in range(50)]
    assert [a.bernoulli(0.7) for _ in range(50)] == \
        [b.bernoulli(0.7) for _ in range(50)]


# -------------------------------------------------------------- swizzle

@pytest.mark.parametrize("width,height,spp", [(16, 8, 1), (32, 24, 2),
                                              (48, 16, 3)])
def test_tile_swizzle_equals_jax_and_inverts(width, height, spp):
    total = width * height * spp
    lin = np.arange(total)
    j = jrenderer.tile_swizzle_ids(jnp.asarray(lin, jnp.uint32), width, spp)
    t = tcamera.tile_swizzle_ids(torch.from_numpy(lin), width, spp)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))
    perm = tcamera.tile_unswizzle_perm(width, height, spp)
    np.testing.assert_array_equal(
        perm, jrenderer.tile_unswizzle_perm(width, height, spp))
    np.testing.assert_array_equal(perm, t.numpy())
    assert np.array_equal(np.sort(perm), lin)       # a permutation


# --------------------------------------------------------------- floats

def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _float_cases():
    rng = np.random.default_rng(42)
    n = 2048
    inc = _unit(rng.normal(size=(n, 3))).astype(np.float32)
    nrm = _unit(rng.normal(size=(n, 3))).astype(np.float32)
    eta = rng.uniform(0.5, 2.0, n).astype(np.float32)
    cosv = rng.uniform(-1.0, 0.0, n).astype(np.float32)
    u = [rng.uniform(0, 1, n).astype(np.float32) for _ in range(3)]
    pts = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    poles = np.array([[0, 1, 0], [0, -1, 0], [1, 0, 0]], np.float32)
    dirs = np.concatenate([inc, poles])
    J, T = jnp.asarray, torch.from_numpy
    # unit_sphere derives sin from cos as sqrt(1 - c^2): a last-ulp
    # difference dc in the cosine becomes c*dc/s in the sine, unbounded as
    # s -> 0. Its lanes get 1e-6 plus that amplified ulp.
    sin_theta = np.abs(np.sin(2.0 * np.pi * u[1].astype(np.float64)))
    _float_cases.sphere_tol = (1e-6 + 2e-7 / np.maximum(sin_theta, 1e-9))
    return {
        "reflect": (lambda: jmath.reflect(J(inc), J(nrm)),
                    lambda: tmath.reflect(T(inc), T(nrm))),
        "refract": (lambda: jmath.refract(J(inc), J(nrm), J(eta))[0],
                    lambda: tmath.refract(T(inc), T(nrm), T(eta))[0]),
        "refract_valid": (lambda: jmath.refract(J(inc), J(nrm), J(eta))[1],
                          lambda: tmath.refract(T(inc), T(nrm), T(eta))[1]),
        "schlick_reflectance": (
            lambda: jmath.schlick_reflectance(J(cosv), J(eta)),
            lambda: tmath.schlick_reflectance(T(cosv), T(eta))),
        "equirect_uv": (lambda: jmath.equirect_uv(J(dirs)),
                        lambda: tmath.equirect_uv(T(dirs))),
        "safe_normalize": (lambda: jmath.safe_normalize(J(pts)),
                           lambda: tmath.safe_normalize(T(pts))),
        "unit_disk": (lambda: jsampling.unit_disk(J(u[0]), J(u[1])),
                      lambda: tsampling.unit_disk(T(u[0]), T(u[1]))),
        "unit_sphere": (lambda: jsampling.unit_sphere(J(u[0]), J(u[1])),
                        lambda: tsampling.unit_sphere(T(u[0]), T(u[1]))),
        "unit_ball": (
            lambda: jsampling.unit_ball(J(u[0]), J(u[1]), J(u[2])),
            lambda: tsampling.unit_ball(T(u[0]), T(u[1]), T(u[2]))),
        "noise_real": (
            lambda: jnoise.noise_real(*(J(pts[:, i].astype(np.int32))
                                        for i in range(3)), 5),
            lambda: tnoise.noise_real(*(T(pts[:, i].astype(np.int64))
                                        for i in range(3)), 5)),
        "value_noise": (lambda: jnoise.value_noise(J(pts), 3),
                        lambda: tnoise.value_noise(T(pts), 3)),
        "perlin": (lambda: jnoise.perlin(J(pts), 7),
                   lambda: tnoise.perlin(T(pts), 7)),
    }


_FLOAT_NAMES = ["reflect", "refract", "refract_valid", "schlick_reflectance",
                "equirect_uv", "safe_normalize", "unit_disk", "unit_sphere",
                "unit_ball", "noise_real", "value_noise", "perlin"]


@pytest.mark.parametrize("name", _FLOAT_NAMES)
def test_float_helper_matches_jax(name):
    jfn, tfn = _float_cases()[name]
    want, got = np.asarray(jfn()), tfn().numpy()
    assert got.shape == want.shape
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    elif name in ("unit_sphere", "unit_ball"):
        tol = _float_cases.sphere_tol[:, None]
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
        assert np.median(np.abs(got - want)) < 1e-7
    else:
        # same formulas in float32; only the last ulp of sqrt/cos/atan2/pow
        # may differ between the two frameworks
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fn", ["to_srgb_u8", "to_u8"])
def test_color_quantizers_exact(fn):
    # inputs whose quantized value sits mid-bucket, so a last-ulp difference
    # in pow cannot move it across an integer, plus out-of-range values
    k = np.arange(255, dtype=np.float64) + 0.5
    power = 2.2 if fn == "to_srgb_u8" else 1.0
    c = np.concatenate([(k / 255.0) ** power, [-0.5, 0.0, 1.0, 3.0, 0.25]])
    c = np.stack([c, c[::-1], np.roll(c, 7)], axis=-1).astype(np.float32)
    want = np.asarray(getattr(jcolor, fn)(jnp.asarray(c)))
    got = getattr(tcolor, fn)(torch.from_numpy(c)).numpy()
    assert got.dtype == np.uint8 and got.shape == (c.shape[0], 4)
    np.testing.assert_array_equal(got, want)


def test_sqrt_is_correctly_rounded():
    """core/math.py::sqrt rounds as IEEE asks, on the CPU too: equal bit
    for bit to the float64 root rounded once to float32, and to XLA's
    float32 root. torch's own float32 root on the CPU is not, on some
    CPUs (one ulp off on about a fifth of these inputs), which moved
    camera rays and hit points of the port away from the reference's."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.random(50_000), rng.uniform(0, 1e4, 50_000),
                        [0.0, 1.0, 4.0, 2.0 ** -126]]).astype(np.float32)
    exact = np.sqrt(x.astype(np.float64)).astype(np.float32)
    got = tmath.sqrt(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, exact)
    np.testing.assert_array_equal(got, np.asarray(jnp.sqrt(x)))
    assert tmath.sqrt(torch.from_numpy(x).double()).dtype == torch.float64
