"""potato_tpu_torch's differentiable path (diff/surrogate.py,
diff/optimize.py, ops/material.py's ior_score, the detach points of
ops/flash.py) against the JAX package on the same numpy-seeded scenes,
targets and parameters (CPU).

The JAX side's gradients are `jax.grad` of JAX's own `make_render_loss`,
computed once per scene for all of its fields (one dict-valued loss), on
`accel="brute"`. Its render is specialized to the scene's feature set, as
the port's loss is (`jax_render.specialized_render`, which says why).

Tolerances:
- gradients against jax.grad: 1e-3 of max |g| per field: float32 through
  three bounces in another summation order (the readings are ~1e-7);
- the port's flash gradient against its brute-force gradient: rtol 2e-4,
  atol 1e-7, as tests/test_gradients.py holds the JAX package's;
- finite differences: the relative tolerances of tests/test_gradients.py;
- the IOR gradient against a wide FD with and without its choice term,
  and the pathwise one against a tiny-eps FD: the gates of
  tests/test_surrogate.py and tests/test_gradients.py;
- the chunk-by-chunk gradient against one whole-frame graph: 1e-5 of
  max |g| (float32 summation order only);
- losses of optimize_textures against JAX's: rtol 1e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import potato_tpu.diff.optimize as joptimize
from potato_tpu.core.types import HitBatch as JHitBatch
from potato_tpu.diff import surrogate as jsurrogate
from potato_tpu.ops import material as jmaterial
from potato_tpu.render import renderer as jrenderer
from potato_tpu.scene import description as jd
from potato_tpu.scene import examples as jexamples

from potato_tpu_torch.core.types import HitBatch, RayBatch
from potato_tpu_torch.diff import optimize as toptimize
from potato_tpu_torch.diff import surrogate as tsurrogate
from potato_tpu_torch.io import tga
from potato_tpu_torch.ops import flash as tflash
from potato_tpu_torch.ops import material as tmaterial
from potato_tpu_torch.render.renderer import make_intersect_fn, render_chunk
from potato_tpu_torch.scene import description as td
from potato_tpu_torch.scene import examples as texamples
from potato_tpu_torch.utils.metrics import MetricsLogger

from jax_render import specialized_render

SIZE, SPP, BOUNCES, SEED = 8, 2, 3, 11


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every case on one torch thread, restored after the file: the inputs
    are small, and under the suite's other test workers a pool of every
    core waits on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ scenes

def three_balls(ex, d):
    return ex.three_balls()


def emissive_three_balls(ex, d):
    """three_balls with material 1 emissive, so the emit table matters."""
    s = ex.three_balls()
    s.materials[1] = d.Material(s.materials[1].scatter,
                                s.materials[1].absorb,
                                d.Emit.color_(0.5, 0.2, 0.1))
    return s


def lit_three_balls(ex, d):
    """three_balls with one emissive material and a colour background, so
    that every field of DIFFERENTIABLE_FIELDS moves the image."""
    s = emissive_three_balls(ex, d)
    s.background = d.Emit.color_(0.9, 0.8, 1.0)
    return s


def glass(ex, d):
    """A dielectric sphere in front of a lambert one, on a sky gradient."""
    s = d.SceneBuilder()
    s.camera = d.Camera(fov=0.6, position=(0.0, 0.0, 0.0),
                        target=(0.0, 0.0, -2.0))
    m0 = s.add_material(d.Material(d.Scatter.dielectric(1.5),
                                   d.Absorb.albedo(0.8, 0.9, 1.0),
                                   d.Emit.none()))
    m1 = s.add_material(d.Material(d.Scatter.lambert(),
                                   d.Absorb.albedo(0.7, 0.3, 0.2),
                                   d.Emit.none()))
    s.add_sphere((0.0, 0.0, -2.0), 0.6, m0)
    s.add_sphere((0.5, 0.2, -3.2), 0.7, m1)
    s.background = d.Emit.sky_gradient()
    return s


def metal_ball(ex, d):
    """A fuzzy metal sphere filling a narrow fov: no silhouette lanes, and
    scattered rays end in the smooth sky gradient."""
    s = d.SceneBuilder()
    s.camera = d.Camera(fov=0.3, position=(0.0, 0.0, 0.0),
                        target=(0.0, 0.0, -2.0))
    m0 = s.add_material(d.Material(d.Scatter.metal(0.3),
                                   d.Absorb.albedo(0.9, 0.9, 0.9),
                                   d.Emit.none()))
    s.add_sphere((0.0, 0.0, -2.0), 1.0, m0)
    return s


def sky_glass_ball(ex, d):
    """tests/test_surrogate.py's IOR scene: a clear dielectric sphere
    filling most of a wide fov against the sky."""
    s = d.SceneBuilder()
    m = s.add_material(d.Material(d.Scatter.dielectric(1.5),
                                  d.Absorb.white_body(), d.Emit.none()))
    s.add_sphere((0.0, 0.0, -2.2), 1.0, m)
    s.camera = d.Camera(fov=np.pi / 3)
    return s


def tinted_glass_ball(ex, d):
    """tests/test_gradients.py's IOR scene: a tinted dielectric sphere in
    a narrow fov."""
    s = d.SceneBuilder()
    s.camera = d.Camera(fov=0.4, position=(0.0, 0.0, 0.0),
                        target=(0.0, 0.0, -2.0))
    m = s.add_material(d.Material(d.Scatter.dielectric(1.5),
                                  d.Absorb.albedo(0.8, 0.9, 1.0),
                                  d.Emit.none()))
    s.add_sphere((0.0, 0.0, -2.0), 0.9, m)
    return s


def write_earthmap(directory, w=32, h=16):
    """A seeded smooth-plus-checker earthmap.tga in `directory`."""
    rng = np.random.default_rng(8)
    y, x = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 4), np.uint8)
    img[..., 0] = 255 * x // w
    img[..., 1] = 255 * y // h
    img[..., 2] = np.where((x // 4 + y // 4) % 2, 200, 40)
    img[..., :3] ^= rng.integers(0, 16, (h, w, 3), np.uint8)
    img[..., 3] = 255
    tga.save(img, str(directory / "earthmap.tga"))
    return str(directory)


FIELDS = {
    "three_balls": toptimize.DIFFERENTIABLE_FIELDS,
    "earth": ("atlas", "bg_color"),
    "glass": ("m_scatter_param", "m_absorb_color"),
}


def _descriptions(name, tmp_factory):
    if name == "three_balls":
        return lit_three_balls(jexamples, jd), lit_three_balls(texamples, td)
    if name == "glass":
        return glass(jexamples, jd), glass(texamples, td)
    assets = write_earthmap(tmp_factory.mktemp("earth"))
    return jexamples.earth(assets), texamples.earth(assets)


def _target(seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (SIZE * SIZE, 3)).astype(np.float32)


_cases = {}


@pytest.fixture(scope="module")
def grads(tmp_path_factory):
    """name -> (JAX loss, JAX grads, port loss, port grads, port scene),
    each computed once, all fields of the scene in one gradient."""
    def get(name):
        if name in _cases:
            return _cases[name]
        jb, tb = _descriptions(name, tmp_path_factory)
        js = jb.build(accel="brute")
        ts = tb.build(accel="brute", device="cpu")
        fields = FIELDS[name]
        kw = dict(width=SIZE, height=SIZE, spp=SPP, max_bounce=BOUNCES,
                  seed=SEED, fields=fields)
        target = _target()
        ids = np.arange(SIZE * SIZE * SPP)
        with specialized_render(js):
            jloss = joptimize.make_render_loss(js, **kw)
        base = {f: jnp.asarray(getattr(js.tables, f)) for f in fields}
        jv, jg = jax.jit(jax.value_and_grad(
            lambda p: jloss(p, jnp.asarray(ids, jnp.uint32),
                            jnp.asarray(target))))(base)
        tloss = toptimize.make_render_loss(ts, **kw)
        params = {f: getattr(ts.tables, f) for f in fields}
        tv, tg = tloss.value_and_grad(params, torch.from_numpy(ids),
                                      torch.from_numpy(target))
        _cases[name] = (float(jv), {k: np.asarray(g) for k, g in jg.items()},
                        float(tv), {k: g.numpy() for k, g in tg.items()}, ts)
        return _cases[name]
    return get


# ------------------------------------------------------- surrogate, shading

def test_score_weight_is_one_with_gradient_dlogp_as_jax():
    p = np.asarray([1e-7, 0.1, 0.5, 0.9, 0.999, 1.0], np.float32)
    chose = np.asarray([True, False, True, False, True, True])
    tp = torch.tensor(p, requires_grad=True)
    w = tsurrogate.score_weight(tp, torch.tensor(chose))
    assert torch.equal(w.detach(), torch.ones(6))
    (g,) = torch.autograd.grad(w.sum(), tp)
    jg = jax.grad(lambda q: jnp.sum(jsurrogate.score_weight(
        q, jnp.asarray(chose))))(jnp.asarray(p))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    # d log p_b: 1/p where the true branch was chosen, -1/(1-p) elsewhere
    inner = (p[1:5] > 1e-6) & (p[1:5] < 1 - 1e-6)
    want = np.where(chose[1:5], 1 / p[1:5], -1 / (1 - p[1:5]))
    np.testing.assert_allclose(g.numpy()[1:5][inner], want[inner],
                               rtol=1e-5)


def test_bernoulli_expectation_grad_matches_analytic():
    """d/dθ E[f(b)], b ~ Bernoulli(p(θ)): the score estimator over
    stratified uniforms against (f_true - f_false) · dp/dθ."""
    n = 1 << 14
    u = (torch.arange(n, dtype=torch.float32) + 0.5) / n
    theta = torch.tensor(0.37, requires_grad=True)
    p = 0.3 + 0.4 * torch.sigmoid(theta)
    est = tsurrogate.bernoulli_expectation_grad(2.0, -1.0, p.expand(n), u)
    (got,) = torch.autograd.grad(est, theta)
    sig = 1 / (1 + np.exp(-0.37))
    want = 3.0 * 0.4 * sig * (1 - sig)
    # stratified draws: the estimator's error is O(1/n) at the flip
    np.testing.assert_allclose(float(got), want, rtol=2e-3)


def _dielectric_hits(n):
    rng = np.random.default_rng(2)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    u = [rng.uniform(0, 1, n).astype(np.float32) for _ in range(4)]
    return d, nrm, u


@pytest.mark.parametrize("ior", [1.5, 2.4])
def test_eval_scatter_ior_score_weights_match_jax(ior):
    """Weights and their IOR gradient, interior and exterior lanes, total
    internal reflection among them (probability 1: no score)."""
    n = 2048
    d, nrm, u = _dielectric_hits(n)
    s_j, s_t = glass(jexamples, jd), glass(texamples, td)
    jt = s_j.build(accel="brute").tables
    tt = s_t.build(accel="brute", device="cpu").tables
    kind = np.zeros(n, np.int32)      # material 0: the dielectric

    def jweights(i):
        hit = JHitBatch(t=jnp.ones(n), position=jnp.zeros((n, 3)),
                        normal=jnp.asarray(nrm), uv=jnp.zeros((n, 2)),
                        material=jnp.asarray(kind), valid=jnp.ones(n, bool))
        out = jmaterial.eval_scatter(
            jt, jt.m_scatter_kind[hit.material], jnp.full((n,), i),
            jnp.asarray(d), hit, *(jnp.asarray(x) for x in u),
            ior_score=True)
        return out.weight, out.direction

    (jw, jdir), jvjp = jax.vjp(jweights, jnp.float32(ior))
    jgrad = float(jvjp((jnp.ones(n), jnp.zeros((n, 3))))[0])
    ti = torch.tensor(ior, requires_grad=True)
    hit = HitBatch(t=torch.ones(n), position=torch.zeros(n, 3),
                   normal=torch.from_numpy(nrm), uv=torch.zeros(n, 2),
                   material=torch.from_numpy(kind).long(),
                   valid=torch.ones(n, dtype=torch.bool))
    out = tmaterial.eval_scatter(
        tt, tt.m_scatter_kind[hit.material].long(), ti.expand(n),
        torch.from_numpy(d), hit, *(torch.from_numpy(x) for x in u),
        ior_score=True)
    assert torch.equal(out.weight.detach(), torch.ones(n))
    np.testing.assert_array_equal(out.weight.detach().numpy(),
                                  np.asarray(jw))
    np.testing.assert_allclose(out.direction.detach().numpy(),
                               np.asarray(jdir), atol=1e-5)
    (g,) = torch.autograd.grad(out.weight.sum(), ti)
    np.testing.assert_allclose(float(g), jgrad, rtol=1e-4)
    assert abs(float(g)) > 1.0       # the choice term is there


def test_eval_material_folds_the_weight_into_absorb():
    n = 512
    d, nrm, u = _dielectric_hits(n)
    tt = glass(texamples, td).build(accel="brute", device="cpu").tables
    tables = tt._replace(m_scatter_param=tt.m_scatter_param.clone()
                         .requires_grad_(True))
    hit = HitBatch(t=torch.ones(n), position=torch.zeros(n, 3),
                   normal=torch.from_numpy(nrm), uv=torch.zeros(n, 2),
                   material=torch.zeros(n, dtype=torch.int64),
                   valid=torch.ones(n, dtype=torch.bool))
    args = (tables, hit.material, torch.from_numpy(d), hit,
            *(torch.from_numpy(x) for x in u))
    on = tmaterial.eval_material(*args, ior_score=True)
    off = tmaterial.eval_material(*args)
    assert torch.equal(on.absorb.detach(), off.absorb.detach())
    assert torch.equal(off.scatter.weight, torch.ones(n))
    (g_on,) = torch.autograd.grad(on.absorb.sum(), tables.m_scatter_param,
                                  retain_graph=True)
    # the albedo absorb itself does not depend on the IOR
    assert float(torch.autograd.grad(
        off.absorb.sum(), tables.m_scatter_param,
        retain_graph=True)[0].abs().sum()) == 0.0
    want = torch.autograd.grad(
        (on.scatter.weight[:, None] * off.absorb).sum(),
        tables.m_scatter_param)[0]
    torch.testing.assert_close(g_on, want)
    assert float(g_on.abs().sum()) > 0


# ------------------------------------------- render-loss gradients vs JAX

def _assert_grad_close(got, want, field):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, field
    assert np.isfinite(got).all(), field
    assert err <= 1e-3 * scale, f"{field}: max err {err:.3e} of {scale:.3e}"


@pytest.mark.parametrize("field", toptimize.DIFFERENTIABLE_FIELDS)
def test_render_loss_gradient_matches_jax_three_balls(grads, field):
    jv, jg, tv, tg, _ = grads("three_balls")
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    _assert_grad_close(tg[field], jg[field], field)
    if field != "atlas":         # three_balls has no image texture
        assert np.abs(tg[field]).max() > 0, field


def test_render_loss_gradient_matches_jax_earth_atlas(grads):
    jv, jg, tv, tg, ts = grads("earth")
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    for f in FIELDS["earth"]:
        _assert_grad_close(tg[f], jg[f], f)
    seen = np.abs(tg["atlas"]).max(-1) > 0
    assert 0 < seen.sum() < seen.size      # the texels the camera sees


@pytest.mark.parametrize("field", FIELDS["glass"])
def test_render_loss_gradient_matches_jax_dielectric(grads, field):
    jv, jg, tv, tg, _ = grads("glass")
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    _assert_grad_close(tg[field], jg[field], field)
    assert np.abs(tg[field][0]).max() > 0    # the dielectric's own row


# -------------------------------------------------- within the port

def _port_grads(scene, fields, target, max_bounce=BOUNCES, chunk=None,
                whole=False):
    loss = toptimize.make_render_loss(
        scene, width=SIZE, height=SIZE, spp=SPP, max_bounce=max_bounce,
        seed=SEED, fields=fields)
    ids = torch.arange(SIZE * SIZE * SPP)
    params = {f: getattr(scene.tables, f) for f in fields}
    if whole:
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        value = loss(leaves, ids, target)
        got = torch.autograd.grad(value, list(leaves.values()),
                                  allow_unused=True)
        return value.detach(), {k: (g if g is not None else
                                    torch.zeros_like(leaves[k]))
                                for k, g in zip(leaves, got)}
    if chunk is not None:
        loss.chunk_rays = chunk
    value, g = loss.value_and_grad(params, ids, target)
    return value, g, loss.chunks


@pytest.mark.parametrize("name", ["one_triangle", "three_balls"])
def test_flash_gradient_matches_brute_gradient(name):
    """The flash path (its plain version here: CPU tensors) detaches the
    hit decision only; where scene parameters do not move rays, its
    gradient is the brute-force one."""
    fields = ("m_absorb_color", "m_emit_color", "t_color")
    target = torch.from_numpy(_target(1))
    g = {}
    for accel in ("brute", "flash"):
        s = texamples.SCENES[name]().build(accel=accel, device="cpu")
        g[accel] = _port_grads(s, fields, target)[1]
    for f in fields:
        np.testing.assert_allclose(g["flash"][f].numpy(),
                                   g["brute"][f].numpy(), rtol=2e-4,
                                   atol=1e-7, err_msg=f)
    assert float(g["flash"]["m_absorb_color"].abs().max()) > 0


def test_flash_kernel_inputs_and_outputs_are_detached():
    """The detach points of the JAX package: the dense-sphere fold into
    t_max, the kernel's inputs and its outputs. Gradients reach the hit
    only through the dense sphere test's t and the epilogue's shading
    values."""
    s = texamples.three_balls().build(accel="flash", device="cpu")
    rng = np.random.default_rng(3)
    o = torch.tensor(rng.normal(size=(300, 3)).astype(np.float32) * 0.1
                     + np.asarray([-2.0, 2.0, 1.0], np.float32),
                     requires_grad=True)
    d = torch.nn.functional.normalize(
        torch.tensor([0.0, -1.0, -1.0]) + 0.3 * torch.from_numpy(
            rng.normal(size=(300, 3)).astype(np.float32)), dim=-1)
    rays = RayBatch(o, d, torch.full((300,), 1e-3),
                    torch.full((300,), tflash.BIG))
    tables = s.tables._replace(s_center=s.tables.s_center.clone()
                               .requires_grad_(True))
    inp = tflash.prepare_flash(s.accel, tables, rays)
    assert not inp.packed_rays.requires_grad
    assert not any(q.requires_grad for q in inp.queues)
    assert inp.sph_dense[0].requires_grad       # s_t keeps its gradient
    hit = tflash.intersect_flash(s.accel, tables, rays)
    (g_c,) = torch.autograd.grad(hit.t.sum(), tables.s_center)
    assert float(g_c.abs().sum()) > 0
    import inspect
    import potato_tpu_torch.ops.flash as mod
    assert "autograd.Function" not in inspect.getsource(mod)


@pytest.mark.parametrize("name,field,eps,rel", [
    ("three_balls", "m_absorb_color", 1e-2, 5e-3),
    ("three_balls", "bg_color", 1e-2, 5e-3),
])
def test_gradient_matches_central_finite_differences(name, field, eps, rel):
    s = lit_three_balls(texamples, td).build(accel="brute", device="cpu")
    target = torch.zeros(SIZE * SIZE, 3)
    _, g, _ = _port_grads(s, (field,), target)
    g = g[field]
    index = np.unravel_index(int(g.abs().argmax()), tuple(g.shape))
    loss = toptimize.make_render_loss(
        s, width=SIZE, height=SIZE, spp=SPP, max_bounce=BOUNCES, seed=SEED,
        fields=(field,))
    ids = torch.arange(SIZE * SIZE * SPP)
    base = getattr(s.tables, field)
    basis = torch.zeros_like(base)
    basis[index] = 1.0
    f_plus = float(loss({field: base + eps * basis}, ids, target))
    f_minus = float(loss({field: base - eps * basis}, ids, target))
    fd = (f_plus - f_minus) / (2 * eps)
    ad = float(g[index])
    assert abs(ad) > 1e-6
    assert abs(fd - ad) / max(abs(fd), abs(ad)) < rel, (ad, fd)


def _fd_check(builder, field, rel_tol, eps, *, index=None, spp=2, size=12,
              max_bounce=3, seed=11, accel="brute"):
    """tests/test_gradients.py's _fd_check on the port: loss mean(color^2),
    its gradient chunk by chunk, a central difference at `index` (default
    the largest |g|)."""
    s = builder(texamples, td).build(accel=accel, device="cpu")
    loss = toptimize.make_render_loss(
        s, width=size, height=size, spp=spp, max_bounce=max_bounce,
        seed=seed, fields=(field,))
    ids = torch.arange(size * size * spp)
    target = torch.zeros(size * size, 3)
    base = getattr(s.tables, field)
    g = loss.value_and_grad({field: base}, ids, target)[1][field]
    if index is None:
        index = np.unravel_index(int(g.abs().argmax()), tuple(g.shape))
    basis = torch.zeros_like(base)
    basis[index] = 1.0
    f_plus = float(loss({field: base + eps * basis}, ids, target))
    f_minus = float(loss({field: base - eps * basis}, ids, target))
    fd = (f_plus - f_minus) / (2 * eps)
    ad = float(g[index])
    assert np.isfinite(ad)
    assert abs(fd - ad) / max(abs(fd), abs(ad), 1e-8) < rel_tol, (
        f"{field}[{index}]: AD {ad:.6g} vs FD {fd:.6g}")
    return ad


@pytest.mark.parametrize("builder,field,rel,eps,kw,floor", [
    (three_balls, "t_color", 5e-3, 1e-2, {}, 1e-6),
    (emissive_three_balls, "m_emit_color", 5e-3, 1e-2, {}, 1e-6),
    (three_balls, "m_absorb_color", 5e-3, 1e-2,
     dict(size=8, max_bounce=2, accel="flash"), 1e-6),
    (metal_ball, "m_scatter_param", 3e-2, 3e-3,
     dict(index=(0,), spp=4, max_bounce=2), 1e-5),
    (metal_ball, "m_scatter_param", 3e-2, 3e-3,
     dict(index=(0,), spp=4, max_bounce=2, accel="flash"), 1e-5),
], ids=["solid_texture", "emission", "albedo_flash", "fuzz", "fuzz_flash"])
def test_gradient_matches_fd_as_the_jax_package_checks(builder, field, rel,
                                                        eps, kw, floor):
    """The scenes, fields, steps, tolerances and sizes of the matching
    cases of tests/test_gradients.py."""
    assert abs(_fd_check(builder, field, rel, eps, **kw)) > floor


def test_fuzz_gradient_matches_jax():
    """The brute fuzz case above against jax.grad of JAX's own loss on the
    same scene, rays and target."""
    size, spp = 12, 4
    kw = dict(width=size, height=size, spp=spp, max_bounce=2, seed=SEED,
              fields=("m_scatter_param",))
    ids = np.arange(size * size * spp)
    target = np.zeros((size * size, 3), np.float32)
    js = metal_ball(jexamples, jd).build(accel="brute")
    with specialized_render(js):
        jloss = joptimize.make_render_loss(js, **kw)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss({"m_scatter_param": p}, jnp.asarray(ids, jnp.uint32),
                        jnp.asarray(target))))(
        jnp.asarray(js.tables.m_scatter_param))
    ts = metal_ball(texamples, td).build(accel="brute", device="cpu")
    tloss = toptimize.make_render_loss(ts, **kw)
    tv, tg = tloss.value_and_grad(
        {"m_scatter_param": ts.tables.m_scatter_param},
        torch.from_numpy(ids), torch.from_numpy(target))
    g = tg["m_scatter_param"].numpy()
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    _assert_grad_close(g, np.asarray(jg), "m_scatter_param")
    assert abs(g[0]) > 1e-5


def _ior_renders(builder, size, spp, max_bounce, seed):
    """The colour of every ray of `builder`'s scene as a function of its
    dielectric's IOR and of ior_score: on the port, and on JAX with its
    render specialized to the scene's features."""
    ts = builder(texamples, td).build(accel="brute", device="cpu")
    js = builder(jexamples, jd).build(accel="brute")
    kw = dict(width=size, height=size, spp=spp, max_bounce=max_bounce,
              seed=seed)
    t_ids = torch.arange(size * size * spp)
    j_ids = jnp.arange(size * size * spp, dtype=jnp.uint32)
    t_intersect = make_intersect_fn(ts)
    j_intersect = jrenderer.make_intersect_fn(js)

    def port(ior, score):
        tables = ts.tables._replace(
            m_scatter_param=ior.expand_as(ts.tables.m_scatter_param))
        return render_chunk(tables, ts.camera, t_ids,
                            intersect_fn=t_intersect, ior_score=score,
                            **kw).color

    def jax_(ior, score):
        tables = js.tables._replace(
            m_scatter_param=jnp.full_like(js.tables.m_scatter_param, ior))
        return jrenderer.render_chunk(tables, js.camera, j_ids,
                                      intersect_fn=j_intersect,
                                      features=js.features, ior_score=score,
                                      **kw).color

    return port, jax_


def test_render_ior_gradient_includes_choice_term():
    """tests/test_surrogate.py's case through the port's render_chunk: a
    dielectric sphere against the sky at max_bounce 2, whose image moves
    with the IOR almost only through the reflect probability. A wide
    common-random-numbers FD is the oracle: ior_score=True must match it,
    ior_score=False must not. Both gradients are also JAX's."""
    port, jax_ = _ior_renders(sky_glass_ball, size=12, spp=48, max_bounce=2,
                              seed=3)

    def grad_image(score):
        ior = torch.tensor(1.5, requires_grad=True)
        return float(torch.autograd.grad(port(ior, score).mean(), ior)[0])

    g_on, g_off = grad_image(True), grad_image(False)
    eps = 0.05  # wide FD step: flips are discrete, need many in the bracket
    with torch.no_grad():
        fd = float((port(torch.tensor(1.5 + eps), False).mean()
                    - port(torch.tensor(1.5 - eps), False).mean()) / (2 * eps))
    assert abs(g_on - fd) < 0.4 * abs(fd), (g_on, g_off, fd)
    assert abs(g_off - fd) > 3 * abs(g_on - fd), (g_on, g_off, fd)
    j_g = jax.jit(lambda i: jnp.stack([
        jax.grad(lambda j: jax_(j, score).mean())(i)
        for score in (True, False)]))(jnp.float32(1.5))
    _assert_grad_close(np.array([g_on, g_off]), np.asarray(j_g),
                       "m_scatter_param")


def test_ior_pathwise_gradient_matches_fd():
    """tests/test_gradients.py::test_ior_gradient_matches_fd on the port:
    the pathwise estimator (ior_score=False), whose gradient flows through
    Schlick and the refracted direction, against a tiny-eps FD at seven
    base points. The loss is piecewise smooth with branch flips ~1e-2
    apart in IOR, so the median relative error is gated: it is immune to
    the minority of stencils that straddle a flip. The port's gradients at
    those points are also JAX's."""
    spp = 4
    port, jax_ = _ior_renders(tinted_glass_ball, size=16, spp=spp,
                              max_bounce=4, seed=17)

    def loss(render):
        return lambda ior: (
            render(ior, False).reshape(-1, spp, 3).mean(1) ** 2).mean()

    t_loss, j_grad = loss(port), jax.jit(jax.grad(loss(jax_)))
    eps = 1e-3
    rel_errs, ads, j_ads = [], [], []
    for base in (1.4931, 1.4967, 1.4990, 1.5005, 1.5041, 1.5062, 1.5098):
        b = torch.tensor(base)
        with torch.no_grad():
            fd = (float(t_loss(b + eps)) - float(t_loss(b - eps))) / (2 * eps)
        ior = b.clone().requires_grad_(True)
        ad = float(torch.autograd.grad(t_loss(ior), ior)[0])
        assert np.isfinite(ad)
        assert abs(ad) > 1e-4
        rel_errs.append(abs(fd - ad) / max(abs(fd), abs(ad), 1e-8))
        ads.append(ad)
        j_ads.append(float(j_grad(jnp.float32(base))))
    assert np.median(rel_errs) < 0.2, rel_errs
    _assert_grad_close(np.array(ads), np.array(j_ads), "m_scatter_param")


@pytest.mark.parametrize("chunk", [38, 64])
def test_chunked_gradient_equals_one_whole_frame_graph(chunk):
    s = lit_three_balls(texamples, td).build(accel="flash", device="cpu")
    fields = ("m_absorb_color", "m_scatter_param", "t_color")
    target = torch.from_numpy(_target(2))
    value, g, chunks = _port_grads(s, fields, target, chunk=chunk)
    assert chunks == -(-SIZE * SIZE * SPP // chunk)
    whole_value, whole = _port_grads(s, fields, target, whole=True)
    torch.testing.assert_close(value, whole_value, rtol=1e-6, atol=0)
    for f in fields:
        scale = float(whole[f].abs().max())
        assert float((g[f] - whole[f]).abs().max()) <= 1e-5 * scale, f


# ------------------------------------------------------- optimize_textures

def _optimize_pair(tmp_path_factory, steps=3):
    jb, tb = _descriptions("three_balls", tmp_path_factory)
    js = jb.build(accel="brute")
    ts = tb.build(accel="brute", device="cpu")
    target = _target(4).reshape(SIZE, SIZE, 3)
    init = {"m_absorb_color": np.asarray(js.tables.m_absorb_color) * 0.8}
    kw = dict(width=SIZE, height=SIZE, spp=SPP, max_bounce=BOUNCES,
              seed=SEED, fields=("m_absorb_color",), steps=steps,
              learning_rate=0.05, log_every=0, init=init)
    return js, ts, target, kw


def test_optimize_textures_losses_match_jax(tmp_path_factory):
    js, ts, target, kw = _optimize_pair(tmp_path_factory)
    with specialized_render(js):
        want = joptimize.optimize_textures(js, target, **kw)
    got = toptimize.optimize_textures(ts, target, device="cpu", **kw)
    assert got.steps_done == want.steps_done == 3
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    assert got.losses[-1] < got.losses[0]
    np.testing.assert_allclose(got.params["m_absorb_color"],
                               want.params["m_absorb_color"], atol=1e-4)


def test_checkpoint_resume_equals_an_uninterrupted_run(tmp_path_factory,
                                                       tmp_path):
    _, ts, target, kw = _optimize_pair(tmp_path_factory)
    straight = toptimize.optimize_textures(ts, target, device="cpu", **kw)
    path = str(tmp_path / "opt.npz")
    cut = dict(kw, steps=2)
    toptimize.optimize_textures(ts, target, device="cpu",
                                checkpoint_path=path, checkpoint_every=1,
                                **cut)
    with np.load(path) as ckpt:
        keys = set(ckpt.files)
        assert int(ckpt["step"]) == 2
    assert keys == {"step", "losses", "p_m_absorb_color",
                    "m_m_absorb_color", "v_m_absorb_color"}
    resumed = toptimize.optimize_textures(ts, target, device="cpu",
                                          checkpoint_path=path, **kw)
    assert resumed.losses == straight.losses
    np.testing.assert_array_equal(resumed.params["m_absorb_color"],
                                  straight.params["m_absorb_color"])


class _Lines:
    def __init__(self):
        self.records = []

    def write(self, line):
        self.records.append(json.loads(line))


def test_opt_step_and_checkpoint_events(tmp_path_factory, tmp_path):
    _, ts, target, kw = _optimize_pair(tmp_path_factory)
    log = _Lines()
    out = toptimize.optimize_textures(
        ts, target, device="cpu", metrics=MetricsLogger(stream=log),
        checkpoint_path=str(tmp_path / "c.npz"), checkpoint_every=2, **kw)
    steps = [r for r in log.records if r["event"] == "opt_step"]
    assert [r["step"] for r in steps] == [0, 1, 2]
    assert [r["loss"] for r in steps] == out.losses
    assert all(r["seconds"] >= 0 for r in steps)
    assert [r["step"] for r in log.records
            if r["event"] == "opt_checkpoint"] == [2]


def test_optimize_textures_defaults_to_the_card(tmp_path_factory):
    _, ts, target, kw = _optimize_pair(tmp_path_factory, steps=1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        toptimize.optimize_textures(ts, target, **kw)
