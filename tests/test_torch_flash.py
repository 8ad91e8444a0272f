"""potato_tpu_torch.ops.flash against the JAX package, on the CPU (so the
kernel's plain PyTorch version runs): queue build id for id, the intersector
against both packages' brute force, against the JAX flash kernel in
interpret mode, and the shared-edge no-leak property.

Both sides compute on identical tables: each scene is built once by the JAX
package and handed to the port through `scene_from_numpy`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from potato_tpu.core.types import RayBatch as JRayBatch
from potato_tpu.ops import flash as jflash
from potato_tpu.ops.intersect import intersect_brute_force as jbrute
from potato_tpu.scene import description as jd

from potato_tpu_torch.core.types import BIG, RAY_EPSILON, RayBatch
from potato_tpu_torch.ops import flash as tflash
from potato_tpu_torch.ops.intersect import intersect_brute_force as tbrute

from test_torch_scene import port_scene_from_jax

R = tflash.R


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every case on one torch thread, restored after the file: the inputs
    are small, and under the suite's other test workers a pool of every
    core waits on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- fixtures

def _sphere_scene(rng, n):
    s = jd.SceneBuilder()
    for _ in range(4):
        s.add_material(jd.Material(jd.Scatter.lambert(),
                                   jd.Absorb.albedo(0.5, 0.5, 0.5),
                                   jd.Emit.none()))
    for _ in range(n):
        s.add_sphere(rng.uniform(-5, 5, 3), rng.uniform(0.1, 1.5),
                     rng.integers(0, 4))
    return s


def _tri_scene(rng, n):
    s = jd.SceneBuilder()
    s.add_material(jd.Material(jd.Scatter.lambert(),
                               jd.Absorb.albedo(0.5, 0.5, 0.5),
                               jd.Emit.none()))
    base = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    idx = np.arange(n, dtype=np.int32)
    mesh = jd.MeshData(
        positions=np.concatenate([base, base + e1, base + e2]),
        normals=rng.normal(size=(3 * n, 3)).astype(np.float32),
        uvs=rng.uniform(0, 1, (3 * n, 2)).astype(np.float32),
        indices=np.stack([idx, idx + n, idx + 2 * n], axis=1))
    s.add_mesh(mesh, 0)
    return s


def _mixed_scene(rng, ns, nt):
    s = _sphere_scene(rng, ns)
    tri = _tri_scene(rng, nt)
    s.meshes, s.mesh_materials = tri.meshes, tri.mesh_materials
    return s


def _rays_np(rng, b):
    origin = rng.uniform(-8, 8, (b, 3)).astype(np.float32)
    direction = rng.normal(size=(b, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    return (origin, direction, np.full(b, RAY_EPSILON, np.float32),
            np.full(b, BIG, np.float32))


def _both(rays_np):
    return (JRayBatch(*(jnp.asarray(a) for a in rays_np)),
            RayBatch(*(torch.from_numpy(a) for a in rays_np)))


_SCENES = {
    "spheres300": lambda rng: _sphere_scene(rng, 300),    # sphere phase +
    "spheres12": lambda rng: _sphere_scene(rng, 12),      # hybrid / dense
    "triangles300": lambda rng: _tri_scene(rng, 300),
    "triangles2000": lambda rng: _tri_scene(rng, 2000),   # fills the tail
    "mixed": lambda rng: _mixed_scene(rng, 150, 200),
}
_cache = {}


def _scene(name):
    """(JAX scene with flash accel, the port's scene over the same arrays,
    numpy rays (1024), both packages' RayBatch)."""
    if name not in _cache:
        rng = np.random.default_rng(sorted(_SCENES).index(name) + 13)
        js = _SCENES[name](rng).build(accel="flash")
        rays_np = _rays_np(rng, 1024)
        _cache[name] = (js, port_scene_from_jax(js), rays_np)
    js, ts, rays_np = _cache[name]
    return (js, ts) + _both(rays_np)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(out, brute, atol=2e-3):
    """The gates of tests/test_flash.py::_assert_same: the watertight edge
    test and the Cramer test may disagree on rays that graze an edge, and
    FMA contraction moves t by ulps."""
    same_valid = _np(out.valid) == _np(brute.valid)
    assert same_valid.mean() > 0.995, f"{(~same_valid).sum()} flips"
    v = _np(brute.valid) & same_valid
    np.testing.assert_allclose(_np(out.t)[v], _np(brute.t)[v],
                               rtol=1e-3, atol=atol)
    same_mat = _np(out.material)[v] == _np(brute.material)[v]
    assert same_mat.mean() > 0.995


# ---------------------------------------------------------- queue build

@pytest.mark.parametrize("name", ["triangles300", "triangles2000", "mixed"])
def test_packed_queue_equals_jax(name):
    """Integer path: counts and id lists are equal, entries to 1e-6."""
    js, ts, jrays, trays = _scene(name)
    want = jflash.build_packed_queue(jrays, js.accel)
    got = tflash.build_packed_queue(trays, ts.accel)
    n_pk, n_tail, tail_ids, pk_entry, tail_entry, child_ids = map(_np, got)
    jn_pk, jn_tail, jtail_ids, jqf_pk, jqf_tail, jgidx = map(_np, want)
    np.testing.assert_array_equal(n_pk, jn_pk[:, 0])
    np.testing.assert_array_equal(n_tail, jn_tail[:, 0])
    np.testing.assert_array_equal(child_ids, jgidx)
    assert child_ids.dtype == np.int32 and tail_ids.dtype == np.int32
    np.testing.assert_allclose(pk_entry, jqf_pk, rtol=1e-6)
    for blk in range(n_tail.shape[0]):     # ids past the count are padding
        k = n_tail[blk]
        np.testing.assert_array_equal(tail_ids[blk, :k], jtail_ids[blk, :k])
        np.testing.assert_allclose(tail_entry[blk, :k], jqf_tail[blk, :k],
                                   rtol=1e-6)
    if name == "triangles2000":
        assert n_tail.max() > 0, "this scene is meant to fill the tail"


@pytest.mark.parametrize("name", ["spheres300", "mixed"])
def test_block_queue_equals_jax(name):
    js, ts, jrays, trays = _scene(name)
    jc, jids, jentry = map(_np, jflash.build_block_queue(
        jrays, js.accel.sph_cmin, js.accel.sph_cmax))
    c, ids, entry = map(_np, tflash.build_block_queue(
        trays, ts.accel.sph_cmin, ts.accel.sph_cmax))
    np.testing.assert_array_equal(c, jc[:, 0])
    for blk in range(c.shape[0]):
        np.testing.assert_array_equal(ids[blk, :c[blk]], jids[blk, :c[blk]])
    np.testing.assert_allclose(entry, jentry, rtol=1e-6)


def test_block_queue_front_to_back():
    _, ts, _, trays = _scene("triangles300")
    counts, _, entry = map(_np, tflash.build_block_queue(
        trays, ts.accel.tri_cmin, ts.accel.tri_cmax))
    for blk in range(counts.shape[0]):
        assert (np.diff(entry[blk, :counts[blk]]) >= 0).all()
        assert (entry[blk, counts[blk]:] == np.float32(BIG)).all()


def test_block_queue_covers_every_hit():
    """Every cluster whose AABB holds a ray's winning hit point is in that
    ray's block queue."""
    _, ts, _, trays = _scene("triangles300")
    counts, ids, _ = map(_np, tflash.build_block_queue(
        trays, ts.accel.tri_cmin, ts.accel.tri_cmax))
    brute = tbrute(ts.tables, trays)
    valid = _np(brute.valid)
    cmin, cmax = _np(ts.accel.tri_cmin), _np(ts.accel.tri_cmax)
    eps = 1e-3
    for pos, blk in zip(_np(brute.position)[valid],
                        np.nonzero(valid)[0] // R):
        inside = ((pos >= cmin - eps) & (pos <= cmax + eps)).all(axis=1)
        entered = ids[blk, :counts[blk]]
        assert np.intersect1d(np.nonzero(inside)[0], entered).size > 0


# ---------------------------------------------------------- intersector

@pytest.mark.parametrize("oracle", ["port_brute", "jax_brute"])
@pytest.mark.parametrize("name", sorted(_SCENES))
def test_flash_matches_brute_force(name, oracle):
    js, ts, jrays, trays = _scene(name)
    out = tflash.intersect_flash(ts.accel, ts.tables, trays)
    brute = tbrute(ts.tables, trays) if oracle == "port_brute" \
        else jbrute(js.tables, jrays)
    _assert_same(out, brute)


def test_flash_ragged_batch():
    """A batch that is not a multiple of the block is padded with dead
    rays and cut back."""
    js, ts, jrays, trays = _scene("triangles300")
    cut = RayBatch(*(f[:300] for f in trays))
    out = tflash.intersect_flash(ts.accel, ts.tables, cut)
    assert out.t.shape == (300,)
    _assert_same(out, tbrute(ts.tables, cut))
    _assert_same(out, jbrute(js.tables, JRayBatch(*(f[:300] for f in jrays))))


@pytest.mark.parametrize("name", ["spheres300", "mixed"])
def test_flash_dead_rays_hit_nothing(name):
    _, ts, _, trays = _scene(name)
    dead = trays._replace(t_max=torch.full_like(trays.t_max, -1.0))
    out = tflash.intersect_flash(ts.accel, ts.tables, dead)
    assert not bool(out.valid.any())


def test_flash_matches_jax_flash_kernel_interpret_mode():
    """Same tables, same rays, the Pallas kernel in interpret mode against
    the port's plain version: valid and material >= 99.5 %, first-hit t to
    rtol 1e-4 plus atol 2e-5. The absolute term is the sphere quadratic's:
    its c coefficient |o|^2 - 2 o.c + (|c|^2 - r^2) cancels at magnitudes
    near 100 here, so the two frameworks' contraction choices move t by
    about 1e-5 whatever its size (seen: 9.4e-6 on a hit at t = 0.018)."""
    js, ts, jrays, trays = _scene("mixed")
    want = jflash.intersect_flash(js.accel, js.tables, jrays, interpret=True)
    got = tflash.intersect_flash(ts.accel, ts.tables, trays)
    same_valid = _np(got.valid) == _np(want.valid)
    assert same_valid.mean() >= 0.995
    v = _np(want.valid) & same_valid
    np.testing.assert_allclose(_np(got.t)[v], _np(want.t)[v], rtol=1e-4,
                               atol=2e-5)
    assert (_np(got.material)[v] == _np(want.material)[v]).mean() >= 0.995
    np.testing.assert_allclose(_np(got.normal)[v], _np(want.normal)[v],
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(_np(got.uv)[v], _np(want.uv)[v],
                               rtol=1e-3, atol=2e-3)


def test_flash_shared_edge_never_leaks():
    """Rays aimed exactly at the shared edge of a two-triangle quad must
    report a hit: the case of
    tests/test_watertight.py::test_flash_kernel_shared_edge_never_leaks."""
    rng = np.random.default_rng(7)
    p0 = np.asarray([-1.0, -1.0, -2.0], np.float32)
    p1 = np.asarray([1.0, 1.0, -2.0], np.float32)
    q0 = np.asarray([-1.0, 1.0, -2.0], np.float32)
    q1 = np.asarray([1.0, -1.0, -2.0], np.float32)
    mesh = jd.MeshData(
        positions=np.stack([p0, p1, q0, q1]),
        normals=np.tile([[0, 0, 1]], (4, 1)).astype(np.float32),
        uvs=np.zeros((4, 2), np.float32),
        indices=np.asarray([[0, 1, 2], [1, 0, 3]], np.int32))
    s = jd.SceneBuilder()
    m = s.add_material(jd.Material(jd.Scatter.lambert(),
                                   jd.Absorb.albedo(1, 1, 1), jd.Emit.none()))
    s.add_mesh(mesh, m)
    ts = port_scene_from_jax(s.build(accel="flash"))

    n = 2048
    lam = rng.uniform(0.02, 0.98, size=(n, 1)).astype(np.float32)
    target = p0[None] * (1 - lam) + p1[None] * lam   # on the shared edge
    origin = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    origin[:, 2] = 2.0
    rays = RayBatch(torch.from_numpy(origin),
                    torch.from_numpy(target - origin),
                    torch.full((n,), 1e-4), torch.full((n,), 1e9))
    out = tflash.intersect_flash(ts.accel, ts.tables, rays)
    leaked = int((~out.valid).sum())
    assert leaked == 0, f"{leaked} / {n} edge rays leaked through flash"


# -------------------------------------------------- wrapper and counters

def test_wrapper_takes_the_plain_version_for_cpu_tensors_only():
    _, ts, _, trays = _scene("mixed")
    inp = tflash.prepare_flash(ts.accel, ts.tables, trays)
    before = tflash.flash_intersect_kernel.launches
    a = tflash.flash_intersect_kernel(
        inp.packed_rays, inp.queues, ts.accel.tri_flat, ts.accel.sph_feats,
        R, inp.has_sph)
    b = tflash.flash_intersect_plain(
        inp.packed_rays, inp.queues, ts.accel.tri_flat, ts.accel.sph_feats,
        R, inp.has_sph)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [x.dtype for x in a] == [torch.float32, torch.int32] * 2
    # the count rises only where the CUDA kernel is launched
    assert tflash.flash_intersect_kernel.launches == before


def _wall_scene():
    """2000 scattered triangles and, in front of them as seen from
    x = -30, a wall of two large ones at x = -6 (built by the port's own
    SceneBuilder, on the CPU)."""
    if "wall" not in _cache:
        from potato_tpu_torch.scene import description as td

        rng = np.random.default_rng(21)
        n = 2000
        base = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
        e1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        e2 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        wall = np.asarray([[-6, -3, -3], [-6, 3, -3], [-6, 3, 3], [-6, -3, 3]],
                          np.float32)
        idx = np.arange(n, dtype=np.int32)
        indices = np.concatenate([
            np.stack([idx, idx + n, idx + 2 * n], axis=1),
            np.asarray([[3 * n, 3 * n + 1, 3 * n + 2],
                        [3 * n, 3 * n + 2, 3 * n + 3]], np.int32)])
        positions = np.concatenate([base, base + e1, base + e2, wall])
        s = td.SceneBuilder()
        s.add_material(td.Material())
        s.add_mesh(td.MeshData(
            positions=positions, normals=np.ones_like(positions),
            uvs=np.zeros((positions.shape[0], 2), np.float32),
            indices=indices), 0)
        _cache["wall"] = s.build(accel="flash", device="cpu")
    return _cache["wall"]


def _wall_rays(b=1024, stray_from=None):
    """A coherent bundle from x = -30 that all lands on the wall. With
    `stray_from`, the rays of every block from that index on keep their
    origin and fly at random instead, so some of them hit nothing."""
    rng = np.random.default_rng(22)
    origin = np.tile(np.asarray([[-30.0, 0.0, 0.0]], np.float32), (b, 1))
    target = np.concatenate(
        [np.zeros((b, 1)), rng.uniform(-0.5, 0.5, (b, 2))], axis=1)
    direction = (target - origin).astype(np.float32)
    if stray_from is not None:
        stray = (np.arange(b) % R) >= stray_from
        direction[stray] = rng.normal(size=(int(stray.sum()), 3))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    return RayBatch(torch.from_numpy(origin),
                    torch.from_numpy(direction.astype(np.float32)),
                    torch.full((b,), RAY_EPSILON), torch.full((b,), BIG))


def test_early_termination_changes_work_not_result():
    """A coherent bundle that all lands on a near wall: the front-to-back
    walk stops once every ray's best precedes the next entry. Visiting
    every queued cluster instead (entries forced to 0, so nothing is ever
    skipped) gives the same hits and takes more visits."""
    ts = _wall_scene()
    trays = _wall_rays()

    inp = tflash.prepare_flash(ts.accel, ts.tables, trays)
    nb = inp.packed_rays.shape[1] // R
    args = (ts.accel.tri_flat, ts.accel.sph_feats, R, inp.has_sph)
    v_early = torch.zeros((nb, 3), dtype=torch.int32)
    early = tflash.flash_intersect_plain(inp.packed_rays, inp.queues, *args,
                                         visits=v_early)
    q = inp.queues
    eager = q._replace(pk_entry=torch.zeros_like(q.pk_entry),
                       tail_entry=torch.zeros_like(q.tail_entry),
                       sph_entry=torch.zeros_like(q.sph_entry))
    v_all = torch.zeros((nb, 3), dtype=torch.int32)
    full = tflash.flash_intersect_plain(inp.packed_rays, eager, *args,
                                        visits=v_all)
    a = tflash.flash_epilogue(ts.accel, trays, early, inp.sph_dense)
    b_ = tflash.flash_epilogue(ts.accel, trays, full, inp.sph_dense)
    assert bool(a.valid.all())
    assert torch.equal(a.valid, b_.valid) and torch.equal(a.t, b_.t)
    assert bool((v_all >= v_early).all())
    assert int(q.n_tail.min()) > 0
    assert torch.equal(v_all[:, 2], q.n_tail)
    assert int(v_early[:, 2].sum()) < int(v_all[:, 2].sum())


# ------------------------------------------------- termination groups

_GROUPS = tflash.GROUPS            # (64, 128, 256, 512)
# the file's scenes under their random rays, and the wall under a bundle of
# which the second half of every block strays (so a block's far bound is
# BIG while that of its first groups is the wall's distance)
_GROUP_CASES = sorted(_SCENES) + ["wall_half_stray"]
_ROWS = torch.tensor([tflash.K, tflash.W, tflash.K])   # rows of one visit


def _plain_at(case, group):
    """(kernel inputs, the plain version's four outputs, its visits
    (Bp // group, 3)) for one case at one termination group."""
    key = ("plain", case, group)
    if key not in _cache:
        if case == "wall_half_stray":
            ts, trays = _wall_scene(), _wall_rays(stray_from=R // 2)
        else:
            _, ts, _, trays = _scene(case)
        inp = tflash.prepare_flash(ts.accel, ts.tables, trays)
        v = torch.zeros((inp.packed_rays.shape[1] // group, 3),
                        dtype=torch.int32)
        out = tflash.flash_intersect_plain(
            inp.packed_rays, inp.queues, ts.accel.tri_flat,
            ts.accel.sph_feats, R, inp.has_sph, visits=v, group=group)
        _cache[key] = (ts, inp, out, v)
    return _cache[key]


def _pairs_tested(visits, group):
    return int(group * (visits.long() * _ROWS).sum())


@pytest.mark.parametrize("group", _GROUPS)
@pytest.mark.parametrize("case", _GROUP_CASES)
def test_termination_group_changes_work_not_result(case, group):
    """An entry distance bounds every ray of the block from below, so a
    group that stops earlier than its block loses nothing: all four outputs
    are bit-equal to those at group = block, and no group takes more visits
    than its block does."""
    _, _, want, v_block = _plain_at(case, R)
    _, _, got, v_group = _plain_at(case, group)
    for name, a, b in zip(("tri_t", "tri_slot", "sph_t", "sph_slot"),
                          got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    per_block = v_group.reshape(v_block.shape[0], R // group, 3)
    assert bool((per_block <= v_block[:, None]).all())
    if group == R:
        assert torch.equal(v_group, v_block)


@pytest.mark.parametrize("case", _GROUP_CASES)
def test_pairs_tested_do_not_rise_as_the_group_shrinks(case):
    """Pairs tested = rays of a group x rows it visited, summed."""
    pairs = [_pairs_tested(_plain_at(case, g)[3], g)
             for g in sorted(_GROUPS, reverse=True)]
    if case != "spheres12":     # its spheres all take the dense path
        assert pairs[0] > 0
    assert all(a >= b for a, b in zip(pairs, pairs[1:])), pairs
    if case == "wall_half_stray":
        assert pairs[1] < pairs[0], pairs   # 256 splits walled from stray


@pytest.mark.parametrize("group", [0, -64, 48, 96, 384, 1024])
def test_wrapper_refuses_a_group_that_does_not_fit(group):
    """A group divides the block and is a multiple of 32."""
    ts, inp, _, _ = _plain_at("mixed", R)
    with pytest.raises(ValueError, match="group"):
        tflash.flash_intersect_kernel(
            inp.packed_rays, inp.queues, ts.accel.tri_flat,
            ts.accel.sph_feats, R, inp.has_sph, group=group)


def test_default_group_divides_the_block():
    assert tflash.resolve_group(R) == tflash.DEFAULT_GROUP
    assert tflash.DEFAULT_GROUP in _GROUPS and R % tflash.DEFAULT_GROUP == 0
    assert tflash.resolve_group(96) == 96       # no default fits: the block
    assert tflash.resolve_group(R, 64) == 64


@pytest.mark.parametrize("group", _GROUPS)
def test_wrapper_passes_the_group_to_the_plain_version_on_cpu(group):
    ts, inp, want, v_want = _plain_at("wall_half_stray", group)
    before = tflash.flash_intersect_kernel.launches
    v = torch.zeros_like(v_want)
    got = tflash.flash_intersect_kernel(
        inp.packed_rays, inp.queues, ts.accel.tri_flat, ts.accel.sph_feats,
        R, inp.has_sph, visits=v, group=group)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(v, v_want)
    assert tflash.flash_intersect_kernel.launches == before


@pytest.mark.parametrize("case", _GROUP_CASES)
def test_pairs_that_can_hit_are_counted_per_group(case):
    """`can_hit` counts, per group, the tested pairs that needed more than
    the part every pair pays: no more than the pairs tested of their kind,
    at least one for every ray that hit, and asking for the count changes
    no output."""
    group = tflash.DEFAULT_GROUP
    ts, inp, want, v = _plain_at(case, group)
    hits = torch.zeros((v.shape[0], 2), dtype=torch.int64)
    got = tflash.flash_intersect_plain(
        inp.packed_rays, inp.queues, ts.accel.tri_flat, ts.accel.sph_feats,
        R, inp.has_sph, group=group, can_hit=hits)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    tested_sph = group * v[:, 0].long() * tflash.K
    tested_tri = group * (v[:, 1].long() * tflash.W
                          + v[:, 2].long() * tflash.K)
    assert bool((hits >= 0).all())
    assert bool((hits[:, 0] <= tested_sph).all())
    assert bool((hits[:, 1] <= tested_tri).all())
    tri_t, _, sph_t, _ = (x.reshape(-1, group) for x in got)
    assert bool((hits[:, 0] >= (sph_t < BIG).sum(dim=1)).all())
    assert bool((hits[:, 1] >= (tri_t < BIG).sum(dim=1)).all())
    if case == "wall_half_stray":
        assert int(hits[:, 1].sum()) < int(tested_tri.sum())
