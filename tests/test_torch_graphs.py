"""The bounce pass replayed as CUDA graphs (render/bounce_graphs.py).

On the CPU a GraphedStep runs the bodies of its two graphs eagerly, through
the same input buffers, device-scalar seed words and bounce, kernel call on
copies and copies out as on a card; here it is held bit for bit to the
eager step of integrator.make_bounce_step, with the constants that were
hoisted out of the pass (Threefry's words, the lattice hash's terms, the
sky's zenith colour, +z) against today's arithmetic.

The cases marked `card` run only with an NVIDIA card (skipped here):

    python -m pytest tests/test_torch_graphs.py -m card

They hold whole render() frames of the graph path to the eager path bit
for bit, a pass to no host sync, and later frames to no capture.

The JAX package has nothing of this; nothing here imports it.
"""

import gc
import json
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark import faults, harness
from potato_tpu_torch.core import noise as tnoise
from potato_tpu_torch.core import rng as trng
from potato_tpu_torch.core.types import device_constant, hits_at_infinity
from potato_tpu_torch.ops import flash
from potato_tpu_torch.ops.material import eval_emit
from potato_tpu_torch.render import bounce_graphs, integrator
from potato_tpu_torch.render import renderer as trenderer
from potato_tpu_torch.render.camera import chunk_ray_ids, generate_rays
from potato_tpu_torch.scene import description as d
from potato_tpu_torch.scene import examples as texamples
from potato_tpu_torch.utils.metrics import MetricsLogger

SEEDS = [(1 << 62) + 12_345, 9_007_199_254_740_993 * 511 % (1 << 63)]
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


@pytest.fixture
def card():
    """The card, or a skip: decided when the case runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run there: python -m pytest "
                    "tests/test_torch_graphs.py -m card)")
    return torch.device("cuda")


def _scene(name, device="cpu"):
    if (name, device) not in _scenes:
        _scenes[name, device] = texamples.SCENES[name]().build(
            accel="flash", device=device)
    return _scenes[name, device]


def _chunk(scene, width, height, spp, start, lanes, seed):
    ids, live = chunk_ray_ids(start, lanes, width, height, spp, scene.device)
    rays = generate_rays(scene.camera, width, height, spp, ids, seed,
                         lens=scene.features.has_lens)
    return integrator.init_state(rays, live=live), ids


def _leaves(state):
    return bounce_graphs._leaves(state)


def _assert_states_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ------------------------------------------------ CPU: bodies against eager

@pytest.mark.parametrize("name,frame,start,first,seed", [
    # the aovs-at-bounce-0 variant, then the later-bounce one
    ("more_balls", (32, 16, 1), 0, 0, SEEDS[0]),
    ("cornell_box", (24, 24, 1), 0, 0, SEEDS[1]),
    # later bounces only, from a state two eager bounces in
    ("more_balls", (32, 16, 1), 0, 2, SEEDS[1]),
    ("cornell_box", (24, 24, 1), 0, 2, SEEDS[0]),
    # a tail chunk: 384 of its 512 lanes are born dead
    ("cornell_box", (40, 16, 1), 512, 0, SEEDS[0]),
    ("more_balls", (20, 20, 2), 512, 0, SEEDS[1]),
    # Perlin noise in the pass (the lattice hash)
    ("two_balls", (16, 16, 2), 0, 0, SEEDS[0]),
])
def test_graphed_step_equals_eager_step(name, frame, start, first, seed):
    scene = _scene(name)
    state, ids = _chunk(scene, *frame, start, 512, seed)
    fn = trenderer.make_intersect_fn(scene)
    eager = integrator.make_bounce_step(scene.tables, fn, seed,
                                        features=scene.features)
    graphed = bounce_graphs.GraphedStep(scene.tables, scene.accel, seed,
                                        features=scene.features)
    for bounce in range(first):
        state = eager(state, bounce, ids)
    want = got = state
    for bounce in range(first, first + 4):
        lanes = flash.intersect_flash.lanes
        want = eager(want, bounce, ids)
        eager_lanes = flash.intersect_flash.lanes - lanes
        got = graphed(got, bounce, ids)
        assert flash.intersect_flash.lanes - lanes == 2 * eager_lanes
        _assert_states_equal(want, got)
    assert int(want.segments) > 0


def test_graphed_step_returns_states_no_later_call_writes():
    scene = _scene("cornell_box")
    state, ids = _chunk(scene, 24, 24, 1, 0, 512, SEEDS[0])
    graphed = bounce_graphs.GraphedStep(scene.tables, scene.accel, SEEDS[0],
                                        features=scene.features)
    first = graphed(state, 0, ids)
    kept = [x.clone() for x in _leaves(first)]
    second = graphed(first, 1, ids)
    graphed(second, 2, ids)
    for x, y in zip(_leaves(first), kept):
        assert torch.equal(x, y)


def test_make_bounce_step_runs_eagerly_on_the_cpu():
    scene = _scene("cornell_box")
    state, ids = _chunk(scene, 24, 24, 1, 0, 512, SEEDS[1])
    step = integrator.make_bounce_step(
        scene.tables, trenderer.make_intersect_fn(scene), SEEDS[1],
        features=scene.features)
    before = integrator.pass_counts.snapshot()
    for bounce in range(3):
        state = step(state, bounce, ids)
    assert integrator.pass_counts.snapshot() == \
        (before[0] + 3, before[1], before[2])


def test_intersect_fn_names_its_kernel_accelerator_unless_plain():
    scene = _scene("cornell_box")
    assert trenderer.make_intersect_fn(scene).flash_accel is scene.accel
    assert trenderer.make_intersect_fn(
        scene, force_plain=True).flash_accel is None


def test_scene_graphs_go_with_the_scene():
    scene = texamples.SCENES["cornell_box"]().build(accel="flash",
                                                    device="cpu")
    state, ids = _chunk(scene, 24, 24, 1, 0, 512, SEEDS[0])
    bounce_graphs.GraphedStep(scene.tables, scene.accel, SEEDS[0],
                              features=scene.features)(state, 0, ids)
    key = id(scene.accel.tri_flat)
    assert bounce_graphs._SCENES[key].owner() is scene.accel.tri_flat
    del scene, state, ids
    gc.collect()
    assert key not in bounce_graphs._SCENES


def test_step_under_the_state_fault_returns_its_state():
    scene = _scene("cornell_box")
    state, ids = _chunk(scene, 24, 24, 1, 0, 512, SEEDS[0])
    with faults.planted("step_returns_state_unchanged"):
        step = integrator.make_bounce_step(
            scene.tables, trenderer.make_intersect_fn(scene), SEEDS[0],
            features=scene.features)
        assert step(state, 0, ids) is state


# --------------------------------------------- CPU: the hoisted constants

@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_words_as_python_ints_and_device_scalars(seed):
    """Today's arithmetic made a tensor of every word; python ints and a
    Key of int64 scalars give the same bits."""
    ids = torch.arange(-3, 4093, dtype=torch.int64) * 7919
    salt = trng.bounce_salt(5, trng.STREAM_SCATTER_B)
    k0, k1 = seed & 0xFFFFFFFF, seed >> 32
    as_tensors = trng.threefry2x32(
        torch.tensor(k0), torch.tensor(k1), ids & 0xFFFFFFFF,
        torch.tensor(salt).expand(ids.shape), rounds=trng.RENDER_ROUNDS)
    key = trng.Key(torch.tensor(k0), torch.tensor(k1))
    for got in (trng.random_bits2(seed, salt, ids),
                trng.random_bits2(key, torch.tensor(5) * trng.NUM_STREAMS
                                  + trng.STREAM_SCATTER_B, ids)):
        for a, b in zip(as_tensors, got):
            assert torch.equal(a, b)
    assert trng.key_from_seed(seed) == (k0, k1)
    # python ints alone still give host tensors
    w = trng.threefry2x32(k0, k1, 1, salt)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in w)


@pytest.mark.parametrize("mix", ["x", "seed", "all"])
def test_lattice_hash_with_python_int_terms(mix):
    pts = np.random.default_rng(3).integers(-2**40, 2**40, (257, 4))
    want = tnoise.noise_i64(*(torch.from_numpy(pts[:, i]) for i in range(4)))
    for row in range(0, 257, 64):
        args = [torch.from_numpy(pts[row:row + 1, i]) for i in range(4)]
        if mix in ("x", "all"):
            args[0] = int(pts[row, 0])
        if mix in ("seed", "all"):
            args[3] = int(pts[row, 3])
        got = tnoise.noise_i64(*args)
        assert int(got.reshape(-1)[0]) == int(want[row])


def test_sky_zenith_and_plus_z_are_todays_bits():
    zenith = device_constant((0.5, 0.7, 1.0), torch.float32, "cpu")
    assert torch.equal(zenith, torch.tensor([0.5, 0.7, 1.0]))
    assert device_constant((0.5, 0.7, 1.0), torch.float32, "cpu") is zenith
    assert torch.equal(device_constant((0.0, 0.0, 1.0), torch.float32,
                                       "cpu"), torch.tensor([0.0, 0.0, 1.0]))
    scene = _scene("two_balls")
    direction = torch.nn.functional.normalize(
        torch.randn(64, 3, generator=torch.Generator().manual_seed(1)),
        dim=-1)
    kind = torch.full((64,), d.EMIT_SKY_GRADIENT, dtype=torch.int32)
    got = eval_emit(scene.tables, kind, torch.zeros(64, 3),
                    torch.zeros(64, dtype=torch.int32), direction,
                    hits_at_infinity(direction))
    t = (0.5 * (direction[:, 1] / torch.linalg.norm(direction, dim=-1)
                + 1.0))[:, None]
    want = (1.0 - t) * torch.ones(3) + t * torch.tensor([0.5, 0.7, 1.0])
    assert torch.equal(got, want)


# ----------------------------------------------- CPU: counters and reader

def test_render_complete_logs_the_pass_counters(tmp_path):
    path = tmp_path / "m.jsonl"
    logger = MetricsLogger(str(path))
    scene = _scene("cornell_box")
    trenderer.render(scene, 16, 16, spp=1, max_bounce=3, seed=SEEDS[0],
                     metrics=logger, device="cpu")
    logger.close()
    done = [json.loads(line) for line in path.read_text().splitlines()
            if '"render_complete"' in line][-1]
    assert done["passes"] == 3 and done["replayed"] == 0
    assert done["captures"] == 0


def test_graphed_pass_pct_reader():
    reader = harness.metric_reader(harness.BENCH,
                                   "integrator.graphed_pass_pct")
    run = mock.Mock(state={})
    counts = integrator.pass_counts
    reader.before_window(run)
    counts.passes += 8
    counts.replayed += 6
    reader.after_window(run)
    assert reader.read(run) == 75.0
    reader.before_window(run)
    reader.after_window(run)
    assert reader.read(run) is None          # no pass in the window
    with mock.patch.object(integrator, "pass_counts", None, create=False):
        reader.before_window(run)
        reader.after_window(run)
        assert reader.read(run) is None      # a program without counters


# --------------------------------------------------------- on the card only

def _eager_only():
    """Every pass op by op: the graphed step declines each pass."""
    return mock.patch.object(bounce_graphs.GraphedStep, "__call__",
                             lambda self, *a: None)


def _frames(scene, width, height, spp, bounces, driver, seeds):
    return [trenderer.render(scene, width, height, spp=spp,
                             max_bounce=bounces, seed=s, driver=driver,
                             device="cuda") for s in seeds]


def _assert_frames_equal(a, b):
    assert a.segments == b.segments
    np.testing.assert_array_equal(a.color, b.color)
    np.testing.assert_array_equal(a.normal, b.normal)
    np.testing.assert_array_equal(a.coverage, b.coverage)


@pytest.mark.card
@pytest.mark.parametrize("name,size,spp,bounces", [
    ("cornell_box", (64, 48), 1, 50), ("cornell_box", (600, 600), 1, 50),
    ("more_balls", (64, 48), 4, 8), ("more_balls", (800, 600), 4, 8)])
@pytest.mark.parametrize("driver", ["chunked", "compact"])
def test_graph_frames_equal_eager_frames(card, name, size, spp, bounces,
                                         driver):
    scene = _scene(name, "cuda")
    seeds = [SEEDS[0], SEEDS[1]]
    got = _frames(scene, *size, spp, bounces, driver, seeds)
    with _eager_only():
        want = _frames(scene, *size, spp, bounces, driver, seeds)
    for a, b in zip(got, want):
        _assert_frames_equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("name", ["cornell_box", "more_balls", "two_balls"])
def test_a_pass_does_not_sync_the_host(card, name):
    scene = _scene(name, "cuda")
    state, ids = _chunk(scene, 256, 128, 1, 0, 1 << 15, SEEDS[0])
    step = integrator.make_bounce_step(
        scene.tables, trenderer.make_intersect_fn(scene), SEEDS[0],
        features=scene.features)
    counts = integrator.pass_counts
    for bounce in range(2):          # the eager pass, then the capture
        state = step(state, bounce, ids)
    replayed = counts.replayed
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = step(state, 2, ids)
        with _eager_only():
            step(state, 3, ids)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert counts.replayed == replayed + 1


@pytest.mark.card
@pytest.mark.parametrize("name,size,spp,bounces", [
    ("cornell_box", (600, 600), 1, 50), ("more_balls", (800, 600), 4, 8)])
def test_later_frames_capture_nothing_and_count_as_eager(card, name, size,
                                                         spp, bounces):
    scene = _scene(name, "cuda")
    counts = integrator.pass_counts
    trenderer.render(scene, *size, spp=spp, max_bounce=bounces,
                     seed=SEEDS[1], device="cuda")
    captures = counts.captures
    launches, lanes = flash.flash_intersect_kernel.launches, \
        flash.intersect_flash.lanes
    passes, replayed = counts.passes, counts.replayed
    for s in SEEDS:
        trenderer.render(scene, *size, spp=spp, max_bounce=bounces, seed=s,
                         device="cuda")
    assert counts.captures == captures
    assert counts.replayed - replayed == counts.passes - passes > 0
    graph_counts = (flash.flash_intersect_kernel.launches - launches,
                    flash.intersect_flash.lanes - lanes)
    launches, lanes = flash.flash_intersect_kernel.launches, \
        flash.intersect_flash.lanes
    with _eager_only():
        for s in SEEDS:
            trenderer.render(scene, *size, spp=spp, max_bounce=bounces,
                             seed=s, device="cuda")
    assert graph_counts == (flash.flash_intersect_kernel.launches - launches,
                            flash.intersect_flash.lanes - lanes)


@pytest.mark.card
def test_a_scene_left_in_a_cycle_goes_before_the_next_capture(card):
    """The graphs of a scene that only the cycle collector frees are freed
    before a capture, never during one (which would invalidate it)."""
    old = texamples.SCENES["two_balls"]().build(accel="flash", device="cuda")
    trenderer.render(old, 64, 48, spp=1, max_bounce=3, seed=SEEDS[0],
                     device="cuda")
    key = id(old.accel.tri_flat)
    assert key in bounce_graphs._SCENES
    cycle = [old]
    cycle.append(cycle)
    del old, cycle
    new = texamples.three_balls().build(accel="flash", device="cuda")
    captures = integrator.pass_counts.captures
    trenderer.render(new, 64, 48, spp=1, max_bounce=3, seed=SEEDS[1],
                     device="cuda")
    assert integrator.pass_counts.captures > captures
    assert key not in bounce_graphs._SCENES


@pytest.mark.card
def test_the_diff_path_differentiates_eagerly(card):
    from potato_tpu_torch.diff.optimize import make_render_loss

    scene = _scene("more_balls", "cuda")
    w, h, spp = 32, 16, 1
    target = torch.full((w * h, 3), 0.25, device="cuda")
    loss_fn = make_render_loss(scene, width=w, height=h, spp=spp,
                               max_bounce=3, seed=SEEDS[0],
                               fields=("m_absorb_color",))
    params = {"m_absorb_color": scene.tables.m_absorb_color.clone()}
    ids = torch.arange(w * h * spp, device="cuda")
    replayed = integrator.pass_counts.replayed
    loss, grads = loss_fn.value_and_grad(params, ids, target)
    g = grads["m_absorb_color"]
    assert torch.isfinite(loss) and torch.isfinite(g).all()
    assert float(g.abs().sum()) > 0
    assert integrator.pass_counts.replayed == replayed
