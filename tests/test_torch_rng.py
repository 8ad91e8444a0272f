"""The uniform draws of ops/rng_kernel.py: the plain version of
core/rng.py on the CPU, the hand-written Threefry kernel
(csrc/threefry_uniforms.cu) on a card.

On the CPU every draw takes the plain version (`uniforms_plain`, today's
`threefry2x32` and `_bits_to_unit_float`); here it is held to that
arithmetic and to the published known-answer vectors, the kernel's
wrapper to what it refuses, and the counter `draw_counts` to lanes x
streams and launches, also across a captured and replayed bounce pass.

The cases marked `card` run only with an NVIDIA card (skipped here):

    python -m pytest tests/test_torch_rng.py -m card

They hold the kernel to the plain version bit for bit (ids at and above
2^32, odd lane counts, every form of key and bounce, 1 and 2 streams, 13
and 20 rounds, a draw replayed in a CUDA graph after its buffers are
refilled) and whole frames of both benchmark cells' scenes through the
chunked, compact and pool drivers with the kernel to the same frames with
the plain version in its place.

The JAX package has nothing of this; nothing here imports it.
"""

import ast
import json
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import potato_tpu_torch.ops
from benchmark import harness
from potato_tpu_torch.core import rng as trng
from potato_tpu_torch.ops import _build, flash
from potato_tpu_torch.ops import rng_kernel as rk
from potato_tpu_torch.render import bounce_graphs, integrator
from potato_tpu_torch.render import renderer as trenderer
from potato_tpu_torch.render.camera import chunk_ray_ids, generate_rays
from potato_tpu_torch.render.wavefront import render_pool
from potato_tpu_torch.scene import examples as texamples
from potato_tpu_torch.utils.metrics import MetricsLogger

ONES = 0xFFFFFFFF
SEEDS = [(1 << 62) + 12_345, 9_007_199_254_740_993 * 511 % (1 << 63)]
STREAMS = [(trng.STREAM_SCATTER_A, trng.STREAM_SCATTER_B),
           (trng.STREAM_LENS,)]
# Published Threefry-2x32-20 vectors (Random123) and the 13-round fixture
# of tests/test_rng.py: (key, counter) words all 0 or all ones.
KNOWN = [(0, 20, (0x6B200159, 0x99BA4EFE)),
         (ONES, 20, (0x1CB996FC, 0xBB002BE7)),
         (0, 13, (0x9D1C5EC6, 0xA7A6230F)),
         (ONES, 13, (0xFD36D047, 0x48E8430A))]
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
                    "tests/test_torch_rng.py -m card)")
    return torch.device("cuda")


def _scene(name, device="cpu"):
    if (name, device) not in _scenes:
        _scenes[name, device] = texamples.SCENES[name]().build(
            accel="flash", device=device)
    return _scenes[name, device]


def _ids(n, seed, device="cpu"):
    """Random ray ids, a quarter of them at or above 2^32 (only their low
    32 bits are counters)."""
    ids = np.random.default_rng(seed).integers(0, 1 << 34, n)
    return torch.from_numpy(ids).to(device)


def _seed_form(form, seed, device):
    k0, k1 = trng.key_from_seed(seed)
    i64 = dict(dtype=torch.int64, device=device)
    return {"int": seed,
            "key": trng.Key(k0, k1),
            "device_key": trng.Key(torch.tensor(k0, **i64),
                                   torch.tensor(k1, **i64)),
            "tensor_seed": torch.tensor(seed & 0x7FFFFFFFFFF, **i64)}[form]


def _bounce_form(form, n, device):
    i64 = dict(dtype=torch.int64, device=device)
    return {"int": 37,
            "device_scalar": torch.tensor(37, **i64),
            "per_lane": torch.arange(n, **i64) % 50}[form]


def _todays_bits(seed, bounce, streams, ids, rounds=trng.RENDER_ROUNDS):
    """The uniforms as the render path computed them before the draw had a
    kernel: one `random_bits2`-style call a stream, then
    `_bits_to_unit_float`."""
    if isinstance(seed, trng.Key):
        k0, k1 = seed
    elif isinstance(seed, torch.Tensor):
        k0, k1 = seed, 0
    else:
        k0, k1 = trng.key_from_seed(seed)
    rows = []
    for s in streams:
        for w in trng.threefry2x32(k0, k1, ids,
                                   trng.bounce_salt(bounce, s),
                                   rounds=rounds):
            rows.append(trng._bits_to_unit_float(w))
    return torch.stack(rows)


# ------------------------------------------------ CPU: the plain version

@pytest.mark.parametrize("seed_form", ["int", "key", "device_key",
                                       "tensor_seed"])
@pytest.mark.parametrize("bounce_form", ["int", "device_scalar",
                                         "per_lane"])
def test_cpu_draws_take_the_plain_version(seed_form, bounce_form):
    n = 1001
    ids = _ids(n, 7)
    seed = _seed_form(seed_form, SEEDS[0], "cpu")
    bounce = _bounce_form(bounce_form, n, "cpu")
    before = rk.draw_counts.snapshot()
    got = rk.uniforms(seed, bounce, STREAMS[0], ids)
    assert got.shape == (4, n) and got.dtype == torch.float32
    assert torch.equal(got, _todays_bits(seed, bounce, STREAMS[0], ids))
    assert rk.draw_counts.snapshot() == (before[0], before[1] + 2 * n,
                                         before[2])


@pytest.mark.parametrize("word,rounds,want", KNOWN)
def test_cpu_draws_give_the_known_answers(word, rounds, want):
    # salt = bounce * NUM_STREAMS + stream: 0, or 0x1FFFFFFF * 8 + 7 = ONES
    bounce, stream = (0, 0) if word == 0 else (ONES >> 3, 7)
    got = rk.uniforms(trng.Key(word, word), bounce, (stream,),
                      torch.tensor([word]), rounds=rounds)
    bits = torch.tensor(want, dtype=torch.int64)[:, None]
    assert torch.equal(got, trng._bits_to_unit_float(bits))


def test_uniform2_and_uniform1_are_one_stream_of_a_draw():
    ids = _ids(513, 3)
    salt = trng.bounce_salt(4, trng.STREAM_SCATTER_B)
    u0, u1 = trng.uniform2(SEEDS[1], salt, ids)
    want = _todays_bits(SEEDS[1], 4, (trng.STREAM_SCATTER_B,), ids)
    assert torch.equal(u0, want[0]) and torch.equal(u1, want[1])
    assert torch.equal(trng.uniform1(SEEDS[1], salt, ids), want[0])
    assert trng.uniform2(SEEDS[1], salt, ids, torch.float64)[0].dtype \
        == torch.float64


@pytest.mark.parametrize("draw", ["uniform2", "uniform1"])
def test_uniform2_and_uniform1_raise_off_the_cpu(draw):
    """No plain draw on a card: there every draw is the kernel's."""
    ids = torch.arange(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CPU tensors only"):
        getattr(trng, draw)(SEEDS[0], 3, ids)


def test_the_kernel_salts_a_bounce_as_the_plain_version_does():
    """csrc/threefry_uniforms.cu draws at salt bounce * NUM_STREAMS +
    stream, with its own copy of the stream count."""
    src = open(_build.source_path("threefry_uniforms")).read()
    assert f"constexpr uint32_t NUM_STREAMS = {trng.NUM_STREAMS}u;" in src
    assert trng.bounce_salt(5, trng.STREAM_SCATTER_B) \
        == 5 * trng.NUM_STREAMS + trng.STREAM_SCATTER_B


def test_core_rng_imports_nothing_of_ops():
    """core/ is the port's lowest layer: the kernel's wrapper lives in
    ops/rng_kernel.py, which imports core/rng.py, not the other way."""
    path = os.path.join(os.path.dirname(trng.__file__), "rng.py")
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    assert names and not [n for n in names if "ops" in n.split(".")
                          or n.startswith(".")], names


# ------------------------------------------------ CPU: the kernel's wrapper

@pytest.mark.parametrize("case,message", [
    ("int32_ids", "contiguous int64"),
    ("strided_ids", "contiguous int64"),
    ("rounds", "rounds"),
    ("no_stream", "streams"),
    ("three_streams", "streams"),
    ("bounce_shape", "bounce"),
    ("bounce_dtype", "bounce"),
    ("key_device", "key word 0"),
    ("key_shape", "key word 1"),
    ("cpu_ids", "CUDA device"),
    ("meta_ids_through_uniforms", "CUDA device"),
])
def test_the_kernel_wrapper_raises_on_what_it_does_not_take(case, message):
    ids = torch.arange(64, dtype=torch.int64)
    seed, bounce, streams, rounds = SEEDS[0], 3, STREAMS[0], 13
    if case == "int32_ids":
        ids = ids.to(torch.int32)
    elif case == "strided_ids":
        ids = torch.arange(128)[::2]
    elif case == "rounds":
        rounds = 12
    elif case == "no_stream":
        streams = ()
    elif case == "three_streams":
        streams = (2, 3, 4)
    elif case == "bounce_shape":
        bounce = torch.zeros(63, dtype=torch.int64)
    elif case == "bounce_dtype":
        bounce = torch.zeros((), dtype=torch.int32)
    elif case == "key_device":
        seed = trng.Key(torch.zeros((), dtype=torch.int64, device="meta"), 0)
    elif case == "key_shape":
        seed = trng.Key(0, torch.zeros(1, dtype=torch.int64))
    before = rk.draw_counts.snapshot()
    with pytest.raises(ValueError, match=message):
        if case == "meta_ids_through_uniforms":
            # no device but the CPU takes the plain version
            rk.uniforms(seed, bounce, streams, ids.to("meta"))
        else:
            rk.threefry_uniforms_kernel(seed, bounce, streams, ids, rounds)
    assert rk.draw_counts.snapshot() == before


# ------------------------------------------------ CPU: the counter

def test_camera_and_advance_draw_every_stream_once():
    scene = _scene("more_balls")
    assert scene.features.has_lens
    ids, live = chunk_ray_ids(0, 512, 32, 16, 1, "cpu")
    before = rk.draw_counts.snapshot()
    rays = generate_rays(scene.camera, 32, 16, 1, ids, SEEDS[0], lens=True)
    assert rk.draw_counts.plain - before[1] == 2 * 512   # jitter, lens
    generate_rays(scene.camera, 32, 16, 1, ids, SEEDS[0], jitter=False,
                  lens=False)
    assert rk.draw_counts.plain - before[1] == 2 * 512   # no draw
    step = integrator.make_bounce_step(
        scene.tables, trenderer.make_intersect_fn(scene), SEEDS[0],
        features=scene.features)
    state = step(integrator.init_state(rays, live=live), 0, ids)
    step(state, 1, ids)
    assert rk.draw_counts.plain - before[1] == 2 * 512 + 2 * 2 * 512
    assert (rk.draw_counts.kernel, rk.draw_counts.launches) == (
        before[0], before[2])


def _fake_capture():
    """torch.cuda's graph capture as a CPU can run it: the captured bodies
    run eagerly once, and a replay does nothing."""
    class Graph:
        def replay(self):
            pass

    class Capture:
        def __init__(self, graph, pool=None):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    return (mock.patch.object(torch.cuda, "CUDAGraph", Graph),
            mock.patch.object(torch.cuda, "graph", Capture))


def _card_like(seed, bounce, streams, ids, rounds=trng.RENDER_ROUNDS):
    """`rk.uniforms` counting as the card's kernel counts a draw."""
    out = trng.uniforms_plain(seed, bounce, streams, ids, rounds)
    rk.draw_counts.add(kernel=out.numel() // 2, launches=1)
    return out


@pytest.mark.parametrize("drawn_by", ["plain", "kernel"])
def test_a_replay_adds_the_draws_its_capture_made(drawn_by):
    """A replay adds the draws and kernel launches its capture counted;
    the kernel's counting is played on the CPU by `_card_like`."""
    if drawn_by == "kernel":
        with mock.patch.object(rk, "uniforms", _card_like):
            return _replay_adds_the_draws((2 * 512, 0, 1))
    return _replay_adds_the_draws((0, 2 * 512, 0))


def _replay_adds_the_draws(want_per_pass):
    bounce_graphs._SCENES.clear()          # no variant of an earlier case
    scene = _scene("cornell_box")
    ids, live = chunk_ray_ids(0, 512, 24, 24, 1, "cpu")
    rays = generate_rays(scene.camera, 24, 24, 1, ids, SEEDS[1], lens=False)
    state = integrator.init_state(rays, live=live)
    step = bounce_graphs.GraphedStep(scene.tables, scene.accel, SEEDS[1],
                                     features=scene.features)
    state = step(state, 0, ids)               # the bodies, eagerly
    eager = rk.draw_counts.snapshot()
    step(state, 1, ids)
    per_pass = tuple(a - b for a, b in zip(rk.draw_counts.snapshot(),
                                           eager))
    assert per_pass == want_per_pass
    v = step.mine[512, False]
    sg = bounce_graphs._scene_graphs(scene.accel)
    graph, capture = _fake_capture()
    before = rk.draw_counts.snapshot()
    with graph, capture:
        v.capture(scene.tables, scene.accel, sg.words, sg.bounce, None)
    assert rk.draw_counts.snapshot() == before    # moved to the variant
    assert v.draws == per_pass
    replayed = integrator.pass_counts.replayed
    step(state, 1, ids)                            # a replay
    assert integrator.pass_counts.replayed == replayed + 1
    assert tuple(a - b for a, b in zip(rk.draw_counts.snapshot(),
                                       before)) == per_pass


def test_render_complete_logs_the_draws(tmp_path):
    path = tmp_path / "m.jsonl"
    logger = MetricsLogger(str(path))
    scene = _scene("cornell_box")
    trenderer.render(scene, 16, 16, spp=1, max_bounce=3, seed=SEEDS[0],
                     metrics=logger, device="cpu")
    logger.close()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    start = [e for e in events if e["event"] == "render_start"][-1]
    done = [e for e in events if e["event"] == "render_complete"][-1]
    camera = start["chunk_size"] * start["num_chunks"]   # jitter only
    assert done["draws_kernel"] == 0
    assert done["draws_plain"] == camera + 2 * done["lanes"]


def test_kernel_draw_pct_reader(monkeypatch):
    reader = harness.metric_reader(harness.BENCH, "rng.kernel_draw_pct")
    run = mock.Mock(state={})
    reader.before_window(run)
    rk.draw_counts.add(300, 100)
    reader.after_window(run)
    assert reader.read(run) == 75.0
    reader.before_window(run)
    reader.after_window(run)
    assert reader.read(run) is None          # no draw in the window
    with mock.patch.object(rk, "draw_counts", None, create=False):
        reader.before_window(run)
        reader.after_window(run)
        assert reader.read(run) is None      # a program without the counter
    # nor the module that keeps it, as in a program before the kernel
    monkeypatch.delattr(potato_tpu_torch.ops, "rng_kernel")
    monkeypatch.setitem(sys.modules, "potato_tpu_torch.ops.rng_kernel", None)
    reader.before_window(run)
    reader.after_window(run)
    assert reader.read(run) is None


# --------------------------------------------------------- on the card only

@pytest.mark.card
@pytest.mark.parametrize("streams", STREAMS)
@pytest.mark.parametrize("seed_form", ["int", "key", "device_key",
                                       "tensor_seed"])
@pytest.mark.parametrize("bounce_form", ["int", "device_scalar",
                                         "per_lane"])
@pytest.mark.parametrize("n", [1, 4097, 1 << 15])
def test_kernel_equals_the_plain_version(card, streams, seed_form,
                                         bounce_form, n):
    ids = _ids(n, n, card)
    seed = _seed_form(seed_form, SEEDS[n % 2], card)
    bounce = _bounce_form(bounce_form, n, card)
    before = rk.draw_counts.snapshot()
    got = rk.uniforms(seed, bounce, streams, ids)
    assert rk.draw_counts.snapshot() == (before[0] + n * len(streams),
                                         before[1], before[2] + 1)
    want = trng.uniforms_plain(seed, bounce, streams, ids)
    assert got.shape == want.shape == (2 * len(streams), n)
    assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("word,rounds,want", KNOWN)
def test_kernel_gives_the_known_answers(card, word, rounds, want):
    bounce, stream = (0, 0) if word == 0 else (ONES >> 3, 7)
    got = rk.threefry_uniforms_kernel(
        trng.Key(word, word), bounce, (stream,),
        torch.tensor([word], device=card), rounds)
    bits = torch.tensor(want, dtype=torch.int64)[:, None]
    assert torch.equal(got.cpu(), trng._bits_to_unit_float(bits))


@pytest.mark.card
def test_a_captured_draw_reads_its_refilled_buffers(card):
    n = 3001
    i64 = dict(dtype=torch.int64, device=card)
    ids = _ids(n, 5, card)
    key = trng.Key(torch.zeros((), **i64), torch.zeros((), **i64))
    bounce = torch.zeros((), **i64)
    rk.uniforms(key, bounce, STREAMS[0], ids)            # warm, eagerly
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rk.uniforms(key, bounce, STREAMS[0], ids)
    for seed, b in ((SEEDS[0], 3), (SEEDS[1], 49)):
        k0, k1 = trng.key_from_seed(seed)
        key.k0.fill_(k0)
        key.k1.fill_(k1)
        bounce.fill_(b)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, trng.uniforms_plain(seed, b, STREAMS[0],
                                                    ids))


@pytest.mark.card
def test_a_kernel_draw_does_not_sync_the_host(card):
    ids = _ids(1 << 15, 1, card)
    bounces = (2, torch.tensor(2, device=card),
               torch.full((1 << 15,), 2, dtype=torch.int64, device=card))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in bounces:
            rk.uniforms(SEEDS[0], b, STREAMS[0], ids)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _plain_in_the_kernels_place():
    return mock.patch.object(rk, "threefry_uniforms_kernel",
                             trng.uniforms_plain)


def _eager_only():
    """Every pass op by op: the graphed step declines each pass."""
    return mock.patch.object(bounce_graphs.GraphedStep, "__call__",
                             lambda self, *a: None)


def _frame(scene, size, spp, bounces, driver, seed):
    """A frame on fresh graphs (none captured with another draw): its
    passes run eagerly, capture and replay."""
    bounce_graphs._SCENES.clear()
    if driver == "pool":
        return render_pool(scene, *size, spp=spp, max_bounce=bounces,
                           seed=seed, device="cuda")
    return trenderer.render(scene, *size, spp=spp, max_bounce=bounces,
                            seed=seed, driver=driver, device="cuda")


def _assert_frames_equal(a, b):
    assert a.segments == b.segments
    np.testing.assert_array_equal(a.color, b.color)
    np.testing.assert_array_equal(a.normal, b.normal)
    np.testing.assert_array_equal(a.coverage, b.coverage)


@pytest.mark.card
@pytest.mark.parametrize("name,size,spp,bounces", [
    ("cornell_box", (64, 64), 1, 50), ("more_balls", (64, 64), 4, 8)])
@pytest.mark.parametrize("driver", ["chunked", "compact", "pool"])
def test_frames_with_the_kernel_equal_frames_with_the_plain_version(
        card, name, size, spp, bounces, driver):
    scene = _scene(name, "cuda")
    for seed in SEEDS:
        launches = rk.draw_counts.launches
        got = _frame(scene, size, spp, bounces, driver, seed)
        assert rk.draw_counts.launches > launches
        with _plain_in_the_kernels_place():
            want = _frame(scene, size, spp, bounces, driver, seed)
        _assert_frames_equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("name,size,spp,bounces", [
    ("cornell_box", (64, 64), 1, 50), ("more_balls", (64, 64), 4, 8)])
@pytest.mark.parametrize("driver", ["chunked", "compact"])
def test_draw_counts_read_the_same_with_and_without_graphs(
        card, name, size, spp, bounces, driver):
    scene = _scene(name, "cuda")
    counts = []
    for patch in (mock.MagicMock(), _eager_only()):
        before = rk.draw_counts.snapshot()
        replayed = integrator.pass_counts.replayed
        with patch:
            out = _frame(scene, size, spp, bounces, driver, SEEDS[0])
        counts.append((tuple(a - b for a, b in zip(
            rk.draw_counts.snapshot(), before)), out.segments))
        if len(counts) == 1:
            assert integrator.pass_counts.replayed > replayed
    assert counts[0] == counts[1]
    kernel, plain, launches = counts[0][0]
    assert kernel > 0 and plain == 0 and launches > 0
    assert flash.flash_intersect_kernel.launches > 0
