"""potato_tpu_torch/parallel/ (torch.distributed scale-out) and
io/native.py::morton_argsort, against one process and against the JAX
package's parallel/ on the same seeded scenes (CPU).

Worlds 2 and 4 are real processes joined under gloo
(`launch.spawn(device="cpu")`), each spawned once for the whole module;
world 1 runs in this process with no process group. The ranks run
chip_smoke_ranks.py's measure_render and measure_train_step, the rank
functions of chip_smoke.py's scale-out phase, on small scenes. Every case
below reads those runs.

Tolerances:
- sharded against one process (the chunked driver's frame, same ids):
  bit for bit, color, both AOVs and segments: every ray's randomness is
  a function of (seed, global id) alone;
- against potato_tpu.parallel.make_sharded_render_fn on the conftest's
  8-device CPU mesh: the image gate of tests/test_render_oracle.py::_compare
  (per-pixel 2e-3, at most max(1, 0.2 %) pixels off; reading 3e-6, no
  pixel off), segments equal;
- the training step against potato_tpu.parallel.make_sharded_train_step
  (same target): atlas' to atol 1e-6 (the step moves a texel by up to
  0.16; the two renders differ by float32 rounding through three bounces;
  reading 1.2e-7, one ulp), loss to rtol 1e-5 (reading: equal);
- world 2 against world 1: relative L2 of atlas' - init <= 1e-5 and loss
  rtol 1e-6: the ranks sum their shares' gradients in another order than
  one process sums its chunks' (at this size the readings are 0).
"""

import ast
import os
from contextlib import contextmanager
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from potato_tpu.io import native as jnative
from potato_tpu.parallel import make_ray_mesh
from potato_tpu.parallel import shard as jshard
from potato_tpu.render import renderer as jrenderer
from potato_tpu.scene import examples as jexamples

from potato_tpu_torch.io import native as tnative
from potato_tpu_torch.io import tga
from potato_tpu_torch.parallel import distributed, launch, shard
from potato_tpu_torch.parallel.mesh import RayGroup, make_ray_group
from potato_tpu_torch.render import renderer as trenderer
from potato_tpu_torch.scene import examples as texamples

from chip_smoke_ranks import frame_ray_ids, measure_render, measure_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDER = dict(width=16, height=16, spp=2, max_bounce=4, seed=3)
SCENES = {"three_balls": (texamples.three_balls, "brute"),
          "one_triangle": (texamples.one_triangle, "flash")}
TRAIN = dict(width=8, height=8, spp=2, max_bounce=3, seed=0, steps=2,
             learning_rate=20.0, init=0.25)


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
    tga.save(img, os.path.join(directory, "earthmap.tga"))
    return directory


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return write_earthmap(str(tmp_path_factory.mktemp("earth")))


@pytest.fixture(scope="module")
def runs(assets):
    """world -> {"render": measure_render's result, "train":
    measure_train_step's result (worlds 1 and 2)}."""
    render = partial(measure_render, scenes=SCENES, **RENDER)
    train = partial(measure_train_step,
                    make_scene=partial(texamples.earth, assets),
                    accel="brute", **TRAIN)
    one = make_ray_group(device="cpu")
    out = {1: {"render": render(one), "train": train(one)}}
    for world, fns in ((2, [render, train]), (4, [render])):
        got = launch.spawn(partial(launch.in_turn, fns=fns), world,
                           device="cpu", timeout_s=300)
        assert got.backend == "gloo"
        assert [r["device"] for r in got.startup] == ["cpu"] * world
        out[world] = dict(zip(("render", "train"), got.result))
    return out


def _chunked_frame(name):
    """One process: the chunked driver's stacked rows of the frame."""
    make, accel = SCENES[name]
    scene = make().build(accel=accel, device="cpu")
    kw = {k: RENDER[k] for k in ("width", "height", "spp", "max_bounce")}
    fn, starts = trenderer.compile_frame(scene, aovs=True, driver="chunked",
                                         device="cpu", **kw)
    out = fn(scene.tables, scene.camera, RENDER["seed"], starts)
    total = RENDER["width"] * RENDER["height"] * RENDER["spp"]
    return ({"color": out.color.reshape(-1, 3)[:total].numpy(),
             "aov_normal": out.aov_normal.reshape(-1, 3)[:total].numpy(),
             "aov_hit": out.aov_hit.reshape(-1)[:total].numpy()},
            int(out.segments.sum()))


def _image(rows):
    """Traversal-order rows of RENDER's frame -> (H, W, 3) pixel means."""
    w, h, spp = RENDER["width"], RENDER["height"], RENDER["spp"]
    flat = np.empty_like(rows)
    flat[trenderer.tile_unswizzle_perm(w, h, spp)] = rows
    return flat.reshape(h, w, spp, 3).mean(axis=2)


@contextmanager
def specialized(jscene):
    """The reference's sharded functions with render_chunk given the
    scene's feature set, as the port's are. Its default computes every
    material and texture variant for every lane: the same values, but
    half a minute of compilation on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jshard, "render_chunk",
                   partial(jrenderer.render_chunk, features=jscene.features))
        yield


# ------------------------------------------------------------ the render

@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("name", list(SCENES))
def test_sharded_render_bit_equal_to_one_process(runs, name, world):
    got = runs[world]["render"]["scenes"][name]
    want, segments = _chunked_frame(name)
    for field, rows in want.items():
        np.testing.assert_array_equal(got[field], rows, err_msg=field)
    assert got["segments"] == segments > 512
    assert len(got["frame_ms"]) == 1


@pytest.mark.parametrize("world", [2, 4])
def test_scene_digest_equal_on_every_rank(runs, world):
    r = runs[world]["render"]
    for name in SCENES:
        digests = r["scenes"][name]["digests"]
        assert len(digests) == world and len(set(digests)) == 1
    assert len(r["cold_start"]) == world


def test_sharded_render_matches_the_jax_sharded_render(runs):
    """World 4 against the reference's shard_map render on 8 devices,
    the same (tile-swizzled) ray ids; the reference given the scene's
    feature set (see `specialized`)."""
    got = runs[4]["render"]["scenes"]["three_balls"]
    js = jexamples.three_balls().build(accel="brute")
    ids = frame_ray_ids(RENDER["width"], RENDER["height"],
                               RENDER["spp"], "cpu")
    with specialized(js):
        fn = jshard.make_sharded_render_fn(js, make_ray_mesh(), **RENDER)
        want = fn(js.tables, js.camera, jnp.asarray(ids.numpy(), jnp.uint32))
    diff = np.abs(_image(got["color"]).astype(np.float64)
                  - _image(np.asarray(want.color)))
    bad = (diff > 2e-3).any(axis=-1)
    assert bad.sum() <= max(1, round(0.002 * bad.size)), diff.max()
    assert got["segments"] == int(want.segments)


# ------------------------------------------------------- the train step

def test_train_step_matches_the_jax_sharded_train_step(runs, assets):
    """World 2's first step against the reference's step on 8 devices,
    both from the port's target."""
    got = runs[2]["train"]
    js = jexamples.earth(assets).build(accel="brute")
    kw = {k: TRAIN[k] for k in ("width", "height", "spp", "max_bounce",
                                "seed", "learning_rate")}
    with specialized(js):
        step = jshard.make_sharded_train_step(js, make_ray_mesh(), **kw)
        total = TRAIN["width"] * TRAIN["height"] * TRAIN["spp"]
        atlas, loss = step(jnp.full(js.tables.atlas.shape, TRAIN["init"]),
                           js.tables, js.camera,
                           jnp.arange(total, dtype=jnp.uint32),
                           jnp.asarray(got["target"]))
    np.testing.assert_allclose(got["atlas_after_first_step"],
                               np.asarray(atlas), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["losses"][0], float(loss), rtol=1e-5)
    assert np.abs(got["atlas_after_first_step"] - TRAIN["init"]).max() > 1e-3


@pytest.mark.parametrize("world", [1, 2])
def test_train_step_loss_falls(runs, world):
    losses = runs[world]["train"]["losses"]
    assert len(losses) == 2 and 0.0 < losses[1] < losses[0], losses
    assert np.isfinite(runs[world]["train"]["atlas_after_first_step"]).all()


def test_train_step_world_2_equals_world_1_to_summation_order(runs):
    one, two = runs[1]["train"], runs[2]["train"]
    np.testing.assert_array_equal(two["target"], one["target"])
    a1 = one["atlas_after_first_step"].astype(np.float64) - TRAIN["init"]
    a2 = two["atlas_after_first_step"].astype(np.float64) - TRAIN["init"]
    assert np.linalg.norm(a2 - a1) <= 1e-5 * np.linalg.norm(a1)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-6)
    assert len(set(two["digests"])) == 1


def test_world_1_step_is_the_plain_sgd_step(runs, assets):
    """With one process the step is exactly: render, squared error summed
    over rays and channels, one backward, atlas - lr * grad / n."""
    got = runs[1]["train"]
    scene = texamples.earth(assets).build(accel="brute", device="cpu")
    kw = {k: TRAIN[k] for k in ("width", "height", "spp", "max_bounce",
                                "seed")}
    total = TRAIN["width"] * TRAIN["height"] * TRAIN["spp"]
    ids = torch.arange(total)
    target = torch.from_numpy(got["target"])
    atlas = torch.full_like(scene.tables.atlas, TRAIN["init"])
    leaf = atlas.clone().requires_grad_(True)
    out = trenderer.render_chunk(
        scene.tables._replace(atlas=leaf), scene.camera, ids,
        intersect_fn=trenderer.make_intersect_fn(scene),
        features=scene.features, **kw)
    loss = torch.sum((out.color - target) ** 2)
    grad, = torch.autograd.grad(loss, [leaf])
    want = atlas - TRAIN["learning_rate"] * grad / target.numel()
    np.testing.assert_array_equal(got["atlas_after_first_step"],
                                  want.numpy())
    assert got["losses"][0] == float(loss.detach() / target.numel())


# ------------------------------------------------- rules and entry points

def test_dryrun_multichip_on_two_cpu_processes(assets):
    """Both legs of the dry run (flagship render, one train step on the
    earth) on two gloo ranks; no bunny.obj in `assets`: one_triangle."""
    got = launch.dryrun_multichip(2, device="cpu", assets_dir=assets,
                                  timeout_s=300)
    assert got["flagship"] == "one_triangle"
    assert got["segments"] >= 64 * 64 and got["loss"] > 0.0


@pytest.mark.parametrize("world", [2, 4])
def test_length_not_dividing_by_the_world_is_refused(world):
    scene = texamples.three_balls().build(accel="brute", device="cpu")
    group = RayGroup(rank=world - 1, world_size=world,
                     device=torch.device("cpu"))
    fn = shard.make_sharded_render_fn(scene, group, **RENDER)
    with pytest.raises(ValueError, match="divide"):
        fn(scene.tables, scene.camera, torch.arange(4 * world + 1))
    last = list(range(4 * (world - 1), 4 * world))
    assert shard.share(torch.arange(4 * world), group).tolist() == last


def test_initialize_does_nothing_without_configuration(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") is None
    assert not torch.distributed.is_initialized()
    assert distributed.is_coordinator()
    group = make_ray_group(device="cpu")
    assert (group.rank, group.world_size, group.process_group) == \
        (0, 1, None)


@pytest.mark.parametrize("device_type,local_world,cards,world,want", [
    ("cuda", 1, 1, None, "nccl"),    # one rank, one card
    ("cuda", 4, 4, None, "nccl"),    # a card for each rank
    ("cuda", 2, 1, None, "gloo"),    # two ranks share the card
    ("cuda", 8, 4, None, "gloo"),
    ("cpu", 4, 0, None, "gloo"),
    ("cuda", 1, 1, 4, "nccl"),       # 4 hosts of one card each
    ("cuda", 8, 8, 16, "nccl"),      # 2 hosts of 8 cards each
    ("cuda", None, 4, 4, "nccl"),    # no local count: the world fits
    ("cuda", None, 1, 4, ValueError),  # one host of 4 or 4 hosts of 1
    ("cpu", None, 0, 4, "gloo"),
])
def test_backend_rule(device_type, local_world, cards, world, want):
    if want is ValueError:
        with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
            distributed.choose_backend(device_type, local_world, cards,
                                       world)
        return
    assert distributed.choose_backend(device_type, local_world, cards,
                                      world) == want


@pytest.mark.parametrize("entry", ["initialize", "make_ray_group", "spawn"])
def test_cuda_raises_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' works")
    calls = {"initialize": lambda: distributed.initialize(world_size=2),
             "make_ray_group": lambda: make_ray_group(),
             "spawn": lambda: launch.spawn(launch.in_turn, 2, [])}
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
    assert not torch.distributed.is_initialized()


def test_morton_argsort_equals_the_jax_binding():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(5000, 3)).astype(np.float32)
    pts[::7] = pts[3]                       # ties keep their order
    got = tnative.morton_argsort(pts)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jnative.morton_argsort(pts))
    assert sorted(got.tolist()) == list(range(5000))


def test_no_module_of_the_port_imports_jax():
    files = [os.path.join(ROOT, f)
             for f in ("chip_smoke.py", "chip_smoke_ranks.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "potato_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    # the port's profilers, which import no reference tool either
    tools = os.path.join(ROOT, "tools")
    ported = sorted(n for n in os.listdir(tools)
                    if n.startswith("torch_") and n.endswith(".py"))
    reference = {n[:-3] for n in os.listdir(tools)
                 if n.endswith(".py") and n not in ported}
    files += [os.path.join(tools, n) for n in ported]
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""] if isinstance(
                node, ast.ImportFrom) else []
            if isinstance(node, ast.ImportFrom) and node.module == "tools":
                mods = ["tools." + a.name for a in node.names]
            bad += [(path, m) for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "potato_tpu")
                    or m in reference
                    or m.split(".")[-1] in reference and m.startswith(
                        "tools.")]
    assert len(ported) >= 6 and len(files) > 36 and not bad, bad
