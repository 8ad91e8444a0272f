"""potato_tpu_torch.scene against potato_tpu.scene: the port's own build of
the asset-free example scenes gives the same tables, feature sets and
flash acceleration structure, exactly (both builds are host numpy; nothing
is computed in float on a device)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from potato_tpu.scene import examples as jexamples

from potato_tpu_torch.render import renderer as trenderer
from potato_tpu_torch.scene import examples as texamples
from potato_tpu_torch.scene import tables as ttables
from potato_tpu_torch.scene.description import (
    Absorb, Emit, Material, Scatter, SceneBuilder, Texture,
)

SCENES = ["three_balls", "more_balls", "two_balls", "one_triangle"]
_cache = {}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every case on one torch thread, restored after the file: the inputs
    are small, and under the suite's other test workers a pool of every
    core waits on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(name):
    """(JAX CompiledScene, port CompiledScene), flash accel, built once."""
    if name not in _cache:
        _cache[name] = (
            jexamples.SCENES[name]().build(accel="flash"),
            texamples.SCENES[name]().build(accel="flash", device="cpu"))
    return _cache[name]


def _tensor_fields(record):
    return [f for f in record._fields
            if isinstance(getattr(record, f), torch.Tensor)]


def _assert_records_equal(jrec, trec):
    names = _tensor_fields(trec)
    assert names
    for f in names:
        want = np.asarray(getattr(jrec, f))
        got = getattr(trec, f).numpy()
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        assert got.shape == want.shape, (f, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f)


def port_scene_from_jax(jscene, device="cpu"):
    """The port's CompiledScene over a JAX-built scene's own arrays."""
    def arrays(record):
        return {f: np.asarray(getattr(record, f)) for f in record._fields
                if not isinstance(getattr(record, f), int)}

    accel = arrays(jscene.accel) if jscene.accel is not None else None
    return ttables.scene_from_numpy(
        arrays(jscene.tables), arrays(jscene.camera), accel,
        ttables.SceneFeatures(*jscene.features),
        (jscene.num_spheres, jscene.num_triangles), device=device)


@pytest.mark.parametrize("name", SCENES)
def test_scene_tables_equal_jax_build(name):
    js, ts = _pair(name)
    _assert_records_equal(js.tables, ts.tables)
    _assert_records_equal(js.camera, ts.camera)
    assert (js.num_spheres, js.num_triangles) == \
        (ts.num_spheres, ts.num_triangles)


@pytest.mark.parametrize("name", SCENES)
def test_flash_accel_equals_jax_build(name):
    js, ts = _pair(name)
    _assert_records_equal(js.accel, ts.accel)
    assert (js.accel.num_triangles, js.accel.num_spheres) == \
        (ts.accel.num_triangles, ts.accel.num_spheres)
    # the kernel's wrapper takes these as they are
    assert ts.accel.tri_flat.is_contiguous()
    assert ts.accel.sph_feats.is_contiguous()


@pytest.mark.parametrize("name", SCENES)
def test_scene_features_equal_jax_build(name):
    js, ts = _pair(name)
    assert tuple(js.features) == tuple(ts.features)
    assert trenderer.default_driver(ts) == \
        ("compact" if name in ("three_balls", "more_balls") else "chunked")


@pytest.mark.parametrize("name", ["three_balls", "one_triangle"])
def test_scene_from_numpy_round_trip(name):
    js, ts = _pair(name)
    rt = port_scene_from_jax(js)
    for rec_a, rec_b in ((rt.tables, ts.tables), (rt.camera, ts.camera),
                         (rt.accel, ts.accel)):
        for f in _tensor_fields(rec_b):
            assert torch.equal(getattr(rec_a, f), getattr(rec_b, f)), f
    assert rt.features == ts.features
    a = trenderer.render(rt, 16, 16, spp=1, max_bounce=3, seed=3,
                         driver="chunked", device="cpu")
    b = trenderer.render(ts, 16, 16, spp=1, max_bounce=3, seed=3,
                         driver="chunked", device="cpu")
    np.testing.assert_array_equal(a.color, b.color)
    assert a.segments == b.segments


def test_scene_from_numpy_names_missing_fields():
    js, _ = _pair("three_balls")
    tables = {f: np.asarray(getattr(js.tables, f))
              for f in js.tables._fields if f != "atlas"}
    with pytest.raises(KeyError, match="atlas"):
        ttables.scene_from_numpy(tables, {}, None, ttables.all_features(),
                                 (4, 0), device="cpu")


def test_import_and_cpu_render_leave_jax_out():
    """The port must not import jax or the JAX package, even indirectly."""
    code = (
        "import sys\n"
        "import potato_tpu_torch\n"
        "from potato_tpu_torch.scene import examples\n"
        "from potato_tpu_torch.render.renderer import render\n"
        "s = examples.one_triangle().build(accel='flash', device='cpu')\n"
        "out = render(s, 16, 8, spp=1, max_bounce=2, driver='chunked',"
        " device='cpu')\n"
        "assert out.color.shape == (8, 16, 3)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'potato_tpu'"
        " or m.startswith('potato_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("clean")


@pytest.mark.parametrize("entry", ["build", "compile_scene", "render",
                                   "compile_frame"])
def test_entry_points_default_to_the_card_and_raise_without_one(entry):
    """device defaults to "cuda": with no card an entry point raises, it
    does not quietly run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, ts = _pair("one_triangle")
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "build":
            texamples.one_triangle().build(accel="flash")
        elif entry == "compile_scene":
            ttables.compile_scene(texamples.one_triangle())
        elif entry == "render":
            trenderer.render(ts, 16, 8, spp=1, driver="chunked")
        else:
            trenderer.compile_frame(ts, 16, 8, spp=1, driver="chunked")


@pytest.mark.parametrize("accel", ["dense", "cluster", "pallas"])
def test_reference_accel_names_build_their_accel(accel):
    """Every accel name the reference takes builds here: dense and cluster
    their structures (tests/test_torch_accels.py holds them), and "pallas",
    the reference's name for its kernel's path, the flash accel, as
    potato_tpu/scene/tables.py maps it: its image is flash's, bit for bit."""
    from potato_tpu_torch.ops.dense import DenseAccel
    from potato_tpu_torch.ops.flash import FlashAccel
    from potato_tpu_torch.scene.bvh import ClusterAccel

    ts = texamples.three_balls().build(accel=accel, device="cpu")
    want = {"dense": DenseAccel, "cluster": ClusterAccel,
            "pallas": FlashAccel}[accel]
    assert isinstance(ts.accel, want)
    if accel == "pallas":
        _, flash = _pair("three_balls")
        got = trenderer.render(ts, 16, 8, spp=1, device="cpu")
        ref = trenderer.render(flash, 16, 8, spp=1, device="cpu")
        np.testing.assert_array_equal(got.color, ref.color)
        np.testing.assert_array_equal(got.segments, ref.segments)


@pytest.mark.parametrize("accel", ["flash", "dense", "cluster"])
def test_accel_builders_default_to_the_card(accel):
    """Called without `device`, each accel builder asks for the card: it
    raises without one and builds there with one."""
    from potato_tpu_torch.ops.dense import build_dense_accel
    from potato_tpu_torch.ops.flash import build_flash_accel
    from potato_tpu_torch.scene.bvh import build_cluster_accel

    ts = texamples.three_balls().build(accel="brute", device="cpu")
    tab = type(ts.tables)(*(a.numpy() for a in ts.tables))
    ns, ntr = ts.num_spheres, ts.num_triangles
    tri = {k: getattr(tab, "tri_" + k)[:ntr]
           for k in ("pa", "pb", "pc", "na", "nb", "nc", "ua", "ub", "uc")}
    tri["mat"] = tab.tri_material[:ntr]
    calls = {
        "flash": lambda: build_flash_accel(tab, ns, ntr),
        "dense": lambda: build_dense_accel(tab, ns, ntr),
        "cluster": lambda: build_cluster_accel(
            tab.s_center[:ns], tab.s_radius[:ns], tab.s_material[:ns], tri),
    }
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            calls[accel]()
        return
    built = calls[accel]()
    tensors = [a for a in built if isinstance(a, torch.Tensor)]
    assert tensors and all(a.device.type == "cuda" for a in tensors)


def test_compact_driver_says_it_is_not_ported():
    """The compact driver is ported now (tests/test_torch_compact.py holds
    it): the default and the named driver render the chunked image, and a
    driver that does not exist is refused."""
    _, ts = _pair("three_balls")     # a dielectric: default is "compact"
    want = trenderer.render(ts, 16, 8, spp=1, driver="chunked", device="cpu")
    for driver in (None, "compact"):
        got = trenderer.render(ts, 16, 8, spp=1, driver=driver, device="cpu")
        np.testing.assert_array_equal(got.color, want.color)
    with pytest.raises(ValueError, match="unknown driver"):
        trenderer.render(ts, 16, 8, spp=1, driver="wavefront", device="cpu")


@pytest.mark.parametrize("name", ["earth", "bunny", "glass_bunny"])
def test_asset_scenes_fail_like_the_reference_without_assets(name, tmp_path):
    with pytest.raises(FileNotFoundError):
        jexamples.SCENES[name](str(tmp_path))
    with pytest.raises(FileNotFoundError):
        texamples.SCENES[name](str(tmp_path))


def test_checker_cycle_is_a_build_error():
    s = SceneBuilder()
    s.add_texture(Texture.checker(1, 1))
    s.add_texture(Texture.checker(0, 0))
    s.add_material(Material(Scatter.lambert(), Absorb.albedo_map(0),
                            Emit.none()))
    s.add_sphere((0, 0, 0), 1.0, 0)
    with pytest.raises(ValueError, match="cycle"):
        s.build(accel="brute", device="cpu")
