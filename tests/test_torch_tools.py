"""The port's profilers (tools/torch_*.py) on the CPU, at a tiny size.

Each profiler's `main` runs once per module at 16x16, 1 spp, 2 bounces
(chunks of 2^7 and 2^8, blocks of 128 and 256, groups of 64 and 128,
worlds 1 and 2 under gloo), with device="cpu": the kernel's plain version
stands in for the kernel because the tensors lie on the CPU. The cases
read those runs: one JSON line each, the keys of the report, every gate
held (images bit-equal across chunk sizes under both drivers), the trace
summaries of the ranks. Beside them, on seeded inputs:
- tools/torch_stats_clusters.py's copies of hier_split, cluster_aabbs and
  slab_entered give what tools/stats_clusters.py's give, exactly (the
  same numpy operations);
- the plain version's visits per termination group are bounded by the
  visits of their block (a group stops at the first visit whose entry is
  past its own rays' farthest bound, a block at its rays' farthest);
- the plain version's closest hits do not depend on the block size R.
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from tools import torch_perf_scenes, torch_profile_blocksize
from tools import torch_profile_chunksize, torch_profile_depth
from tools import torch_scaling_harness, torch_stats_clusters

from chip_smoke import write_standin_assets
from potato_tpu_torch.ops import flash
from potato_tpu_torch.scene import examples
from torch_common import chunk_rays     # tools/, on the path from above

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--width", "16", "--height", "16", "--spp", "1"]
DEPTH = ["--max-bounce", "2"]
TOOLS = {
    "chunksize": (torch_profile_chunksize, TINY + DEPTH + [
        "--scenes", "three_balls,bunny", "--chunks", "128,256",
        "--frames", "1"]),
    "depth": (torch_profile_depth, TINY + [
        "--scenes", "glass_bunny", "--depths", "1,2", "--frames", "1"]),
    "blocksize": (torch_profile_blocksize, TINY + DEPTH + [
        "--scenes", "one_triangle", "--blocks", "128,256", "--rays", "256",
        "--frames", "1"]),
    "stats": (torch_stats_clusters, TINY + [
        "--scenes", "one_triangle", "--groups", "64,128", "--rays", "256",
        "--widths", "16,32", "--block-rays", "128,256"]),
    "scaling": (torch_scaling_harness, TINY + DEPTH + [
        "--scenes", "three_balls", "--worlds", "1,2", "--frames", "1",
        "--trace"]),
    "matrix": (torch_perf_scenes, TINY + DEPTH + ["--frames", "1"]),
}
KEYS = {
    "chunksize": ("cells", "workload"),
    "depth": ("cells", "workload"),
    "blocksize": ("cells", "frames", "workload"),
    "stats": ("groups", "entered", "workload"),
    "scaling": ("one_process", "worlds", "efficiency_base_world"),
    "matrix": ("scenes", "workload"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every case on one torch thread (spawned ranks take their share of
    it): the inputs are tiny, and under the other test workers' load a
    pool of every core waits on descheduled threads (in the suite's six
    workers on 8 cores the runs below took 939 s that way, 10 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each profiler's main() once: (exit code, stdout lines)."""
    out = {}
    traces = str(tmp_path_factory.mktemp("traces"))
    for name, (tool, argv) in TOOLS.items():
        if name == "scaling":
            argv = argv + ["--trace-dir", traces]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tool.main(argv)
        out[name] = (rc, buf.getvalue().splitlines())
    return out


@pytest.mark.parametrize("name", list(TOOLS))
def test_main_prints_one_json_line_of_a_cpu_report(runs, name):
    rc, lines = runs[name]
    assert rc == 0 and len(lines) == 1
    rep = json.loads(lines[0])
    assert rep["tool"] == TOOLS[name][0].__name__.split(".")[-1]
    assert rep["device"] == {"type": "cpu", "name": "cpu", "card": None}
    assert rep["ok"] and rep["gates"] and all(g["ok"] for g in rep["gates"])
    assert all(k in rep for k in KEYS[name] + ("launches",))


@pytest.mark.parametrize("scene", ["three_balls", "bunny"])
@pytest.mark.parametrize("driver", ["chunked", "compact"])
def test_images_bit_equal_across_chunk_sizes(runs, scene, driver):
    rep = json.loads(runs["chunksize"][1][0])
    gates = [g for g in rep["gates"]
             if g["name"].startswith(f"{scene}, {driver}:")]
    assert len(gates) == 1 and gates[0]["ok"], gates
    cells = [c for c in rep["cells"]
             if c["scene"] == scene and c["driver"] == driver]
    assert [c["chunk_size"] for c in cells] == [128, 256]
    assert cells[0]["segments"] == cells[1]["segments"]


def test_frame_cells_carry_their_readings(runs):
    rep = json.loads(runs["depth"][1][0])
    keys = {"frame_ms", "best_ms", "segments", "segments_per_s",
            "launches_per_frame", "passes_per_bounce", "peak_mib"}
    for c in rep["cells"]:
        assert keys <= set(c) and c["peak_mib"] is None      # no card
        assert c["passes_per_bounce"][0] == 1     # compact: one chunk
    assert [c["max_bounce"] for c in rep["cells"]] == [1, 2]


def test_scaling_traces_every_rank(runs):
    rep = json.loads(runs["scaling"][1][0])
    one = rep["one_process"]["three_balls"]
    assert set(one["traces"]) == {"chunked driver", "sharded fn, no group"}
    for world in ("1", "2"):
        row = rep["worlds"][world]
        assert row["backend"] == "gloo"
        traces = row["three_balls"]["traces"]
        assert len(traces) == int(world)
        for t in traces:
            assert os.path.exists(t["trace"]) and t["host_ops"] > 0
            assert t["device_busy_share"] is None and t["kernels"] == 0
    assert rep["worlds"]["1"]["three_balls"]["efficiency"] == 1.0


def test_matrix_has_the_reference_fields(runs):
    rep = json.loads(runs["matrix"][1][0])
    assert list(rep["scenes"]) == list(torch_perf_scenes.SCENES)
    fields = {"segments_per_s", "segments_per_frame", "mean_path_length",
              "num_triangles", "num_spheres", "sphere_path", "driver"}
    for name, row in rep["scenes"].items():
        assert fields <= set(row)
        assert row["sphere_path"] == ("kernel" if name.startswith(
            "more_balls") else "dense")


# ---- tools/stats_clusters.py's numpy helpers, copied

def _reference_stats():
    spec = importlib.util.spec_from_file_location(
        "reference_stats_clusters",
        os.path.join(ROOT, "tools", "stats_clusters.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _boxes(rng, n):
    lo = rng.normal(size=(n, 3))
    return lo, lo + rng.uniform(0.01, 0.3, (n, 3))


@pytest.mark.parametrize("fn", ["hier_split", "cluster_aabbs",
                                "slab_entered"])
def test_stats_helpers_equal_the_reference(fn):
    ref = _reference_stats()
    rng = np.random.default_rng(5)
    pmin, pmax = _boxes(rng, 300)
    if fn == "hier_split":
        for leaf in (16, 32):
            np.testing.assert_array_equal(
                torch_stats_clusters.hier_split(pmin, pmax, leaf),
                ref.hier_split(pmin, pmax, leaf))
        return
    order = ref.hier_split(pmin, pmax, 16)
    if fn == "cluster_aabbs":
        for w in (16, 64):
            for a, b in zip(torch_stats_clusters.cluster_aabbs(
                    pmin, pmax, order, w),
                    ref.cluster_aabbs(pmin, pmax, order, w)):
                np.testing.assert_array_equal(a, b)
        return
    cmin, cmax = ref.cluster_aabbs(pmin, pmax, order, 16)
    o = rng.normal(size=(200, 3)).astype(np.float32) * 3
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d[::7, 0] = 0.0                       # axis-parallel: 1/0 and NaN
    tmin = np.full(200, 1e-3, np.float32)
    tmax = np.where(np.arange(200) % 5, 3e38, -1.0).astype(np.float32)
    got = torch_stats_clusters.slab_entered(o, d, tmin, tmax, cmin, cmax)
    np.testing.assert_array_equal(
        got, ref.slab_entered(o, d, tmin, tmax, cmin, cmax))
    assert 0 < got.mean() < 1


# ---- the plain version: visits per group, hits across R

def _stand_in_rays(tmp_path, n=1024):
    write_standin_assets(str(tmp_path))
    scene = examples.bunny(str(tmp_path)).build(accel="flash", device="cpu")
    rays, _ = chunk_rays(scene, width=32, height=32, spp=1, seed=7, n=n,
                         bounce=0)
    return scene, rays


def _plain(scene, inp, block, group):
    v = torch.zeros((inp.packed_rays.shape[1] // group, 3),
                    dtype=torch.int32)
    out = flash.flash_intersect_plain(
        inp.packed_rays, inp.queues, scene.accel.tri_flat,
        scene.accel.sph_feats, block, inp.has_sph, visits=v, group=group)
    return out, v


@pytest.mark.parametrize("group", [64, 128])
def test_group_visits_bounded_by_their_block(tmp_path, group):
    scene, rays = _stand_in_rays(tmp_path)
    inp = flash.prepare_flash(scene.accel, scene.tables, rays, flash.R)
    _, per_block = _plain(scene, inp, flash.R, flash.R)
    _, per_group = _plain(scene, inp, flash.R, group)
    nb = per_block.shape[0]
    grouped = per_group.reshape(nb, flash.R // group, 3)
    assert (grouped <= per_block[:, None, :]).all()
    assert int(per_block[:, 1:].sum()) > 0           # the mesh is visited


def test_plain_hits_equal_across_block_sizes(tmp_path):
    scene, rays = _stand_in_rays(tmp_path)
    hits = {}
    for block in (128, 256, 512, 1024):
        inp = flash.prepare_flash(scene.accel, scene.tables, rays, block)
        (tri_t, tri_slot, _, _), _ = _plain(scene, inp, block, block)
        hits[block] = (tri_t[:inp.b], tri_slot[:inp.b])
    assert bool((hits[512][0] < flash.BIG).any())
    for block, (t, slot) in hits.items():
        assert torch.equal(t, hits[512][0]), block
        assert torch.equal(slot, hits[512][1]), block
