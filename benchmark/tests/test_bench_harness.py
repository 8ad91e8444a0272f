"""The harness on the CPU: what it may import, that it takes a new
configuration, cell and metric from files alone, that its frozen
measurement code answers as the originals do, and that a broken timed path
makes `correct` false."""

from __future__ import annotations

import ast
import hashlib
import inspect
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import faults, measure
from benchmark.tests import tinycell

ROOT = tinycell.ROOT
BENCH = os.path.join(ROOT, "benchmark")
SEED = 2 ** 31 + 101


def python_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(python_files(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_benchmark_module_imports_jax_or_the_jax_package(path):
    found = set(top_level_imports(path)) & {"jax", "jaxlib", "flax",
                                            "potato_tpu"}
    assert not found, found


@pytest.mark.parametrize("path", sorted(python_files(
    os.path.join(BENCH, "reference"))), ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    allowed = {"__future__", "math", "dataclasses", "typing", "numpy",
               "torch"}
    assert set(top_level_imports(path)) <= allowed


def run_in_copy(root, code):
    """`code` in a fresh interpreter whose `benchmark` is the copy's."""
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def digests(root):
    return {os.path.relpath(p, root): hashlib.sha256(open(p, "rb").read())
            .hexdigest() for p in python_files(os.path.join(root, "benchmark"))}


def test_new_config_cell_and_metric_are_files_and_entries_only(tmp_path):
    root = tinycell.make(tmp_path)
    before = digests(root)
    tinycell.write(root, "benchmark/configs/few_balls.json", {
        "name": "few_balls", "source": "a smaller grid of more_balls",
        "builder": "more_balls_grid", "layout_seed": 7, "grid_min": -3,
        "grid_max": 3, "reduced": ["grid_min", "grid_max"]})
    tinycell.write(root, "benchmark/metrics/window.frames.py", textwrap.dedent(
        '''
        """Frames the window rendered."""


        def read(run):
            return len(run.window.frames)
        '''))
    tinycell.write(root, "benchmark/limits/few_balls.tiny.json",
                   tinycell.LIMITS)
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["configs"].append({"name": "few_balls", "source": "-",
                            "file": "benchmark/configs/few_balls.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "few_balls.tiny", "config": "few_balls",
                              "traffic": "tiny", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "window.frames", "unit": "frames",
                              "better": "higher", "source": "host_clock",
                              "layer": "frame driver",
                              "moves": "segments_per_s",
                              "workloads": ["few_balls.tiny"]})
    tinycell.write(root, "BENCHMARK.json", spec)
    got = run_in_copy(root, f"""
        import json
        from benchmark import harness
        r = harness.run_cell("few_balls.tiny", {SEED}, 0.5, True, "cpu")
        print(json.dumps(r))
        """)
    after = digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert got["correct"] is True, got
    assert got["metrics"]["window.frames"]["value"] == got["attempted"] >= 1
    assert list(got)[-1] == "checks"


@pytest.mark.parametrize("trace", [0, 1])
def test_harness_runs_each_configuration_on_the_cpu(tmp_path, trace):
    root = tinycell.make(tmp_path)
    got = run_in_copy(root, f"""
        import json
        from benchmark import harness
        out = {{}}
        spec = harness.load_json("BENCHMARK.json")
        for cell in [c["name"] + ".tiny" for c in spec["configs"]]:
            out[cell] = harness.run_cell(cell, {SEED}, 0.3, {bool(trace)}, "cpu")
        print(json.dumps(out))
        """)
    for cell, r in got.items():
        assert r["correct"] is True, (cell, r)
        assert r["failed"] == 0 and r["attempted"] >= 1
        if trace:
            assert "window_s" in r["device"] and "breakdown" in r
        else:
            assert set(r["metrics"]) == {"segments_per_s", "setup_s"}


# ---- a broken timed path makes `correct` false

@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_broken_timed_path_is_not_correct(tmp_path, fault):
    from benchmark import harness

    root = tinycell.make(tmp_path)
    with faults.planted(fault):
        got = harness.run_cell("more_balls.tiny", SEED, 0.2, False, "cpu",
                               bench=os.path.join(root, "benchmark"))
    assert got["correct"] is False, got
    assert got["failed"] == 0      # the frames are wrong, not failed


def test_planted_fault_is_taken_out_again():
    from potato_tpu_torch.render import compact, integrator, renderer

    before = (renderer._to_host, renderer._frame_fn,
              integrator.make_bounce_step, compact.make_bounce_step)
    for fault in faults.FAULTS:
        with faults.planted(fault):
            pass
    assert (renderer._to_host, renderer._frame_fn,
            integrator.make_bounce_step, compact.make_bounce_step) == before


# ---- the frozen measurement code answers as the originals

def _body(fn):
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    body = tree.body[0].body
    if isinstance(body[0], ast.Expr) and isinstance(body[0].value,
                                                    ast.Constant):
        body = body[1:]
    return [ast.dump(node) for node in body]


@pytest.mark.parametrize("name", ["count_syncs", "device_ms", "_merged",
                                  "event", "elapsed_ms"])
def test_frozen_copy_has_the_originals_body(name):
    """The card-only copies (a CPU build has no sync debug mode and no
    CUDA events) are held to the original's code, statement by statement."""
    import chip_smoke
    import chip_smoke_ranks

    original = getattr(chip_smoke, name, None) or getattr(chip_smoke_ranks,
                                                          name)
    assert _body(getattr(measure, name)) == _body(original)


def synthetic_events(seed):
    rng = np.random.default_rng(seed)
    events, t = [], 0.0
    for k in range(400):
        t += float(rng.uniform(0, 30))
        cat = ["kernel", "gpu_memcpy", "gpu_memset", "cpu_op",
               "cuda_runtime", "python_function"][k % 6]
        name = {"kernel": f"k{k % 7}", "gpu_memcpy": "Memcpy DtoH",
                "gpu_memset": "Memset", "cpu_op": f"aten::op{k % 5}",
                "cuda_runtime": ["cudaLaunchKernel", "cudaStreamSynchronize",
                                 "cudaEventSynchronize"][k % 3],
                "python_function": "f"}[cat]
        events.append({"ph": "X", "cat": cat, "name": name, "ts": t,
                       "dur": float(rng.uniform(0, 80))})
    events.append({"ph": "i", "cat": "kernel", "name": "instant", "ts": 5.0})
    return events


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frozen_trace_summary_answers_as_the_original(seed):
    from chip_smoke_ranks import trace_summary

    events = synthetic_events(seed)
    assert measure.trace_summary(events, 12.5) == trace_summary(events, 12.5)
    wide = measure.trace_summary(events, 12.5, top_ops=10, idle_gaps=10)
    assert len(wide["idle_gaps"]) == 10
    assert wide["idle_gaps"][:5] == trace_summary(events, 12.5)["idle_gaps"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frozen_kernel_bound_answers_as_the_original(seed):
    import chip_smoke
    from potato_tpu_torch.ops import flash

    g = torch.Generator().manual_seed(seed)
    group, block = flash.resolve_group(flash.R), flash.R
    nb = 6
    bp = nb * block

    def ints(*shape, hi=50):
        return torch.randint(0, hi, shape, generator=g, dtype=torch.int32)

    queues = flash.BlockQueues(ints(nb), ints(nb), ints(nb), ints(nb, 16),
                               torch.rand(nb, 2, generator=g), ints(nb, 3),
                               torch.rand(nb, 3, generator=g), ints(nb, 4),
                               torch.rand(nb, 4, generator=g))
    inp = SimpleNamespace(packed_rays=torch.rand(8, bp, generator=g),
                          queues=queues, has_sph=bool(seed % 2))
    accel = SimpleNamespace(tri_flat=torch.rand(flash.K * 3 + flash.W, 32),
                            sph_feats=torch.rand(flash.K * 2, 8))
    visits = ints(bp // group, 3)
    can_hit = ints(bp // group, 2, hi=1000).long()
    visits_block = ints(bp // block, 3)
    want = chip_smoke.kernel_bound_ms(SimpleNamespace(accel=accel), inp,
                                      visits, can_hit, visits_block)
    got = measure.kernel_bound_ms(accel.tri_flat, accel.sph_feats, inp,
                                  visits, can_hit, visits_block, group,
                                  block, flash.W, flash.K)
    assert got == want
    assert measure.pairs_tested(visits, group, flash.W, flash.K) == \
        chip_smoke.pairs_tested(visits, group)
