"""A copy of the benchmark in a temporary directory with a tiny cell of
each configuration (and, on request, files a later change would add), for
running the harness on the CPU."""

from __future__ import annotations

import json
import os
import shutil

from benchmark import compare

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = {"loop": "closed", "width": 32, "height": 16, "spp": 2,
        "max_bounce": 3, "check_frames": 2, "trace_frames": 2,
        "why": "a frame small enough for the CPU"}
LIMITS = {n: {"limit": 2.0} for n in compare.NAMES}


def make(tmp) -> str:
    """Returns the copy's root; its cells `<config>.tiny` run on the CPU."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    os.symlink(os.path.join(ROOT, "potato_tpu_torch"),
               os.path.join(root, "potato_tpu_torch"))
    write(root, "benchmark/traffic/tiny.json", TINY)
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    for c in spec["configs"]:
        name = c["name"] + ".tiny"
        spec["workloads"].append({"name": name, "config": c["name"],
                                  "traffic": "tiny", "chips": 1,
                                  "why": "tiny"})
        write(root, f"benchmark/limits/{name}.json", LIMITS)
    write(root, "BENCHMARK.json", spec)
    return root


def write(root, rel, obj):
    with open(os.path.join(root, rel), "w") as f:
        if isinstance(obj, str):
            f.write(obj)
        else:
            json.dump(obj, f, indent=1)
