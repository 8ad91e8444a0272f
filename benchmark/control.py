"""The readings that the limits of `correct` are set from:

- sound runs: frame 0 of the run seeds `--first-seed` ... through the
  port's `render()`, each against the reference at the configuration's
  precision (float32);
- the control: the reference computed one precision lower (bfloat16, as
  float32 elementwise work has no TF32 path) in the port's place, against
  the same float32 reference, on the first `--control-seeds` seeds; float16
  beside it for information;
- with `--faults`, each fault of `faults.py` planted in the port's timed
  path, on the same seeds.

    python3 benchmark/control.py --workload <cell> --seeds 12 --control-seeds 3 --faults

prints one JSON line a seed, then a summary line: the largest reading of
each number over the sound runs (`lower`) and the smallest over the
control (`upper`). Every reading is judged against the cell's committed
limits (`limits/<cell>.json`) where they exist: `passes` in a seed's line,
and in the summary whether the sound runs all passed and whether the
control and each fault failed on every seed. Run on the card; `--device
cpu` is for tests.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import compare, faults, harness  # noqa: E402
from benchmark.reference import pathtracer  # noqa: E402

CONTROLS = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def readings(cell, seeds, control_seeds, device="cuda", bench=harness.BENCH,
             with_faults=False):
    """Yields one row a seed, then the summary row."""
    dev = torch.device(device)
    limits_path = os.path.join(bench, "limits", cell + ".json")
    limits = harness.load_json(limits_path) \
        if os.path.exists(limits_path) else None
    run = harness.build_run(cell, 0, dev, bench)
    t = run.traffic
    run.render_frame(-1)
    frames = []
    planted = {}
    for k, s in enumerate(seeds):
        run.seed = s
        t0 = time.perf_counter()
        out = run.render_frame(0)
        run.sync()
        frames.append((s, harness.frame_seed(s, 0), out,
                       time.perf_counter() - t0))
        if with_faults and k < control_seeds:
            for name in faults.FAULTS:
                with faults.planted(name):
                    planted[name, s] = run.render_frame(0)
    records = run.records
    del run
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    size = (t["width"], t["height"], t["spp"], t["max_bounce"])
    ref32 = pathtracer.scene_tables(records, dev)
    lower = {}
    upper = {}
    verdicts = {}             # reading -> [passed?] over the seeds read
    for k, (s, fs, out, render_s) in enumerate(frames):
        t0 = time.perf_counter()
        want = pathtracer.render(ref32, *size, fs)
        row = {"seed": s, "frame_seed": fs, "render_s": render_s,
               "reference_s": time.perf_counter() - t0,
               "program": compare.frame_numbers(out, want)}
        for n, v in row["program"].items():
            lower[n] = max(lower.get(n, 0.0), v)
        if k < control_seeds:
            for name, dtype in CONTROLS.items():
                low = pathtracer.render(
                    pathtracer.scene_tables(records, dev, dtype), *size, fs)
                row[name] = compare.frame_numbers(low, want)
                if name == "bfloat16":
                    for n, v in row[name].items():
                        upper[n] = min(upper.get(n, float("inf")), v)
            for name in faults.FAULTS:
                if (name, s) in planted:
                    row[name] = compare.frame_numbers(planted[name, s], want)
        if limits is not None:
            row["passes"] = {}
            for name in ["program", *CONTROLS, *faults.FAULTS]:
                if name in row:
                    ok = compare.judge(row[name], limits)[0]
                    row["passes"][name] = ok
                    verdicts.setdefault(name, []).append(ok)
        yield row
    yield {"summary": cell, "seeds": len(frames),
           "control_seeds": min(control_seeds, len(frames)),
           "lower": lower, "upper": upper,
           "sound_runs_all_pass": all(verdicts.get("program", [False])),
           "caught_on_every_seed": {n: not any(v) for n, v in verdicts.items()
                                    if n != "program"}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    for row in readings(args.workload, seeds, args.control_seeds,
                        args.device, with_faults=args.faults):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
