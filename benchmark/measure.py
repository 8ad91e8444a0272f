"""Frozen copies of the port's sound measurement arithmetic (from
chip_smoke.py and chip_smoke_ranks.py), so that the yardstick stays with
the benchmark: host syncs by torch's sync debug mode, a launch's device
time behind a spinning kernel, the flash kernel's least time (pairs tested
and pairs that can hit, over the published float32 and memory peaks), and
the summary of a profiler trace (busy share, idle gaps, top device ops).
`tests/test_bench_harness.py` holds each against its original.
"""

from __future__ import annotations

import time
import warnings
from collections import defaultdict

import torch

# Published peaks of one H100 SXM (data sheet, 700 W): float32 outside the
# tensor cores, and device memory.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Operations of one pair test: every pair pays the head, a pair that can
# hit also the tail (triangle: edge values, det, sign test | divide, plane
# term, range test, minimum; sphere: d.c, half_b, c, delta | root, two t,
# range tests, minimum).
FLOPS_TRI_HEAD, FLOPS_TRI_TAIL = 42, 11
FLOPS_SPH_HEAD, FLOPS_SPH_TAIL = 18, 10
# The yardstick of the kernel's first design: every pair at the
# granularity of a whole block, at the full cost of its test.
FIRST_FLOPS_PER_TRI_PAIR = 50
FIRST_FLOPS_PER_SPH_PAIR = 30

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP_OPS, IDLE_GAPS = 10, 5


def event(device="cuda"):
    """A mark on the device's timeline (the host clock off the card)."""
    if torch.device(device).type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def elapsed_ms(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


def count_syncs(fn) -> int:
    """Host-device synchronisations while fn() runs, as torch's sync debug
    mode reports them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def device_ms(launch, reps=20) -> float:
    """Device time of one `launch()`: `reps` of them queued behind a
    spinning kernel, so the card never waits for the host between them."""
    launch()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    a = event()
    for _ in range(reps):
        launch()
    b = event()
    torch.cuda.synchronize()
    return elapsed_ms(a, b) / reps


def pairs_tested(visits, group, W, K) -> dict:
    """Pair tests behind per-group visit counts (sphere clusters, children,
    tail parents): rays of a group x rows it visited, summed."""
    sph, children, tail = (int(x) for x in visits.sum(0))
    return {"tri": group * (children * W + tail * K),
            "sph": group * sph * K}


def kernel_bound_ms(tri_flat, sph_feats, inp, visits, can_hit, visits_block,
                    group, block, W, K) -> dict:
    """The least time the card could take for one launch: the operations of
    the pair tests its queues need over the float32 peak, against every
    input read once and every output written once over the memory rate.
    `visits` and `can_hit` are taken at the kernel's termination group
    `group`; `visits_block` at the whole block, for the first design's
    yardstick `first_ms`. W and K are the queue design's child and parent
    cluster sizes."""
    pairs = pairs_tested(visits, group, W, K)
    hit_sph, hit_tri = (int(x) for x in can_hit.sum(0))
    flops = (pairs["tri"] * FLOPS_TRI_HEAD + hit_tri * FLOPS_TRI_TAIL
             + pairs["sph"] * FLOPS_SPH_HEAD + hit_sph * FLOPS_SPH_TAIL)
    at_block = pairs_tested(visits_block, block, W, K)
    first_flops = (at_block["tri"] * FIRST_FLOPS_PER_TRI_PAIR
                   + at_block["sph"] * FIRST_FLOPS_PER_SPH_PAIR)
    bp = inp.packed_rays.shape[1]
    nbytes = inp.packed_rays.numel() * 4 + bp * 16
    nbytes += sum(t.numel() * t.element_size() for t in inp.queues)
    nbytes += tri_flat.numel() * 4
    if inp.has_sph:
        nbytes += sph_feats.numel() * 4
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"ms": max(t_ops, t_bytes), "ops_ms": t_ops, "bytes_ms": t_bytes,
            "pairs": pairs, "can_hit": {"tri": hit_tri, "sph": hit_sph},
            "first_ms": max(first_flops / PEAK_F32_FLOPS * 1e3, t_bytes),
            "pairs_at_block": at_block}


def _merged(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def trace_summary(events, wall_ms: float, top_ops: int = TOP_OPS,
                  idle_gaps: int = IDLE_GAPS) -> dict:
    """What one traced call did on the card and where the card waited.

    `events` are complete events (microseconds) with a Chrome trace's
    `ph`, `cat`, `name`, `ts` and `dur`. The card's work is its kernels,
    copies and fills; busy is their union over `wall_ms`. An idle gap is a
    span between two stretches of device work; its host operation is the
    innermost host op (or runtime call) in flight at the gap's middle."""
    spans = [e for e in events if e.get("ph") == "X"]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    host = [e for e in spans if e.get("cat") in ("cpu_op", "cuda_runtime")]
    busy = _merged((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy_us = sum(b - a for a, b in busy)
    idle = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:idle_gaps]

    def in_flight(t):
        around = [e for e in host if e["ts"] <= t <= e["ts"] + e["dur"]]
        return max(around, key=lambda e: e["ts"])["name"] if around else None

    by_name = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
    runtime = [e["name"] for e in spans if e.get("cat") == "cuda_runtime"]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3 if device else None,
        "device_busy_share": busy_us / 1e3 / wall_ms if device else None,
        "kernels": sum(e["cat"] == "kernel" for e in device),
        "host_syncs": sum(n in SYNC_CALLS for n in runtime),
        "dtoh_copies": sum(e["cat"] == "gpu_memcpy" and "DtoH" in e["name"]
                           for e in device),
        "host_ops": sum(e["cat"] == "cpu_op" for e in host),
        "idle_gaps": [{"ms": g / 1e3, "host_op": in_flight((a + b) / 2)}
                      for g, a, b in idle],
        "top_device_ops": [
            {"name": n[:120], "ms": us / 1e3, "count": c}
            for n, (us, c) in sorted(by_name.items(),
                                     key=lambda kv: -kv[1][0])[:top_ops]],
    }
