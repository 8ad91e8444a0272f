#!/usr/bin/env python3
"""Quickest proof that potato_tpu_torch still starts on the GPU.

    python3 chip_smoke.py                 # everything below, one card
    python3 chip_smoke.py --kernel-only   # phases 1-3, then stop (no verdict)
    python3 chip_smoke.py --profile       # also trace one chunk per scene
                                          # after phase 4

1. needs a CUDA card: exits non-zero at once without one;
2. builds the CUDA kernel from potato_tpu_torch/csrc with nvcc;
3. holds the kernel against its plain PyTorch version (results and visit
   counts, at the default termination group and at every measured one),
   and the whole intersector against brute force, on the card, on three
   inputs;
4. renders more_balls and a bunny stand-in (the bunny scene with a
   5 120-triangle icosphere as its mesh, written as bunny.obj and read back
   by the OBJ loader) at 800x600, 4 spp, 8 bounces through the entry points
   a user calls with the chunked driver, checks the images, counts the
   kernel's launches, times whole frames and the share of each phase, and
   compares a small frame rendered through the kernel with one rendered
   through the plain version;
5. renders more_balls, a glass stand-in (glass_bunny with the icosphere as
   bunny_flat.obj) and the bunny stand-in through render() with each
   scene's default driver, holds the compact image against the chunked one
   bit for bit, times both drivers in turns (ms, segments/s, launches and
   host syncs a frame, passes a bounce), runs the CLI in-process (render to
   a TGA file held against srgb(), bench, --metrics) and resumes a cut
   checkpoint, counting the kernel's launches on its own;
6. drives the differentiable path at 800x600, 2 spp, 4 bounces through the
   kernel: optimize_textures on the earth scene (a procedural 1024x512
   earthmap.tga written from the seed, the atlas fitted from a constant
   0.5 start, 3 Adam steps) and on more_balls (albedos and scatter
   parameters from 0.8 x the albedos, 2 steps), gating finite gradients,
   falling losses and the gradients the fields must have; times forward
   and backward apart, counts chunks and launches a step and the peak
   memory; and holds the gradient through the kernel against the gradient
   through the plain version at 64x64 on three_balls and the bunny
   stand-in;
7. holds the dense and cluster accelerators against brute force on
   more_balls and the bunny stand-in (camera and incoherent rays), the
   pool driver against the chunked one bit for bit, and times a frame of
   dense, cluster and pool on each of the three scenes (a frame that would
   not fit the run's time is cut in size, and the cut is printed);
8. scales out (potato_tpu_torch/parallel/): renders more_balls and the
   bunny stand-in at 800x600, 4 spp, 8 bounces sharded over 1 process
   (nccl), 2 and 4 processes (gloo) on this card, each frame bit for bit
   against the chunked driver's frame in this process (same ray ids), with
   equal scene digests on every rank, ms/frame, segments/s, each rank's
   kernel launches and cold start; the sharded SGD step on the earth
   stand-in at 800x600, 2 spp, 4 bounces on 1 and 2 processes (world 1
   bit-equal to the step written out in this process, world 2 to float32
   summation order, the loss falling); and dryrun_multichip(2). The
   ranks run the functions of chip_smoke_ranks.py, beside this script;
9. runs each profiler of tools/ (tools/torch_*.py: chunk size, depth,
   block size, visit statistics, scaling with a trace of each rank, the
   per-scene matrix) in a quick form on this card, with at least one cell
   of each at the full frame, every gate of theirs enforced; the full
   reports go to chiprun_out/profilers/ and the traces to
   chiprun_out/traces/;
10. prints one JSON line describing every kernel, then a verdict line.

Any failed gate raises, so the run ends non-zero with no verdict line.
The script imports only the port (torch, numpy) and chip_smoke_ranks.py:
nothing of JAX.
"""

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from functools import partial

import numpy as np
import torch

from potato_tpu_torch import cli
from potato_tpu_torch.core.types import RayBatch
from potato_tpu_torch.diff import optimize
from potato_tpu_torch.io import obj, tga
from potato_tpu_torch.ops import flash
from potato_tpu_torch.ops.dense import intersect_dense
from potato_tpu_torch.ops.intersect import intersect_brute_force
from potato_tpu_torch.ops.traverse import intersect_clustered
from potato_tpu_torch.parallel import launch, make_ray_group
from potato_tpu_torch.parallel import make_sharded_render_fn
from potato_tpu_torch.render import renderer, wavefront
from potato_tpu_torch.render.camera import generate_rays
from potato_tpu_torch.render.integrator import init_state, make_bounce_step
from potato_tpu_torch.scene import examples
from potato_tpu_torch.scene import description as desc
from potato_tpu_torch.scene.description import MeshData
from potato_tpu_torch.utils import metrics as metrics_mod

from chip_smoke_ranks import elapsed_ms, event, sync
from chip_smoke_ranks import frame_ray_ids, measure_render, measure_train_step

WIDTH, HEIGHT, SPP, BOUNCES = 800, 600, 4, 8
SEED = 7
CHUNK = renderer.DEFAULT_CHUNK

# Published peaks of one H100 SXM: float32 outside the tensor cores, and
# device memory. The bound below is stated against these.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Operations of one pair test as the plain version writes it (one per add,
# multiply, compare, divide and root). Every pair pays the head; only a
# pair that can hit (the plain version's `can_hit`) needs the tail.
#   triangle head: three edge values of 11, det 2, sign test 6, det != 0 1
#   triangle tail: divide 1, plane term 7, range test 2, minimum 1
#   sphere head:   d.c 5, half_b 1, c 8, delta 3, delta > 0 1
#   sphere tail:   root 1, two t 4, range tests 4, minimum 1
FLOPS_TRI_HEAD, FLOPS_TRI_TAIL = 42, 11
FLOPS_SPH_HEAD, FLOPS_SPH_TAIL = 18, 10
# The yardstick the kernel's first design was held to: every pair at the
# granularity of a whole block, with divide or root and range test each.
FIRST_FLOPS_PER_TRI_PAIR = 50
FIRST_FLOPS_PER_SPH_PAIR = 30
REPLACES = "potato_tpu/ops/flash.py:1031"
KERNEL_SOURCE = "potato_tpu_torch/csrc/flash_intersect.cu"


def say(*parts):
    print(*parts, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def gate(name, reading, ok, limit):
    say(f"  gate {name}: {reading} (limit {limit}) {'ok' if ok else 'MISSED'}")
    if not ok:
        raise SystemExit(f"chip_smoke: gate missed: {name} = {reading}, "
                         f"limit {limit}")


# ------------------------------------------------------------------ scenes

def icosphere(subdivisions=4, radius=0.5, center=(0.0, 0.5, 0.0)) -> MeshData:
    """A subdivided icosahedron (20 * 4^n triangles) with smooth normals."""
    p = (1.0 + 5.0 ** 0.5) / 2.0
    verts = [(-1, p, 0), (1, p, 0), (-1, -p, 0), (1, -p, 0), (0, -1, p),
             (0, 1, p), (0, -1, -p), (0, 1, -p), (p, 0, -1), (p, 0, 1),
             (-p, 0, -1), (-p, 0, 1)]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdivisions):
        mid = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mid[key] = len(verts) - 1
            return mid[key]

        split = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            split += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = split
    normals = np.asarray(verts, np.float32)
    uvs = np.stack([0.5 + np.arctan2(normals[:, 2], normals[:, 0])
                    / (2 * np.pi), 0.5 + np.arcsin(normals[:, 1]) / np.pi],
                   axis=-1).astype(np.float32)
    return MeshData(
        positions=(normals * radius + np.asarray(center, np.float32))
        .astype(np.float32),
        normals=normals, uvs=uvs, indices=np.asarray(faces, np.int32))


def write_standin_assets(directory) -> MeshData:
    """The icosphere as `v//vn` OBJ files named as the bunny scenes' meshes
    (bunny.obj, bunny_flat.obj) in `directory`, every float written so that
    it reads back exactly. Returns the icosphere."""
    mesh = icosphere()
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in mesh.positions]
    lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in mesh.normals]
    lines += [f"f {a + 1}//{a + 1} {b + 1}//{b + 1} {c + 1}//{c + 1}"
              for a, b, c in mesh.indices]
    for name in ("bunny.obj", "bunny_flat.obj"):
        with open(os.path.join(directory, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    return mesh


def check_loaded_mesh(name, path, mesh):
    """The OBJ loader's mesh has the icosphere's triangles, corner for
    corner (the loader numbers vertices in order of first use)."""
    loaded = obj.load(path)
    same = loaded.num_triangles == mesh.num_triangles and all(
        np.array_equal(getattr(loaded, f)[loaded.indices],
                       getattr(mesh, f)[mesh.indices])
        for f in ("positions", "normals"))
    gate(f"{name}: loaded OBJ equals the icosphere (corners, normals)",
         f"{loaded.num_triangles} triangles, equal {same}",
         same, f"{mesh.num_triangles} triangles, equal True")


# The bunny scenes (camera, sky panorama, metal ground; DebugNormals mesh
# for `bunny`, green glass for `glass_bunny`) with the icosphere, read from
# a written OBJ file, in the bunny's place.
SCENES = {"more_balls": lambda assets: examples.more_balls(),
          "bunny_standin": examples.bunny}


# -------------------------------------------- phase 3: kernel vs plain/brute

def camera_rays(scene, chunk_index, width=WIDTH, height=HEIGHT, spp=SPP):
    ids, live = renderer.chunk_ray_ids(chunk_index * CHUNK, CHUNK, width,
                                       height, spp, scene.device)
    rays = generate_rays(scene.camera, width, height, spp, ids, SEED,
                         lens=scene.features.has_lens)
    return init_state(rays, live=live).rays


def incoherent_rays(scene, n, seed):
    rng = np.random.default_rng(seed)
    lo = scene.accel.world_min.cpu().numpy().clip(-2, 2)
    hi = scene.accel.world_max.cpu().numpy().clip(-2, 2)
    origin = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    direction = rng.normal(size=(n, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    dev = scene.device
    return RayBatch(torch.tensor(origin, device=dev),
                    torch.tensor(direction, device=dev),
                    torch.full((n,), 1e-3, device=dev),
                    torch.full((n,), flash.BIG, device=dev))


def kernel_args(scene, inp, block=flash.R):
    return (inp.packed_rays, inp.queues, scene.accel.tri_flat,
            scene.accel.sph_feats, block, inp.has_sph)


def new_visits(scene, inp, group):
    return torch.zeros((inp.packed_rays.shape[1] // group, 3),
                       dtype=torch.int32, device=scene.device)


def run_both(scene, inp, group=None, block=flash.R):
    """(kernel outputs, plain outputs, kernel visits, plain visits), both
    versions at the same termination group (default: the wrapper's)."""
    group = flash.resolve_group(block, group)
    vk = new_visits(scene, inp, group)
    vp = torch.zeros_like(vk)
    args = kernel_args(scene, inp, block)
    got = flash.flash_intersect_kernel(*args, visits=vk, group=group)
    sync(scene.device)          # a fault during the run surfaces here
    want = flash.flash_intersect_plain(*args, visits=vp, group=group)
    return got, want, vk, vp


def pairs_tested(visits, group) -> dict:
    """Pair tests behind per-group visit counts: rays of a group x rows it
    visited, summed over the groups."""
    sph, children, tail = (int(x) for x in visits.sum(0))
    return {"tri": group * (children * flash.W + tail * flash.K),
            "sph": group * sph * flash.K}


def winners(raw):
    """Merged closest hit of a raw (tri_t, tri_slot, sph_t, sph_slot): the
    triangle result matters only where no sphere precedes it."""
    tri_t, tri_slot, sph_t, sph_slot = raw
    sphere = sph_t <= tri_t
    t = torch.where(sphere, sph_t, tri_t)
    # spheres numbered after an offset so a slot names one primitive
    slot = torch.where(sphere, sph_slot.long() + (1 << 30), tri_slot.long())
    return t, slot, t < flash.BIG


def compare_kernel_with_plain(label, scene, rays, block=flash.R) -> float:
    inp = flash.prepare_flash(scene.accel, scene.tables, rays, block)
    got, want, vk, vp = run_both(scene, inp, block=block)
    kt, ks, kh = winners(got)
    pt, ps, ph = winners(want)
    n = kt.numel()
    both = kh & ph
    same = both & (ks == ps)
    err = (kt - pt).abs()[same]
    rel = (err / pt[same].abs().clamp(min=1e-30))
    max_abs = float(err.max()) if err.numel() else 0.0
    group = flash.resolve_group(block)
    say(f"[kernel vs plain] {label}: {n} rays, {int(ph.sum())} hits, groups "
        f"of {group}, visits kernel {vk.sum(0).tolist()} plain "
        f"{vp.sum(0).tolist()} (sphere clusters, children, tail parents)")
    gate("visit counts, every group", f"{int((vk != vp).sum())} differ",
         torch.equal(vk, vp), "0 differ")
    gate("hit/miss agreement", f"{float((kh == ph).float().mean()):.6f}",
         float((kh == ph).float().mean()) >= 0.999, ">= 0.999")
    slot_share = float(same.sum() / both.sum()) if bool(both.any()) else 1.0
    gate("slot agreement where both hit", f"{slot_share:.6f}",
         slot_share >= 0.999, ">= 0.999")
    # Same formulas in float32, but nvcc contracts multiply-adds and eager
    # torch does not. The triangle test's det = U + V + W sums three edge
    # values that are each 10-100 times larger than det itself (small
    # triangles seen from afar), so that rounding difference shows at about
    # 1e-4 of t on a few rays in ten thousand: hence a share at rtol 1e-4
    # and a cap, for every ray, at the rtol 1e-3 of the brute-force gate.
    scale = pt[same].abs()
    share = float((err <= 1e-4 * scale + 1e-6).float().mean()) \
        if err.numel() else 1.0
    gate("t within rtol 1e-4 where both hit the same primitive",
         f"{share:.6f} of rays, max abs {max_abs:.3e}, "
         f"max rel {float(rel.max()) if rel.numel() else 0.0:.3e}",
         share >= 0.999, ">= 0.999 of rays")
    gate("t within rtol 1e-3, every ray", bool((err <= 1e-3 * scale
                                               + 1e-6).all()),
         bool((err <= 1e-3 * scale + 1e-6).all()), "True")
    # The results do not depend on the termination group, the visits do:
    # at every measured group (and at 32) that divides the block, the kernel
    # returns what it returned above, bit for bit, and takes the visits the
    # plain version takes.
    for g in (32,) + flash.GROUPS:
        if block % g:
            continue
        got_g, _, vk_g, vp_g = run_both(scene, inp, g, block)
        same_out = all(torch.equal(a, b) for a, b in zip(got_g, got))
        gate(f"group {g}: outputs equal to group {group}'s, visits equal "
             f"to the plain version's",
             f"{same_out}, {int((vk_g != vp_g).sum())} differ; visits "
             f"{vk_g.sum(0).tolist()}, pairs {pairs_tested(vk_g, g)}",
             same_out and torch.equal(vk_g, vp_g), "True, 0 differ")
    return max_abs


def compare_flash_with_brute(label, scene, rays, step=2048, intersect=None):
    """The gates of tests/test_flash.py::_assert_same, on the card. At
    2^15 rays a few graze a primitive, where the kernel's pair tests and
    the oracle's (other formulas for the same geometry) may name different
    winners; such a ray differs in material and in t alike, so t is held
    to the same > 99.5 % share as the material. `intersect(rays)` is the
    intersector under test (default: the scene's flash path)."""
    if intersect is None:
        out = flash.intersect_flash(scene.accel, scene.tables, rays)
    else:
        out = intersect(rays)
    parts = []
    for s in range(0, rays.origin.shape[0], step):
        cut = RayBatch(*(f[s:s + step] for f in rays))
        parts.append(intersect_brute_force(scene.tables, cut))
    brute = type(parts[0])(*(torch.cat(f) for f in zip(*parts)))
    sync(scene.device)
    same_valid = out.valid == brute.valid
    v = brute.valid & same_valid
    err = (out.t - brute.t).abs()[v]
    close = err <= 2e-3 + 1e-3 * brute.t[v].abs()
    same_mat = (out.material == brute.material)[v].float().mean()
    say(f"[{'flash' if intersect is None else 'intersector'} vs brute "
        f"force] {label}: {int(brute.valid.sum())} hits")
    gate("valid agreement", f"{float(same_valid.float().mean()):.6f}",
         float(same_valid.float().mean()) > 0.995, "> 0.995")
    gate("t within rtol 1e-3 atol 2e-3",
         f"{float(close.float().mean()):.6f} of hits "
         f"({int((~close).sum())} off, max abs err {float(err.max()):.3e})",
         float(close.float().mean()) > 0.995, "> 0.995")
    gate("material agreement", f"{float(same_mat):.6f}",
         float(same_mat) > 0.995, "> 0.995")


def phase_kernel_checks(scenes) -> float:
    bunny, balls = scenes["bunny_standin"], scenes["more_balls"]
    mid = (WIDTH * HEIGHT * SPP // CHUNK) // 2
    inputs = [
        ("icosphere 5120 tris, coherent camera rays (tile-swizzled)",
         bunny, camera_rays(bunny, mid)),
        ("icosphere 5120 tris, incoherent rays",
         bunny, incoherent_rays(bunny, CHUNK, seed=11)),
        ("more_balls, camera rays", balls, camera_rays(balls, mid)),
    ]
    worst = 0.0
    for label, scene, rays in inputs:
        worst = max(worst, compare_kernel_with_plain(label, scene, rays))
        compare_flash_with_brute(label, scene, rays)
    # a block that no group of whole warps per slice fills: its CTAs carry
    # dead lanes, and the batch is padded to a whole number of blocks
    for label, scene, rays in inputs[1:]:
        worst = max(worst, compare_kernel_with_plain(
            label + ", blocks of 96 rays", scene, rays, block=96))
    return worst


# ------------------------------------------------ phase 4: the main path

def check_image(name, out):
    pixels = WIDTH * HEIGHT
    assert out.color.shape == (HEIGHT, WIDTH, 3), out.color.shape
    gate(f"{name}: image finite", bool(np.isfinite(out.color).all()),
         bool(np.isfinite(out.color).all()), "True")
    gate(f"{name}: segments", out.segments, out.segments >= pixels * SPP,
         f">= {pixels * SPP}")
    gate(f"{name}: first-hit coverage", f"{float(out.coverage.mean()):.4f}",
         float(out.coverage.mean()) > 0.0, "> 0")
    gate(f"{name}: mean radiance", f"{float(out.color.mean()):.4f}",
         0.0 < float(out.color.mean()) < 10.0, "in (0, 10)")


def timed_frames(scene, frames=3):
    """ms per frame and segments per frame over `frames` whole frames."""
    frame_fn, starts = renderer.compile_frame(
        scene, WIDTH, HEIGHT, SPP, BOUNCES, driver="chunked")
    ms, segs = [], []
    for i in range(frames):
        a = event()
        out = frame_fn(scene.tables, scene.camera, SEED + i, starts)
        b = event()
        sync(scene.device)
        ms.append(elapsed_ms(a, b))
        segs.append(int(out.segments.sum()))
    return ms, segs


def instrumented_frame(scene):
    """One frame driven chunk by chunk and bounce by bounce through the
    port's own pieces, with events around each phase. Returns the phase
    sums (ms), the kernel's visits, the number of intersect calls, the
    kernel inputs of the middle chunk's launches, and the passes (chunks
    still running) at each bounce."""
    accel, tables, dev = scene.accel, scene.tables, scene.device
    marks = []     # (phase, start event, end event)
    visits = []
    captured = []
    state_box = {"capture": False}

    def intersect(tables_, rays):
        e0 = event()
        inp = flash.prepare_flash(accel, tables_, rays)
        e1 = event()
        v = new_visits(scene, inp, flash.resolve_group(flash.R))
        raw = flash.flash_intersect_kernel(*kernel_args(scene, inp),
                                           visits=v)
        e2 = event()
        hit = flash.flash_epilogue(accel, rays, raw, inp.sph_dense)
        e3 = event()
        marks.extend([("queue build", e0, e1), ("kernel", e1, e2),
                      ("epilogue", e2, e3)])
        visits.append(v)
        if state_box["capture"]:
            captured.append(inp)
        return hit

    step = make_bounce_step(tables, intersect, SEED,
                            features=scene.features, aovs=False)
    total = WIDTH * HEIGHT * SPP
    num_chunks = (total + CHUNK - 1) // CHUNK
    calls = 0
    per_bounce = [0] * BOUNCES
    f0 = event()
    for c in range(num_chunks):
        state_box["capture"] = c == num_chunks // 2
        e0 = event()
        ids, live = renderer.chunk_ray_ids(c * CHUNK, CHUNK, WIDTH, HEIGHT,
                                           SPP, dev)
        rays = generate_rays(scene.camera, WIDTH, HEIGHT, SPP, ids, SEED,
                             lens=scene.features.has_lens)
        state = init_state(rays, live=live)
        e1 = event()
        marks.append(("camera + rng", e0, e1))
        bounce = 0
        while bounce < BOUNCES and bool(state.active.any()):
            s0 = event()
            state = step(state, bounce, ids)
            s1 = event()
            marks.append(("bounce step", s0, s1))
            per_bounce[bounce] += 1
            bounce += 1
            calls += 1
    f1 = event()
    sync(dev)
    sums = {}
    for phase, a, b in marks:
        sums[phase] = sums.get(phase, 0.0) + elapsed_ms(a, b)
    sums["shading"] = sums.pop("bounce step") - sums["queue build"] \
        - sums["kernel"] - sums["epilogue"]
    sums["frame"] = elapsed_ms(f0, f1)
    return sums, torch.cat(visits), calls, captured, per_bounce


def kernel_bound_ms(scene, inp, visits, can_hit, visits_block) -> dict:
    """The least time the card could take for this launch: the operations
    of the pair tests this run's queues need over the float32 peak, against
    every input read once and every output written once over the memory
    rate. `visits` and `can_hit` are the plain version's at the kernel's
    own termination group: every pair it tested pays the head of its test,
    the pairs that could hit also the tail.

    `first_ms` is the yardstick of the kernel's first design, kept beside it
    so that readings stay comparable: the pairs at the granularity of a
    whole block (`visits_block`), each at the full cost of its test."""
    pairs = pairs_tested(visits, flash.resolve_group(flash.R))
    hit_sph, hit_tri = (int(x) for x in can_hit.sum(0))
    flops = (pairs["tri"] * FLOPS_TRI_HEAD + hit_tri * FLOPS_TRI_TAIL
             + pairs["sph"] * FLOPS_SPH_HEAD + hit_sph * FLOPS_SPH_TAIL)
    at_block = pairs_tested(visits_block, flash.R)
    first_flops = (at_block["tri"] * FIRST_FLOPS_PER_TRI_PAIR
                   + at_block["sph"] * FIRST_FLOPS_PER_SPH_PAIR)
    bp = inp.packed_rays.shape[1]
    nbytes = inp.packed_rays.numel() * 4 + bp * 16
    nbytes += sum(t.numel() * t.element_size() for t in inp.queues)
    nbytes += scene.accel.tri_flat.numel() * 4
    if inp.has_sph:
        nbytes += scene.accel.sph_feats.numel() * 4
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"ms": max(t_ops, t_bytes), "ops_ms": t_ops, "bytes_ms": t_bytes,
            "pairs": pairs, "can_hit": {"tri": hit_tri, "sph": hit_sph},
            "first_ms": max(first_flops / PEAK_F32_FLOPS * 1e3, t_bytes),
            "pairs_at_block": at_block}


def device_ms(launch, reps=20) -> float:
    """Device time of one `launch()`: `reps` of them queued behind a
    spinning kernel, so the card never waits for the host between them."""
    launch()                                   # warm
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)      # ~20 ms: the host runs ahead
    a = event()
    for _ in range(reps):
        launch()
    b = event()
    torch.cuda.synchronize()
    return elapsed_ms(a, b) / reps


def time_captured(scene, captured, reps=20, plain_reps=2):
    """Kernel, plain version and bound on the main path's own inputs: the
    launches of one chunk (its camera pass and its bounce passes).

    `ms` is the kernel's device time at the wrapper's default group, `by
    group` the same at every measured group. `enqueue_ms` is the loop with
    the card idle at its start, which for a short kernel measures the
    wrapper's host cost per call. The bound is reckoned from the plain
    version's visits and pairs that can hit at the kernel's group (gated
    equal to the kernel's own visits here), the first design's yardstick
    from its visits at group = block."""
    dev = scene.device
    group = flash.resolve_group(flash.R)
    rows = []
    for inp in captured:
        args = kernel_args(scene, inp)
        v = new_visits(scene, inp, group)
        flash.flash_intersect_kernel(*args, visits=v)       # warm
        sync(dev)
        e0 = event()
        for _ in range(reps):
            flash.flash_intersect_kernel(*args)
        e1 = event()
        sync(dev)
        by_group = {g: device_ms(
            lambda: flash.flash_intersect_kernel(*args, group=g), reps)
            for g in flash.GROUPS}         # the default group is one of them
        v_block = new_visits(scene, inp, flash.R)
        flash.flash_intersect_plain(*args, visits=v_block)  # warm
        v_plain = torch.zeros_like(v)
        can_hit = torch.zeros((v.shape[0], 2), dtype=torch.int64, device=dev)
        flash.flash_intersect_plain(*args, visits=v_plain, group=group,
                                    can_hit=can_hit)
        if not torch.equal(v, v_plain):
            raise SystemExit("chip_smoke: kernel and plain version took "
                             "different visits on a launch of the main path")
        c = event()
        for _ in range(plain_reps):
            flash.flash_intersect_plain(*args)
        d = event()
        sync(dev)
        rows.append({"ms": by_group[group], "ms_by_group": by_group,
                     "enqueue_ms": elapsed_ms(e0, e1) / reps,
                     "plain_ms": elapsed_ms(c, d) / plain_reps,
                     "bound": kernel_bound_ms(scene, inp, v_plain, can_hit,
                                              v_block)})
    return rows


def small_frame_agreement(name, scene, size=64, spp=2, gated_bounces=4):
    """The whole path through the kernel against the whole path through
    the plain version, under the gate of
    tests/test_render_oracle.py::_compare (per-pixel 2e-3, at most
    max(1, 0.2 %) pixels off).

    The gate is taken at 4 bounces, the depth the repository's image tests
    use it at: the kernel (contracted multiply-adds) and the plain version
    (none) differ in t by up to ~1e-4 relative, a bounce off a sphere of
    radius 0.2 magnifies that, and the count of pixels off grows with
    depth. The reading at full depth is printed beside it, ungated."""
    def pixels_off(bounces):
        kw = dict(spp=spp, max_bounce=bounces, seed=SEED, driver="chunked")
        a = renderer.render(scene, size, size, **kw)
        b = renderer.render(scene, size, size, force_plain=True, **kw)
        bad = (np.abs(a.color.astype(np.float64) - b.color) > 2e-3).any(-1)
        return int(bad.sum()), bad.size

    off, pixels = pixels_off(gated_bounces)
    allowed = max(1, round(0.002 * pixels))
    deep, _ = pixels_off(BOUNCES)
    gate(f"{name}: {size}x{size}x{spp}spp kernel path vs plain path, "
         f"pixels off by > 2e-3 at {gated_bounces} bounces", off,
         off <= allowed, f"<= {allowed}; at {BOUNCES} bounces: {deep}")


def profile_chunk(name, scene):
    """torch.profiler over the middle chunk of a frame: the card's busy
    share and the kernels that take its time."""
    from torch.profiler import ProfilerActivity, profile

    num_chunks = (WIDTH * HEIGHT * SPP + CHUNK - 1) // CHUNK
    frame_fn, _ = renderer.compile_frame(
        scene, WIDTH, HEIGHT, SPP, BOUNCES, driver="chunked")
    starts = torch.tensor([(num_chunks // 2) * CHUNK], device=scene.device)
    frame_fn(scene.tables, scene.camera, SEED, starts)      # warm
    sync(scene.device)
    t0 = time.perf_counter()
    frame_fn(scene.tables, scene.camera, SEED, starts)
    sync(scene.device)
    wall_ms = (time.perf_counter() - t0) * 1e3     # host clock, profiler off
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        frame_fn(scene.tables, scene.camera, SEED, starts)
        sync(scene.device)
    # device-side rows only: an operator's row repeats the time of the
    # kernels it launched
    rows = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0))
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows) / 1e3
    say(f"[profile] {name}: one chunk of {CHUNK} rays, {BOUNCES} bounces: "
        f"wall {wall_ms:.1f} ms with the profiler off, device busy "
        f"{busy_ms:.2f} ms (traced) = {busy_ms / wall_ms:.4f} of that wall, "
        f"{sum(r[1] for r in rows)} device kernels")
    for key, count, us in rows[:12]:
        say(f"[profile]   {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")


def phase_main_path(scenes):
    """Drives render / compile_frame at full width; returns per-scene
    results and the launch count of the run."""
    results = {}
    flash.flash_intersect_kernel.launches = 0
    for name, scene in scenes.items():
        out = renderer.render(scene, WIDTH, HEIGHT, spp=SPP,
                              max_bounce=BOUNCES, seed=SEED,
                              driver="chunked")          # also the warm-up
        check_image(name, out)
        results[name] = {"chunked_out": out}
        before = flash.flash_intersect_kernel.launches
        ms, segs = timed_frames(scene)
        per_frame = (flash.flash_intersect_kernel.launches - before) / len(ms)
        results[name].update(frame_ms=ms, segments=segs,
                             launches_per_frame=per_frame)
        say(f"[main path] {name}: {WIDTH}x{HEIGHT}, {SPP} spp, {BOUNCES} "
            f"bounces, chunked driver, chunks of {CHUNK}: "
            f"ms/frame {[round(x, 2) for x in ms]}, "
            f"segments/s {[round(s / (m / 1e3)) for s, m in zip(segs, ms)]}, "
            f"segments/frame {segs}, kernel launches/frame {per_frame}")
    launches = flash.flash_intersect_kernel.launches
    num_chunks = (WIDTH * HEIGHT * SPP + CHUNK - 1) // CHUNK
    gate("kernel launches on the main path", launches,
         launches >= 4 * num_chunks * len(scenes),
         f">= {4 * num_chunks * len(scenes)} (one per chunk per frame)")

    for name, scene in scenes.items():
        before = flash.flash_intersect_kernel.launches
        sums, visits, calls, captured, per_bounce = \
            instrumented_frame(scene)
        took = flash.flash_intersect_kernel.launches - before
        gate(f"{name}: one launch per chunk per bounce taken",
             f"{took} launches, {calls} bounce steps", took == calls,
             "equal")
        frame = sums.pop("frame")
        shares = {k: round(v / frame, 4) for k, v in sums.items()}
        shares["host gaps"] = round(1.0 - sum(sums.values()) / frame, 4)
        say(f"[phases] {name}: instrumented frame {frame:.1f} ms; "
            f"ms {json.dumps({k: round(v, 2) for k, v in sums.items()})}; "
            f"share of frame {json.dumps(shares)}; kernel mean "
            f"{sums['kernel'] / calls:.4f} ms over {calls} launches")
        rows = time_captured(scene, captured)
        for i, r in enumerate(rows):
            by_group = r["ms_by_group"]
            say(f"[kernel timing] {name} middle chunk bounce {i}: kernel "
                f"{r['ms']:.4f} ms on the device at group "
                f"{flash.resolve_group(flash.R)} (enqueue_ms "
                f"{r['enqueue_ms']:.4f} a call when enqueued on an idle "
                f"card); by group "
                f"{json.dumps({g: round(t, 4) for g, t in by_group.items()})}"
                f"; plain {r['plain_ms']:.2f} ms, bound "
                f"{r['bound']['ms']:.5f} ms (operations "
                f"{r['bound']['ops_ms']:.5f}, bytes "
                f"{r['bound']['bytes_ms']:.5f}; pairs tested "
                f"{json.dumps(r['bound']['pairs'])}, of which can hit "
                f"{json.dumps(r['bound']['can_hit'])}); first design's "
                f"yardstick {r['bound']['first_ms']:.5f} ms (pairs at block "
                f"granularity {json.dumps(r['bound']['pairs_at_block'])})")
        results[name].update(
            phases_ms=sums, shares=shares, frame_instrumented_ms=frame,
            chunked_passes_per_bounce=per_bounce,
            kernel_mean_ms_in_frame=sums["kernel"] / calls,
            frame_visits=visits.sum(0).tolist(), rows=rows)
        small_frame_agreement(name, scene)
    return results, launches


# -------------------------------- phase 5: the default driver and the CLI

DRIVERS = ("chunked", "compact")


def count_syncs(fn) -> int:
    """Host-device synchronisations while fn() runs, as torch's sync debug
    mode reports them (a tensor read on the host, a copy to or from the
    host, a data-dependent shape)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def same_image(a, b) -> bool:
    return (a.segments == b.segments and np.array_equal(a.color, b.color)
            and np.array_equal(a.normal, b.normal)
            and np.array_equal(a.coverage, b.coverage))


def time_drivers(name, scene, frames=3):
    """`frames` whole frames of each driver, in turns (chunked, compact,
    chunked, ...), through compile_frame; then one frame of each under the
    sync counter. Returns per driver: ms, segments and launches a frame,
    passes a bounce (compact: from the driver; chunked: filled in by the
    caller) and host syncs a frame."""
    fns = {d: renderer.compile_frame(scene, WIDTH, HEIGHT, SPP, BOUNCES,
                                     driver=d) for d in DRIVERS}
    rows = {d: {"frame_ms": [], "segments": [], "launches": []}
            for d in DRIVERS}
    for i in range(frames):
        for d in DRIVERS:
            fn, starts = fns[d]
            before = flash.flash_intersect_kernel.launches
            a = event()
            out = fn(scene.tables, scene.camera, SEED + i, starts)
            b = event()
            sync(scene.device)
            rows[d]["frame_ms"].append(elapsed_ms(a, b))
            rows[d]["segments"].append(int(out.segments.sum()))
            rows[d]["launches"].append(
                flash.flash_intersect_kernel.launches - before)
    for d in DRIVERS:
        fn, starts = fns[d]
        rows[d]["host_syncs"] = count_syncs(lambda: (
            fn(scene.tables, scene.camera, SEED, starts), sync(scene.device)))
        rows[d]["segments_per_s"] = [
            s / (m / 1e3) for s, m in zip(rows[d]["segments"],
                                          rows[d]["frame_ms"])]
    rows["compact"]["passes_per_bounce"] = list(fns["compact"][0].passes)
    gate(f"{name}: segments a frame equal under both drivers",
         f"{rows['chunked']['segments']} / {rows['compact']['segments']}",
         rows["chunked"]["segments"] == rows["compact"]["segments"],
         "equal")
    return rows


def truncate_checkpoint(path, keep):
    """Rewrite the checkpoint as if the process had died after `keep`
    chunks were saved."""
    ckpt = dict(np.load(path))
    ckpt["chunks_done"] = keep
    for k in ("color", "aov_normal", "aov_hit", "segments"):
        ckpt[k] = ckpt[k][:keep]
    with open(path, "wb") as f:
        np.savez(f, **ckpt)


class EventList:
    """A metrics stream that keeps each record written to it."""

    def __init__(self):
        self.records = []

    def write(self, line):
        self.records.append(json.loads(line))


def phase_cli(balls_image):
    """The CLI in-process at full width: `render` to a TGA file (read back
    and held against render(...).srgb()), `bench` (one JSON line) and
    `--metrics`."""
    args = ["--scene", "more_balls", "--width", str(WIDTH), "--height",
            str(HEIGHT), "--spp", str(SPP), "--max-bounce", str(BOUNCES),
            "--seed", str(SEED)]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="potato_cli_") as tmp:
        tga_path = os.path.join(tmp, "more_balls.tga")
        metrics_path = os.path.join(tmp, "metrics.jsonl")
        rc = cli.main(["render", *args, "--output", tga_path,
                       "--metrics", metrics_path])
        gate("cli render exit code", rc, rc == 0, "0")
        written = tga.load(tga_path)
        with open(metrics_path) as f:
            events = [json.loads(line)["event"] for line in f
                      if line.strip()]
    want = balls_image.srgb()
    gate("cli render: TGA read back equals render(...).srgb() bit for bit",
         f"{written.shape}, {int((written != want).any(-1).sum())} pixels "
         "differ", written.shape == want.shape
         and np.array_equal(written, want), "0 differ")
    gate("cli --metrics: render_start and render_complete written",
         f"{len(events)} events, first {events[:1]}, last {events[-1:]}",
         "render_start" in events and "render_complete" in events, "both")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", *args])
    lines = buf.getvalue().strip().splitlines()
    bench = json.loads(lines[-1]) if lines else {}
    gate("cli bench: one JSON line, the frame's segments",
         f"rc {rc}, {len(lines)} line(s): {lines[-1] if lines else ''}",
         rc == 0 and len(lines) == 1
         and bench.get("segments") == balls_image.segments,
         f"rc 0, 1 line, segments {balls_image.segments}")
    say(f"[cli] render + bench of more_balls at {WIDTH}x{HEIGHT}: "
        f"{time.perf_counter() - t0:.1f} s with both scene builds")
    return bench


def phase_checkpoint(balls):
    """A 160x120 render of more_balls (3 chunks) with a checkpoint, cut
    after 2 chunks and resumed, against one render straight through."""
    kw = dict(spp=SPP, max_bounce=BOUNCES, seed=SEED)
    num_chunks = -(-160 * 120 * SPP // CHUNK)
    straight = renderer.render(balls, 160, 120, **kw)
    with tempfile.TemporaryDirectory(prefix="potato_ckpt_") as tmp:
        path = os.path.join(tmp, "render.ckpt.npz")
        renderer.render(balls, 160, 120, checkpoint_path=path, **kw)
        truncate_checkpoint(path, keep=2)
        log = EventList()
        resumed = renderer.render(
            balls, 160, 120, checkpoint_path=path,
            metrics=metrics_mod.MetricsLogger(stream=log), **kw)
    redone = [r["chunk"] for r in log.records if r["event"] == "chunk"]
    want = list(range(2, num_chunks))
    gate(f"checkpoint cut after 2 of {num_chunks} chunks, resumed: "
         "bit-equal to a render straight through", f"chunks redone {redone},"
         f" equal {same_image(resumed, straight)}",
         redone == want and same_image(resumed, straight),
         f"chunks redone {want}, equal True")


def phase_default_driver(scenes, main_results):
    """Each scene at full width through render() with its default driver,
    held bit for bit against the chunked image; both drivers timed in
    turns. Returns per-scene driver rows and the images rendered."""
    rows, images = {}, {}
    for name, scene in scenes.items():
        default = renderer.default_driver(scene)
        kw = dict(spp=SPP, max_bounce=BOUNCES, seed=SEED)
        compact = renderer.render(
            scene, WIDTH, HEIGHT,
            driver=None if default == "compact" else "compact", **kw)
        chunked = main_results[name]["chunked_out"] if name in main_results \
            else renderer.render(scene, WIDTH, HEIGHT, driver="chunked", **kw)
        check_image(f"{name} (compact)", compact)
        off = int((compact.color != chunked.color).any(-1).sum())
        gate(f"{name}: default driver {default}; compact image equals the "
             "chunked image bit for bit (color, normal, coverage, segments)",
             f"{off} pixels differ in color, segments {compact.segments} / "
             f"{chunked.segments}", same_image(compact, chunked),
             "0 differ, equal")
        images[name] = compact
        rows[name] = r = time_drivers(name, scene)
        if name in main_results:
            per_bounce = main_results[name]["chunked_passes_per_bounce"]
        else:
            per_bounce = instrumented_frame(scene)[4]
        r["chunked"]["passes_per_bounce"] = per_bounce
        for d in DRIVERS:
            x = r[d]
            say(f"[drivers] {name}: {d}{' (default)' if d == default else ''}"
                f": ms/frame {[round(m, 2) for m in x['frame_ms']]}, "
                f"segments/s {[round(v) for v in x['segments_per_s']]}, "
                f"kernel launches/frame {x['launches']}, passes a bounce "
                f"{x['passes_per_bounce']}, host syncs/frame "
                f"{x['host_syncs']}")
    return rows, images


# ------------------------------------- phase 6: the differentiable path

# optimize_textures' defaults (spp 2, 4 bounces) at the reference frame size
OPT_W, OPT_H, OPT_SPP, OPT_BOUNCES = 800, 600, 2, 4


def write_earthmap(directory, seed=SEED, width=1024, height=512):
    """A procedural earthmap.tga at the real file's size in `directory`: a
    smooth gradient plus a checker, with seeded noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width]
    img = np.empty((height, width, 3), np.int64)
    img[..., 0] = 40 + 180 * x // width
    img[..., 1] = 40 + 160 * y // height
    img[..., 2] = np.where((x // 64 + y // 64) % 2 == 0, 200, 60)
    img += rng.integers(0, 24, img.shape)
    tga.save(np.clip(img, 0, 255).astype(np.uint8),
             os.path.join(directory, "earthmap.tga"))


def profiled_gradient(loss, params, ids, target):
    """One chunk-by-chunk gradient with a CUDA event at each chunk's
    forward, backward and end: (loss, grads, forward ms, backward ms,
    chunks, peak bytes allocated during it)."""
    marks = []
    sync(target.device)
    torch.cuda.reset_peak_memory_stats()
    value, grads = loss.value_and_grad(
        params, ids, target, stamp=lambda label: marks.append((label,
                                                               event())))
    sync(target.device)
    ms = {"forward": 0.0, "backward": 0.0}
    for (label, a), (_, b) in zip(marks, marks[1:]):
        if label in ms:
            ms[label] += elapsed_ms(a, b)
    return (float(value), grads, ms["forward"], ms["backward"], loss.chunks,
            torch.cuda.max_memory_allocated())


def run_optimize(name, scene, target, fields, init, steps, learning_rate):
    """optimize_textures at OPT_* from `init`, then one profiled gradient
    at the same start. Returns a row of readings."""
    log = EventList()
    before = flash.flash_intersect_kernel.launches
    torch.cuda.reset_peak_memory_stats()
    res = optimize.optimize_textures(
        scene, target, width=OPT_W, height=OPT_H, spp=OPT_SPP,
        max_bounce=OPT_BOUNCES, seed=SEED, fields=fields, steps=steps,
        learning_rate=learning_rate, init=init, log_every=0,
        metrics=metrics_mod.MetricsLogger(stream=log))
    sync(scene.device)
    opt_peak = torch.cuda.max_memory_allocated()
    launches = flash.flash_intersect_kernel.launches - before
    seconds = [r["seconds"] for r in log.records if r["event"] == "opt_step"]
    loss = optimize.make_render_loss(
        scene, width=OPT_W, height=OPT_H, spp=OPT_SPP,
        max_bounce=OPT_BOUNCES, seed=SEED, fields=fields)
    dev = scene.device
    params = {f: torch.as_tensor(np.asarray(init[f]), device=dev)
              if f in init else getattr(scene.tables, f) for f in fields}
    ids = torch.arange(OPT_W * OPT_H * OPT_SPP, device=dev)
    tgt = torch.as_tensor(np.asarray(target, np.float32).reshape(-1, 3),
                          device=dev)
    value, grads, fwd, bwd, chunks, peak = profiled_gradient(
        loss, params, ids, tgt)
    row = {"losses": res.losses, "learning_rate": learning_rate,
           "step_seconds": seconds,
           "launches_per_step": launches / steps, "chunks_per_step": chunks,
           "forward_ms": fwd, "backward_ms": bwd,
           "backward_over_forward": bwd / fwd, "peak_bytes_gradient": peak,
           "peak_bytes_optimize": opt_peak, "profiled_loss": value,
           "scene_bytes": sum(t.numel() * t.element_size()
                              for t in scene.tables)}
    say(f"[diff] {name}: {OPT_W}x{OPT_H}, {OPT_SPP} spp, {OPT_BOUNCES} "
        f"bounces, fields {list(fields)}, Adam at {learning_rate}: losses "
        f"{res.losses}; seconds a "
        f"step {seconds} (host clock); one gradient: forward "
        f"{fwd:.1f} ms, backward {bwd:.1f} ms (ratio {bwd / fwd:.2f}), "
        f"{chunks} chunks; kernel launches a step {launches / steps}; peak "
        f"memory {peak / 2**20:.1f} MiB in the gradient, "
        f"{opt_peak / 2**20:.1f} MiB over optimize_textures")
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    gate(f"{name}: every gradient finite", finite, finite, "True")
    gate(f"{name}: loss after the last step below the first step's",
         f"{res.losses[0]:.6g} -> {res.losses[-1]:.6g}",
         res.losses[-1] < res.losses[0], "falls")
    return row, grads


def grad_kernel_vs_plain(name, scene, fields, size=64, spp=2, bounces=2):
    """The gradient through the kernel against the gradient through its
    plain version, on one frame. Kernel and plain version differ in t by
    rounding on under 0.01 % of rays (ROADMAP.md queue C), which moves a
    bounce's hit point by ~1e-4 of its distance; hence a relative L2 gate
    of 1e-3 rather than equality."""
    dev = scene.device
    rng = np.random.default_rng(SEED)
    target = torch.tensor(rng.uniform(0, 1, (size * size, 3))
                          .astype(np.float32), device=dev)
    ids = torch.arange(size * size * spp, device=dev)
    params = {f: getattr(scene.tables, f) for f in fields}
    got = []
    for plain in (False, True):
        loss = optimize.make_render_loss(
            scene, width=size, height=size, spp=spp, max_bounce=bounces,
            seed=SEED, fields=fields, force_plain=plain)
        got.append(loss.value_and_grad(params, ids, target)[1])
    worst = 0.0
    for f in fields:
        k, p = got[0][f].double(), got[1][f].double()
        rel = float((k - p).norm() / p.norm().clamp(min=1e-30))
        worst = max(worst, rel)
        gate(f"{name}: {size}x{size}x{spp}spp, {bounces} bounces, gradient "
             f"of {f} through the kernel vs through the plain version, "
             f"relative L2", f"{rel:.3e} (|g| {float(p.norm()):.3e})",
             rel <= 1e-3 and float(p.norm()) > 0, "<= 1e-3, |g| > 0")
    return worst


def phase_differentiable(scenes, earth):
    """The slice's path: optimize_textures through the kernel at full
    width on the earth stand-in and on more_balls. Returns its readings
    and the kernel launches of the path."""
    dev = earth.device
    balls = scenes["more_balls"]
    # Each target is the scene's own render at another seed than the
    # optimisation's: a target sharing the optimisation's noise realization
    # makes any move of a scatter parameter decorrelate that noise, and the
    # realized loss then rises for every step size (PERF.md, findings).
    kw = dict(spp=OPT_SPP, max_bounce=OPT_BOUNCES, seed=SEED + 1)
    target_e = renderer.render(earth, OPT_W, OPT_H, **kw).color
    target_b = renderer.render(balls, OPT_W, OPT_H, **kw).color
    atlas = earth.tables.atlas
    init_e = {"atlas": np.full(tuple(atlas.shape), 0.5, np.float32)}
    init_b = {"m_absorb_color":
              balls.tables.m_absorb_color.cpu().numpy() * 0.8}
    sync(dev)

    say(f"[diff] card: {gpu_line()}")
    flash.flash_intersect_kernel.launches = 0
    t0 = time.perf_counter()
    row_e, g_e = run_optimize("earth", earth, target_e, ("atlas",), init_e,
                              steps=3, learning_rate=0.05)
    # Adam's first step moves every parameter with a gradient by the whole
    # learning rate. A scatter parameter's gradient is noisy at 2 spp, and
    # at 0.05 the step in fuzz and IOR cost more than the albedo step
    # gained (the loss rose; PERF.md, findings): hence 0.005 here.
    row_b, g_b = run_optimize("more_balls", balls, target_b,
                              ("m_absorb_color", "m_scatter_param"), init_b,
                              steps=2, learning_rate=0.005)
    launches = flash.flash_intersect_kernel.launches
    seen = int((g_e["atlas"].abs().amax(dim=-1) > 0).sum())
    gate("earth: atlas gradient nonzero on the texels the camera sees",
         f"{seen} of {atlas.shape[0]} texels", seen > 0, "> 0")
    dielectric = balls.tables.m_scatter_kind == desc.SCATTER_DIELECTRIC
    moved = int((g_b["m_scatter_param"][dielectric] != 0).sum())
    gate("more_balls: m_scatter_param gradient nonzero on dielectrics "
         "(ior_score on)", f"{moved} of {int(dielectric.sum())}", moved > 0,
         "> 0")
    gate("kernel launches on the differentiable path", launches,
         launches > 0, "> 0")
    say(f"[diff] phase path in {time.perf_counter() - t0:.1f} s, "
        f"{launches} kernel launches")

    worst = max(
        grad_kernel_vs_plain("three_balls", scenes["three_balls"],
                             ("m_absorb_color",)),
        grad_kernel_vs_plain("bunny_standin", scenes["bunny_standin"],
                             ("m_absorb_color",)))
    return {"earth": row_e, "more_balls": row_b,
            "grad_kernel_vs_plain_rel_l2": worst}, launches


# ------------------------- phase 7: the accelerators and the pool driver

FRAME_BUDGET_S = 25.0     # the longest frame phase 7 times at full size
POOL = wavefront.DEFAULT_POOL


def phase_accel_gates(scenes, alt):
    """dense and cluster against brute force on 2^15 camera rays and 2^15
    incoherent rays (rays of the flash build; the same geometry)."""
    mid = (WIDTH * HEIGHT * SPP // CHUNK) // 2
    for name in ("more_balls", "bunny_standin"):
        base = scenes[name]
        for label, rays in (("camera rays", camera_rays(base, mid)),
                            ("incoherent rays",
                             incoherent_rays(base, CHUNK, seed=13))):
            for accel in ("dense", "cluster"):
                s = alt[name, accel]
                if accel == "dense":
                    def run(r, s=s):
                        return intersect_dense(s.accel, s.tables, r)
                else:
                    def run(r, s=s):
                        return intersect_clustered(s.accel, r)
                t0 = time.perf_counter()
                compare_flash_with_brute(f"{accel}, {name}, {label}", s,
                                         rays, intersect=run)
                say(f"  ({time.perf_counter() - t0:.2f} s with brute force)")


def frame_ms(scene, width, height):
    """One frame on the scene's default driver through compile_frame,
    CUDA events around it: (ms, segments)."""
    fn, starts = renderer.compile_frame(scene, width, height, SPP, BOUNCES)
    a = event()
    out = fn(scene.tables, scene.camera, SEED, starts)
    b = event()
    sync(scene.device)
    return elapsed_ms(a, b), int(out.segments.sum())


def timed_alt_frame(name, accel, scene):
    """A frame at full size if a 200x150 frame projects it (x16) under
    FRAME_BUDGET_S, else at 400x300 if that fits, else at 200x150."""
    small_ms, small_segs = frame_ms(scene, 200, 150)
    size = (200, 150)
    for w, h in ((WIDTH, HEIGHT), (400, 300)):
        scale = (w * h) / (200 * 150)
        if small_ms * scale / 1e3 <= FRAME_BUDGET_S:
            size = (w, h)
            break
    ms, segs = (small_ms, small_segs) if size == (200, 150) else \
        frame_ms(scene, *size)
    cut = "" if size == (WIDTH, HEIGHT) else (
        f" (cut to {size[0]}x{size[1]}: the 200x150 frame took "
        f"{small_ms:.1f} ms, x{WIDTH * HEIGHT // (200 * 150)} would pass "
        f"{FRAME_BUDGET_S:.0f} s)")
    say(f"[accels] {name}, {accel}, {renderer.default_driver(scene)} "
        f"driver: {size[0]}x{size[1]}, {SPP} spp, {BOUNCES} bounces: "
        f"{ms:.1f} ms a frame, {segs} segments, "
        f"{segs / (ms / 1e3):.0f} segments/s{cut}")
    return {"size": list(size), "frame_ms": ms, "segments": segs,
            "segments_per_s": segs / (ms / 1e3)}


def phase_pool_and_frames(scenes, glass, alt, full_images):
    """The pool driver bit for bit against the chunked driver (64x64 with
    regeneration, and the full frame against the images of phases 4-5);
    one timed frame of dense, cluster and pool on each scene. Returns the
    readings and the kernel launches of the pool frames."""
    flat = {"more_balls": scenes["more_balls"], "glass_standin": glass,
            "bunny_standin": scenes["bunny_standin"]}
    for name in ("more_balls", "glass_standin"):
        kw = dict(spp=2, max_bounce=BOUNCES, seed=SEED)
        want = renderer.render(flat[name], 64, 64, driver="chunked", **kw)
        got = wavefront.render_pool(flat[name], 64, 64, pool=2048, **kw)
        off = int((got.color != want.color).any(-1).sum())
        gate(f"{name}: pool of 2048 lanes (4 generations) vs chunked, 64x64,"
             f" 2 spp, {BOUNCES} bounces, bit for bit", f"{off} pixels "
             f"differ, segments {got.segments} / {want.segments}",
             same_image(got, want), "0 differ, equal")
    rows = {}
    say(f"[accels] card: {gpu_line()}")
    flash.flash_intersect_kernel.launches = 0
    for name, scene in flat.items():
        fn = wavefront.build_pool_fn(scene, WIDTH, HEIGHT, SPP, BOUNCES,
                                     POOL)
        a = event()
        buf, segments = fn(scene.tables, scene.camera, SEED)
        b = event()
        sync(scene.device)
        ms = elapsed_ms(a, b)
        out = wavefront.render_pool(scene, WIDTH, HEIGHT, spp=SPP,
                                    max_bounce=BOUNCES, seed=SEED, pool=POOL)
        gate(f"{name}: pool of {POOL} lanes, full frame, bit for bit against "
             "the frame of phases 4-5", same_image(out, full_images[name]),
             same_image(out, full_images[name]), "True")
        rows[name] = {"pool": {"frame_ms": ms, "segments": int(segments),
                               "segments_per_s": int(segments) / (ms / 1e3),
                               "iterations": fn.iterations}}
        say(f"[accels] {name}, pool of {POOL}: {ms:.1f} ms a frame, "
            f"{fn.iterations} iterations, {int(segments)} segments")
    launches = flash.flash_intersect_kernel.launches
    for name in flat:
        for accel in ("dense", "cluster"):
            rows[name][accel] = timed_alt_frame(name, accel,
                                                alt[name, accel])
    return rows, launches


# --------------------------------------------------- phase 8: scale-out

# (world, the backend choose_backend must pick on a one-card machine)
SCALE_WORLDS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))
SCALE_FRAMES = 2
SPAWN_TIMEOUT_S = 300      # a hung rank fails the run, not its time limit
# The sharded step's learning rate. The update is lr * grad / n with
# n = 2.88 M (rays x channels); on the earth stand-in at 800x600, 2 spp a
# step at 5e5 raises the loss (texels seen by many rays overshoot), so 1e5,
# a factor 5 inside that edge.
TRAIN_LR = 1e5
TRAIN_INIT = 0.5


def one_process_rows(scene, frames=SCALE_FRAMES, *, width=WIDTH,
                     height=HEIGHT, spp=SPP, max_bounce=BOUNCES, seed=SEED):
    """The chunked driver's frame in this process: its stacked rows on the
    host (color, aov_normal, aov_hit; the frame's rows only) and segments,
    and ms a frame over `frames` frames (CUDA events); and, in turns with
    it, ms a frame of the sharded render in this process without a
    process group (world 1), which sets the sharded function's own cost
    apart from a rank's."""
    dev = scene.device
    fn, starts = renderer.compile_frame(scene, width, height, spp,
                                        max_bounce, aovs=True,
                                        driver="chunked", device=dev)
    sharded = make_sharded_render_fn(
        scene, make_ray_group(dev), width=width, height=height, spp=spp,
        max_bounce=max_bounce, seed=seed)
    ids = frame_ray_ids(width, height, spp, dev)
    total = width * height * spp
    ms, ms_sharded = [], []
    for _ in range(frames):
        for run, into in ((lambda: fn(scene.tables, scene.camera, seed,
                                      starts), ms),
                          (lambda: sharded(scene.tables, scene.camera, ids),
                           ms_sharded)):
            a = event(dev)
            out = run()
            b = event(dev)
            sync(dev)
            into.append(elapsed_ms(a, b))
    out = fn(scene.tables, scene.camera, seed, starts)
    rows = {"color": out.color.reshape(-1, 3)[:total].cpu().numpy(),
            "aov_normal": out.aov_normal.reshape(-1, 3)[:total].cpu().numpy(),
            "aov_hit": out.aov_hit.reshape(-1)[:total].cpu().numpy()}
    return rows, int(out.segments.sum()), ms, ms_sharded


def say_cold_start(label, spawned, colds):
    """Each rank's cold start, once: `spawned.startup` and the cold-start
    readings of each rank function the spawn ran (`colds`)."""
    for s, *c in zip(spawned.startup, *colds):
        say(f"[scale-out] {label}: rank {s['rank']} ({s['device']}) cold "
            f"start: spawn to entry (interpreter, torch, package) "
            f"{s['spawn_to_entry_s']:.3f} s, init_process_group "
            f"{s['init_process_group_s']:.3f} s, " + ", ".join(
                f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                for part in c for k, v in part.items()))


def plain_sgd_step(scene, target, learning_rate):
    """The training step in one process, without the sharded layer: the
    chunks' squared errors summed and differentiated
    (`optimize.chunked_value_and_grad`), then atlas - lr * grad / n
    (n = rays x channels)."""
    dev = scene.device
    total = OPT_W * OPT_H * OPT_SPP
    ids = torch.arange(total, device=dev)
    tgt = torch.as_tensor(target, device=dev)
    atlas = torch.full_like(scene.tables.atlas, TRAIN_INIT)
    intersect_fn = renderer.make_intersect_fn(scene)

    def ray_loss(leaves, c0, c1):
        out = renderer.render_chunk(
            scene.tables._replace(**leaves), scene.camera, ids[c0:c1],
            intersect_fn=intersect_fn, width=OPT_W, height=OPT_H,
            spp=OPT_SPP, max_bounce=OPT_BOUNCES, seed=SEED,
            features=scene.features)
        return torch.sum((out.color - tgt[c0:c1]) ** 2)

    loss, grads, _ = optimize.chunked_value_and_grad(
        ray_loss, {"atlas": atlas}, total, CHUNK)
    n = tgt.numel()
    return ((atlas - learning_rate * grads["atlas"] / n).cpu().numpy(),
            float(loss / n))


def phase_scale_out(scenes, device):
    """The sharded render of more_balls and the bunny stand-in at full
    width on 1 (nccl), 2 and 4 (gloo) processes on this card, bit for bit
    against the chunked driver's frame in this process; the sharded
    training step on the earth stand-in at 1 and 2 processes; the dry run
    on 2. Returns its readings and the kernel launches of the ranks'
    timed frames and steps."""
    say(f"[scale-out] card: {gpu_line()}; host cores {os.cpu_count()}")
    refs = {}
    for name in ("more_balls", "bunny_standin"):
        refs[name] = one_process_rows(scenes[name])
        say(f"[scale-out] {name}: 1 process (this process, in turns): "
            f"chunked driver ms/frame {[round(m, 2) for m in refs[name][2]]}"
            f"; sharded render without a process group ms/frame "
            f"{[round(m, 2) for m in refs[name][3]]}; segments "
            f"{refs[name][1]}")
    rows = {"one_process_ms": {n: r[2] for n, r in refs.items()},
            "one_process_sharded_fn_ms": {n: r[3] for n, r in refs.items()}}
    launches = 0
    with tempfile.TemporaryDirectory(prefix="potato_scale_") as assets:
        write_standin_assets(assets)
        write_earthmap(assets)
        render = partial(measure_render, scenes={
            "more_balls": (examples.more_balls, "flash"),
            "bunny_standin": (partial(examples.bunny, assets), "flash")},
            width=WIDTH, height=HEIGHT, spp=SPP, max_bounce=BOUNCES,
            seed=SEED, frames=SCALE_FRAMES)
        train = partial(measure_train_step,
                        make_scene=partial(examples.earth, assets),
                        width=OPT_W, height=OPT_H, spp=OPT_SPP,
                        max_bounce=OPT_BOUNCES, seed=SEED, steps=2,
                        learning_rate=TRAIN_LR, init=TRAIN_INIT)
        trained = {}
        for world, backend in SCALE_WORLDS:
            fns = [render, train] if world <= 2 else [render]
            t0 = time.perf_counter()
            got = launch.spawn(partial(launch.in_turn, fns=fns), world,
                               device=device, timeout_s=SPAWN_TIMEOUT_S)
            wall = time.perf_counter() - t0
            gate(f"world {world}: backend by the rule", got.backend,
                 got.backend == backend, backend)
            say(f"[scale-out] world {world} ({got.backend}, ranks on "
                f"{sorted(set(s['device'] for s in got.startup))}): spawn "
                f"to join {wall:.1f} s")
            res = got.result[0]
            say_cold_start(f"world {world}", got, [r["cold_start"]
                                                   for r in got.result])
            row = rows[f"world {world}"] = {"backend": got.backend}
            for name, r in res["scenes"].items():
                want, segments, one_ms, _ = refs[name]
                off = {f: int((r[f] != want[f]).reshape(len(want[f]), -1)
                              .any(-1).sum()) for f in want}
                gate(f"world {world}, {name}: sharded rows (color, "
                     "aov_normal, aov_hit) and segments bit-equal to the "
                     "1-process frame", f"rows off {off}, segments "
                     f"{r['segments']} / {segments}",
                     not any(off.values()) and r["segments"] == segments,
                     "0 off, equal")
                digest = renderer.scene_digest(scenes[name])
                gate(f"world {world}, {name}: scene digest of every rank "
                     "equals this process's", f"{len(set(r['digests']))} "
                     f"distinct over {world} ranks",
                     set(r["digests"]) == {digest}, "1, this process's")
                gate(f"world {world}, {name}: kernel launched on every rank",
                     r["launches"], min(r["launches"]) > 0, "> 0 each")
                launches += sum(r["launches"])
                sps = [segments / (m / 1e3) for m in r["frame_ms"]]
                say(f"[scale-out] world {world}, {name}: ms/frame "
                    f"{[round(m, 2) for m in r['frame_ms']]} (rank 0's "
                    "device clock, barrier to barrier), host s/frame "
                    f"{[round(h, 3) for h in r['host_s']]}, segments/s "
                    f"{[round(v) for v in sps]}; kernel launches by rank "
                    f"over {SCALE_FRAMES} frames {r['launches']} (sum "
                    f"{sum(r['launches'])}); 1 process: ms/frame "
                    f"{[round(m, 2) for m in one_ms]}")
                row[name] = {"frame_ms": r["frame_ms"], "host_s": r["host_s"],
                             "segments_per_s": sps,
                             "launches_by_rank": r["launches"]}
            row["cold_start"] = [dict(s, **c) for s, c in
                                 zip(got.startup, res["cold_start"])]
            if world <= 2:
                trained[world] = got.result[1]
        t0 = time.perf_counter()
        dry = launch.dryrun_multichip(2, device=device, assets_dir=assets,
                                      timeout_s=SPAWN_TIMEOUT_S)
        say(f"[scale-out] dryrun_multichip(2) in "
            f"{time.perf_counter() - t0:.1f} s: {dry}")
        earth = examples.earth(assets).build(accel="flash", device=device)
    rows["train"] = check_sharded_steps(earth, trained)
    for world, t in trained.items():
        launches += sum(t["launches"])
    rows["dryrun_multichip_2"] = dry
    return rows, launches


def check_sharded_steps(earth, trained):
    """Gates and readings of the sharded training step, worlds 1 and 2."""
    one, two = trained[1], trained[2]
    plain_atlas, plain_loss = plain_sgd_step(earth, one["target"], TRAIN_LR)
    a1 = one["atlas_after_first_step"]
    gate("train step, world 1: atlas' and loss bit-equal to the plain "
         "single-process SGD step", f"{int((a1 != plain_atlas).sum())} "
         f"texels differ, loss {one['losses'][0]!r} / {plain_loss!r}",
         np.array_equal(a1, plain_atlas) and one["losses"][0] == plain_loss,
         "0, equal")
    gate("train step: the target frame of world 2 equals world 1's",
         np.array_equal(two["target"], one["target"]),
         np.array_equal(two["target"], one["target"]), "True")
    d1 = a1.astype(np.float64) - TRAIN_INIT
    d2 = two["atlas_after_first_step"].astype(np.float64) - TRAIN_INIT
    rel_update = float(np.linalg.norm(d2 - d1) / np.linalg.norm(d1))
    rel_atlas = float(np.linalg.norm(d2 - d1)
                      / np.linalg.norm(a1.astype(np.float64)))
    # float32 summation order: world 2 sums two shares' chunk gradients
    # where world 1 sums one share's, and the ranks' sums once more
    gate("train step: world 2 against world 1 after one step, relative L2 "
         "of the update atlas' - init", f"{rel_update:.3e} (of atlas' "
         f"itself {rel_atlas:.3e}; |update| {np.linalg.norm(d1):.4g})",
         rel_update <= 1e-5 and np.linalg.norm(d1) > 0, "<= 1e-5, > 0")
    for world, t in trained.items():
        gate(f"train step, world {world}: loss falls over 2 steps at "
             f"learning rate {TRAIN_LR:g}", t["losses"],
             t["losses"][1] < t["losses"][0], "falls")
        gate(f"train step, world {world}: scene digest equal on every rank",
             len(set(t["digests"])), len(set(t["digests"])) == 1, "1")
        say(f"[scale-out] train step, world {world}, earth stand-in "
            f"{OPT_W}x{OPT_H}, {OPT_SPP} spp, {OPT_BOUNCES} bounces, SGD at "
            f"{TRAIN_LR:g} from {TRAIN_INIT}: losses {t['losses']}; s/step "
            f"{[round(s, 4) for s in t['step_s']]} (host clock, barrier to "
            f"barrier); rank 0 forward ms "
            f"{[round(m, 1) for m in t['forward_ms']]}, backward ms "
            f"{[round(m, 1) for m in t['backward_ms']]}, all-reduce ms "
            f"{[round(m, 2) for m in t['all_reduce_ms']]}; kernel launches "
            f"by rank over 2 steps {t['launches']}")
    return {w: {k: t[k] for k in ("losses", "step_s", "forward_ms",
                                  "backward_ms", "all_reduce_ms", "launches")}
            for w, t in trained.items()} | {
        "rel_l2_update_world2_vs_world1": rel_update,
        "learning_rate": TRAIN_LR}


# --------------------------------------------------- phase 9: the profilers

PROFILER_REPORTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "chiprun_out", "profilers")


def profiler_quick_forms(device):
    """(name, run) of each profiler of tools/ (tools/torch_*.py) in a quick
    form: at least one cell of each at the full frame (800x600, 4 spp, 8
    bounces; blocks and groups on a 2^15-ray chunk of it, whose bounce-1
    rays of more_balls start on the kernel's spheres)."""
    from tools import torch_perf_scenes, torch_profile_blocksize
    from tools import torch_profile_chunksize, torch_profile_depth
    from tools import torch_scaling_harness, torch_stats_clusters

    size = dict(width=WIDTH, height=HEIGHT, spp=SPP, seed=SEED)
    full = dict(size, max_bounce=BOUNCES)
    return [
        ("torch_profile_chunksize", partial(
            torch_profile_chunksize.run, ("bunny",), (CHUNK, 2 * CHUNK),
            ("compact",), frames=1, device=device, **full)),
        ("torch_profile_depth", partial(
            torch_profile_depth.run, ("bunny",), (1, BOUNCES), frames=1,
            device=device, **size)),
        ("torch_profile_blocksize", partial(
            torch_profile_blocksize.run, ("more_balls", "bunny"), (256, 512),
            frames=0, device=device, **full)),
        ("torch_stats_clusters", partial(
            torch_stats_clusters.run, ("more_balls", "bunny"), (64, 256),
            (16,), (512,), device=device, **size)),
        ("torch_scaling_harness", partial(
            torch_scaling_harness.run, (1, 2), ("bunny",), frames=1,
            trace=True, device=device, **full)),
        ("torch_perf_scenes", partial(
            torch_perf_scenes.run, ("three_balls", "more_balls_optimized"),
            frames=1, device=device, **full)),
    ]


def say_profiler(name, rep):
    """A few lines of a profiler's readings."""
    if name in ("torch_profile_chunksize", "torch_profile_depth"):
        for c in rep["cells"]:
            say(f"[profilers] {name}: {c['scene']}, {c['driver']}, chunk "
                f"{c['chunk_size']}, {c['max_bounce']} bounces: ms/frame "
                f"{[round(m, 2) for m in c['frame_ms']]}, launches/frame "
                f"{c['launches_per_frame']}, passes a bounce "
                f"{c['passes_per_bounce']}, peak MiB {c['peak_mib']}")
    elif name == "torch_profile_blocksize":
        for c in rep["cells"]:
            say(f"[profilers] {name}: {c['rays']}, R {c['block']}: queue "
                f"build {c['queue_build_ms']:.3f} ms, kernel "
                f"{c['kernel_ms']:.4f} ms, visits a block "
                f"{json.dumps(c['visits_per_block'])}")
    elif name == "torch_stats_clusters":
        for c in rep["groups"]:
            say(f"[profilers] {name}: {c['rays']}, group {c['group']}: rows "
                f"a CTA mean {c['rows_per_cta_mean']:.1f}, max "
                f"{c['rows_per_cta_max']:.0f} (max over mean "
                f"{c['max_over_mean']}), kernel {c['kernel_ms']:.4f} ms")
    elif name == "torch_scaling_harness":
        for world, row in rep["worlds"].items():
            for scene, r in row.items():
                if not isinstance(r, dict) or "frame_ms" not in r:
                    continue
                traces = r["traces"] or ()
                busy = [round(t["device_busy_share"] or 0.0, 4)
                        for t in traces]
                ms = [round(m, 2) for m in r["frame_ms"]]
                say(f"[profilers] {name}: world {world} ({row['backend']}),"
                    f" {scene}: ms/frame {ms}"
                    f", efficiency {r['efficiency']:.3f}; traced frame by "
                    f"rank: device busy share {busy}, host syncs "
                    f"{[t['host_syncs'] for t in traces]}")
    elif name == "torch_perf_scenes":
        for scene, r in rep["scenes"].items():
            say(f"[profilers] {name}: {scene} ({r['driver']}, sphere path "
                f"{r['sphere_path']}): segments/s {r['segments_per_s']:.0f}, "
                f"ms/frame {[round(m, 2) for m in r['frame_ms']]}")


def phase_profilers(device):
    """Each profiler's quick form on this card, every gate of its report
    enforced; the full reports are written to chiprun_out/profilers/.
    Returns per profiler its seconds, gates held and launches, and the
    kernel launches of the frames the profilers rendered (not those that
    hold the kernel against its plain version or time it alone)."""
    os.makedirs(PROFILER_REPORTS, exist_ok=True)
    rows, launches = {}, 0
    for name, run in profiler_quick_forms(device):
        t0 = time.perf_counter()
        rep = run()
        seconds = time.perf_counter() - t0
        with open(os.path.join(PROFILER_REPORTS, name + ".json"), "w") as f:
            json.dump(rep, f)
        gate(f"{name}: ran on the card", rep["device"]["name"],
             rep["device"]["type"] == "cuda",
             torch.cuda.get_device_name(0))
        for g in rep["gates"]:
            gate(f"{name}: {g['name']}", g["reading"], g["ok"], g["limit"])
        say_profiler(name, rep)
        say(f"[profilers] {name}: {seconds:.1f} s, {len(rep['gates'])} "
            f"gates held, {rep['launches']} kernel launches in its frames")
        launches += rep["launches"]
        rows[name] = {"seconds": seconds, "gates": len(rep["gates"]),
                      "launches": rep["launches"]}
    for name in ("torch_profile_chunksize", "torch_profile_depth",
                 "torch_scaling_harness", "torch_perf_scenes"):
        gate(f"{name}: kernel launched in its frames",
             rows[name]["launches"], rows[name]["launches"] > 0, "> 0")
    return rows, launches


def ptxas_summary(log: str) -> dict:
    """Over the kernels of the build (one per slice count): the most
    registers and static shared memory, and all spill bytes, from what
    `nvcc -Xptxas -v` printed."""
    def numbers(pattern):
        return [int(x) for x in re.findall(pattern, log)]

    spills = numbers(r"(\d+) bytes spill stores") + \
        numbers(r"(\d+) bytes spill loads")
    return {"registers": max(numbers(r"Used (\d+) registers"), default=None),
            "shared_bytes": max(numbers(r"(\d+) bytes smem"), default=None),
            "spill_bytes": sum(spills) if spills else None}


# -------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel-only", action="store_true",
                    help="build and check the kernel, then stop")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one chunk of each scene with "
                         "torch.profiler (device busy share, top kernels)")
    opts = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda")
    card = gpu_line()
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    info = flash.load_kernel_library()
    say(f"[build] {KERNEL_SOURCE} -> {info['path']} in "
        f"{info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            say("[build]", line.strip())
    ptxas = ptxas_summary(info["log"])
    rays_per_thread = flash._library().flash_intersect_rays_per_thread()
    say(f"[build] {rays_per_thread} rays a thread, default group "
        f"{flash.resolve_group(flash.R)} of blocks of {flash.R}: {ptxas}")
    gate("ptxas reports no spills", ptxas["spill_bytes"],
         ptxas["spill_bytes"] == 0, "0 bytes")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="potato_assets_") as assets:
        mesh = write_standin_assets(assets)
        for f in ("bunny.obj", "bunny_flat.obj"):
            check_loaded_mesh(f, os.path.join(assets, f), mesh)
        scenes = {name: make(assets).build(accel="flash", device=device)
                  for name, make in SCENES.items()}
        glass = examples.glass_bunny(assets).build(accel="flash",
                                                   device=device)
        # phase 7's builds of the same three scenes on the other accels
        makers = {"more_balls": examples.more_balls,
                  "bunny_standin": lambda: examples.bunny(assets),
                  "glass_standin": lambda: examples.glass_bunny(assets)}
        alt = {(name, accel): make().build(accel=accel, device=device)
               for name, make in makers.items()
               for accel in ("dense", "cluster")}
        write_earthmap(assets)
        earth = examples.earth(assets).build(accel="flash", device=device)
    say(f"[scenes] built in {time.perf_counter() - t0:.1f} s: " + ", ".join(
        f"{n}: {s.num_spheres} spheres, {s.num_triangles} triangles"
        for n, s in scenes.items()))

    max_abs_err = phase_kernel_checks(scenes)
    if opts.kernel_only:
        say("kernel-only run: stopped after the kernel checks")
        return 0

    results, launches = phase_main_path(scenes)
    if opts.profile:
        for name, scene in scenes.items():
            profile_chunk(name, scene)

    # the default driver of every scene and the CLI: counted on their own
    flash.flash_intersect_kernel.launches = 0
    t0 = time.perf_counter()
    driver_rows, images = phase_default_driver(
        {"more_balls": scenes["more_balls"], "glass_standin": glass,
         "bunny_standin": scenes["bunny_standin"]}, results)
    phase_cli(images["more_balls"])
    phase_checkpoint(scenes["more_balls"])
    launches_default = flash.flash_intersect_kernel.launches
    compact_launches = sum(sum(r["compact"]["launches"])
                           for r in driver_rows.values())
    gate("kernel launches of the compact driver's timed frames",
         compact_launches, compact_launches >= 3 * len(driver_rows),
         f">= {3 * len(driver_rows)}")
    say(f"[drivers] phase in {time.perf_counter() - t0:.1f} s, "
        f"{launches_default} kernel launches")

    # phase 6, the differentiable path: counted on its own
    t0 = time.perf_counter()
    diff_rows, launches_diff = phase_differentiable(
        {**scenes, "three_balls": examples.three_balls().build(
            accel="flash", device=device)}, earth)
    say(f"[diff] phase in {time.perf_counter() - t0:.1f} s")

    # phase 7: dense, cluster and the pool; the pool's frames counted
    t0 = time.perf_counter()
    phase_accel_gates(scenes, alt)
    full_images = {"more_balls": results["more_balls"]["chunked_out"],
                   "bunny_standin": results["bunny_standin"]["chunked_out"],
                   "glass_standin": images["glass_standin"]}
    accel_rows, launches_pool = phase_pool_and_frames(scenes, glass, alt,
                                                      full_images)
    gate("kernel launches of the pool's frames", launches_pool,
         launches_pool > 0, "> 0")
    say(f"[accels] phase in {time.perf_counter() - t0:.1f} s, "
        f"{launches_pool} kernel launches")

    # phase 8: scale-out; the launches of the ranks' timed frames and steps
    t0 = time.perf_counter()
    scale_rows, launches_sharded = phase_scale_out(scenes, device)
    gate("kernel launches on the sharded path", launches_sharded,
         launches_sharded > 0, "> 0")
    say(f"[scale-out] phase in {time.perf_counter() - t0:.1f} s, "
        f"{launches_sharded} kernel launches in the ranks")

    # phase 9: the profilers (tools/torch_*.py), quick forms; the launches
    # of their frames, this process's and the ranks'
    t0 = time.perf_counter()
    flash.flash_intersect_kernel.launches = 0
    profiler_rows, launches_profilers = phase_profilers(device)
    say(f"[profilers] phase in {time.perf_counter() - t0:.1f} s, "
        f"{launches_profilers} kernel launches in their frames")

    rows = [r for res in results.values() for r in res["rows"]]
    bound_ms = float(np.mean([r["bound"]["ms"] for r in rows]))
    by_ops = float(np.mean([r["bound"]["ops_ms"] for r in rows])) >= \
        float(np.mean([r["bound"]["bytes_ms"] for r in rows]))
    kernels = {"kernels": [{
        "name": "flash_intersect",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches + launches_default + launches_diff
        + launches_pool + launches_sharded + launches_profilers,
        "launches_by_path": {
            "main path (chunked, forced)": launches,
            "default driver of each scene, CLI, checkpoint":
                launches_default,
            "differentiable path (optimize_textures, earth and more_balls)":
                launches_diff,
            "pool driver, one frame of each scene": launches_pool,
            "sharded": launches_sharded,
            "profilers (tools/torch_*.py, quick forms)": launches_profilers},
        "max_abs_err": max_abs_err,
        "ms": float(np.mean([r["ms"] for r in rows])),
        "plain_ms": float(np.mean([r["plain_ms"] for r in rows])),
        "bound_ms": bound_ms,
        "bound_by": "operations" if by_ops else "bytes",
        "library_ms": None,
        "group": flash.resolve_group(flash.R),
        "rays_per_thread": rays_per_thread,
        **ptxas,
        "ms_by_group": {g: float(np.mean([r["ms_by_group"][g] for r in rows]))
                        for g in flash.GROUPS},
        "enqueue_ms": float(np.mean([r["enqueue_ms"] for r in rows])),
        "pairs_tested": {k: sum(r["bound"]["pairs"][k] for r in rows)
                         for k in ("tri", "sph")},
        "pairs_that_can_hit": {k: sum(r["bound"]["can_hit"][k] for r in rows)
                               for k in ("tri", "sph")},
        "first_design_bound_ms": float(np.mean([r["bound"]["first_ms"]
                                                for r in rows])),
        "pairs_at_block_granularity": {
            k: sum(r["bound"]["pairs_at_block"][k] for r in rows)
            for k in ("tri", "sph")},
        "timed_on": "the launches of the middle chunk of one frame of each "
                    "scene (camera pass and bounce passes), "
                    f"{CHUNK} rays each",
        "per_scene": {
            name: {
                "launches_per_frame": res["launches_per_frame"],
                "frame_ms": res["frame_ms"],
                "segments_per_s": [s / (m / 1e3) for s, m in
                                   zip(res["segments"], res["frame_ms"])],
                "kernel_mean_ms_in_frame": res["kernel_mean_ms_in_frame"],
                "phase_shares": res["shares"],
                "frame_visits": res["frame_visits"],
                "ms": [r["ms"] for r in res["rows"]],
                "enqueue_ms": [r["enqueue_ms"] for r in res["rows"]],
                "plain_ms": [r["plain_ms"] for r in res["rows"]],
                "bound_ms": [r["bound"]["ms"] for r in res["rows"]],
            } for name, res in results.items()},
    }]}
    kernels["kernels"][0]["differentiable_path"] = diff_rows
    kernels["kernels"][0]["accelerators_and_pool"] = accel_rows
    kernels["kernels"][0]["scale_out"] = scale_rows
    kernels["kernels"][0]["profilers"] = profiler_rows
    per_scene = kernels["kernels"][0]["per_scene"]
    for name, by_driver in driver_rows.items():
        per_scene.setdefault(name, {})["drivers"] = {
            d: {k: by_driver[d][k] for k in (
                "frame_ms", "segments_per_s", "launches",
                "passes_per_bounce", "host_syncs")} for d in DRIVERS}
    say(f"[done] {time.perf_counter() - t_start:.0f} s in all")
    say(card)
    say(json.dumps(kernels))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
