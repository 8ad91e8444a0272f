#!/usr/bin/env python3
"""Visit statistics of the flash kernel on the card: the work of each
termination group, and the sub-clusters a block of rays enters.

    python3 tools/torch_stats_clusters.py                    # full run
    python3 tools/torch_stats_clusters.py --device cpu --width 16 \
        --height 16 --spp 1 --rays 256                       # rehearsal

The port's counterpart of tools/stats_clusters.py, on the middle chunk of
a frame (`--rays` ids, 2^15 by default): its camera rays and the rays one
bounce step (render/integrator.py::make_bounce_step) sends on, of each
scene, in queue blocks of flash.R rays.

(a) Per termination group (the rays one CTA of the kernel takes, 32 to
    512): the kernel's own `visits` output ((Bp // group, 3): sphere
    clusters, packed children, tail parents), gated equal to
    flash_intersect_plain(..., group=)'s, with the outputs equal to the
    default group's bit for bit. A CTA's rows of primitives are W a child
    and K a parent or sphere cluster, every ray of the group tests each
    row, so rows stand for its time: the longest CTA against the mean of
    the launch, percentiles, and the kernel's device ms at that group.
(b) The reference's table, in numpy on the host: for sub-cluster widths W
    and blocks of RS consecutive rays, how many W-wide sub-clusters of the
    scene's triangles (longest-axis median split, `hier_split`) a block
    enters (`slab_entered`), the pairs a ray then tests, and packed
    128-lane visits a block. K and W stay compile-time constants of the
    kernel (csrc/flash_intersect.cu): the W sweep is statistics only.
"""

from __future__ import annotations

import os
import sys

if os.path.dirname(os.path.abspath(__file__)) not in sys.path:
    sys.path.append(os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_common import (  # noqa: E402
    Gates, asset_dir, assets_label, build_scenes, chunk_rays, device_of,
    emit, frame_args, ints, launch_ms, names, parser, report)

from chip_smoke import kernel_args, run_both  # noqa: E402
from potato_tpu_torch.ops import flash  # noqa: E402

SCENES = ("more_balls", "glass_bunny", "bunny")
GROUPS = (32, 64, 128, 256, 512)
WIDTHS = (16, 32, 64, 128)
BLOCK_RAYS = (128, 256, 512)
RAYS = 1 << 15


# ---- (b): numpy, as tools/stats_clusters.py computes it

def hier_split(pmin, pmax, leaf):
    """Recursive longest-axis median split to exact `leaf`-size chunks.
    Returns the permutation (hierarchical order)."""
    n = pmin.shape[0]
    centroid = 0.5 * (pmin + pmax)
    chunks = []

    def split(idx, nc):
        if nc == 1:
            chunks.append(idx)
            return
        cen = centroid[idx]
        axis = int(np.argmax(cen.max(axis=0) - cen.min(axis=0)))
        left_c = nc // 2
        k = left_c * leaf
        part = np.argpartition(cen[:, axis], k)
        split(idx[part[:k]], left_c)
        split(idx[part[k:]], nc - left_c)

    split(np.arange(n, dtype=np.int64), max((n + leaf - 1) // leaf, 1))
    return np.concatenate(chunks)


def cluster_aabbs(pmin, pmax, order, w):
    """The boxes of `w` consecutive primitives in `order` (the last one
    padded with empty boxes)."""
    n = order.shape[0]
    c = (n + w - 1) // w
    pad = c * w - n
    bmin = np.concatenate([pmin[order], np.full((pad, 3), np.inf)])
    bmax = np.concatenate([pmax[order], np.full((pad, 3), -np.inf)])
    return bmin.reshape(c, w, 3).min(1), bmax.reshape(c, w, 3).max(1)


def slab_entered(o, d, tmin, tmax, cmin, cmax):
    """(B,) rays x (C,) boxes -> (B, C) entered bool."""
    lo = np.broadcast_to(tmin[:, None], (o.shape[0], cmin.shape[0])).copy()
    hi = np.broadcast_to(tmax[:, None], lo.shape).copy()
    for a in range(3):
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d[:, a]
            t0 = (cmin[None, :, a] - o[:, a, None]) * inv[:, None]
            t1 = (cmax[None, :, a] - o[:, a, None]) * inv[:, None]
        near = np.fmin(t0, t1)   # fmin/fmax ignore NaN
        far = np.fmax(t0, t1)
        lo = np.fmax(lo, near)
        hi = np.fmin(hi, far)
    return hi >= lo


def entered_table(tables, num_triangles, rays, widths, block_rays):
    """Rows of (W, RS): sub-clusters (C in all) a block of RS rays enters,
    mean and most; pairs a ray tests (entered x W); packed 128-lane visits
    a block, mean and most."""
    t = num_triangles
    pa, pb, pc = (getattr(tables, f)[:t].cpu().numpy().astype(np.float64)
                  for f in ("tri_pa", "tri_pb", "tri_pc"))
    tri_min = np.minimum(np.minimum(pa, pb), pc)
    tri_max = np.maximum(np.maximum(pa, pb), pc)
    order = hier_split(tri_min, tri_max, 16)
    o, d, tmin, tmax = (f.cpu().numpy().astype(np.float32) for f in rays)
    rows = []
    for w in widths:
        cmin, cmax = cluster_aabbs(tri_min, tri_max, order, w)
        ent = slab_entered(o, d, tmin, tmax, cmin, cmax)
        for rs in block_rays:
            nb = o.shape[0] // rs
            if nb == 0:
                continue
            cnt = ent[:nb * rs].reshape(nb, rs, -1).any(axis=1).sum(axis=1)
            packed = np.ceil(cnt * w / 128)
            rows.append({"W": w, "RS": rs, "clusters": int(cmin.shape[0]),
                         "entered_per_block": float(cnt.mean()),
                         "pairs_per_ray": float(cnt.mean() * w),
                         "packed_visits_per_block": float(packed.mean()),
                         "max_entered": int(cnt.max()),
                         "max_packed": int(packed.max())})
    return rows


# ---- (a): the kernel's visits per termination group

def group_rows(gates, label, scene, rays, groups):
    """At each group: the kernel's visits per CTA (gated equal to the
    plain version's; outputs gated equal to the default group's), the
    distribution of rows a CTA visits, and the kernel's ms a launch."""
    inp = flash.prepare_flash(scene.accel, scene.tables, rays)
    default, _, _, _ = run_both(scene, inp)
    rows = []
    for g in groups:
        got, _, vk, vp = run_both(scene, inp, g)
        same = all(torch.equal(a, b) for a, b in zip(got, default))
        gates(f"{label}, group {g}: kernel visits equal to the plain "
              "version's, outputs equal to the default group's",
              f"{int((vk != vp).sum())} differ, outputs equal {same}",
              torch.equal(vk, vp) and same, "0 differ, True")
        sph, children, tail = vk.long().unbind(-1)
        per_cta = (children * flash.W + (tail + sph) * flash.K).double()
        busy = per_cta[per_cta > 0]
        args = kernel_args(scene, inp)
        mean = float(per_cta.mean())
        rows.append({
            "rays": label, "group": g, "ctas": per_cta.numel(),
            "ctas_with_work": busy.numel(),
            "rows_per_cta_mean": mean,
            "rows_per_cta_max": float(per_cta.max()),
            "max_over_mean": float(per_cta.max()) / mean if mean else None,
            "rows_per_cta_p50_p90_p99": [
                float(x) for x in torch.quantile(
                    per_cta, torch.tensor([0.5, 0.9, 0.99],
                                          dtype=per_cta.dtype,
                                          device=per_cta.device))],
            "visits": {"sphere_clusters": int(sph.sum()),
                       "children": int(children.sum()),
                       "tail_parents": int(tail.sum())},
            "kernel_ms": launch_ms(
                lambda: flash.flash_intersect_kernel(*args, group=g),
                scene.device)})
    return rows


def run(scenes=SCENES, groups=GROUPS, widths=WIDTHS, block_rays=BLOCK_RAYS,
        *, rays=RAYS, width=800, height=600, spp=4, seed=7, assets=None,
        device="cuda") -> dict:
    """(a) and (b) on each scene's camera and bounce-1 rays. Returns the
    report (groups, entered, gates)."""
    dev = device_of(device)
    gates = Gates()
    by_group, entered = [], []
    with asset_dir(assets) as adir:
        built = build_scenes(scenes, adir, dev)
    for name, scene in built.items():
        for bounce in (0, 1):
            batch, live = chunk_rays(scene, width=width, height=height,
                                     spp=spp, seed=seed, n=rays,
                                     bounce=bounce)
            label = f"{name}, {'bounce-1' if bounce else 'camera'} rays"
            for row in group_rows(gates, label, scene, batch, groups):
                by_group.append({"scene": name, "live_share": live, **row})
            if scene.num_triangles and widths:
                for row in entered_table(scene.tables, scene.num_triangles,
                                         batch, widths, block_rays):
                    entered.append({"scene": name, "rays": label, **row})
    return report("torch_stats_clusters", dev, gates,
                  workload=dict(width=width, height=height, spp=spp,
                                seed=seed, rays=rays,
                                block=flash.R, K=flash.K, W=flash.W,
                                assets=assets_label(assets)),
                  groups=by_group, entered=entered, launches=0)


def main(argv=None) -> int:
    ap = parser(__doc__, depth=False)
    ap.add_argument("--scenes", type=names, default=list(SCENES))
    ap.add_argument("--groups", type=ints, default=list(GROUPS))
    ap.add_argument("--widths", type=ints, default=list(WIDTHS),
                    help="sub-cluster widths W of table (b)")
    ap.add_argument("--block-rays", type=ints, default=list(BLOCK_RAYS),
                    help="rays a block RS of table (b)")
    ap.add_argument("--rays", type=int, default=RAYS)
    opts = ap.parse_args(argv)
    return emit(run(opts.scenes, opts.groups, opts.widths, opts.block_rays,
                    rays=opts.rays, assets=opts.assets, device=opts.device,
                    **frame_args(opts)))


if __name__ == "__main__":
    sys.exit(main())
