"""Flash intersector: two-level hierarchical block traversal.

A per-ray recursive BVH walk is pointer chasing; here the walk is split
into phases, each done where it is cheap:

1. **Two-level cluster hierarchy** (host, numpy). Primitives are
   median-split into parent clusters of K=128, and each parent into 8
   children of W=16, the leaf granularity that sets pair-test volume.

2. **Queues, one list per block of R rays** (tensor ops). A dense per-ray
   slab test marks the parent clusters any ray of the block enters; a
   conservative interval slab of the block's ray bundle (origin box x
   direction box x t range) refines entered parents to child granularity.
   The nearest children, front to back, fill the packed visits; parents
   owning children beyond that capacity are visited whole afterwards
   (the tail), where early termination usually skips them.

3. **The kernel** (`csrc/flash_intersect.cu`, one CTA per termination
   group of `group` consecutive rays of a block, a few rays per thread)
   drains the block's queues: sphere clusters first, then packed child
   visits, then tail parents, keeping each ray's running best in
   registers. A visit whose entry distance is beyond the best of every
   live ray of the group is skipped, and because queues are sorted by
   entry, the first skip ends the phase. `flash_intersect_plain` is the
   same function in tensor ops.

4. **Epilogue** (tensor ops): merge sphere and triangle winners, gather one
   shade row per ray, re-derive barycentrics for the winning triangle only.

Small sphere sets (<= SPH_BRUTE_MAX) never enter the kernel: an exact
dense test resolves them and folds their bound into t_max before the queue
build, so clusters behind the nearest sphere are never visited. Larger
sets keep the SPH_BRUTE_MAX largest spheres on that path and send the rest
through the kernel's sphere phase.

Triangle pair tests run the watertight bilinear edge-function form (det !=
0 acceptance) rather than ops/intersect.py's Cramer form with its SMOL
cutoff, so agreement with the brute-force oracle is at the ~0.5 % level on
degenerate-adjacent rays, not bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from potato_tpu_torch.core import math as pmath
from potato_tpu_torch.core.types import BIG, HitBatch, RayBatch, resolve_device
from potato_tpu_torch.ops.intersect import sphere_hit_t

# Starting values; only DEFAULT_GROUP was chosen on the H100 (PERF.md).
R = 512        # rays per queue block (a launch parameter)
DEFAULT_GROUP = 64    # rays per CTA of the kernel: the termination group
GROUPS = (64, 128, 256, 512)   # the groups the card is measured at
K = 128        # primitives per parent cluster
W = 16         # primitives per child cluster
CPP = K // W   # children per parent
TOP_P = 2      # packed-visit capacity per block, in parents' worth of
               # children; overflow goes to whole-parent tail visits
SPH_BRUTE_MAX = 16   # sphere count at/below which spheres skip the kernel
RAY_COLS = 8   # o(3) d(3) tmin tmax;  m = d x o is derived in the kernel
# watertight edge-function features: gU eU gV eV gW eW (3 each) n(3)
# corner a(3) = columns 0..23; column 24 = global primitive slot (f32);
# padded to 32 columns (one 128-byte row)
F_ROWS = 32
SLOT_ROW = 24
SPH_FEATURES = 8      # c(3) r^2(1) valid(1) pad(3)


class FlashAccel(NamedTuple):
    """Two-level cluster tables + AABBs (device tensors)."""

    tri_flat: torch.Tensor     # (Cp*K + W, F_ROWS) f32, fine (child) order,
                               # + W all-zero rows: the sentinel child that
                               # fills unused packed slots (det 0, never wins)
    tri_perm: torch.Tensor     # (Cp*K,) int32 fine slot -> original tri id
    tri_cmin: torch.Tensor     # (Cp,3) f32 parent AABBs
    tri_cmax: torch.Tensor     # (Cp,3)
    tri_cmin16: torch.Tensor   # (Cp*CPP,3) f32 child AABBs
    tri_cmax16: torch.Tensor   # (Cp*CPP,3)
    sph_feats: torch.Tensor    # (Cs*K, SPH_FEATURES) f32, cluster-ordered
    sph_perm: torch.Tensor     # (Cs*K,) int32
    sph_cmin: torch.Tensor     # (Cs,3)
    sph_cmax: torch.Tensor     # (Cs,3)
    # hybrid sphere split (scenes with > SPH_BRUTE_MAX spheres): the
    # SPH_BRUTE_MAX LARGEST spheres are always resolved by the exact dense
    # test and their bound folded into t_max BEFORE the queue build, so a
    # huge ground sphere culls every cluster behind it. Only the remaining
    # (small) spheres live in kernel clusters.
    sph_brute: torch.Tensor         # (SB,) int32 original sphere ids
    sph_brute_center: torch.Tensor  # (SB,3) f32
    sph_brute_radius: torch.Tensor  # (SB,) f32
    # unified shade table (one row gather per ray in the epilogue):
    # tri rows [na nb nc | ua ub uc | pa pb pc | mat] then sphere rows
    # [center radius 0...| mat]; sphere rows in ORIGINAL table order when
    # all spheres take the dense path, sph_perm order (then the brute set)
    # otherwise.
    shade: torch.Tensor        # (Cp*K + Ssh, 25) f32
    world_min: torch.Tensor    # (3,) f32 scene bounds
    world_max: torch.Tensor    # (3,)
    num_triangles: int
    num_spheres: int


# ------------------------------------------------------- host-side build

def _median_split_order(pmin: np.ndarray, pmax: np.ndarray, leaf: int):
    """Recursive longest-axis median split into exact `leaf`-size chunks
    (the last chunk may be short). Returns the permutation."""
    n = pmin.shape[0]
    centroid = (0.5 * (pmin + pmax)).astype(np.float32)
    chunks = []

    def split(idx: np.ndarray, nc: int):
        if nc == 1:
            chunks.append(idx)
            return
        cen = centroid[idx]
        axis = int(np.argmax(cen.max(axis=0) - cen.min(axis=0)))
        left_c = nc // 2
        k = left_c * leaf  # left side gets exactly left_c full chunks
        part = np.argpartition(cen[:, axis], k)
        split(idx[part[:k]], left_c)
        split(idx[part[k:]], nc - left_c)

    split(np.arange(n, dtype=np.int32), max((n + leaf - 1) // leaf, 1))
    return np.concatenate(chunks).astype(np.int32)


def _aabbs_of(pmin, pmax, order, width, total):
    """(C, 3) AABBs of `width`-wide chunks of the padded order; padding
    slots (order shorter than total) contribute empty boxes."""
    n = order.shape[0]
    bmin = np.concatenate(
        [pmin[order], np.full((total - n, 3), np.inf, np.float32)])
    bmax = np.concatenate(
        [pmax[order], np.full((total - n, 3), -np.inf, np.float32)])
    c = total // width
    cmin = np.nan_to_num(bmin.reshape(c, width, 3).min(axis=1), posinf=3e38)
    cmax = np.nan_to_num(bmax.reshape(c, width, 3).max(axis=1), neginf=-3e38)
    return cmin.astype(np.float32), cmax.astype(np.float32)


def _hier_cluster(pmin: np.ndarray, pmax: np.ndarray):
    """Hierarchical order: parents of K, each split into CPP children of W.

    Parent p owns fine slots [p*K, (p+1)*K); child c owns [c*W, (c+1)*W).
    Only the LAST parent can be short (global padding sits at the end), so
    the alignment invariants hold for every parent/child.
    Returns (order, total_slots, parent cmin/cmax, child cmin/cmax).
    """
    n = pmin.shape[0]
    order = _median_split_order(pmin, pmax, K)
    refined = []
    for p in range(0, n, K):
        chunk = order[p:p + K]
        sub = _median_split_order(pmin[chunk], pmax[chunk], W)
        refined.append(chunk[sub])
    order = np.concatenate(refined).astype(np.int32) if refined else order
    cp = max((n + K - 1) // K, 1)
    total = cp * K
    cmin, cmax = _aabbs_of(pmin, pmax, order, K, total)
    cmin16, cmax16 = _aabbs_of(pmin, pmax, order, W, total)
    return order, total, cmin, cmax, cmin16, cmax16


def build_flash_accel(tables, num_spheres: int, num_triangles: int,
                      device="cuda") -> FlashAccel:
    """Host-side (cold path) build in vectorized numpy, uploaded once.
    `tables` is a SceneTables of numpy arrays or of tensors."""
    device = resolve_device(device)

    def host(name, dtype):
        a = getattr(tables, name)
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
        return np.asarray(a, dtype)

    # --- triangles ---
    T = num_triangles
    pa = host("tri_pa", np.float64)[:T].reshape(-1, 3)
    pb = host("tri_pb", np.float64)[:T].reshape(-1, 3)
    pc = host("tri_pc", np.float64)[:T].reshape(-1, 3)
    if T == 0:  # degenerate placeholder (never hit: n = 0 -> det 0)
        pa = pb = pc = np.zeros((1, 3))
        T = 1
    tri_min = np.minimum(np.minimum(pa, pb), pc).astype(np.float32)
    tri_max = np.maximum(np.maximum(pa, pb), pc).astype(np.float32)
    order, total, tri_cmin, tri_cmax, tri_cmin16, tri_cmax16 = \
        _hier_cluster(tri_min, tri_max)
    tri_perm = np.concatenate(
        [order, np.zeros(total - order.shape[0], np.int32)])

    tf = np.zeros((F_ROWS, total), np.float64)
    pa_o, pb_o, pc_o = pa[order], pb[order], pc[order]
    # Watertight Moller-Trumbore in bilinear form: the Woop 2013 sheared
    # 2D edge function for edge (P, Q) equals (up to a positive per-ray
    # scale) U = d.(P x Q) + (d x o).(P - Q), a dot of per-ray [d, m] with
    # per-triangle [P x Q, P - Q]. Two triangles sharing an edge traverse
    # it in opposite directions, and these features are EXACT negations in
    # f64 (and stay so through the f32 cast), so the kernel's U values are
    # exact floating-point negations even under FMA contraction: the
    # watertight no-leak guarantee without any per-ray shear frame.
    # Padding slots are all-zero: U = V = W = 0 exactly => det 0, rejected.
    nt = order.shape[0]
    ba = pa_o - pb_o
    ca = pa_o - pc_o
    n = np.cross(ba, ca)
    tf[0:3, :nt] = np.cross(pc_o, pb_o).T      # gU, edge (c, b): weights pa
    tf[3:6, :nt] = (pc_o - pb_o).T             # eU
    tf[6:9, :nt] = np.cross(pa_o, pc_o).T      # gV, edge (a, c): weights pb
    tf[9:12, :nt] = (pa_o - pc_o).T            # eV
    tf[12:15, :nt] = np.cross(pb_o, pa_o).T    # gW, edge (b, a): weights pc
    tf[15:18, :nt] = (pb_o - pa_o).T           # eW
    tf[18:21, :nt] = n.T                       # plane normal (for t)
    tf[21:24, :nt] = pa_o.T                    # corner a (for t)
    # column SLOT_ROW carries each row's global fine slot as f32, so a
    # visit reads the winning slot along with the features
    tf[SLOT_ROW, :] = np.arange(total, dtype=np.float64)
    tf = np.ascontiguousarray(tf.astype(np.float32).T)   # (total, F_ROWS)
    # + W all-zero rows: the sentinel child (id = total // W)
    tf = np.concatenate([tf, np.zeros((W, F_ROWS), np.float32)])

    # --- spheres (single-level clusters of K) ---
    S = num_spheres
    c = host("s_center", np.float64)[:S].reshape(-1, 3)
    r = host("s_radius", np.float64)[:S].reshape(-1)
    if S == 0:
        c = np.zeros((1, 3))
        r = np.zeros((1,))
        S = 1
    if num_spheres > SPH_BRUTE_MAX:
        # hybrid split: the SPH_BRUTE_MAX largest spheres go to the exact
        # dense path (stable order by descending radius); the rest stay in
        # kernel clusters
        by_radius = np.argsort(-np.abs(r), kind="stable")
        brute_ids = np.sort(by_radius[:SPH_BRUTE_MAX]).astype(np.int32)
        kern_ids = np.sort(by_radius[SPH_BRUTE_MAX:]).astype(np.int32)
    else:
        brute_ids = np.zeros((0,), np.int32)
        kern_ids = np.arange(S, dtype=np.int32)
    ck = c[kern_ids]
    rk = r[kern_ids]
    r3 = np.abs(rk)[:, None].astype(np.float32)
    smin = ck.astype(np.float32) - r3
    smax = ck.astype(np.float32) + r3
    sorder = _median_split_order(smin, smax, K)
    stotal = max((kern_ids.shape[0] + K - 1) // K, 1) * K
    sph_cmin, sph_cmax = _aabbs_of(smin, smax, sorder, K, stotal)
    sph_perm = np.concatenate(
        [kern_ids[sorder],
         np.zeros(stotal - sorder.shape[0], np.int32)]).astype(np.int32)
    sf = np.zeros((SPH_FEATURES, stotal), np.float64)
    c_o, r_o = ck[sorder], rk[sorder]
    ns = sorder.shape[0]
    sf[0:3, :ns] = c_o.T
    # r^2 rounded as float32 r * r, as the dense test and the reference
    # square the table's float32 radius
    r32 = r_o.astype(np.float32)
    sf[3, :ns] = r32 * r32
    sf[4, :ns] = 1.0  # validity flag (pad spheres invalid)

    # The triangle table carries each slot as an f32 column; slots above
    # 2^24 are not exactly representable and would shade the wrong
    # primitive.
    if total >= (1 << 24) or stotal >= (1 << 24):
        raise ValueError(
            "flash intersector carries primitive slots in f32: "
            f"padded counts (tris {total}, spheres {stotal}) "
            "must stay below 2^24")

    wmin = np.minimum(tri_cmin.min(0), sph_cmin.min(0))
    wmax = np.maximum(tri_cmax.max(0), sph_cmax.max(0))

    # --- baked unified shade table (see FlashAccel.shade) ---
    tpm = tri_perm

    def g(name):
        return host(name, np.float32)

    tri_shade = np.concatenate([
        g("tri_na")[tpm], g("tri_nb")[tpm], g("tri_nc")[tpm],
        g("tri_ua")[tpm], g("tri_ub")[tpm], g("tri_uc")[tpm],
        g("tri_pa")[tpm], g("tri_pb")[tpm], g("tri_pc")[tpm],
        g("tri_material")[tpm][:, None]], axis=1)
    if num_spheres <= SPH_BRUTE_MAX:
        spm = np.arange(g("s_center").shape[0])
    else:
        # kernel-ordered rows [0, stotal), then the brute set's rows
        spm = np.concatenate(
            [kern_ids[sorder],
             np.zeros(stotal - sorder.shape[0], np.int32),
             brute_ids]).astype(np.int32)
    sph_shade = np.concatenate([
        g("s_center")[spm], g("s_radius")[spm][:, None],
        np.zeros((spm.shape[0], 20), np.float32),
        g("s_material")[spm][:, None]], axis=1)
    shade = np.concatenate([tri_shade, sph_shade], axis=0)

    def up(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=device).contiguous()

    f32, i32 = np.float32, np.int32
    return FlashAccel(
        tri_flat=up(tf, f32),
        tri_perm=up(tri_perm, i32),
        tri_cmin=up(tri_cmin, f32), tri_cmax=up(tri_cmax, f32),
        tri_cmin16=up(tri_cmin16, f32), tri_cmax16=up(tri_cmax16, f32),
        sph_feats=up(sf.T, f32),
        sph_perm=up(sph_perm, i32),
        sph_cmin=up(sph_cmin, f32), sph_cmax=up(sph_cmax, f32),
        sph_brute=up(brute_ids, i32),
        sph_brute_center=up(c[brute_ids], f32),
        sph_brute_radius=up(r[brute_ids], f32),
        shade=up(shade, f32),
        world_min=up(np.nan_to_num(wmin, posinf=0.0), f32),
        world_max=up(np.nan_to_num(wmax, neginf=1.0), f32),
        num_triangles=num_triangles, num_spheres=num_spheres,
    )


# ------------------------------------------------------------ queue build

_INF = float("inf")


def slab_test(rays: RayBatch, cmin, cmax):
    """Dense slab test of every ray against every cluster AABB.

    NaN-robust: a zero direction component with the origin exactly on a
    cluster bound yields 0 * inf = NaN; such an axis is treated as
    non-constraining (cluster kept). Conservative: an extra visit is
    allowed, a missed hit is not.

    Returns (entered (B, C) bool, lo (B, C) f32 entry distance).
    """
    b = rays.origin.shape[0]
    c = cmin.shape[0]
    lo = rays.t_min[:, None].expand(b, c)
    hi = rays.t_max[:, None].expand(b, c)
    for a in range(3):
        inv_d = (1.0 / rays.direction[:, a])[:, None]      # (B, 1)
        oa = rays.origin[:, a][:, None]
        t0 = (cmin[None, :, a] - oa) * inv_d               # (B, C)
        t1 = (cmax[None, :, a] - oa) * inv_d
        near = torch.minimum(t0, t1)
        far = torch.maximum(t0, t1)
        lo = torch.maximum(lo, torch.nan_to_num(near, nan=-_INF,
                                                posinf=_INF, neginf=-_INF))
        hi = torch.minimum(hi, torch.nan_to_num(far, nan=_INF,
                                                posinf=_INF, neginf=-_INF))
    return hi >= lo, lo


def _pad_rays(rays: RayBatch, block: int):
    """Pad the batch to a multiple of `block` with dead rays."""
    b = rays.origin.shape[0]
    bp = ((b + block - 1) // block) * block
    if bp == b:
        return rays, b
    pad = bp - b

    def padf(a, fill):
        return torch.cat([a, a.new_full((pad,) + a.shape[1:], fill)])

    return RayBatch(
        origin=padf(rays.origin, 0.0),
        direction=padf(rays.direction, 1.0),
        t_min=padf(rays.t_min, 0.0),
        t_max=padf(rays.t_max, -1.0),  # t_max < t_min: pad rays hit nothing
    ), b


def _masked_inf(mask, x):
    return torch.where(mask, x, x.new_full((), _INF))


def _finite_or_big(x):
    return torch.where(torch.isfinite(x), x, x.new_full((), BIG))


def build_block_queue(rays: RayBatch, cmin, cmax, block: int = R):
    """Per `block`-ray block: front-to-back list of clusters any ray enters.

    Returns (counts (NB,) i32, ids (NB,C) i32, entry (NB,C) f32): the
    first counts[b] entries of ids[b] are cluster indices sorted by
    block-min entry t; the tail is padding (entry = BIG).
    """
    b = rays.origin.shape[0]
    nb = b // block
    c = cmin.shape[0]
    entered, lo = slab_test(rays, cmin, cmax)
    entered = entered.reshape(nb, block, c)
    entry = _masked_inf(entered, lo.reshape(nb, block, c)).amin(dim=1)
    counts = entered.any(dim=1).sum(dim=1).to(torch.int32)
    # stable sort (inf sorts last): ties keep the lower cluster index first
    entry_sorted, ids = torch.sort(entry, dim=1, stable=True)
    return counts, ids.to(torch.int32), _finite_or_big(entry_sorted)


def _block_ray_bounds(rays: RayBatch, nb: int, block: int):
    """Per-block conservative ray bundle: origin box, direction box and t
    interval over the LIVE rays of each block (dead lanes, t_max < t_min,
    are excluded so retired rays never widen the bundle)."""
    live = (rays.t_max >= rays.t_min).reshape(nb, block)
    big = 3e38

    def mn(x):
        shaped = x.reshape(nb, block, -1)
        return torch.where(live[..., None], shaped,
                           shaped.new_full((), big)).amin(dim=1)

    def mx(x):
        shaped = x.reshape(nb, block, -1)
        return torch.where(live[..., None], shaped,
                           shaped.new_full((), -big)).amax(dim=1)

    return (mn(rays.origin), mx(rays.origin),
            mn(rays.direction), mx(rays.direction),
            mn(rays.t_min)[:, 0], mx(rays.t_max)[:, 0])


def _interval_slab(bounds, cmin, cmax):
    """Conservative slab test of each block's ray BUNDLE against every box.

    Interval arithmetic over the bundle (origin box x direction box x t
    interval): if ANY live ray of the block can enter the box, the box is
    kept. An axis whose direction interval straddles zero is treated as
    non-constraining. Tight for coherent camera tiles (point origin,
    narrow cone); loose for post-bounce tiles, where it degrades toward
    whole-parent visits.

    Returns (entered (NB, C), entry (NB, C) conservative entry t).
    """
    omin, omax, dmin, dmax, tlo, thi = bounds
    nbk = omin.shape[0]
    c = cmin.shape[0]
    lo = tlo[:, None].expand(nbk, c)
    hi = thi[:, None].expand(nbk, c)
    for a in range(3):
        # interval quotient ([cmin,cmax] - [omin,omax]) / [dmin,dmax]: all
        # four corner quotients against both d endpoints, then the envelope
        num_lo = cmin[None, :, a] - omax[:, a, None]        # (NB, C)
        num_hi = cmax[None, :, a] - omin[:, a, None]
        da, db = dmin[:, a, None], dmax[:, a, None]
        straddle = (da <= 0.0) & (db >= 0.0)
        inv1 = 1.0 / torch.where(da == 0.0, torch.ones_like(da), da)
        inv2 = 1.0 / torch.where(db == 0.0, torch.ones_like(db), db)
        q = [num_lo * inv1, num_lo * inv2, num_hi * inv1, num_hi * inv2]
        near = torch.minimum(torch.minimum(q[0], q[1]),
                             torch.minimum(q[2], q[3]))
        far = torch.maximum(torch.maximum(q[0], q[1]),
                            torch.maximum(q[2], q[3]))
        near = torch.where(straddle | torch.isnan(near),
                           near.new_full((), -_INF), near)
        far = torch.where(straddle | torch.isnan(far),
                          far.new_full((), _INF), far)
        lo = torch.maximum(lo, near)
        hi = torch.minimum(hi, far)
    return hi >= lo, lo


def build_packed_queue(rays: RayBatch, accel: FlashAccel, block: int = R):
    """Two-level front-to-back triangle queue per block.

    Returns (n_pk (NB,), n_tail (NB,), tail_ids (NB, tail_cap),
    pk_entry (NB, p_eff), tail_entry (NB, tail_cap), child_ids (NB, cap_c))
    where p_eff = min(TOP_P, #parents) and cap_c = p_eff * CPP. Unused
    child slots hold the sentinel id (the table's zero rows).
    """
    b = rays.origin.shape[0]
    nb = b // block
    cp = accel.tri_cmin.shape[0]
    csub = accel.tri_cmin16.shape[0]
    p_eff = min(TOP_P, cp)
    cap_c = p_eff * CPP          # children coverable by packed visits
    nsub = (accel.tri_flat.shape[0] - W) // W

    # exact per-ray parent test, reduced to block granularity
    entered_p, lo_p = slab_test(rays, accel.tri_cmin, accel.tri_cmax)
    entb = entered_p.reshape(nb, block, cp)
    blk_any = entb.any(dim=1)                               # (NB, Cp)
    entry_p = _masked_inf(entb, lo_p.reshape(nb, block, cp)).amin(dim=1)

    # conservative child refinement at BLOCK granularity: interval slab of
    # the block's ray bundle vs all child AABBs. A child counts only if its
    # parent was per-ray entered; its entry is the tighter of the interval
    # bound and the parent's exact entry.
    bounds = _block_ray_bounds(rays, nb, block)
    ent_c, lo_c = _interval_slab(bounds, accel.tri_cmin16, accel.tri_cmax16)
    child_ok = ent_c & blk_any.repeat_interleave(CPP, dim=1)
    centry = _masked_inf(
        child_ok,
        torch.maximum(lo_c, entry_p.repeat_interleave(CPP, dim=1)))
    # nearest cap_c children front to back. A stable ascending sort keeps
    # the lower child id first among equal entries (torch.topk promises no
    # tie order).
    centry_all, cid_all = torch.sort(centry, dim=1, stable=True)
    centry_sorted = centry_all[:, :cap_c]
    cid_sorted = cid_all[:, :cap_c].to(torch.int32)
    n_c = torch.clamp(child_ok.sum(dim=1), max=cap_c).to(torch.int32)

    live = torch.arange(cap_c, dtype=torch.int32,
                        device=n_c.device)[None, :] < n_c[:, None]
    child_ids = torch.where(live, cid_sorted,
                            cid_sorted.new_full((), nsub))
    n_pk = (n_c + CPP - 1) // CPP
    pk_entry = _finite_or_big(centry_sorted[:, ::CPP])      # (NB, p_eff)

    # coarse tail for correctness under overflow: any parent owning an
    # entered child that did NOT fit in the packed capacity is visited
    # whole (front to back, after the packed visits). Ties at the cutoff
    # may re-test a packed child's parent: idempotent, never wrong.
    if csub > cap_c:
        thr = centry_sorted[:, -1:]                         # (NB, 1)
        overflow = child_ok & (centry >= thr)
        par_over = overflow.reshape(nb, cp, CPP).any(dim=2)
        tail_sorted, tail_ids = torch.sort(
            _masked_inf(par_over, entry_p), dim=1, stable=True)
        tail_ids = tail_ids.to(torch.int32)
        tail_entry = _finite_or_big(tail_sorted)
        n_tail = par_over.sum(dim=1).to(torch.int32)
    else:
        dev = rays.origin.device
        tail_ids = torch.zeros((nb, 0), dtype=torch.int32, device=dev)
        tail_entry = torch.zeros((nb, 0), dtype=torch.float32, device=dev)
        n_tail = torch.zeros((nb,), dtype=torch.int32, device=dev)

    return n_pk, n_tail, tail_ids, pk_entry, tail_entry, child_ids


def _sphere_brute(centers, radii, rays: RayBatch):
    """Exact closest sphere hit over a (small) sphere set, dense.

    Returns (s_t (B,), s_slot (B,) index into `centers`, s_hit (B,) bool).
    """
    st, _ = sphere_hit_t(
        centers[None, :, :], radii[None, :],
        rays.origin[:, None, :], rays.direction[:, None, :],
        rays.t_min[:, None], rays.t_max[:, None])
    s_t, s_best = torch.min(st, dim=1)   # invalid lanes already carry BIG
    return s_t, s_best, s_t < BIG


class BlockQueues(NamedTuple):
    """What one kernel launch drains: per block of rays, the front-to-back
    visit lists. All contiguous; ids int32, entries f32."""

    n_pk: torch.Tensor        # (NB,) packed visits to take
    n_tail: torch.Tensor      # (NB,) tail visits to take
    n_sph: torch.Tensor       # (NB,) sphere cluster visits to take
    child_ids: torch.Tensor   # (NB, v_cap*CPP) child ids, sentinel = nsub
    pk_entry: torch.Tensor    # (NB, v_cap) entry t of each packed visit
    tail_ids: torch.Tensor    # (NB, tail_cap) parent ids
    tail_entry: torch.Tensor  # (NB, tail_cap)
    sph_ids: torch.Tensor     # (NB, cs) sphere cluster ids
    sph_entry: torch.Tensor   # (NB, cs)


class FlashInputs(NamedTuple):
    """Everything `prepare_flash` hands to the kernel and the epilogue."""

    packed_rays: torch.Tensor   # (RAY_COLS, Bp) f32 rows [o d t_min t_max]
    queues: BlockQueues
    has_sph: bool               # the kernel's sphere phase is in use
    sph_dense: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    b: int                      # unpadded ray count


def prepare_flash(accel: FlashAccel, tables, rays: RayBatch,
                  block: int = R) -> FlashInputs:
    """Dense sphere test + queue build: all that precedes the kernel."""
    padded, b = _pad_rays(rays, block)
    nb = padded.origin.shape[0] // block
    dev = padded.origin.device

    # dense sphere set: ALL spheres when the scene is small, the
    # SPH_BRUTE_MAX largest when it is not. Either way their closest-hit
    # bound folds into t_max BEFORE the queue build.
    has_sph = accel.num_spheres > SPH_BRUTE_MAX
    sph_dense = None
    if not has_sph:
        centers, radii = tables.s_center, tables.s_radius
    else:
        ids = accel.sph_brute.long()
        centers, radii = tables.s_center[ids], tables.s_radius[ids]
    if centers.shape[0] > 0:
        s_t, s_slot, s_hit = _sphere_brute(centers, radii, padded)
        sph_dense = (s_t[:b], s_slot[:b], s_hit[:b])
        # detached fold: the queue build and the kernel are not
        # differentiated (their outputs are detached); gradients reach the
        # spheres through the epilogue's use of s_t itself
        padded = padded._replace(
            t_max=torch.minimum(padded.t_max, s_t.detach()))

    # The kernel's outputs are detached (intersect_flash), so detaching its
    # inputs changes no gradient, and it keeps autograd from recording the
    # queue build (or, on the CPU, the plain version) at all.
    padded = RayBatch(*(f.detach() for f in padded))
    packed_rays = torch.cat(
        [padded.origin.T, padded.direction.T,
         padded.t_min[None], padded.t_max[None]]).contiguous()

    n_pk, n_tail, tail_ids, pk_entry, tail_entry, child_ids = \
        build_packed_queue(padded, accel, block)
    if has_sph:
        n_sph, sph_ids, sph_entry = build_block_queue(
            padded, accel.sph_cmin, accel.sph_cmax, block)
    else:
        n_sph = torch.zeros((nb,), dtype=torch.int32, device=dev)
        sph_ids = torch.zeros((nb, 0), dtype=torch.int32, device=dev)
        sph_entry = torch.zeros((nb, 0), dtype=torch.float32, device=dev)

    queues = BlockQueues(*(t.contiguous() for t in (
        n_pk, n_tail, n_sph, child_ids, pk_entry, tail_ids, tail_entry,
        sph_ids, sph_entry)))
    return FlashInputs(packed_rays, queues, has_sph, sph_dense, b)


# ------------------------------------------- the kernel, and its plain version

def _sphere_keys(o, d, t_min, t_max, tile):
    """Sphere pair tests: rays (NB, 1, R) components against tile rows
    (NB, rows, 1) -> key (NB, rows, R), BIG where there is no hit, and
    can_hit (NB, rows, R), the pairs whose test needs its root (the ray's
    line meets a real sphere). Half-b quadratic with two-root select, as
    ops/intersect.py, in the sphere's own frame: oc = o - c, half_b = d.oc,
    c = oc.oc - r^2. (The expanded c = |o|^2 - 2 o.c + |c|^2 - r^2
    cancels to its rounding error where a ray leaves a small sphere far
    from the origin, and the near root then lands past t_min: a bounce
    ray re-hits the sphere it left, from inside.)"""
    ox, oy, oz = o
    dx, dy, dz = d
    cx, cy, cz, rr, ok = (tile[:, :, i:i + 1] for i in range(5))
    a_coef = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a_coef
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    half_b = dx * ocx + dy * ocy + dz * ocz
    c_coef = (ocx * ocx + ocy * ocy + ocz * ocz) - rr
    delta = half_b * half_b - a_coef * c_coef
    sph_ok = (delta > 0.0) & (ok > 0.5)
    sqrt_delta = pmath.sqrt(torch.where(sph_ok, delta,
                                         torch.ones_like(delta)))
    tt0 = (-half_b - sqrt_delta) * inv_a
    tt1 = (-half_b + sqrt_delta) * inv_a
    t0_ok = (tt0 >= t_min) & (tt0 <= t_max)
    t1_ok = (tt1 >= t_min) & (tt1 <= t_max)
    st = torch.where(t0_ok, tt0, tt1)
    valid = sph_ok & (t0_ok | t1_ok)
    return torch.where(valid, st, st.new_full((), BIG)), sph_ok


def _triangle_keys(o, d, m, t_min, t_max, tile):
    """Triangle pair tests, watertight bilinear form: the sheared 2D edge
    function of edge (P, Q) is, up to one positive per-ray scale,
    U = d.(PxQ) + m.(P-Q) with m = d x o. Adjacent triangles carry exactly
    negated (PxQ, P-Q) features for their shared edge, so their U values
    are exact negations: a ray crossing the shared edge is accepted by at
    least one of them. rays (NB, 1, R) against tile (NB, rows, F_ROWS) ->
    key (NB, rows, R), and can_hit (NB, rows, R), the pairs whose test needs
    its divide (the ray's line crosses the triangle and det != 0)."""
    ox, oy, oz = o
    dx, dy, dz = d
    mx, my, mz = m
    f = [tile[:, :, i:i + 1] for i in range(24)]
    U = (dx * f[0] + dy * f[1] + dz * f[2]
         + mx * f[3] + my * f[4] + mz * f[5])
    V = (dx * f[6] + dy * f[7] + dz * f[8]
         + mx * f[9] + my * f[10] + mz * f[11])
    Wf = (dx * f[12] + dy * f[13] + dz * f[14]
          + mx * f[15] + my * f[16] + mz * f[17])
    det = U + V + Wf
    same_sign = (((U >= 0.0) & (V >= 0.0) & (Wf >= 0.0))
                 | ((U <= 0.0) & (V <= 0.0) & (Wf <= 0.0)))
    det_ok = det != 0.0
    # t from the plane through corner a, in a's frame: t = (a - o).n / d.n,
    # every product and sum rounded apart, as the kernel rounds them. Not
    # from det: U, V and W are each the size of |a x b|, so for a ray far
    # from the origin their sum keeps few of its bits, and a t divided by
    # it put hit points up to 5e-2 off the plane of a box face 600 out (a
    # bounce ray from there then re-hit its face from behind). A ray in
    # the plane (d.n = 0) gets an infinite or NaN t: no hit.
    p_n = ((f[21] - ox) * f[18] + (f[22] - oy) * f[19]) + (f[23] - oz) * f[20]
    d_n = (dx * f[18] + dy * f[19]) + dz * f[20]
    tt = p_n / torch.where(det_ok, d_n, torch.ones_like(d_n))
    can_hit = det_ok & same_sign
    valid = can_hit & (tt >= t_min) & (tt <= t_max)
    return torch.where(valid, tt, tt.new_full((), BIG)), can_hit


def resolve_group(block: int = R, group: Optional[int] = None) -> int:
    """The termination group a launch uses: `group` if given (it must divide
    `block` and be a multiple of 32), else DEFAULT_GROUP where that divides
    `block`, else the whole block."""
    if group is None:
        return DEFAULT_GROUP if block % DEFAULT_GROUP == 0 else block
    if group <= 0 or group % 32 or block % group:
        raise ValueError(f"group must be a multiple of 32 that divides "
                         f"block = {block}, got {group}")
    return group


def flash_intersect_plain(packed_rays, queues: BlockQueues, tri_flat,
                          sph_feats, block: int = R, has_sph: bool = False,
                          visits: Optional[torch.Tensor] = None,
                          group: Optional[int] = None,
                          can_hit: Optional[torch.Tensor] = None):
    """The kernel's function in plain tensor ops: same queues in, same four
    outputs out. Visits follow the queue order over (blocks, rows, rays)
    tiles; each ray keeps a strict `<` running minimum, so the first
    primitive visited that attains the minimum wins, as in the kernel.

    `group` (default: the whole block) is the termination group: every
    `group` consecutive rays of a block walk the block's queues on their
    own and stop at the first visit whose entry is not below the farthest
    bound among them. An entry is a lower bound for every ray of the block,
    so the results do not depend on `group`; the visits taken do.

    Returns (tri_t f32, tri_slot i32, sph_t f32, sph_slot i32), each (Bp,).
    `visits` (Bp // group, 3) int32, if given, receives per group the sphere
    clusters, the non-sentinel children and the tail parents visited.
    `can_hit` (Bp // group, 2) int64, if given, receives per group how many
    of the sphere pairs and of the triangle pairs it tested could hit, i.e.
    needed the root or the divide and the range test beyond the part every
    pair pays (chip_smoke.py reckons the kernel's bound from it).
    """
    q = queues
    bp = packed_rays.shape[1]
    nb = bp // block
    group = block if group is None else resolve_group(block, group)
    ng = block // group                               # groups per block
    dev = packed_rays.device
    rows = packed_rays.reshape(RAY_COLS, nb, 1, block)
    o = (rows[0], rows[1], rows[2])
    d = (rows[3], rows[4], rows[5])
    t_min, t_max = rows[6], rows[7]                   # (NB, 1, R)
    m = (d[1] * o[2] - d[2] * o[1],
         d[2] * o[0] - d[0] * o[2],
         d[0] * o[1] - d[1] * o[0])
    tmax_r = t_max[:, 0]                              # (NB, R)

    def fresh():
        return (torch.full((nb, block), BIG, dtype=torch.float32, device=dev),
                torch.zeros((nb, block), dtype=torch.int64, device=dev))

    def far_of(bound):
        """(NB, R) per-ray bounds -> (NB, NG): the farthest of each group."""
        return bound.reshape(nb, ng, group).amax(dim=2)

    count = torch.zeros((nb, ng, 3), dtype=torch.int64, device=dev)
    hits = torch.zeros((nb, ng, 2), dtype=torch.int64, device=dev)

    def take(best_t, best_slot, keys, slot_of_row, go, kind):
        """Fold one visit's keys (NB, rows, R) into the running best of the
        groups where `go` (NB, NG) holds."""
        key, passed = keys
        if can_hit is not None:
            hits[:, :, kind] += go * passed.sum(dim=1).reshape(
                nb, ng, group).sum(dim=2)
        kmin, krow = key.min(dim=1)                   # first minimal row
        better = go.repeat_interleave(group, dim=1) & (kmin < best_t)
        slot = torch.gather(slot_of_row.expand(nb, -1), 1, krow)
        return (torch.where(better, kmin, best_t),
                torch.where(better, slot, best_slot))

    def all_go():
        return torch.ones((nb, ng), dtype=torch.bool, device=dev)

    # ---- sphere phase (first: its result bounds the triangle phases) ----
    sph_t, sph_slot = fresh()
    if has_sph:
        tiles = sph_feats.reshape(-1, K, SPH_FEATURES)
        lane = torch.arange(K, device=dev)[None, :]
        go = all_go()
        for j in range(int(q.n_sph.max()) if nb else 0):
            far = far_of(torch.minimum(sph_t, tmax_r))
            go = go & (j < q.n_sph)[:, None] \
                & (q.sph_entry[:, j, None] < far)
            ci = q.sph_ids[:, j].long()
            key = _sphere_keys(o, d, t_min, t_max, tiles[ci])
            sph_t, sph_slot = take(sph_t, sph_slot, key,
                                   ci[:, None] * K + lane, go, 0)
            count[:, :, 0] += go

    # ---- triangle phases ----
    # a triangle behind the ray's sphere hit is no hit: the sphere result
    # bounds the pair tests' range as well as the groups' far
    t_max = torch.minimum(t_max, sph_t[:, None, :])
    tri_t, tri_slot = fresh()
    nsub = (tri_flat.shape[0] - W) // W
    children = tri_flat.reshape(nsub + 1, W, F_ROWS)
    parents = tri_flat[:nsub * W].reshape(-1, K, F_ROWS)

    def tri_far():
        return far_of(torch.minimum(torch.minimum(tri_t, tmax_r), sph_t))

    go = all_go()
    for j in range(q.pk_entry.shape[1]):
        go = go & (j < q.n_pk)[:, None] & (q.pk_entry[:, j, None] < tri_far())
        ci = q.child_ids[:, j * CPP:(j + 1) * CPP].long()     # (NB, CPP)
        tile = children[ci].reshape(nb, K, F_ROWS)
        key = _triangle_keys(o, d, m, t_min, t_max, tile)
        tri_t, tri_slot = take(tri_t, tri_slot, key,
                               tile[:, :, SLOT_ROW].long(), go, 1)
        count[:, :, 1] += go * (ci != nsub).sum(dim=1)[:, None]

    go = all_go()
    n_tail_max = int(q.n_tail.max()) if (nb and q.tail_ids.shape[1]) else 0
    for j in range(n_tail_max):
        go = go & (j < q.n_tail)[:, None] \
            & (q.tail_entry[:, j, None] < tri_far())
        tile = parents[q.tail_ids[:, j].long()]
        key = _triangle_keys(o, d, m, t_min, t_max, tile)
        tri_t, tri_slot = take(tri_t, tri_slot, key,
                               tile[:, :, SLOT_ROW].long(), go, 1)
        count[:, :, 2] += go

    if visits is not None:
        visits.copy_(count.reshape(nb * ng, 3))
    if can_hit is not None:
        can_hit.copy_(hits.reshape(nb * ng, 2))
    return (tri_t.reshape(bp), tri_slot.reshape(bp).to(torch.int32),
            sph_t.reshape(bp), sph_slot.reshape(bp).to(torch.int32))


_lib = None


def _library():
    """The compiled kernel library, built at first use."""
    global _lib
    if _lib is None:
        from potato_tpu_torch.ops._build import load_library

        lib = load_library("flash_intersect")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_intersect_rays_per_thread.argtypes = []
        lib.flash_intersect_rays_per_thread.restype = i
        lib.flash_intersect_launch.argtypes = [
            p, i, i, i,            # rays, Bp, block, group
            p, p, p,               # n_pk, n_tail, n_sph
            p, p, i,               # child_ids, pk_entry, v_cap
            p, p, i,               # tail_ids, tail_entry, tail_cap
            p, p, i,               # sph_ids, sph_entry, cs
            p, i, p, i,            # tri_flat, nsub, sph_feats, has_sph
            p, p, p, p,            # tri_t, tri_slot, sph_t, sph_slot
            p, p]                  # visits (may be null), stream
        lib.flash_intersect_launch.restype = i
        _lib = lib
    return _lib


def load_kernel_library() -> dict:
    """Load the kernel library now, building it first if its current
    source has not been built; returns how it was had: {"path",
    "seconds" (nvcc's, 0.0 when it was found built), "log" (nvcc's
    output)}."""
    from potato_tpu_torch.ops._build import build_info

    _library()
    return build_info["flash_intersect"]


def _check(t, name, dtype, shape, device):
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def flash_intersect_kernel(packed_rays, queues: BlockQueues, tri_flat,
                           sph_feats, block: int = R, has_sph: bool = False,
                           visits: Optional[torch.Tensor] = None,
                           group: Optional[int] = None):
    """Closest triangle and closest kernel-sphere per ray over the block
    queues: (tri_t f32, tri_slot i32, sph_t f32, sph_slot i32), each (Bp,),
    t = BIG and slot 0 where nothing was hit.

    CUDA tensors launch the hand-written kernel (`flash_intersect_kernel
    .launches` counts the launches) or raise; CPU tensors take
    `flash_intersect_plain`. `group` is the termination group, the rays one
    CTA takes (see `resolve_group`; the results do not depend on it).
    `visits` (Bp // group, 3) int32 optionally receives the visits taken per
    group (sphere clusters, children, tail parents).
    """
    dev = packed_rays.device
    group = resolve_group(block, group)
    if dev.type == "cpu":
        return flash_intersect_plain(packed_rays, queues, tri_flat,
                                     sph_feats, block, has_sph, visits,
                                     group)
    if dev.type != "cuda":
        raise ValueError(f"flash_intersect_kernel: unsupported device {dev}")
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError("block must be a multiple of 32 in [32, 1024]")
    if packed_rays.dim() != 2 or packed_rays.shape[1] % block:
        raise ValueError("packed_rays must be (8, Bp) with Bp a multiple "
                         "of block")
    bp = packed_rays.shape[1]
    nb = bp // block
    q = queues
    f32, i32 = torch.float32, torch.int32
    v_cap = q.pk_entry.shape[1]
    tail_cap = q.tail_ids.shape[1]
    cs = q.sph_ids.shape[1]
    _check(packed_rays, "packed_rays", f32, (RAY_COLS, bp), dev)
    for name in ("n_pk", "n_tail", "n_sph"):
        _check(getattr(q, name), name, i32, (nb,), dev)
    _check(q.child_ids, "child_ids", i32, (nb, v_cap * CPP), dev)
    _check(q.pk_entry, "pk_entry", f32, (nb, v_cap), dev)
    _check(q.tail_ids, "tail_ids", i32, (nb, tail_cap), dev)
    _check(q.tail_entry, "tail_entry", f32, (nb, tail_cap), dev)
    _check(q.sph_ids, "sph_ids", i32, (nb, cs), dev)
    _check(q.sph_entry, "sph_entry", f32, (nb, cs), dev)
    if tri_flat.dim() != 2 or (tri_flat.shape[0] - W) % K:
        raise ValueError("tri_flat must be (Cp*K + W, F_ROWS)")
    _check(tri_flat, "tri_flat", f32, (tri_flat.shape[0], F_ROWS), dev)
    if sph_feats.dim() != 2 or sph_feats.shape[0] % K:
        raise ValueError("sph_feats must be (Cs*K, SPH_FEATURES)")
    _check(sph_feats, "sph_feats", f32,
           (sph_feats.shape[0], SPH_FEATURES), dev)
    if has_sph and cs > sph_feats.shape[0] // K:
        raise ValueError("sphere queue wider than the sphere table")
    for name, t in (("tri_flat", tri_flat), ("sph_feats", sph_feats)):
        if t.data_ptr() % 16:      # the kernel's bulk copies need it
            raise ValueError(f"{name}: expected 16-byte aligned storage")
    if visits is not None:
        _check(visits, "visits", i32, (bp // group, 3), dev)
    nsub = (tri_flat.shape[0] - W) // W

    tri_t = torch.empty((bp,), dtype=f32, device=dev)
    tri_slot = torch.empty((bp,), dtype=i32, device=dev)
    sph_t = torch.empty((bp,), dtype=f32, device=dev)
    sph_slot = torch.empty((bp,), dtype=i32, device=dev)
    if nb == 0:
        return tri_t, tri_slot, sph_t, sph_slot

    lib = _library()
    with torch.cuda.device(dev):
        err = lib.flash_intersect_launch(
            packed_rays.data_ptr(), bp, block, group,
            q.n_pk.data_ptr(), q.n_tail.data_ptr(), q.n_sph.data_ptr(),
            q.child_ids.data_ptr(), q.pk_entry.data_ptr(), v_cap,
            q.tail_ids.data_ptr(), q.tail_entry.data_ptr(), tail_cap,
            q.sph_ids.data_ptr(), q.sph_entry.data_ptr(), cs,
            tri_flat.data_ptr(), nsub, sph_feats.data_ptr(), int(has_sph),
            tri_t.data_ptr(), tri_slot.data_ptr(),
            sph_t.data_ptr(), sph_slot.data_ptr(),
            visits.data_ptr() if visits is not None else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_intersect kernel launch failed: CUDA error {err}")
    flash_intersect_kernel.launches += 1
    return tri_t, tri_slot, sph_t, sph_slot


flash_intersect_kernel.launches = 0


# ---------------------------------------------------------------- epilogue

def flash_epilogue(accel: FlashAccel, rays: RayBatch, raw,
                   sph_dense) -> HitBatch:
    """Kernel outputs -> HitBatch: sphere/triangle winner merge, one shade
    row gather per ray, barycentrics re-derived for the winning triangle
    only, sphere normal + equirect uv.

    Miss lanes carry arbitrary slots by design, so every slot is clamped
    before its gather."""
    b = rays.origin.shape[0]
    tri_t, tri_slot, k_t, k_slot = (x[:b] for x in raw)
    ntp = accel.tri_perm.shape[0]
    shade = accel.shade

    tr_t = tri_t
    tr_slot = tri_slot.long().clamp(0, ntp - 1)
    tr_hit = tr_t < BIG
    if accel.num_spheres > SPH_BRUTE_MAX:
        stotal = accel.sph_perm.shape[0]
        k_slot = k_slot.long().clamp(0, stotal - 1)
        k_hit = k_t < BIG
        if sph_dense is None:
            s_t, s_slot, s_hit = k_t, k_slot, k_hit
        else:
            # hybrid: the densely tested largest spheres vs the kernel's
            # small ones; dense rows sit after the kernel-ordered rows
            x_t, x_idx, x_hit = sph_dense
            x_wins = x_hit & (~k_hit | (x_t <= k_t))
            s_t = torch.where(x_wins, x_t, k_t)
            s_slot = torch.where(x_wins, stotal + x_idx, k_slot)
            s_hit = x_hit | k_hit
    else:
        s_t, s_slot, s_hit = sph_dense

    o, d = rays.origin, rays.direction
    sphere_wins = s_hit & (~tr_hit | (s_t <= tr_t))
    uslot = torch.where(sphere_wins, ntp + s_slot, tr_slot)
    g = shade[uslot.clamp(0, shade.shape[0] - 1)]          # (B, 25)

    one = torch.ones_like(s_t)
    s_t_safe = torch.where(s_hit, s_t, one)
    tr_t_safe = torch.where(tr_hit, tr_t, one)

    # ---- triangle fields: re-derive (u, v) for the winner only ----
    # Cramer triple products (ops/intersect.py triangle_hit_t): u weights
    # pb, v weights pc. Degenerate or garbage rows (miss lanes) guard
    # det == 0.
    pa = g[:, 15:18]
    ba = pa - g[:, 18:21]
    ca = pa - g[:, 21:24]
    po = pa - o
    cd = pmath.cross(ca, d)
    det = pmath.dot(ba, cd)
    det_ok = det != 0.0
    inv_det = det_ok.to(det.dtype) / torch.where(det_ok, det,
                                                 torch.ones_like(det))
    tr_u = pmath.dot(po, cd) * inv_det
    tr_v = pmath.dot(d, pmath.cross(ba, po)) * inv_det
    tw = 1.0 - tr_u - tr_v
    t_n = (tw[:, None] * g[:, 0:3] + tr_u[:, None] * g[:, 3:6]
           + tr_v[:, None] * g[:, 6:9])
    t_uv = (tw[:, None] * g[:, 9:11] + tr_u[:, None] * g[:, 11:13]
            + tr_v[:, None] * g[:, 13:15])

    # ---- sphere fields ----
    center, radius = g[:, 0:3], g[:, 3]
    safe_r = torch.where(radius == 0.0, torch.ones_like(radius), radius)
    t_sel = torch.where(sphere_wins, s_t_safe, tr_t_safe)
    position = o + t_sel[:, None] * d
    s_n = (position - center) / safe_r[:, None]
    s_uv = pmath.equirect_uv(s_n)

    sw = sphere_wins[:, None]
    return HitBatch(
        t=torch.where(sphere_wins, s_t, tr_t),
        position=position,
        normal=torch.where(sw, s_n, t_n),
        uv=torch.where(sw, s_uv, t_uv),
        material=g[:, 24].long(),
        valid=s_hit | tr_hit,
    )


def flash_hits(accel: FlashAccel, inp: FlashInputs, block: int = R,
               force_plain: bool = False):
    """The kernel (or, with force_plain, its plain version) over what
    `prepare_flash` built: (tri_t, tri_slot, sph_t, sph_slot), detached.
    `flash_intersect_kernel` is looked up on this module at each call, so
    a wrapper set in its place sees every launch with its own inputs."""
    fn = flash_intersect_plain if force_plain else flash_intersect_kernel
    raw = fn(inp.packed_rays, inp.queues, accel.tri_flat.detach(),
             accel.sph_feats.detach(), block, inp.has_sph,
             group=resolve_group(block))
    return tuple(x.detach() for x in raw)


def intersect_flash(accel: FlashAccel, tables, rays: RayBatch,
                    block: int = R, force_plain: bool = False) -> HitBatch:
    """Closest hit over all scene primitives: queue build, kernel, epilogue.

    force_plain runs `flash_intersect_plain` in place of the kernel
    whatever the device; it exists for comparisons (tests, chip_smoke.py).
    Both walk the queues in the same termination groups.

    Gradient conventions: the kernel's outputs (t and winning slots) are
    detached and the shade table is a constant of the accel, so the
    kernel has no backward. Scene-parameter gradients (every field of
    diff/optimize.py's DIFFERENTIABLE_FIELDS) flow through the shading
    downstream of the HitBatch, which needs the hit's values only; the
    dense sphere test's t also carries centre and radius gradients. Not
    differentiable: d(hit decision)/d(geometry).

    `intersect_flash.lanes` counts the lanes handed in, live or dead, on
    every device, read from the batch's shape: no host sync.
    """
    intersect_flash.lanes += rays.origin.shape[0]
    inp = prepare_flash(accel, tables, rays, block)
    raw = flash_hits(accel, inp, block, force_plain)
    return flash_epilogue(accel, rays, raw, inp.sph_dense)


intersect_flash.lanes = 0
