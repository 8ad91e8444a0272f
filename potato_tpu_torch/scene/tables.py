"""Scene compilation: description -> flat structure-of-arrays device tables.

The scene's index-addressed tables become dense tensors gathered
branchlessly per ray lane:

- materials: parallel arrays of kind codes + parameters,
- textures: kind codes + params + one shared flat texel atlas (all image
  textures concatenated),
- geometry: spheres as center/radius/material arrays; triangles pre-gathered
  to per-corner arrays (one gather per triangle instead of three through a
  vertex-index indirection),
- background: the scene-wide Emit.

Everything is built in numpy on the host and uploaded once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from potato_tpu_torch.core.types import resolve_device
from potato_tpu_torch.scene import description as d


class SceneTables(NamedTuple):
    # --- materials ---
    m_scatter_kind: torch.Tensor   # (M,) int32
    m_scatter_param: torch.Tensor  # (M,) f32: Metal fuzziness / Dielectric IOR
    m_absorb_kind: torch.Tensor    # (M,) int32
    m_absorb_color: torch.Tensor   # (M,3) f32
    m_absorb_tex: torch.Tensor     # (M,) int32
    m_emit_kind: torch.Tensor      # (M,) int32
    m_emit_color: torch.Tensor     # (M,3) f32
    m_emit_tex: torch.Tensor       # (M,) int32
    # --- textures ---
    t_kind: torch.Tensor           # (T,) int32
    t_color: torch.Tensor          # (T,3) f32
    t_children: torch.Tensor       # (T,2) int32 checker (odd, even)
    t_seed: torch.Tensor           # (T,) int32
    t_image: torch.Tensor          # (T,3) int32 (atlas offset, width, height)
    atlas: torch.Tensor            # (P,3) f32 all image texels, row-major
    # --- background Emit ---
    bg_kind: torch.Tensor          # () int32
    bg_color: torch.Tensor         # (3,) f32
    bg_tex: torch.Tensor           # () int32
    # --- spheres ---
    s_center: torch.Tensor         # (S,3) f32
    s_radius: torch.Tensor         # (S,) f32
    s_material: torch.Tensor       # (S,) int32
    # --- triangles, pre-gathered corners ---
    tri_pa: torch.Tensor           # (Tr,3) f32
    tri_pb: torch.Tensor
    tri_pc: torch.Tensor
    tri_na: torch.Tensor           # (Tr,3) f32 raw vertex normals (NOT
    tri_nb: torch.Tensor           # renormalized after interpolation)
    tri_nc: torch.Tensor
    tri_ua: torch.Tensor           # (Tr,2) f32
    tri_ub: torch.Tensor
    tri_uc: torch.Tensor
    tri_material: torch.Tensor     # (Tr,) int32


class CameraTables(NamedTuple):
    """Device-side thin-lens camera parameters."""

    aspect_ratio: torch.Tensor   # () f32
    tan_half_fov: torch.Tensor   # () f32
    focal_dist: torch.Tensor     # () f32
    lens_radius: torch.Tensor    # () f32
    orientation: torch.Tensor    # (3,3) f32 columns = local axes
    position: torch.Tensor       # (3,) f32


class SceneFeatures(NamedTuple):
    """Which material/texture variants a scene actually uses.

    Static facts of the scene: the branchless dispatch in ops/material.py
    and ops/texture.py computes every variant for every lane, so variants a
    scene can never select are pure waste and are skipped;
    `all_features()` keeps the unspecialized behaviour.
    """

    scatter_kinds: frozenset
    absorb_kinds: frozenset
    emit_kinds: frozenset    # includes the background kind
    texture_kinds: frozenset
    # the camera's thin lens is disabled (lens_radius == 0): ray
    # generation then skips the unit-disk sample entirely
    has_lens: bool = True
    # static unroll depth of the checker recursion: the length of the
    # longest Checker chain in the scene's texture graph
    checker_depth: int = 2
    # material-only emit kinds (background excluded): the per-hit material
    # emission uses this set, so a SkySphere background does not pull the
    # environment-map lookup into every hit lane. None = emit_kinds.
    material_emit_kinds: frozenset = None


def all_features() -> SceneFeatures:
    emit = frozenset((d.EMIT_NONE, d.EMIT_DEBUG_NORMALS, d.EMIT_COLOR,
                      d.EMIT_SKY_GRADIENT, d.EMIT_SKY_SPHERE))
    return SceneFeatures(
        scatter_kinds=frozenset(
            (d.SCATTER_NONE, d.SCATTER_LAMBERT, d.SCATTER_METAL,
             d.SCATTER_DIELECTRIC)),
        absorb_kinds=frozenset(
            (d.ABSORB_BLACK_BODY, d.ABSORB_WHITE_BODY, d.ABSORB_ALBEDO,
             d.ABSORB_ALBEDO_MAP)),
        emit_kinds=emit,
        material_emit_kinds=emit,
        texture_kinds=frozenset(
            (d.TEX_MISSING, d.TEX_DEBUG_UVS, d.TEX_SOLID, d.TEX_IMAGE,
             d.TEX_CHECKER, d.TEX_NOISE, d.TEX_PERLIN)),
    )


@dataclass
class CompiledScene:
    """A scene ready to render: device tables + static metadata.

    `accel` is None (brute force over all primitives), an
    `ops.flash.FlashAccel`, an `ops.dense.DenseAccel` or a
    `scene.bvh.ClusterAccel`.
    """

    tables: SceneTables
    camera: CameraTables
    accel: Optional[object]
    num_spheres: int
    num_triangles: int
    features: SceneFeatures = field(default_factory=all_features)

    @property
    def device(self) -> torch.device:
        return self.tables.s_center.device


def _checker_depth(texs) -> int:
    """Length of the longest Checker chain in the texture graph.

    Computing the exact chain depth when the scene is compiled lets the
    device sampler unroll exactly as deep as the scene needs, and a cyclic
    graph is an error here instead of an infinite recursion.
    """
    depth_memo: dict = {}

    def depth_of(i: int, trail: tuple) -> int:
        if i in trail:
            cycle = " -> ".join(str(j) for j in trail + (i,))
            raise ValueError(f"checker texture cycle: {cycle}")
        if i in depth_memo:
            return depth_memo[i]
        t = texs[i]
        if t.kind != d.TEX_CHECKER:
            out = 0
        else:
            out = 1 + max(depth_of(int(c), trail + (i,)) for c in t.children)
        depth_memo[i] = out
        return out

    return max((depth_of(i, ()) for i in range(len(texs))), default=0)


def _upload(record, device):
    """One upload of a NamedTuple of numpy arrays."""
    return type(record)(*(
        torch.tensor(np.asarray(a), device=device).contiguous()
        for a in record))


ACCELS = ("flash", "auto", "pallas", "dense", "cluster", "brute")


def compile_scene(desc: "d.SceneBuilder", accel: str = "auto",
                  device="cuda", cluster_size: int = 32) -> CompiledScene:
    """Flatten a SceneBuilder into device tables (+ acceleration structure).

    accel:
    - "flash" (= "auto" = "pallas", the reference's name for its kernel):
      the block-queue intersector of ops/flash.py and its hand-written
      kernel;
    - "dense": all rays x all primitives as matrix products (ops/dense.py);
    - "cluster": Morton clusters of `cluster_size` primitives, visited
      front to back per ray (scene/bvh.py, ops/traverse.py);
    - "brute": dense tests against every primitive, the oracle.
    """
    device = resolve_device(device)
    if accel not in ACCELS:
        raise ValueError(f"unknown accel {accel!r}; one of {ACCELS}")
    mats = desc.materials or [d.Material()]
    texs = desc.textures or [d.Texture.missing()]

    # --- texture atlas ---
    offsets, dims, texels = [], [], []
    cursor = 0
    for t in texs:
        if t.kind == d.TEX_IMAGE and t.image is not None:
            img = np.asarray(t.image)
            if img.dtype == np.uint8:
                img = img[..., :3].astype(np.float32) / 255.0
            else:
                img = img[..., :3].astype(np.float32)
            h, w = img.shape[:2]
            offsets.append(cursor)
            dims.append((w, h))
            texels.append(img.reshape(-1, 3))
            cursor += w * h
        else:
            offsets.append(0)
            dims.append((1, 1))
    if not texels:
        texels = [np.zeros((1, 3), np.float32)]
    atlas = np.concatenate(texels, axis=0).astype(np.float32)

    t_image = np.array(
        [[o, wh[0], wh[1]] for o, wh in zip(offsets, dims)], np.int32)

    # --- spheres ---
    ns = len(desc.sphere_center)
    s_center = np.asarray(desc.sphere_center, np.float32).reshape(-1, 3)
    s_radius = np.asarray(desc.sphere_radius, np.float32).reshape(-1)
    s_material = np.asarray(desc.sphere_material, np.int32).reshape(-1)
    if ns == 0:
        # one degenerate sphere. radius must be 0, not negative: the
        # quadratic only sees radius^2, so a radius -1 pad would act like a
        # real unit sphere. With r=0, delta = (d.oc)^2 - |d|^2 |oc|^2 <= 0
        # (Cauchy-Schwarz) and the `delta > 0` gate never passes.
        s_center = np.zeros((1, 3), np.float32)
        s_radius = np.zeros((1,), np.float32)
        s_material = np.zeros((1,), np.int32)

    # --- triangles: flatten all meshes into pre-gathered corner arrays ---
    keys = ("pa", "pb", "pc", "na", "nb", "nc", "ua", "ub", "uc", "mat")
    tri_parts = {k: [] for k in keys}
    ntr = 0
    for mesh, mat_id in zip(desc.meshes, desc.mesh_materials):
        idx = mesh.indices
        for key, src, col in (("pa", mesh.positions, 0), ("pb", mesh.positions, 1),
                              ("pc", mesh.positions, 2), ("na", mesh.normals, 0),
                              ("nb", mesh.normals, 1), ("nc", mesh.normals, 2),
                              ("ua", mesh.uvs, 0), ("ub", mesh.uvs, 1),
                              ("uc", mesh.uvs, 2)):
            tri_parts[key].append(src[idx[:, col]])
        tri_parts["mat"].append(np.full(idx.shape[0], mat_id, np.int32))
        ntr += idx.shape[0]
    if ntr == 0:
        # one degenerate triangle (all corners coincide => det 0, never hit)
        for key in ("pa", "pb", "pc", "na", "nb", "nc"):
            tri_parts[key].append(np.zeros((1, 3), np.float32))
        for key in ("ua", "ub", "uc"):
            tri_parts[key].append(np.zeros((1, 2), np.float32))
        tri_parts["mat"].append(np.zeros((1,), np.int32))
    tri = {k: np.concatenate(v, axis=0).astype(
        np.float32 if k != "mat" else np.int32) for k, v in tri_parts.items()}

    tables = SceneTables(
        m_scatter_kind=np.asarray([m.scatter.kind for m in mats], np.int32),
        m_scatter_param=np.asarray([m.scatter.param for m in mats], np.float32),
        m_absorb_kind=np.asarray([m.absorb.kind for m in mats], np.int32),
        m_absorb_color=np.asarray([m.absorb.color for m in mats], np.float32),
        m_absorb_tex=np.asarray([m.absorb.texture for m in mats], np.int32),
        m_emit_kind=np.asarray([m.emit.kind for m in mats], np.int32),
        m_emit_color=np.asarray([m.emit.color for m in mats], np.float32),
        m_emit_tex=np.asarray([m.emit.texture for m in mats], np.int32),
        t_kind=np.asarray([t.kind for t in texs], np.int32),
        t_color=np.asarray([t.color for t in texs], np.float32),
        t_children=np.asarray([t.children for t in texs], np.int32),
        t_seed=np.asarray([t.seed for t in texs], np.int32),
        t_image=t_image,
        atlas=atlas,
        bg_kind=np.asarray(desc.background.kind, np.int32),
        bg_color=np.asarray(desc.background.color, np.float32),
        bg_tex=np.asarray(desc.background.texture, np.int32),
        s_center=s_center,
        s_radius=s_radius,
        s_material=s_material,
        tri_pa=tri["pa"], tri_pb=tri["pb"], tri_pc=tri["pc"],
        tri_na=tri["na"], tri_nb=tri["nb"], tri_nc=tri["nc"],
        tri_ua=tri["ua"], tri_ub=tri["ub"], tri_uc=tri["uc"],
        tri_material=tri["mat"],
    )

    cam = desc.camera
    camera = CameraTables(
        aspect_ratio=np.asarray(cam.aspect_ratio, np.float32),
        tan_half_fov=np.asarray(np.tan(0.5 * cam.fov), np.float32),
        focal_dist=np.asarray(cam.focal_dist, np.float32),
        lens_radius=np.asarray(cam.lens_radius, np.float32),
        orientation=np.asarray(cam.orientation(), np.float32),
        position=np.asarray(cam.position, np.float32),
    )

    accel_struct = None
    if accel in ("flash", "auto", "pallas"):
        from potato_tpu_torch.ops.flash import build_flash_accel

        accel_struct = build_flash_accel(tables, ns, ntr, device=device)
    elif accel == "dense":
        from potato_tpu_torch.ops.dense import build_dense_accel

        accel_struct = build_dense_accel(tables, ns, ntr, device=device)
    elif accel == "cluster":
        from potato_tpu_torch.scene.bvh import build_cluster_accel

        accel_struct = build_cluster_accel(
            s_center if ns else np.zeros((0, 3), np.float32),
            s_radius if ns else np.zeros((0,), np.float32),
            s_material if ns else np.zeros((0,), np.int32),
            {k: (v if ntr else v[:0]) for k, v in tri.items()},
            cluster_size=cluster_size, device=device)

    features = SceneFeatures(
        scatter_kinds=frozenset(m.scatter.kind for m in mats),
        absorb_kinds=frozenset(m.absorb.kind for m in mats),
        emit_kinds=(frozenset(m.emit.kind for m in mats)
                    | {desc.background.kind}),
        material_emit_kinds=frozenset(m.emit.kind for m in mats),
        texture_kinds=frozenset(t.kind for t in texs),
        has_lens=bool(float(cam.lens_radius) > 0.0),
        checker_depth=_checker_depth(texs),
    )

    return CompiledScene(
        tables=_upload(tables, device), camera=_upload(camera, device),
        accel=accel_struct, num_spheres=ns, num_triangles=ntr,
        features=features,
    )


def scene_from_numpy(tables: dict, camera: dict, accel: Optional[dict],
                     features: SceneFeatures, counts,
                     device="cuda") -> CompiledScene:
    """A CompiledScene from tables that were built elsewhere.

    tables / camera / accel map the field names of `SceneTables`,
    `CameraTables` and `ops.flash.FlashAccel` to numpy arrays (accel may be
    None for brute force; its two integer fields are taken from `counts`).
    `features` carries the static feature sets; counts is
    (num_spheres, num_triangles). This is how a scene compiled by another
    implementation of the same tables is rendered here on identical data.
    """
    from potato_tpu_torch.ops.flash import FlashAccel

    device = resolve_device(device)
    ns, ntr = (int(c) for c in counts)

    def record(cls, arrays, **static):
        names = [f for f in cls._fields if f not in static]
        missing = [f for f in names if f not in arrays]
        if missing:
            raise KeyError(f"{cls.__name__}: missing fields {missing}")
        return cls(**{f: torch.tensor(np.asarray(arrays[f]),
                                   device=device).contiguous()
                      for f in names}, **static)

    accel_struct = None
    if accel is not None:
        accel_struct = record(FlashAccel, accel, num_triangles=ntr,
                              num_spheres=ns)
    return CompiledScene(
        tables=record(SceneTables, tables),
        camera=record(CameraTables, camera),
        accel=accel_struct, num_spheres=ns, num_triangles=ntr,
        features=SceneFeatures(*features),
    )
