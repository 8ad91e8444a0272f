"""Scene records: the inputs of a frame, as plain data.

The benchmark makes these records itself (`benchmark/scenes/`) and hands the
same records to the port (`port_scene.py`) and to the reference
(`reference/pathtracer.py`). Kinds are names, not the port's codes, so that
neither side reads the other's tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

Vec3 = Tuple[float, float, float]


@dataclass(frozen=True)
class Camera:
    """Thin-lens camera looking from `position` at `target`."""

    aspect_ratio: float
    fov: float
    focal_dist: float
    lens_radius: float
    position: Vec3
    target: Vec3
    up: Vec3


@dataclass(frozen=True)
class Emit:
    kind: str = "none"
    color: Vec3 = (0.0, 0.0, 0.0)
    texture: int = 0


@dataclass(frozen=True)
class Material:
    """One scatter, one absorb and one emit function.

    `scatter_param` is a metal's fuzziness or a dielectric's index."""

    scatter: str = "none"
    scatter_param: float = 0.0
    absorb: str = "black_body"
    absorb_color: Vec3 = (0.0, 0.0, 0.0)
    absorb_texture: int = 0
    emit: Emit = Emit()


@dataclass(frozen=True)
class Texture:
    """`children` are a checker's (odd, even) texture ids; `image` is an
    (H, W, 3) float32 array."""

    kind: str
    color: Vec3 = (0.0, 0.0, 0.0)
    children: Tuple[int, int] = (0, 0)
    image: Optional[np.ndarray] = None
    seed: int = 0


@dataclass(frozen=True)
class Mesh:
    positions: np.ndarray   # (V, 3) float32
    normals: np.ndarray     # (V, 3) float32, not renormalised
    uvs: np.ndarray         # (V, 2) float32
    indices: np.ndarray     # (T, 3) int32
    material: int


@dataclass
class SceneRecords:
    camera: Camera
    background: Emit
    textures: List[Texture] = field(default_factory=list)
    materials: List[Material] = field(default_factory=list)
    sphere_center: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3)))   # (S, 3) float64
    sphere_radius: np.ndarray = field(
        default_factory=lambda: np.zeros((0,)))     # (S,) float64
    sphere_material: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int64))
    meshes: List[Mesh] = field(default_factory=list)
