"""Host-side scene description: materials, textures, geometry, camera.

Everything here is plain Python/numpy, the cold path.
`SceneBuilder.build()` compiles the description into `SceneTables` (flat
structure-of-arrays torch tensors on the chosen device) that the device code
consumes branchlessly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class MeshData:
    """A triangle mesh as structure-of-arrays numpy: positions/normals/uvs
    are per deduplicated vertex; indices is (T, 3)."""

    positions: np.ndarray  # (V, 3) float32
    normals: np.ndarray    # (V, 3) float32
    uvs: np.ndarray        # (V, 2) float32
    indices: np.ndarray    # (T, 3) int32

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]


# --- dispatch kind codes (device-side switch indices) ---

SCATTER_NONE = 0
SCATTER_LAMBERT = 1
SCATTER_METAL = 2
SCATTER_DIELECTRIC = 3

ABSORB_BLACK_BODY = 0
ABSORB_WHITE_BODY = 1
ABSORB_ALBEDO = 2
ABSORB_ALBEDO_MAP = 3

EMIT_NONE = 0
EMIT_DEBUG_NORMALS = 1
EMIT_COLOR = 2
EMIT_SKY_GRADIENT = 3
EMIT_SKY_SPHERE = 4

TEX_MISSING = 0
TEX_DEBUG_UVS = 1
TEX_SOLID = 2
TEX_IMAGE = 3
TEX_CHECKER = 4
TEX_NOISE = 5
TEX_PERLIN = 6


@dataclass(frozen=True)
class Scatter:
    """Scattering function."""

    kind: int = SCATTER_NONE
    param: float = 0.0  # Metal fuzziness or Dielectric refraction index

    @staticmethod
    def none() -> "Scatter":
        return Scatter(SCATTER_NONE)

    @staticmethod
    def lambert() -> "Scatter":
        return Scatter(SCATTER_LAMBERT)

    @staticmethod
    def metal(fuzziness: float) -> "Scatter":
        return Scatter(SCATTER_METAL, float(fuzziness))

    @staticmethod
    def dielectric(refraction_index: float) -> "Scatter":
        return Scatter(SCATTER_DIELECTRIC, float(refraction_index))


@dataclass(frozen=True)
class Absorb:
    """Absorption (per-bounce tint) function."""

    kind: int = ABSORB_BLACK_BODY
    color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    texture: int = 0

    @staticmethod
    def black_body() -> "Absorb":
        return Absorb(ABSORB_BLACK_BODY)

    @staticmethod
    def white_body() -> "Absorb":
        return Absorb(ABSORB_WHITE_BODY)

    @staticmethod
    def albedo(r, g, b) -> "Absorb":
        return Absorb(ABSORB_ALBEDO, (float(r), float(g), float(b)))

    @staticmethod
    def albedo_map(texture: int) -> "Absorb":
        return Absorb(ABSORB_ALBEDO_MAP, texture=int(texture))


@dataclass(frozen=True)
class Emit:
    """Emission function."""

    kind: int = EMIT_NONE
    color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    texture: int = 0

    @staticmethod
    def none() -> "Emit":
        return Emit(EMIT_NONE)

    @staticmethod
    def debug_normals() -> "Emit":
        return Emit(EMIT_DEBUG_NORMALS)

    @staticmethod
    def color_(r, g, b) -> "Emit":
        return Emit(EMIT_COLOR, (float(r), float(g), float(b)))

    @staticmethod
    def sky_gradient() -> "Emit":
        return Emit(EMIT_SKY_GRADIENT)

    @staticmethod
    def sky_sphere(texture: int) -> "Emit":
        return Emit(EMIT_SKY_SPHERE, texture=int(texture))


@dataclass(frozen=True)
class Material:
    """Aggregate of one scatter, one absorb, one emit function
   ."""

    scatter: Scatter = field(default_factory=Scatter.none)
    absorb: Absorb = field(default_factory=Absorb.black_body)
    emit: Emit = field(default_factory=Emit.none)


@dataclass(frozen=True)
class Texture:
    """Texture description.

    `image` is an (H, W, 4) uint8 or (H, W, 3) float array; `children` are
    the checker's (odd, even) texture ids.
    """

    kind: int = TEX_MISSING
    color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    image: Optional[np.ndarray] = None
    children: Tuple[int, int] = (0, 0)
    seed: int = 0

    @staticmethod
    def missing() -> "Texture":
        return Texture(TEX_MISSING)

    @staticmethod
    def debug_uvs() -> "Texture":
        return Texture(TEX_DEBUG_UVS)

    @staticmethod
    def solid(r, g, b) -> "Texture":
        return Texture(TEX_SOLID, (float(r), float(g), float(b)))

    @staticmethod
    def image_(image: np.ndarray) -> "Texture":
        return Texture(TEX_IMAGE, image=np.asarray(image))

    @staticmethod
    def checker(odd: int, even: int) -> "Texture":
        return Texture(TEX_CHECKER, children=(int(odd), int(even)))

    @staticmethod
    def noise(seed: int) -> "Texture":
        return Texture(TEX_NOISE, seed=int(seed))

    @staticmethod
    def perlin(seed: int) -> "Texture":
        return Texture(TEX_PERLIN, seed=int(seed))


@dataclass
class Camera:
    """Thin-lens camera. Local frame:
    X right, Y up, Z behind; stored as the lookat orientation + position."""

    aspect_ratio: float = 1.0
    fov: float = np.pi / 2
    focal_dist: float = 1.0
    lens_radius: float = 0.0
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    target: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)

    def orientation(self) -> np.ndarray:
        """Columns = camera local axes; matches the reference's unnormalized
        x/y quirk (src/utility.rs:173-178): only z is unit length."""
        pos = np.asarray(self.position, np.float64)
        z = pos - np.asarray(self.target, np.float64)
        z = z / np.linalg.norm(z)
        x = np.cross(np.asarray(self.up, np.float64), z)
        y = np.cross(z, x)
        return np.stack([x, y, z], axis=-1).astype(np.float32)


@dataclass
class SceneBuilder:
    """Accumulates a scene description and compiles it to device tables.

    Replaces the reference's hand-assembled `SceneData` + `Hittable` tree
    (src/example_scenes.rs): geometry is appended as flat sphere/triangle
    records; `build()` emits `SceneTables` + acceleration structure.
    """

    camera: Camera = field(default_factory=Camera)
    background: Emit = field(default_factory=Emit.sky_gradient)

    materials: List[Material] = field(default_factory=list)
    textures: List[Texture] = field(default_factory=list)

    sphere_center: List[Tuple[float, float, float]] = field(default_factory=list)
    sphere_radius: List[float] = field(default_factory=list)
    sphere_material: List[int] = field(default_factory=list)

    meshes: List[MeshData] = field(default_factory=list)
    mesh_materials: List[int] = field(default_factory=list)

    def add_material(self, material: Material) -> int:
        self.materials.append(material)
        return len(self.materials) - 1

    def add_texture(self, texture: Texture) -> int:
        self.textures.append(texture)
        return len(self.textures) - 1

    def add_sphere(self, center, radius: float, material: int) -> None:
        self.sphere_center.append(tuple(float(c) for c in center))
        self.sphere_radius.append(float(radius))
        self.sphere_material.append(int(material))

    def add_mesh(self, mesh: MeshData, material: int) -> int:
        """Whole-mesh material, like the reference's `Mesh.material`
        (src/mesh.rs:21, hard-wired MaterialId per mesh)."""
        self.meshes.append(mesh)
        self.mesh_materials.append(int(material))
        return len(self.meshes) - 1

    def build(self, accel: str = "auto", device="cuda",
              cluster_size: int = 32):
        """Compile to device tables. `device` defaults to the card and
        raises when there is none; pass "cpu" for the plain PyTorch path."""
        from potato_tpu_torch.scene.tables import compile_scene

        return compile_scene(self, accel=accel, device=device,
                             cluster_size=cluster_size)
