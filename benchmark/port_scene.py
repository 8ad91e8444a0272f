"""Scene records -> the port's `SceneBuilder`, built on the device with the
port's default accelerator. The port derives its tables, accelerator and
queues from these records itself."""

from __future__ import annotations

from benchmark.records import SceneRecords


def _emit(d, e):
    return {
        "none": lambda: d.Emit.none(),
        "debug_normals": lambda: d.Emit.debug_normals(),
        "color": lambda: d.Emit.color_(*e.color),
        "sky_gradient": lambda: d.Emit.sky_gradient(),
        "sky_sphere": lambda: d.Emit.sky_sphere(e.texture),
    }[e.kind]()


def _material(d, m):
    scatter = {
        "none": lambda: d.Scatter.none(),
        "lambert": lambda: d.Scatter.lambert(),
        "metal": lambda: d.Scatter.metal(m.scatter_param),
        "dielectric": lambda: d.Scatter.dielectric(m.scatter_param),
    }[m.scatter]()
    absorb = {
        "black_body": lambda: d.Absorb.black_body(),
        "white_body": lambda: d.Absorb.white_body(),
        "albedo": lambda: d.Absorb.albedo(*m.absorb_color),
        "albedo_map": lambda: d.Absorb.albedo_map(m.absorb_texture),
    }[m.absorb]()
    return d.Material(scatter, absorb, _emit(d, m.emit))


def _texture(d, t):
    return {
        "missing": lambda: d.Texture.missing(),
        "debug_uvs": lambda: d.Texture.debug_uvs(),
        "solid": lambda: d.Texture.solid(*t.color),
        "image": lambda: d.Texture.image_(t.image),
        "checker": lambda: d.Texture.checker(*t.children),
        "noise": lambda: d.Texture.noise(t.seed),
        "perlin": lambda: d.Texture.perlin(t.seed),
    }[t.kind]()


def scene_builder(rec: SceneRecords):
    from potato_tpu_torch.scene import description as d

    s = d.SceneBuilder()
    c = rec.camera
    s.camera = d.Camera(aspect_ratio=c.aspect_ratio, fov=c.fov,
                        focal_dist=c.focal_dist, lens_radius=c.lens_radius,
                        position=c.position, target=c.target, up=c.up)
    s.background = _emit(d, rec.background)
    for t in rec.textures:
        s.add_texture(_texture(d, t))
    for m in rec.materials:
        s.add_material(_material(d, m))
    for center, radius, mat in zip(rec.sphere_center, rec.sphere_radius,
                                   rec.sphere_material):
        s.add_sphere(center, radius, int(mat))
    for mesh in rec.meshes:
        s.add_mesh(d.MeshData(positions=mesh.positions, normals=mesh.normals,
                              uvs=mesh.uvs, indices=mesh.indices),
                   mesh.material)
    return s


def build(rec: SceneRecords, device):
    return scene_builder(rec).build(device=device)
