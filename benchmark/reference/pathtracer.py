"""The benchmark's reference: a plain PyTorch path tracer over scene records.

It renders the frame that the port's `render()` renders, from the same
records, frame seed and frame size, and nothing that the port made: it
builds its own tables, tests every ray against every primitive, and shades
with the source's formulas. Randomness is counter-based, as in the source
the port follows: each draw is Threefry-2x32 (13 rounds) keyed by the frame
seed, with the ray id and a salt (bounce * 8 + stream) as the counter. So
the reference draws the same numbers as the port for each ray, whatever
order either takes the rays in, and frames agree up to rounding, except
where rounding sends a path another way.

`dtype` is the precision of every float computation (float32 as the
configurations state; lower only for the control). Integer work (the
cipher, ray ids, the lattice hash) stays in int64.

Imports torch and numpy only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

BIG = 3.0e38          # t of "no hit"; t_max of a live ray
RAY_EPSILON = 1e-3    # t_min of every ray
SMOL = 1e-7           # |det| below which a triangle test misses
M32 = 0xFFFFFFFF

ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
PARITY = 0x1BD11BDA
ROUNDS = 13
STREAMS = 8
JITTER, LENS, SCATTER_A, SCATTER_B = 0, 1, 2, 3

SCATTER = {"none": 0, "lambert": 1, "metal": 2, "dielectric": 3}
ABSORB = {"black_body": 0, "white_body": 1, "albedo": 2, "albedo_map": 3}
EMIT = {"none": 0, "debug_normals": 1, "color": 2, "sky_gradient": 3,
        "sky_sphere": 4}
TEX = {"missing": 0, "debug_uvs": 1, "solid": 2, "image": 3, "checker": 4,
       "noise": 5, "perlin": 6}


# ------------------------------------------------------------ randomness

def threefry(key: int, c0, c1):
    """Threefry-2x32, 13 rounds: key schedule injected after every fourth
    round and after the last. Words are int64 tensors in [0, 2^32)."""
    k0, k1 = key & M32, (key >> 32) & M32
    keys = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (c0 + k0) & M32
    x1 = (c1 + k1) & M32
    inj = 0
    for r in range(ROUNDS):
        rot = ROTATIONS[r % 8]
        x0 = (x0 + x1) & M32
        x1 = ((x1 << rot) | (x1 >> (32 - rot))) & M32
        x1 = x1 ^ x0
        if r % 4 == 3 or r == ROUNDS - 1:
            inj += 1
            x0 = (x0 + keys[inj % 3]) & M32
            x1 = (x1 + keys[(inj + 1) % 3] + inj) & M32
    return x0, x1


def _unit(bits, dtype):
    """A word's top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0).to(dtype)


def uniforms(seed: int, salt: int, ids, dtype):
    """Two uniforms in [0, 1) per ray id."""
    c1 = torch.full_like(ids, salt & M32)
    b0, b1 = threefry(seed & 0xFFFFFFFFFFFFFFFF, ids & M32, c1)
    return _unit(b0, dtype), _unit(b1, dtype)


# ---------------------------------------------------------------- tables

class Camera(NamedTuple):
    aspect: float
    tan_half_fov: float
    focal: float
    lens: float
    orientation: np.ndarray   # (3, 3) float32, columns = local axes
    position: np.ndarray      # (3,) float32


def camera_of(c) -> Camera:
    """The source's look-at frame: z unit, x = up x z and y = z x x left as
    long as the cross products make them."""
    pos = np.asarray(c.position, np.float64)
    z = pos - np.asarray(c.target, np.float64)
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(c.up, np.float64), z)
    y = np.cross(z, x)
    f32 = np.float32
    return Camera(f32(c.aspect_ratio), f32(np.tan(0.5 * c.fov)),
                  f32(c.focal_dist), f32(c.lens_radius),
                  np.stack([x, y, z], axis=-1).astype(f32),
                  np.asarray(c.position, f32))


def _checker_depth(textures) -> int:
    def depth(i, trail):
        if i in trail:
            raise ValueError("checker texture cycle")
        t = textures[i]
        if t.kind != "checker":
            return 0
        return 1 + max(depth(int(c), trail | {i}) for c in t.children)
    return max((depth(i, frozenset()) for i in range(len(textures))),
               default=0)


@dataclass
class Scene:
    """Flat tables of one scene, on one device, in one precision."""

    camera: Camera
    dtype: torch.dtype
    device: torch.device
    # spheres
    s_center: torch.Tensor
    s_radius: torch.Tensor
    s_material: torch.Tensor
    # triangles: corners, corner normals and uvs
    t_pos: torch.Tensor       # (T, 3, 3)
    t_nrm: torch.Tensor       # (T, 3, 3)
    t_uv: torch.Tensor        # (T, 3, 2)
    t_material: torch.Tensor
    # materials
    m_scatter: torch.Tensor
    m_param: torch.Tensor
    m_absorb: torch.Tensor
    m_absorb_color: torch.Tensor
    m_absorb_tex: torch.Tensor
    m_emit: torch.Tensor
    m_emit_color: torch.Tensor
    m_emit_tex: torch.Tensor
    # textures
    x_kind: torch.Tensor
    x_color: torch.Tensor
    x_children: torch.Tensor
    x_seed: torch.Tensor
    x_image: torch.Tensor     # (X, 3) int64 texel offset, width, height
    texels: torch.Tensor      # (P, 3)
    checker_depth: int
    # background
    bg_kind: int
    bg_color: torch.Tensor
    bg_tex: int


def scene_tables(rec, device, dtype=torch.float32) -> Scene:
    dev = torch.device(device)

    def f(a, shape=None):
        a = np.asarray(a, np.float32)
        if shape is not None:
            a = a.reshape(shape)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).to(dtype)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    ms = rec.materials
    xs = rec.textures
    images, meta, cursor = [], [], 0
    for t in xs:
        if t.kind == "image":
            img = np.asarray(t.image, np.float32)[..., :3]
            h, w = img.shape[:2]
            meta.append((cursor, w, h))
            images.append(img.reshape(-1, 3))
            cursor += w * h
        else:
            meta.append((0, 1, 1))
    texels = np.concatenate(images) if images else np.zeros((1, 3))

    tris = [(m.positions[m.indices], m.normals[m.indices],
             m.uvs[m.indices], np.full(m.indices.shape[0], m.material))
            for m in rec.meshes]
    if tris:
        t_pos, t_nrm, t_uv, t_mat = (np.concatenate(p) for p in zip(*tris))
    else:
        t_pos = t_nrm = np.zeros((0, 3, 3))
        t_uv, t_mat = np.zeros((0, 3, 2)), np.zeros((0,))
    bg = rec.background
    return Scene(
        camera=camera_of(rec.camera), dtype=dtype, device=dev,
        s_center=f(rec.sphere_center, (-1, 3)),
        s_radius=f(rec.sphere_radius, (-1,)),
        s_material=i(rec.sphere_material).reshape(-1),
        t_pos=f(t_pos), t_nrm=f(t_nrm), t_uv=f(t_uv), t_material=i(t_mat),
        m_scatter=i([SCATTER[m.scatter] for m in ms]),
        m_param=f([m.scatter_param for m in ms]),
        m_absorb=i([ABSORB[m.absorb] for m in ms]),
        m_absorb_color=f([m.absorb_color for m in ms], (-1, 3)),
        m_absorb_tex=i([m.absorb_texture for m in ms]),
        m_emit=i([EMIT[m.emit.kind] for m in ms]),
        m_emit_color=f([m.emit.color for m in ms], (-1, 3)),
        m_emit_tex=i([m.emit.texture for m in ms]),
        x_kind=i([TEX[t.kind] for t in xs]),
        x_color=f([t.color for t in xs], (-1, 3)),
        x_children=i([t.children for t in xs]).reshape(-1, 2),
        x_seed=i([t.seed for t in xs]),
        x_image=i(meta).reshape(-1, 3),
        texels=f(texels),
        checker_depth=_checker_depth(xs),
        bg_kind=EMIT[bg.kind], bg_color=f(bg.color), bg_tex=int(bg.texture),
    )


# ------------------------------------------------------------ vector math

def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(a, floor=0.0):
    return a / torch.sqrt(torch.clamp(dot(a, a), min=floor))[..., None]


def reflect(d, n):
    return d - 2.0 * dot(d, n)[..., None] * n


def equirect_uv(v):
    """u from the azimuth (0.5 at the poles), v from the latitude."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    r2 = x * x + z * z
    pole = r2 < 1e-12
    u = 0.5 - torch.atan2(torch.where(pole, torch.zeros_like(z), z),
                          torch.where(pole, torch.ones_like(x), x)) \
        / (2.0 * math.pi)
    w = torch.atan2(y, torch.sqrt(r2 + 1e-12)) / math.pi + 0.5
    return torch.stack([u, w], -1)


def unit_sphere(u1, u2):
    """Uniform on the sphere; the sine from the cosine, signed by u2."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    c = torch.cos((2.0 * math.pi) * u2)
    s = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    s = torch.where(u2 < 0.5, s, -s)
    return torch.stack([r * c, r * s, z], -1)


# ----------------------------------------------------------------- camera

def camera_rays(scene: Scene, width, height, spp, ids, seed):
    """Ray id -> pixel (id // spp, row-major) -> jittered thin-lens ray."""
    dt = scene.dtype
    cam = scene.camera
    pixel = ids // spp
    i = (pixel % width).to(dt)
    j = (pixel // width).to(dt)
    j1, j2 = uniforms(seed, JITTER, ids, dt)
    u = (i + j1) / float(width)
    v = (j + j2) / float(height)
    zero = torch.zeros_like(u)
    if cam.lens > 0.0:
        l1, l2 = uniforms(seed, LENS, ids, dt)
        r = torch.sqrt(l1)
        th = (2.0 * math.pi) * l2
        lens = torch.tensor(cam.lens, dtype=dt, device=u.device)
        ox, oy = r * torch.cos(th) * lens, r * torch.sin(th) * lens
    else:
        ox = oy = zero
    const = {k: torch.tensor(getattr(cam, k), dtype=dt, device=u.device)
             for k in ("aspect", "tan_half_fov", "focal")}
    scale = const["tan_half_fov"] * const["focal"]
    local = torch.stack([(2.0 * u - 1.0) * scale * const["aspect"],
                         (2.0 * v - 1.0) * scale,
                         -const["focal"] * torch.ones_like(u)], -1)
    o_local = torch.stack([ox, oy, zero], -1)
    d_local = normalize(local - o_local)
    rot = torch.as_tensor(cam.orientation, device=u.device).to(dt)
    pos = torch.as_tensor(cam.position, device=u.device).to(dt)
    direction = torch.sum(rot * d_local[:, None, :], dim=-1)
    origin = torch.sum(rot * o_local[:, None, :], dim=-1) + pos
    return origin, direction


# ---------------------------------------------------------- intersection

class Hit(NamedTuple):
    valid: torch.Tensor
    position: torch.Tensor
    normal: torch.Tensor
    uv: torch.Tensor
    material: torch.Tensor


def _spheres(scene, o, d):
    """Closest sphere over every sphere: half-b quadratic, the near root if
    in range, else the far one."""
    oc = o[:, None, :] - scene.s_center[None]
    dd = d[:, None, :]
    a = dot(dd, dd)
    hb = dot(oc, dd)
    c = dot(oc, oc) - scene.s_radius * scene.s_radius
    delta = hb * hb - a * c
    ok = delta > 0.0
    sq = torch.sqrt(torch.where(ok, delta, torch.ones_like(delta)))
    t0 = (-hb - sq) / a
    t1 = (-hb + sq) / a
    in0 = (t0 >= RAY_EPSILON) & (t0 <= BIG)
    in1 = (t1 >= RAY_EPSILON) & (t1 <= BIG)
    t = torch.where(in0, t0, t1)
    t = torch.where(ok & (in0 | in1), t, torch.full_like(t, math.inf))
    return t.min(dim=1)


def _triangles(scene, o, d):
    """Closest triangle over every triangle: Cramer's rule on
    [a-b, a-c, d] [u v t] = a-o; u weights corner b, v corner c."""
    p = scene.t_pos
    ba = (p[:, 0] - p[:, 1])[None]
    ca = (p[:, 0] - p[:, 2])[None]
    n = cross(ba, ca)
    po = p[None, :, 0] - o[:, None, :]
    dd = d[:, None, :].expand_as(po)
    cxd = cross(ca.expand_as(po), dd)
    det = dot(ba, cxd)
    ok = det.abs() >= SMOL
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                      torch.zeros_like(det))
    t = dot(po, n) * inv
    u = dot(po, cxd) * inv
    v = dot(dd, cross(ba.expand_as(po), po)) * inv
    w = 1.0 - u - v
    ok = (ok & (t >= RAY_EPSILON) & (t <= BIG) & (u >= 0.0) & (v >= 0.0)
          & (w >= 0.0))
    t = torch.where(ok, t, torch.full_like(t, math.inf))
    best_t, best = t.min(dim=1)
    take = best[:, None]
    return best_t, best, u.gather(1, take)[:, 0], v.gather(1, take)[:, 0]


def intersect(scene: Scene, o, d, block: int) -> Hit:
    """Closest hit of each ray over all primitives, `block` rays at a
    time. A sphere wins a tie with a triangle."""
    n = o.shape[0]
    dt, dev = scene.dtype, o.device
    inf = torch.full((n,), math.inf, dtype=dt, device=dev)
    s_t, s_i = inf.clone(), torch.zeros(n, dtype=torch.int64, device=dev)
    r_t, r_i = inf.clone(), torch.zeros_like(s_i)
    r_u, r_v = torch.zeros_like(inf), torch.zeros_like(inf)
    for lo in range(0, n, block):
        sl = slice(lo, min(n, lo + block))
        if scene.s_center.shape[0]:
            s_t[sl], s_i[sl] = _spheres(scene, o[sl], d[sl])
        if scene.t_pos.shape[0]:
            r_t[sl], r_i[sl], r_u[sl], r_v[sl] = _triangles(scene, o[sl], d[sl])
    s_hit, r_hit = s_t < math.inf, r_t < math.inf
    sphere = s_hit & (~r_hit | (s_t <= r_t))
    t = torch.where(sphere, s_t, r_t)
    t = torch.where(s_hit | r_hit, t, torch.ones_like(t))
    position = o + t[:, None] * d
    if scene.s_center.shape[0]:
        c, r = scene.s_center[s_i], scene.s_radius[s_i]
        s_n = (position - c) / torch.where(r == 0.0, torch.ones_like(r), r)[:, None]
        s_m = scene.s_material[s_i]
    else:
        s_n, s_m = torch.zeros_like(position), torch.zeros_like(s_i)
    if scene.t_pos.shape[0]:
        w = (1.0 - r_u - r_v)[:, None]
        nrm, uvs = scene.t_nrm[r_i], scene.t_uv[r_i]
        r_n = w * nrm[:, 0] + r_u[:, None] * nrm[:, 1] + r_v[:, None] * nrm[:, 2]
        r_uv = w * uvs[:, 0] + r_u[:, None] * uvs[:, 1] + r_v[:, None] * uvs[:, 2]
        r_m = scene.t_material[r_i]
    else:
        r_n, r_uv, r_m = torch.zeros_like(position), None, torch.zeros_like(r_i)
    sw = sphere[:, None]
    normal = torch.where(sw, s_n, r_n)
    uv = equirect_uv(s_n) if r_uv is None else torch.where(sw, equirect_uv(s_n), r_uv)
    return Hit(s_hit | r_hit, position, normal, uv,
               torch.where(sphere, s_m, r_m))


# ---------------------------------------------------------------- shading

def _lattice(x, y, z, seed):
    """The 64-bit lattice hash (wrapping int64) -> float in [-1, 1]."""
    h = (x * 0x369E6D3B899E43CF + y * 0x53F89E7FFDA3B07D
         + z * 0x3B13C1CA4937E629 + seed * 0x577C2C6E4019D645)
    h = (h >> 13) ^ h
    h = h * (h * h * 60493 + 19990303) + 1376312589
    hi = (h >> 32).to(torch.float32)
    lo = (h & M32).to(torch.float32)
    return (hi * float(2 ** 32) + lo) / float(2 ** 63 - 1)


def _perlin(p, seed):
    fp = torch.floor(p)
    fl = fp.to(torch.int64)
    t = p - fp
    t = (t * (t * 6.0 - 15.0) + 10.0) * t * t * t
    corners = {}
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                ix, iy, iz = fl[:, 0] + cx, fl[:, 1] + cy, fl[:, 2] + cz
                g = [_lattice(ix, iy, iz, seed + k).to(p.dtype) for k in (1, 2, 3)]
                corners[cx, cy, cz] = ((p[:, 0] - ix.to(p.dtype)) * g[0]
                                       + (p[:, 1] - iy.to(p.dtype)) * g[1]
                                       + (p[:, 2] - iz.to(p.dtype)) * g[2])

    def mix(a, b, s):
        return (b - a) * s + a

    tx, ty, tz = t[:, 0], t[:, 1], t[:, 2]
    lo = mix(mix(corners[0, 0, 0], corners[1, 0, 0], tx),
             mix(corners[0, 1, 0], corners[1, 1, 0], tx), ty)
    hi = mix(mix(corners[0, 0, 1], corners[1, 0, 1], tx),
             mix(corners[0, 1, 1], corners[1, 1, 1], tx), ty)
    return 0.5 * mix(lo, hi, tz) + 0.5


def texture(scene: Scene, tid, position, uv, depth=None):
    """Per-lane texture ids -> colour; a checker's child by the parity of
    floor(x) + floor(y) + floor(z), at most `depth` checkers deep."""
    if depth is None:
        depth = scene.checker_depth
    kind = scene.x_kind[tid]
    out = torch.zeros_like(position)

    def put(k, value):
        nonlocal out
        out = torch.where((kind == k)[:, None], value, out)

    put(TEX["debug_uvs"], torch.stack([uv[:, 0], uv[:, 1],
                                       torch.zeros_like(uv[:, 0])], -1))
    put(TEX["solid"], scene.x_color[tid])
    meta = scene.x_image[tid]
    w, h = meta[:, 1].to(uv.dtype), meta[:, 2].to(uv.dtype)
    ix = torch.minimum(torch.clamp(uv[:, 0] * w, min=0.0), w - 1.0).long()
    iy = torch.minimum(torch.clamp(uv[:, 1] * h, min=0.0), h - 1.0).long()
    texel = (meta[:, 0] + iy * meta[:, 1] + ix).clamp(0, scene.texels.shape[0] - 1)
    put(TEX["image"], scene.texels[texel])
    if depth > 0 and bool((kind == TEX["checker"]).any()):
        even = torch.remainder(torch.floor(position).sum(-1), 2.0) == 0.0
        children = scene.x_children[tid]
        child = torch.where(even, children[:, 1], children[:, 0])
        put(TEX["checker"], texture(scene, child, position, uv, depth - 1))
    if bool((kind == TEX["noise"]).any()):
        f = torch.floor(position).to(torch.int64)
        val = 0.5 * _lattice(f[:, 0], f[:, 1], f[:, 2],
                             scene.x_seed[tid]).to(position.dtype) + 0.5
        put(TEX["noise"], val[:, None].expand_as(out))
    if bool((kind == TEX["perlin"]).any()):
        val = _perlin(position, scene.x_seed[tid])
        put(TEX["perlin"], val[:, None].expand_as(out))
    return out


def emission(scene: Scene, kind, color, tex, direction, position, normal, uv):
    out = torch.zeros_like(direction)

    def put(k, value):
        nonlocal out
        out = torch.where((kind == k)[:, None], value, out)

    put(EMIT["debug_normals"], normal)
    put(EMIT["color"], color)
    up = direction[:, 1] / torch.sqrt(dot(direction, direction))
    t = (0.5 * (up + 1.0))[:, None]
    zenith = torch.tensor([0.5, 0.7, 1.0], dtype=out.dtype, device=out.device)
    put(EMIT["sky_gradient"], (1.0 - t) + t * zenith)
    if bool((kind == EMIT["sky_sphere"]).any()):
        put(EMIT["sky_sphere"], texture(scene, tex, position, uv))
    return out


def background(scene: Scene, direction):
    """The scene's emission for a ray that hits nothing: a hit on the
    sphere at infinity, at the ray's direction."""
    n = direction.shape[0]
    kind = torch.full((n,), scene.bg_kind, device=direction.device)
    tex = torch.full((n,), scene.bg_tex, device=direction.device)
    return emission(scene, kind, scene.bg_color.expand(n, 3), tex, direction,
                    direction, direction, equirect_uv(direction))


def material(scene: Scene, hit: Hit, d, u1, u2, u3, u4):
    """(scatter direction, scatter valid, absorb, emit) of each hit."""
    m = hit.material
    kind = scene.m_scatter[m]
    param = scene.m_param[m]
    n = hit.normal
    backface = dot(n, d) > 0.0
    direction = torch.zeros_like(d)
    direction[:, 2] = 1.0
    valid = torch.zeros_like(backface)

    lambert = normalize(n + unit_sphere(u1, u2), floor=1e-20)
    is_l = kind == SCATTER["lambert"]
    direction = torch.where(is_l[:, None], lambert, direction)
    valid = torch.where(is_l, ~backface, valid)

    ball = unit_sphere(u1, u2) * torch.pow(u3, 1.0 / 3.0)[:, None]
    metal = normalize(reflect(d, n) + param[:, None] * ball, floor=1e-20)
    is_m = kind == SCATTER["metal"]
    direction = torch.where(is_m[:, None], metal, direction)
    valid = torch.where(is_m, ~backface & (dot(n, metal) >= 0.0), valid)

    nn = torch.where(backface[:, None], -n, n)
    eta = torch.where(backface, param, 1.0 / torch.clamp(param, min=1e-8))
    cos = dot(nn, d)
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    reflectance = r0 + (1.0 - r0) * (1.0 + cos) ** 5
    k = 1.0 - eta * eta * (1.0 - cos * cos)
    refracts = k > 0.0
    refracted = (eta[:, None] * d - (eta * cos + torch.sqrt(
        torch.where(refracts, k, torch.ones_like(k))))[:, None] * nn)
    mirror = (u4 < reflectance) | ~refracts
    glass = torch.where(mirror[:, None], reflect(d, nn), refracted)
    is_g = kind == SCATTER["dielectric"]
    direction = torch.where(is_g[:, None], glass, direction)
    valid = valid | is_g

    a_kind = scene.m_absorb[m]
    absorb = torch.zeros_like(d)
    absorb = torch.where((a_kind == ABSORB["white_body"])[:, None],
                         torch.ones_like(d), absorb)
    absorb = torch.where((a_kind == ABSORB["albedo"])[:, None],
                         scene.m_absorb_color[m], absorb)
    mapped = a_kind == ABSORB["albedo_map"]
    if bool(mapped.any()):
        absorb = torch.where(mapped[:, None], texture(
            scene, scene.m_absorb_tex[m], hit.position, hit.uv), absorb)
    emit = emission(scene, scene.m_emit[m], scene.m_emit_color[m],
                    scene.m_emit_tex[m], d, hit.position, n, hit.uv)
    return direction, valid, absorb, emit


# ------------------------------------------------------------- integrator

class Paths(NamedTuple):
    color: torch.Tensor    # (N, 3)
    normal: torch.Tensor   # (N, 3) first hit's normal, 0 on a miss
    hit: torch.Tensor      # (N,) bool, the camera ray hit something
    segments: int          # segments traced: live paths summed over bounces


def trace(scene: Scene, ids, width, height, spp, max_bounce, seed,
          block: int = 2048) -> Paths:
    """Trace the camera rays of `ids` (int64) to the end of their paths:
    emission plus absorb times what the scattered ray brings, for at most
    `max_bounce` segments. Only the paths still alive are traced at each
    bounce."""
    o, d = camera_rays(scene, width, height, spp, ids, seed)
    n = ids.shape[0]
    dt, dev = scene.dtype, ids.device
    color = torch.zeros((n, 3), dtype=dt, device=dev)
    through = torch.ones((n, 3), dtype=dt, device=dev)
    normal = torch.zeros((n, 3), dtype=dt, device=dev)
    first_hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    live = torch.arange(n, device=dev)
    segments = 0
    for bounce in range(max_bounce):
        if live.numel() == 0:
            break
        segments += live.numel()
        lo, ld, lid = o[live], d[live], ids[live]
        hit = intersect(scene, lo, ld, block)
        u1, u2 = uniforms(seed, bounce * STREAMS + SCATTER_A, lid, dt)
        u3, u4 = uniforms(seed, bounce * STREAMS + SCATTER_B, lid, dt)
        direction, scatters, absorb, emit = material(scene, hit, ld, u1, u2,
                                                     u3, u4)
        got = torch.where(hit.valid[:, None], emit, background(scene, ld))
        color[live] = color[live] + through[live] * got
        if bounce == 0:
            normal[live] = torch.where(hit.valid[:, None], hit.normal,
                                       torch.zeros_like(hit.normal))
            first_hit[live] = hit.valid
        through[live] = torch.where(hit.valid[:, None], through[live] * absorb,
                                    through[live])
        go = hit.valid & scatters
        o[live] = hit.position
        d[live] = direction
        live = live[go]
    return Paths(color, normal, first_hit, segments)


class Frame(NamedTuple):
    color: np.ndarray      # (H, W, 3) float32, mean over the samples
    normal: np.ndarray     # (H, W, 3)
    coverage: np.ndarray   # (H, W) share of samples whose camera ray hit
    segments: int


def render(scene: Scene, width, height, spp, max_bounce, seed,
           rays_per_pass: int = 1 << 16, block: int = 2048) -> Frame:
    """The whole frame, `rays_per_pass` camera rays at a time, in ray-id
    order (id = pixel * spp + sample, pixel = row * width + column)."""
    total = width * height * spp
    parts = []
    segments = 0
    for lo in range(0, total, rays_per_pass):
        ids = torch.arange(lo, min(total, lo + rays_per_pass),
                           dtype=torch.int64, device=scene.device)
        p = trace(scene, ids, width, height, spp, max_bounce, seed, block)
        parts.append((p.color, p.normal, p.hit))
        segments += p.segments
    color, normal, hit = (torch.cat(x) for x in zip(*parts))

    def image(rows, channels):
        return (rows.float().reshape((height, width, spp) + channels)
                .mean(dim=2).cpu().numpy())

    return Frame(image(color, (3,)), image(normal, (3,)), image(hit, ()),
                 segments)
