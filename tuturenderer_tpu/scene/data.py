"""Scene-as-arrays: the device-side scene representation.

The reference scene is a ``vector<unique_ptr<Object>>`` with virtual
dispatch (Scene.hpp:11-40, Object.hpp:15-44). Here the scene instead
becomes flat structure-of-arrays buffers — triangles ``[T]``, spheres
``[S]``, a material table ``[M]`` indexed per primitive, texture atlases,
and a light table — replicated per device and consumed by vectorized
kernels. One masked blend over material types replaces virtual
``BxDF/sampleDirection/pdf`` calls (Material.hpp:62-439).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.vec import Vec3

# material type enum (Material.hpp:9-16)
LAMBERTIAN = 0
PERFECT_REFLECTIVE = 1
PERFECT_REFRACTIVE = 2
MICROFACET_R = 3
MICROFACET_T = 4
UNLIT = 5

TRIANGLE = 0
SPHERE = 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MaterialTable:
    mtype: jnp.ndarray        # [M] int32
    diffuse: Vec3             # [M]
    specular: Vec3            # [M]
    emission: Vec3            # [M]
    alpha: jnp.ndarray        # [M] opacity
    eta: jnp.ndarray          # [M] index of refraction
    roughness: jnp.ndarray    # [M]
    metallic: jnp.ndarray     # [M]
    diffuse_map: jnp.ndarray  # [M] int32, -1 = none
    normal_map: jnp.ndarray
    roughness_map: jnp.ndarray
    metallic_map: jnp.ndarray

    @property
    def n(self) -> int:
        return self.mtype.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TextureAtlas:
    """Fixed-size-padded stack of textures of one category.

    ``rgb`` is [K, Hmax, Wmax, 3]; per-texture true sizes in ``w``/``h``.
    Lookup reproduces nearest-neighbor repeat-wrap (Texture.hpp:18-39).
    """
    rgb: jnp.ndarray   # [K, Hmax, Wmax, 3] f32
    w: jnp.ndarray     # [K] int32
    h: jnp.ndarray     # [K] int32

    @property
    def k(self) -> int:
        return self.rgb.shape[0]

    def sample(self, idx, u, v) -> Vec3:
        """Nearest-neighbor sample with repeat wrap; idx<0 returns zeros."""
        safe = jnp.maximum(idx, 0)
        # repeat wrap (Texture.hpp:22-29): u>0 -> frac(u); u<=0 -> 1-frac(|u|)
        uw = jnp.where(u > 0, u - jnp.floor(u), 1.0 - (jnp.abs(u) - jnp.floor(jnp.abs(u))))
        vw = jnp.where(v > 0, v - jnp.floor(v), 1.0 - (jnp.abs(v) - jnp.floor(jnp.abs(v))))
        tw = self.w[safe]
        th = self.h[safe]
        x = jnp.clip((uw * tw).astype(jnp.int32), 0, tw - 1)
        y = jnp.clip((vw * th).astype(jnp.int32), 0, th - 1)
        texel = self.rgb[safe, y, x]     # [N, 3] gather
        valid = (idx >= 0)[..., None]
        texel = jnp.where(valid, texel, 0.0)
        return Vec3(texel[..., 0], texel[..., 1], texel[..., 2])


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneData:
    # triangles [T]
    tv0: Vec3
    tv1: Vec3
    tv2: Vec3
    tn0: Vec3
    tn1: Vec3
    tn2: Vec3
    tuv0u: jnp.ndarray
    tuv0v: jnp.ndarray
    tuv1u: jnp.ndarray
    tuv1v: jnp.ndarray
    tuv2u: jnp.ndarray
    tuv2v: jnp.ndarray
    tmat: jnp.ndarray        # [T] int32 material id
    tarea: jnp.ndarray       # [T] f32
    # packed per-triangle shading row [T, 20]: n0(3) n1(3) n2(3) ng(3)
    # uv0(2) uv1(2) uv2(2) mat(1,f32) area(1). ONE row gather replaces
    # ~25 scalar-column gathers in shade_hit
    tri_shade: jnp.ndarray
    # packed per-triangle tangent frame [T, 6]: tangent(3) bitangent(3)
    # from the reference's UV-delta TBN (IIntegrator.hpp:45-56),
    # precomputed on host so normal mapping is ONE row gather instead of
    # ~17 per-column gathers of triangle constants
    tri_tbn: jnp.ndarray
    # spheres [S]
    scenter: Vec3
    sradius: jnp.ndarray
    smat: jnp.ndarray
    sarea: jnp.ndarray       # per area convention chosen at build
    # materials
    materials: MaterialTable
    # lights [L]
    light_kind: jnp.ndarray  # [L] int32 TRIANGLE/SPHERE
    light_idx: jnp.ndarray   # [L] int32 into tri/sphere arrays
    light_area: jnp.ndarray  # [L] f32
    # per-light denormalized geometry + emission so emitter sampling
    # gathers only from [L]-sized tables (small-table gathers lower to
    # selects; indexing the full [T] tables through light_idx costs a
    # slow per-lane gather loop on every NEE). Triangle lights only;
    # sphere lights read the (small) sphere table directly.
    light_v0: Vec3           # [L]
    light_v1: Vec3
    light_v2: Vec3
    light_n0: Vec3
    light_n1: Vec3
    light_n2: Vec3
    light_emission: Vec3     # [L] resolved material emission
    # textures
    diffuse_maps: TextureAtlas
    normal_maps: TextureAtlas
    roughness_maps: TextureAtlas
    metallic_maps: TextureAtlas
    # globals
    bkgcolor: Vec3           # scalar Vec3
    eta: jnp.ndarray         # scene index of refraction (scalar)
    # acceleration structure: flattened stack-traversal BVH for large
    # meshes (ops/bvh.py); None = dense streaming intersection
    bvh: object
    # static metadata
    has_textures: bool = dataclasses.field(metadata=dict(static=True))
    # material types present (static): kernels instantiate only these
    # branches instead of all six (scene-adaptive specialization)
    mtype_set: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def n_tris(self) -> int:
        return self.tmat.shape[0]

    @property
    def n_spheres(self) -> int:
        return self.smat.shape[0]

    @property
    def n_lights(self) -> int:
        return self.light_kind.shape[0]


def _stack_textures(textures: List[np.ndarray]) -> TextureAtlas:
    if not textures:
        return TextureAtlas(rgb=jnp.zeros((1, 1, 1, 3), jnp.float32),
                            w=jnp.ones((1,), jnp.int32),
                            h=jnp.ones((1,), jnp.int32))
    hmax = max(t.shape[0] for t in textures)
    wmax = max(t.shape[1] for t in textures)
    k = len(textures)
    rgb = np.zeros((k, hmax, wmax, 3), np.float32)
    w = np.zeros((k,), np.int32)
    h = np.zeros((k,), np.int32)
    for i, t in enumerate(textures):
        h[i], w[i] = t.shape[0], t.shape[1]
        rgb[i, :h[i], :w[i]] = t
    return TextureAtlas(rgb=jnp.asarray(rgb), w=jnp.asarray(w), h=jnp.asarray(h))


class SceneBuilder:
    """Host-side scene assembly; the analogue of PPMGenerator scene state
    (PPMGenerator.hpp:33-72) plus Scene::add (Scene.hpp:20-26)."""

    def __init__(self, bkgcolor=(0.0, 0.0, 0.0), eta: float = 1.0,
                 tutu_sphere_area: bool = False):
        self.bkgcolor = np.asarray(bkgcolor, np.float32)
        self.eta = float(eta)
        self.tutu_sphere_area = tutu_sphere_area
        self._mat = dict(mtype=[], diffuse=[], specular=[], emission=[],
                         alpha=[], eta=[], roughness=[], metallic=[],
                         dmap=[], nmap=[], rmap=[], mmap=[])
        self._tris: List[np.ndarray] = []   # each [n, 3, 3] verts
        self._tri_normals: List[np.ndarray] = []
        self._tri_uvs: List[np.ndarray] = []
        self._tri_mat: List[np.ndarray] = []
        self._sph_center: List[np.ndarray] = []
        self._sph_radius: List[float] = []
        self._sph_mat: List[int] = []
        self.textures = dict(diffuse=[], normal=[], roughness=[], metallic=[])
        self._texture_names = dict(diffuse={}, normal={}, roughness={}, metallic={})

    # ---- materials ----
    def add_material(self, mtype=LAMBERTIAN, diffuse=(0.9, 0.9, 0.9),
                     specular=(1.0, 1.0, 1.0), emission=(0.0, 0.0, 0.0),
                     alpha=1.0, eta=1.0, roughness=1.0, metallic=0.0,
                     diffuse_map=-1, normal_map=-1, roughness_map=-1,
                     metallic_map=-1) -> int:
        key = (int(mtype), tuple(np.ravel(diffuse).tolist()),
               tuple(np.ravel(specular).tolist()),
               tuple(np.ravel(emission).tolist()),
               float(alpha), float(eta), float(roughness), float(metallic),
               int(diffuse_map), int(normal_map), int(roughness_map),
               int(metallic_map))
        if not hasattr(self, "_mat_dedup"):
            self._mat_dedup = {}
        if key in self._mat_dedup:
            return self._mat_dedup[key]
        m = self._mat
        m['mtype'].append(int(mtype))
        m['diffuse'].append(np.asarray(diffuse, np.float32))
        m['specular'].append(np.asarray(specular, np.float32))
        m['emission'].append(np.asarray(emission, np.float32))
        m['alpha'].append(float(alpha))
        m['eta'].append(float(eta))
        m['roughness'].append(float(roughness))
        m['metallic'].append(float(metallic))
        m['dmap'].append(int(diffuse_map))
        m['nmap'].append(int(normal_map))
        m['rmap'].append(int(roughness_map))
        m['mmap'].append(int(metallic_map))
        idx = len(m['mtype']) - 1
        self._mat_dedup[key] = idx
        return idx

    def add_texture(self, category: str, name: str, rgb: np.ndarray) -> int:
        """Dedup-by-name texture registration (PPMGenerator.hpp:1027-1033)."""
        names = self._texture_names[category]
        if name in names:
            return names[name]
        idx = len(self.textures[category])
        self.textures[category].append(np.asarray(rgb, np.float32))
        names[name] = idx
        return idx

    # ---- geometry ----
    def add_triangles(self, verts: np.ndarray, normals: Optional[np.ndarray],
                      uvs: Optional[np.ndarray], material: int):
        """verts [n,3,3]; normals [n,3,3] or None (-> face normals);
        uvs [n,3,2] or None."""
        verts = np.asarray(verts, np.float32)
        n = verts.shape[0]
        if n == 0:
            return
        if normals is None:
            e1 = verts[:, 1] - verts[:, 0]
            e2 = verts[:, 2] - verts[:, 0]
            fn = np.cross(e1, e2)
            fn = fn / np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
            normals = np.repeat(fn[:, None, :], 3, axis=1)
        if uvs is None:
            uvs = np.full((n, 3, 2), -1.0, np.float32)
        self._tris.append(verts)
        self._tri_normals.append(np.asarray(normals, np.float32))
        self._tri_uvs.append(np.asarray(uvs, np.float32))
        self._tri_mat.append(np.full((n,), material, np.int32))

    def add_sphere(self, center, radius: float, material: int):
        self._sph_center.append(np.asarray(center, np.float32))
        self._sph_radius.append(float(radius))
        self._sph_mat.append(int(material))

    # ---- build ----
    def build(self, use_bvh=None) -> SceneData:
        """use_bvh: None = auto (BVH when the triangle count exceeds the
        dense-streaming threshold), True/False to force."""
        if self._tris:
            verts = np.concatenate(self._tris, 0)
            normals = np.concatenate(self._tri_normals, 0)
            uvs = np.concatenate(self._tri_uvs, 0)
            tmat = np.concatenate(self._tri_mat, 0)
        else:
            verts = np.zeros((0, 3, 3), np.float32)
            normals = np.zeros((0, 3, 3), np.float32)
            uvs = np.zeros((0, 3, 2), np.float32)
            tmat = np.zeros((0,), np.int32)
        e1 = verts[:, 1] - verts[:, 0]
        e2 = verts[:, 2] - verts[:, 0]
        tcross = np.cross(e1, e2)
        tarea = 0.5 * np.linalg.norm(tcross, axis=1)
        tng = tcross / np.maximum(
            np.linalg.norm(tcross, axis=1, keepdims=True), 1e-30)
        tri_shade = np.concatenate([
            normals.reshape(-1, 9), tng.astype(np.float32),
            uvs.reshape(-1, 6), tmat[:, None].astype(np.float32),
            tarea[:, None].astype(np.float32)], axis=1).astype(np.float32)
        # UV-delta tangent frame (changeNormalDir triangle branch,
        # IIntegrator.hpp:45-56), f32 to match the former in-kernel math
        e1f = e1.astype(np.float32)
        e2f = e2.astype(np.float32)
        du1 = (uvs[:, 1, 0] - uvs[:, 0, 0]).astype(np.float32)
        dv1 = (uvs[:, 1, 1] - uvs[:, 0, 1]).astype(np.float32)
        du2 = (uvs[:, 2, 0] - uvs[:, 0, 0]).astype(np.float32)
        dv2 = (uvs[:, 2, 1] - uvs[:, 0, 1]).astype(np.float32)
        det = -du1 * dv2 + dv1 * du2
        coef = (1.0 / np.where(det == 0.0, 1.0, det)).astype(np.float32)
        t_v = (e1f * (-dv2)[:, None] + e2f * dv1[:, None]) * coef[:, None]
        b_v = (e1f * (-du2)[:, None] + e2f * du1[:, None]) * coef[:, None]
        t_v = t_v / np.maximum(np.linalg.norm(t_v, axis=1, keepdims=True),
                               1e-20)
        b_v = b_v / np.maximum(np.linalg.norm(b_v, axis=1, keepdims=True),
                               1e-20)
        tri_tbn = np.concatenate([t_v, b_v], axis=1).astype(np.float32)

        if self._sph_center:
            sc = np.stack(self._sph_center, 0)
            sr = np.asarray(self._sph_radius, np.float32)
            smat = np.asarray(self._sph_mat, np.int32)
        else:
            sc = np.zeros((0, 3), np.float32)
            sr = np.zeros((0,), np.float32)
            smat = np.zeros((0,), np.int32)
        # sphere area: reference returns pi r^2 (Sphere.hpp:135-137, a bug);
        # default here is the true 4 pi r^2
        factor = np.pi if self.tutu_sphere_area else 4.0 * np.pi
        sarea = factor * sr * sr

        m = self._mat
        emission = np.stack(m['emission'], 0) if m['mtype'] else np.zeros((0, 3), np.float32)
        is_light = emission.any(axis=1) if len(emission) else np.zeros((0,), bool)

        # light list: every primitive whose material emits
        # (PPMGenerator::initializeLights, PPMGenerator.hpp:317-324)
        lk, li, la = [], [], []
        lverts, lnorms, lem = [], [], []
        for i in range(len(tmat)):
            if is_light[tmat[i]]:
                lk.append(TRIANGLE)
                li.append(i)
                la.append(tarea[i])
                lverts.append(verts[i])
                lnorms.append(normals[i])
                lem.append(emission[tmat[i]])
        for i in range(len(smat)):
            if is_light[smat[i]]:
                lk.append(SPHERE)
                li.append(i)
                la.append(sarea[i])
                lverts.append(np.zeros((3, 3), np.float32))
                lnorms.append(np.zeros((3, 3), np.float32))
                lem.append(emission[smat[i]])
        lverts = np.stack(lverts, 0) if lverts else np.zeros((0, 3, 3), np.float32)
        lnorms = np.stack(lnorms, 0) if lnorms else np.zeros((0, 3, 3), np.float32)
        lem = np.stack(lem, 0) if lem else np.zeros((0, 3), np.float32)

        def v3(a, axis_n=3):
            a = np.asarray(a, np.float32).reshape(-1, axis_n)
            return Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))

        materials = MaterialTable(
            mtype=jnp.asarray(np.asarray(m['mtype'], np.int32)),
            diffuse=v3(np.stack(m['diffuse'], 0) if m['mtype'] else np.zeros((0, 3))),
            specular=v3(np.stack(m['specular'], 0) if m['mtype'] else np.zeros((0, 3))),
            emission=v3(emission),
            alpha=jnp.asarray(np.asarray(m['alpha'], np.float32)),
            eta=jnp.asarray(np.asarray(m['eta'], np.float32)),
            roughness=jnp.asarray(np.asarray(m['roughness'], np.float32)),
            metallic=jnp.asarray(np.asarray(m['metallic'], np.float32)),
            diffuse_map=jnp.asarray(np.asarray(m['dmap'], np.int32)),
            normal_map=jnp.asarray(np.asarray(m['nmap'], np.int32)),
            roughness_map=jnp.asarray(np.asarray(m['rmap'], np.int32)),
            metallic_map=jnp.asarray(np.asarray(m['mmap'], np.int32)),
        )

        return SceneData(
            tv0=v3(verts[:, 0]), tv1=v3(verts[:, 1]), tv2=v3(verts[:, 2]),
            tn0=v3(normals[:, 0]), tn1=v3(normals[:, 1]), tn2=v3(normals[:, 2]),
            tuv0u=jnp.asarray(uvs[:, 0, 0]), tuv0v=jnp.asarray(uvs[:, 0, 1]),
            tuv1u=jnp.asarray(uvs[:, 1, 0]), tuv1v=jnp.asarray(uvs[:, 1, 1]),
            tuv2u=jnp.asarray(uvs[:, 2, 0]), tuv2v=jnp.asarray(uvs[:, 2, 1]),
            tmat=jnp.asarray(tmat), tarea=jnp.asarray(tarea.astype(np.float32)),
            tri_shade=jnp.asarray(tri_shade),
            tri_tbn=jnp.asarray(tri_tbn),
            scenter=v3(sc), sradius=jnp.asarray(sr), smat=jnp.asarray(smat),
            sarea=jnp.asarray(sarea.astype(np.float32)),
            materials=materials,
            light_kind=jnp.asarray(np.asarray(lk, np.int32)),
            light_idx=jnp.asarray(np.asarray(li, np.int32)),
            light_area=jnp.asarray(np.asarray(la, np.float32)),
            light_v0=v3(lverts[:, 0]), light_v1=v3(lverts[:, 1]),
            light_v2=v3(lverts[:, 2]),
            light_n0=v3(lnorms[:, 0]), light_n1=v3(lnorms[:, 1]),
            light_n2=v3(lnorms[:, 2]),
            light_emission=v3(lem),
            diffuse_maps=_stack_textures(self.textures['diffuse']),
            normal_maps=_stack_textures(self.textures['normal']),
            roughness_maps=_stack_textures(self.textures['roughness']),
            metallic_maps=_stack_textures(self.textures['metallic']),
            bkgcolor=Vec3(jnp.float32(self.bkgcolor[0]),
                          jnp.float32(self.bkgcolor[1]),
                          jnp.float32(self.bkgcolor[2])),
            eta=jnp.float32(self.eta),
            bvh=self._maybe_bvh(verts, use_bvh),
            has_textures=any(len(v) > 0 for v in self.textures.values()),
            mtype_set=tuple(sorted(set(int(t) for t in m['mtype']))),
        )

    def _maybe_bvh(self, verts: np.ndarray, use_bvh):
        from ..ops.bvh import BVH_THRESHOLD, build_bvh
        if use_bvh is None:
            use_bvh = verts.shape[0] >= BVH_THRESHOLD
        if not use_bvh or verts.shape[0] == 0:
            return None
        return build_bvh(verts)
