"""Vectorized ray/scene intersection.

Replaces the reference's per-object virtual ``intersect`` calls
(Triangle.hpp:23-74 Moller-Trumbore, Sphere.hpp:26-126 quadratic) and its
both-children recursive BVH walk (BVH.hpp:145-194) with dense wavefront
kernels: every ray in the ``[N]`` wavefront is tested against triangle
chunks in registers, with a running nearest-hit reduction. For the scene
sizes of the reference suite (tens to thousands of primitives) this
streaming brute force vastly outperforms divergent pointer-chasing on a
vector machine; a BVH path (ops/bvh.py) covers large meshes.

Acceptance criteria mirror the reference exactly:
- triangles: reject near-parallel rays (|dir.n| < 1e-4, Triangle.hpp:39),
  det == 0, and require t > 0, u > 0, v > 0, 1-u-v > 0 (Triangle.hpp:49);
- spheres: smallest strictly-positive root (Sphere.hpp:83-93);
- occlusion: hit with t < dist and |t - dist| >= 1e-4 (BVH.hpp:184).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..scene.data import SPHERE, TRIANGLE, SceneData
from ..utils.vec import Vec3, where as vwhere
from .pallas import intersect as tri_kernel

F32_MAX = jnp.float32(3.4e38)
PARALLEL_EPS = 1e-4  # FLOAT_EQUAL threshold, global.hpp:134-136

# triangles per inner chunk of the XLA form; keeps the [N, C] tile bounded
CHUNK = 512


def _use_kernel() -> bool:
    """Dense triangle scenes take the Triton kernel (ops/pallas/intersect.py)
    on the GPU and the XLA chunk loop below everywhere else."""
    return jax.default_backend() == "gpu"


class HitCore(NamedTuple):
    """Minimal nearest-hit record produced by the traversal reduction."""
    t: jnp.ndarray      # [N] f32, F32_MAX on miss
    kind: jnp.ndarray   # [N] int32 TRIANGLE/SPHERE
    idx: jnp.ndarray    # [N] int32 primitive index, -1 on miss
    bu: jnp.ndarray     # [N] f32 barycentric u (triangles)
    bv: jnp.ndarray     # [N] f32 barycentric v

    @property
    def hit(self):
        return self.idx >= 0


class HitRecord(NamedTuple):
    """Full shading record, the analogue of Intersection (Intersection.hpp:13-31)."""
    t: jnp.ndarray
    hit: jnp.ndarray
    pos: Vec3
    ng: Vec3            # geometric normal
    ns: Vec3            # shading normal
    u: jnp.ndarray      # texture coords
    v: jnp.ndarray
    mat: jnp.ndarray    # [N] int32 material id (0 where miss; gate with hit)
    kind: jnp.ndarray
    idx: jnp.ndarray
    area: jnp.ndarray   # [N] f32 primitive surface area (light-pdf input)


def _gather_vec3(v: Vec3, idx) -> Vec3:
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def _tri_chunk_best(scene: SceneData, orig: Vec3, d: Vec3, lo: int, size: int,
                    best: HitCore) -> HitCore:
    """Test rays [N] against triangles [lo:lo+size], update running best."""
    sl = slice(lo, lo + size)
    v0 = Vec3(scene.tv0.x[sl], scene.tv0.y[sl], scene.tv0.z[sl])
    v1 = Vec3(scene.tv1.x[sl], scene.tv1.y[sl], scene.tv1.z[sl])
    v2 = Vec3(scene.tv2.x[sl], scene.tv2.y[sl], scene.tv2.z[sl])
    e1 = v1 - v0            # [C]
    e2 = v2 - v0
    n = e1.cross(e2)
    n_norm = n.norm()
    n_unit = n * (1.0 / jnp.maximum(n_norm, 1e-30))

    # broadcast [N,1] x [C] -> [N,C]
    ox = orig.x[:, None]
    oy = orig.y[:, None]
    oz = orig.z[:, None]
    dx = d.x[:, None]
    dy = d.y[:, None]
    dz = d.z[:, None]

    sx = ox - v0.x[None, :]
    sy = oy - v0.y[None, :]
    sz = oz - v0.z[None, :]

    # s1 = dir x e2
    s1x = dy * e2.z[None, :] - dz * e2.y[None, :]
    s1y = dz * e2.x[None, :] - dx * e2.z[None, :]
    s1z = dx * e2.y[None, :] - dy * e2.x[None, :]
    # s2 = s x e1
    s2x = sy * e1.z[None, :] - sz * e1.y[None, :]
    s2y = sz * e1.x[None, :] - sx * e1.z[None, :]
    s2z = sx * e1.y[None, :] - sy * e1.x[None, :]

    det = s1x * e1.x[None, :] + s1y * e1.y[None, :] + s1z * e1.z[None, :]
    dn = dx * n_unit.x[None, :] + dy * n_unit.y[None, :] + dz * n_unit.z[None, :]

    inv = 1.0 / jnp.where(det == 0.0, 1.0, det)
    t = (s2x * e2.x[None, :] + s2y * e2.y[None, :] + s2z * e2.z[None, :]) * inv
    u = (s1x * sx + s1y * sy + s1z * sz) * inv
    v = (s2x * dx + s2y * dy + s2z * dz) * inv

    ok = (jnp.abs(dn) >= PARALLEL_EPS) & (det != 0.0) \
        & (t > 0.0) & (u > 0.0) & (v > 0.0) & (1.0 - u - v > 0.0)
    t = jnp.where(ok, t, F32_MAX)

    j = jnp.argmin(t, axis=1)                        # [N]
    rows = jnp.arange(t.shape[0])
    t_min = t[rows, j]
    u_min = u[rows, j]
    v_min = v[rows, j]
    better = t_min < best.t
    return HitCore(
        t=jnp.where(better, t_min, best.t),
        kind=jnp.where(better, TRIANGLE, best.kind),
        idx=jnp.where(better, (lo + j).astype(jnp.int32), best.idx),
        bu=jnp.where(better, u_min, best.bu),
        bv=jnp.where(better, v_min, best.bv),
    )


def _sphere_best(scene: SceneData, orig: Vec3, d: Vec3, best: HitCore) -> HitCore:
    s = scene.n_spheres
    if s == 0:
        return best
    cx = scene.scenter.x[None, :]
    cy = scene.scenter.y[None, :]
    cz = scene.scenter.z[None, :]
    r = scene.sradius[None, :]
    lx = orig.x[:, None] - cx
    ly = orig.y[:, None] - cy
    lz = orig.z[:, None] - cz
    b = d.x[:, None] * lx + d.y[:, None] * ly + d.z[:, None] * lz   # = B/2
    c = lx * lx + ly * ly + lz * lz - r * r
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = -b - sq
    t2 = -b + sq
    t = jnp.where(t1 > 0.0, t1, t2)
    ok = (disc >= 0.0) & (t > 0.0)
    t = jnp.where(ok, t, F32_MAX)

    j = jnp.argmin(t, axis=1)
    rows = jnp.arange(t.shape[0])
    t_min = t[rows, j]
    better = t_min < best.t
    return HitCore(
        t=jnp.where(better, t_min, best.t),
        kind=jnp.where(better, SPHERE, best.kind),
        idx=jnp.where(better, j.astype(jnp.int32), best.idx),
        bu=best.bu, bv=best.bv,
    )


def _mask_rays(orig: Vec3, d: Vec3, mask):
    """Replace dead lanes with a degenerate ray far outside the scene
    pointing away from it: it fails every slab/triangle/sphere test, so
    BVH traversal retires it at the root and no stale direction from its
    last bounce produces a hit that nobody reads."""
    far = jnp.float32(-1e7)
    zero = jnp.zeros_like(d.x)
    orig = Vec3(jnp.where(mask, orig.x, far), jnp.where(mask, orig.y, far),
                jnp.where(mask, orig.z, far))
    d = Vec3(jnp.where(mask, d.x, zero), jnp.where(mask, d.y, zero - 1.0),
             jnp.where(mask, d.z, zero))
    return orig, d


def _no_hit(n: int) -> HitCore:
    return HitCore(t=jnp.full((n,), F32_MAX),
                   kind=jnp.zeros((n,), jnp.int32),
                   idx=jnp.full((n,), -1, jnp.int32),
                   bu=jnp.zeros((n,)), bv=jnp.zeros((n,)))


def xla_nearest(scene: SceneData, orig: Vec3, d: Vec3) -> HitCore:
    """Nearest triangle hit in plain XLA: the chunk loop over the whole
    table. The reference the GPU kernel is checked against."""
    best = _no_hit(orig.x.shape[0])
    lo = 0
    while lo < scene.n_tris:
        size = min(CHUNK, scene.n_tris - lo)
        best = _tri_chunk_best(scene, orig, d, lo, size, best)
        lo += size
    return best


def intersect_core(scene: SceneData, orig: Vec3, d: Vec3,
                   mask=None) -> HitCore:
    """Nearest hit of each ray against the whole scene. Uses the flattened
    BVH when the scene carries one (large meshes); dense streaming
    otherwise — the strategy selection mirroring the reference's EXPEDITE
    switch (Renderer.hpp:38-39), decided per scene at build time.

    ``mask`` (optional bool [N]): lanes with mask=False are dead wavefront
    lanes; they are traced as degenerate never-hit rays (see _mask_rays)."""
    if mask is not None:
        orig, d = _mask_rays(orig, d, mask)
    if scene.bvh is not None:
        from .bvh import bvh_intersect
        best = bvh_intersect(scene, scene.bvh, orig, d)
    elif scene.n_tris and _use_kernel():
        t, idx, bu, bv = tri_kernel.tri_nearest(scene, orig, d)
        best = HitCore(t=t, kind=jnp.zeros_like(idx), idx=idx, bu=bu, bv=bv)
    else:
        best = xla_nearest(scene, orig, d)
    best = _sphere_best(scene, orig, d, best)
    # set idx=-1 lanes consistent
    miss = best.t >= F32_MAX
    return best._replace(idx=jnp.where(miss, -1, best.idx))


def _sphere_occluded(scene: SceneData, orig: Vec3, d: Vec3, dist) -> jnp.ndarray:
    """Any sphere hit with t < dist (+ FLOAT_EQUAL endpoint guard)."""
    best = _sphere_best(scene, orig, d, _no_hit(orig.x.shape[0]))
    return best.hit & (best.t < dist) & (jnp.abs(best.t - dist) >= PARALLEL_EPS)


def occluded(scene: SceneData, orig: Vec3, d: Vec3, dist,
             mask=None) -> jnp.ndarray:
    """Any-hit within ``dist`` (shadow ray). Mirrors hasIntersection
    (BVH.hpp:170-194) incl. the FLOAT_EQUAL guard at the endpoint.

    BVH scenes take the early-out any-hit traversal; dense scenes reuse
    the nearest-hit search (the GPU kernel or the XLA chunk loop). The
    results are equivalent: if the nearest hit fails the endpoint guard,
    no farther hit can pass it, since passing requires t <= dist - eps.

    ``mask`` as in intersect_core: dead lanes become degenerate rays with
    dist 0 and always report unblocked."""
    if mask is not None:
        orig, d = _mask_rays(orig, d, mask)
        dist = jnp.where(mask, dist, 0.0)
    if scene.bvh is None:
        core = intersect_core(scene, orig, d)
        return core.hit & (core.t < dist) & \
            (jnp.abs(core.t - dist) >= PARALLEL_EPS)
    from .bvh import bvh_occluded
    blocked = bvh_occluded(scene, scene.bvh, orig, d, dist)
    if scene.n_spheres:
        blocked = blocked | _sphere_occluded(scene, orig, d, dist)
    return blocked


def transmittance(scene: SceneData, orig: Vec3, d: Vec3, dist,
                  mask=None) -> jnp.ndarray:
    """Alpha-weighted shadow coefficient: the product of ``(1 - alpha)``
    over EVERY primitive the shadow ray crosses within ``dist`` — the
    strategy layer's getShadowCoeffi/ShadowHelper (BVHStrategy.hpp:13-45,
    BaseInterStrategy.hpp:25-43; multiplicative accumulation at
    BVHStrategy.hpp:38-44). Fully opaque occluders (alpha=1) yield 0;
    translucent ones attenuate. Dense all-primitive evaluation on every
    scene, O(rays x primitives) (the reference visits every overlapped
    leaf; a BVH-accelerated form is queued in ROADMAP.md).
    """
    n = orig.x.shape[0]
    trans = jnp.ones((n,), jnp.float32)
    dist = jnp.asarray(dist)
    if dist.ndim == 0:
        dist = jnp.full((n,), dist)
    if mask is not None:
        orig, d = _mask_rays(orig, d, mask)
        dist = jnp.where(mask, dist, 0.0)

    # triangles, in chunks: every accepted hit with t < dist attenuates
    lo = 0
    while lo < scene.n_tris:
        size = min(CHUNK, scene.n_tris - lo)
        sl = slice(lo, lo + size)
        v0 = Vec3(scene.tv0.x[sl], scene.tv0.y[sl], scene.tv0.z[sl])
        v1 = Vec3(scene.tv1.x[sl], scene.tv1.y[sl], scene.tv1.z[sl])
        v2 = Vec3(scene.tv2.x[sl], scene.tv2.y[sl], scene.tv2.z[sl])
        e1 = v1 - v0
        e2 = v2 - v0
        nrm = e1.cross(e2)
        n_unit = nrm * (1.0 / jnp.maximum(nrm.norm(), 1e-30))
        dx, dy, dz = d.x[:, None], d.y[:, None], d.z[:, None]
        sx = orig.x[:, None] - v0.x[None, :]
        sy = orig.y[:, None] - v0.y[None, :]
        sz = orig.z[:, None] - v0.z[None, :]
        s1x = dy * e2.z[None, :] - dz * e2.y[None, :]
        s1y = dz * e2.x[None, :] - dx * e2.z[None, :]
        s1z = dx * e2.y[None, :] - dy * e2.x[None, :]
        s2x = sy * e1.z[None, :] - sz * e1.y[None, :]
        s2y = sz * e1.x[None, :] - sx * e1.z[None, :]
        s2z = sx * e1.y[None, :] - sy * e1.x[None, :]
        det = s1x * e1.x[None, :] + s1y * e1.y[None, :] + s1z * e1.z[None, :]
        dn = dx * n_unit.x[None, :] + dy * n_unit.y[None, :] \
            + dz * n_unit.z[None, :]
        inv = 1.0 / jnp.where(det == 0.0, 1.0, det)
        t = (s2x * e2.x[None, :] + s2y * e2.y[None, :]
             + s2z * e2.z[None, :]) * inv
        u = (s1x * sx + s1y * sy + s1z * sz) * inv
        v = (s2x * dx + s2y * dy + s2z * dz) * inv
        ok = (jnp.abs(dn) >= PARALLEL_EPS) & (det != 0.0) & (t > 0.0) \
            & (u > 0.0) & (v > 0.0) & (1.0 - u - v > 0.0) \
            & (t < dist[:, None])
        a = scene.materials.alpha[scene.tmat[sl]][None, :]     # [1,C]
        trans = trans * jnp.prod(jnp.where(ok, 1.0 - a, 1.0), axis=1)
        lo += size

    # spheres
    if scene.n_spheres:
        trans = trans * _sphere_transmittance(scene, orig, d, dist)
    return trans


def _sphere_transmittance(scene: SceneData, orig: Vec3, d: Vec3, dist):
    lx = orig.x[:, None] - scene.scenter.x[None, :]
    ly = orig.y[:, None] - scene.scenter.y[None, :]
    lz = orig.z[:, None] - scene.scenter.z[None, :]
    b = d.x[:, None] * lx + d.y[:, None] * ly + d.z[:, None] * lz
    c = lx * lx + ly * ly + lz * lz \
        - scene.sradius[None, :] * scene.sradius[None, :]
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = -b - sq
    t2 = -b + sq
    t = jnp.where(t1 > 0.0, t1, t2)
    ok = (disc >= 0.0) & (t > 0.0) & (t < dist[:, None])
    a = scene.materials.alpha[scene.smat][None, :]
    return jnp.prod(jnp.where(ok, 1.0 - a, 1.0), axis=1)


def shade_hit(scene: SceneData, orig: Vec3, d: Vec3, core: HitCore) -> HitRecord:
    """Expand a HitCore into a full shading record by gathering the winning
    primitive's attributes (what Triangle::intersect / Sphere::intersect
    write into Intersection, Triangle.hpp:50-69, Sphere.hpp:95-123)."""
    safe_idx = jnp.maximum(core.idx, 0)
    is_tri = core.kind == TRIANGLE

    # clamp miss distance: F32_MAX would make pos/r^2 inf, and masked infs
    # poison reverse-mode AD (0 * inf = NaN)
    t_safe = jnp.where(core.hit, core.t, 1.0)
    pos = orig + d * t_safe
    zeros = jnp.zeros_like(pos.x)
    zerov = Vec3(zeros, zeros, zeros)

    # triangle attributes. Two gather strategies, chosen by table size:
    # tables of up to 64 rows take per-column gathers, larger ones ONE
    # packed-row gather from tri_shade. The threshold was tuned for an
    # earlier accelerator's gather lowering and is not measured on the
    # H100 (ROADMAP D3).
    if scene.n_tris:
        ti = jnp.where(is_tri, safe_idx, 0)
        w = 1.0 - core.bu - core.bv
        if scene.n_tris > 64:
            rows = scene.tri_shade[ti]               # [N, 20]
            col = lambda j: rows[:, j]
        else:
            col = lambda j: scene.tri_shade[:, j][ti]
        n0 = Vec3(col(0), col(1), col(2))
        n1 = Vec3(col(3), col(4), col(5))
        n2 = Vec3(col(6), col(7), col(8))
        ng_tri = Vec3(col(9), col(10), col(11))      # prenormalized cross
        ns_tri = (n0 * w + n1 * core.bu + n2 * core.bv).normalized(1e-30)
        u_tri = col(12) * w + col(14) * core.bu + col(16) * core.bv
        v_tri = col(13) * w + col(15) * core.bu + col(17) * core.bv
        mat_tri = col(18).astype(jnp.int32)
        area_tri = col(19)
    else:
        ng_tri = ns_tri = zerov
        u_tri = v_tri = zeros
        mat_tri = jnp.zeros_like(core.idx)
        area_tri = zeros

    # sphere attributes (skipped entirely for triangle-only scenes)
    if scene.n_spheres:
        si = jnp.where(is_tri, 0, safe_idx)
        c = _gather_vec3(scene.scenter, si)
        ng_sph = (pos - c).normalized(1e-30)
        # spherical uv (Sphere.hpp:59-77): v = acos(z)/pi, u = atan2/2pi
        phi = jnp.arccos(jnp.clip(ng_sph.z, -1.0, 1.0))
        v_sph = phi / jnp.pi
        theta = jnp.arctan2(ng_sph.y, ng_sph.x)
        theta = jnp.where(theta < 0, theta + 2.0 * jnp.pi, theta)
        u_sph = theta / (2.0 * jnp.pi)
        mat_sph = scene.smat[si]
        area_sph = scene.sarea[si]
        ng = vwhere(is_tri, ng_tri, ng_sph)
        ns = vwhere(is_tri, ns_tri, ng_sph)
        u = jnp.where(is_tri, u_tri, u_sph)
        v = jnp.where(is_tri, v_tri, v_sph)
        mat = jnp.where(core.hit, jnp.where(is_tri, mat_tri, mat_sph), 0)
        area = jnp.where(is_tri, area_tri, area_sph)
    else:
        ng, ns = ng_tri, ns_tri
        u, v = u_tri, v_tri
        mat = jnp.where(core.hit, mat_tri, 0)
        area = area_tri

    return HitRecord(
        t=core.t,
        hit=core.hit,
        pos=pos,
        ng=ng,
        ns=ns,
        u=u,
        v=v,
        mat=mat,
        kind=core.kind,
        idx=core.idx,
        area=area,
    )


def intersect_scene(scene: SceneData, orig: Vec3, d: Vec3) -> HitRecord:
    return shade_hit(scene, orig, d, intersect_core(scene, orig, d))
