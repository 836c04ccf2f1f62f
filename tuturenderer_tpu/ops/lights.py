"""Emitter sampling over the scene light table.

The analogue of sampleLight / sampleLightDir / getLightPdf
(IIntegrator.hpp:155-220). Two compat knobs reproduce reference quirks:

- ``tutu_light_pick``: index = int(r*(size-1)+0.4999) (IIntegrator.hpp:184),
  which under-samples the first/last lights for >2 lights; default is an
  unbiased uniform pick.
- ``tutu_tri_sample``: u=r0, v=r1*(1-u) (Triangle.hpp:119-135), which is
  non-uniform over the triangle while the pdf still claims 1/area; the
  default is the uniform sqrt warp. Sphere sampling keeps the reference's
  uniform-in-angles scheme (Sphere.hpp:139-164) since its pdf convention
  (1/area with area from the build flag) is tied to it.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..scene.data import SPHERE, SceneData
from ..utils.vec import Vec3, local_to_world

PI = jnp.float32(jnp.pi)


class LightSample(NamedTuple):
    pos: Vec3
    ng: Vec3
    emission: Vec3
    pdf_area: jnp.ndarray   # 1 / (n_lights * area)
    valid: jnp.ndarray


def _gather_vec3(v: Vec3, idx) -> Vec3:
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def sample_light(scene: SceneData, r_pick, r0, r1,
                 tutu_light_pick: bool = False,
                 tutu_tri_sample: bool = False) -> LightSample:
    n = scene.n_lights
    shape = jnp.shape(r_pick)
    zeros = jnp.zeros(shape, jnp.float32)
    if n == 0:
        z3 = Vec3(zeros, zeros, zeros)
        return LightSample(z3, z3, z3, zeros, jnp.zeros(shape, bool))

    if tutu_light_pick and n > 1:
        pick = (r_pick * (n - 1) + 0.4999).astype(jnp.int32)
    else:
        pick = jnp.minimum((r_pick * n).astype(jnp.int32), n - 1)
    kind = scene.light_kind[pick]
    idx = scene.light_idx[pick]
    area = scene.light_area[pick]

    # ---- triangle surface point (per-light [L] tables — never gather
    # from the full [T] triangle tables here; see SceneData.light_v0)
    v0 = _gather_vec3(scene.light_v0, pick)
    v1 = _gather_vec3(scene.light_v1, pick)
    v2 = _gather_vec3(scene.light_v2, pick)
    n0 = _gather_vec3(scene.light_n0, pick)
    n1 = _gather_vec3(scene.light_n1, pick)
    n2 = _gather_vec3(scene.light_n2, pick)
    if tutu_tri_sample:
        u = r0
        v = r1 * (1.0 - u)
    else:
        su = jnp.sqrt(jnp.maximum(r0, 0.0))
        u = 1.0 - su
        v = r1 * su
    w = 1.0 - u - v
    tpos = v0 * w + v1 * u + v2 * v
    tng = (n0 * w + n1 * u + n2 * v).normalized(1e-20)

    # ---- sphere surface point (uniform in angles, Sphere.hpp:147-152)
    if scene.n_spheres:
        si = jnp.where(kind == SPHERE, idx, 0)
        c = _gather_vec3(scene.scenter, si)
        r = scene.sradius[si]
        theta = r0 * 2.0 * PI
        phi = r1 * PI
        sp = Vec3(c.x + r * jnp.cos(theta) * jnp.sin(phi),
                  c.y + r * jnp.sin(theta) * jnp.sin(phi),
                  c.z + r * jnp.cos(phi))
        sng = (sp - c).normalized(1e-20)
        is_sph = kind == SPHERE
        pos = Vec3(jnp.where(is_sph, sp.x, tpos.x),
                   jnp.where(is_sph, sp.y, tpos.y),
                   jnp.where(is_sph, sp.z, tpos.z))
        ng = Vec3(jnp.where(is_sph, sng.x, tng.x),
                  jnp.where(is_sph, sng.y, tng.y),
                  jnp.where(is_sph, sng.z, tng.z))
    else:
        pos, ng = tpos, tng

    # the emission gather is the ONE light-table lookup that carries
    # gradients (put_params refreshes light_emission from the material
    # table), so it rides the same custom-VJP onehot-matmul gather as the
    # material table (materials._mat_gather; not measured on the H100)
    from ..materials import _mat_gather
    ex, ey, ez = _mat_gather((scene.light_emission.x,
                              scene.light_emission.y,
                              scene.light_emission.z), pick)
    emission = Vec3(ex, ey, ez)
    pdf = 1.0 / (n * area)
    return LightSample(pos=pos, ng=ng, emission=emission, pdf_area=pdf,
                       valid=jnp.ones(shape, bool))


def light_pdf_of_hit(scene: SceneData, hit_kind, hit_idx, hit_mat,
                     hit_area=None):
    """getLightPdf (IIntegrator.hpp:155-168): 1/(n_lights * area) if the hit
    primitive emits, else 0. Pass ``hit_area`` (HitRecord.area) when
    available to skip the per-lane area gather from the full primitive
    tables."""
    n = scene.n_lights
    if n == 0:
        return jnp.zeros_like(hit_kind, jnp.float32)
    em = scene.materials.emission
    emissive = (em.x[hit_mat] != 0) | (em.y[hit_mat] != 0) | (em.z[hit_mat] != 0)
    if hit_area is not None:
        area = hit_area
    else:
        safe = jnp.maximum(hit_idx, 0)
        area_tri = scene.tarea[jnp.where(hit_kind == SPHERE, 0, safe)] \
            if scene.n_tris else jnp.ones_like(hit_idx, jnp.float32)
        if scene.n_spheres:
            area_sph = scene.sarea[jnp.where(hit_kind == SPHERE, safe, 0)]
            area = jnp.where(hit_kind == SPHERE, area_sph, area_tri)
        else:
            area = area_tri
    return jnp.where(emissive, 1.0 / (n * jnp.maximum(area, 1e-20)), 0.0)


def sample_cosine_dir(n: Vec3, r0, r1):
    """Cosine-weighted emission direction (IIntegrator.hpp:195-220).
    Returns (dir, pdf, ok)."""
    cos_t = jnp.sqrt(r0)
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - r0))
    phi = 2.0 * PI * r1
    d = local_to_world(n, Vec3(jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t, cos_t))
    ok = d.dot(n) >= 0.0
    pdf = jnp.maximum(d.dot(n), 0.0) / PI
    return d, pdf, ok
