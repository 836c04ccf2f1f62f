"""Each reference-quirk compat knob exercises its documented deviation.

The reference carries estimator quirks (SURVEY.md quirks catalog) that the
renderer fixes by default and reproduces behind static RenderOptions/
SceneBuilder flags. These tests pin each knob to the SPECIFIC deviation it
claims to reproduce, so the parity switches stay verified code paths:

- tutu_light_pick  -> int(r*(n-1)+0.4999) under-samples end lights
  (IIntegrator.hpp:184)
- tutu_tri_sample  -> u=r0, v=r1*(1-u) shifts the triangle sample mean
  off the centroid (Triangle.hpp:119-136)
- tutu_sphere_area -> getArea() = pi*r^2, not 4*pi*r^2 (Sphere.hpp:135-137)
- ggx_sample_bug   -> the `alhpa` typo mixes opacity alpha into the GGX
  a^2 used for half-vector sampling (Material.hpp:212-214)
- tutu_bdpt_weight_kill / tutu_bdpt_t1_gate are covered in
  test_integrators.py (parity + hit-fraction scaling) and test_bdpt_mis.py.
"""
import numpy as np
import jax.numpy as jnp

from tuturenderer_tpu.ops.lights import sample_light
from tuturenderer_tpu.scene.data import (LAMBERTIAN, MICROFACET_R,
                                         SceneBuilder)


def _tri_light_scene(n_lights=3, tutu_sphere_area=False, sphere=False):
    b = SceneBuilder(tutu_sphere_area=tutu_sphere_area)
    light = b.add_material(LAMBERTIAN, diffuse=(0.7, 0.7, 0.7),
                           emission=(10.0, 10.0, 10.0))
    for i in range(n_lights):
        # distinct x offsets so samples identify which light was picked
        x0 = 10.0 * i
        v = np.asarray([[(x0, 0, 0), (x0 + 1, 0, 0), (x0, 1, 0)]], np.float32)
        b.add_triangles(v, None, None, light)
    if sphere:
        b.add_sphere((100.0, 0.0, 0.0), 2.0, light)
    return b.build()


def test_tutu_light_pick_undersamples_end_lights():
    """int(r*(size-1)+0.4999) with 3 lights picks (1/4, 1/2, 1/4) instead
    of uniform thirds (IIntegrator.hpp:184)."""
    scene = _tri_light_scene(3)
    r = jnp.linspace(0.0005, 0.9995, 4000)
    z = jnp.zeros_like(r) + 0.25

    biased = sample_light(scene, r, z, z, tutu_light_pick=True)
    which_b = np.asarray(biased.pos.x) // 10
    frac_b = [(which_b == i).mean() for i in range(3)]
    np.testing.assert_allclose(frac_b, [0.25, 0.5, 0.25], atol=0.01)

    fair = sample_light(scene, r, z, z, tutu_light_pick=False)
    which_f = np.asarray(fair.pos.x) // 10
    frac_f = [(which_f == i).mean() for i in range(3)]
    np.testing.assert_allclose(frac_f, [1 / 3] * 3, atol=0.01)


def test_tutu_tri_sample_shifts_sample_mean():
    """u=r0, v=r1*(1-u) gives E[point] = v0/4 + v1/2 + v2/4 (E[u]=1/2,
    E[v]=1/4) while the pdf still claims 1/area; the default sqrt warp is
    uniform with E[point] = centroid (Triangle.hpp:119-136)."""
    scene = _tri_light_scene(1)
    v0 = np.array([0.0, 0.0, 0.0])
    v1 = np.array([1.0, 0.0, 0.0])
    v2 = np.array([0.0, 1.0, 0.0])
    k = 500
    r0, r1 = jnp.meshgrid(jnp.linspace(1e-4, 1 - 1e-4, k),
                          jnp.linspace(1e-4, 1 - 1e-4, k))
    r0, r1 = r0.ravel(), r1.ravel()
    rp = jnp.zeros_like(r0)

    quirk = sample_light(scene, rp, r0, r1, tutu_tri_sample=True)
    mean_q = np.array([np.asarray(quirk.pos.x).mean(),
                       np.asarray(quirk.pos.y).mean()])
    np.testing.assert_allclose(
        mean_q, (v0 / 4 + v1 / 2 + v2 / 4)[:2], atol=2e-3)

    fair = sample_light(scene, rp, r0, r1, tutu_tri_sample=False)
    mean_f = np.array([np.asarray(fair.pos.x).mean(),
                       np.asarray(fair.pos.y).mean()])
    np.testing.assert_allclose(mean_f, ((v0 + v1 + v2) / 3)[:2], atol=2e-3)


def test_tutu_sphere_area_uses_pi_r_squared():
    """Sphere.hpp:135-137 returns pi*r^2; the geometric area is 4*pi*r^2.
    The flag feeds the light-pick pdf (1/(n*area))."""
    quirk = _tri_light_scene(1, tutu_sphere_area=True, sphere=True)
    fair = _tri_light_scene(1, tutu_sphere_area=False, sphere=True)
    r = 2.0
    np.testing.assert_allclose(float(quirk.sarea[0]), np.pi * r * r,
                               rtol=1e-6)
    np.testing.assert_allclose(float(fair.sarea[0]), 4 * np.pi * r * r,
                               rtol=1e-6)
    # pdf of picking a point on the sphere light differs by exactly 4x
    z = jnp.full((8,), 0.9)   # pick the sphere (second light)
    u = jnp.full((8,), 0.3)
    pq = sample_light(quirk, z, u, u).pdf_area
    pf = sample_light(fair, z, u, u).pdf_area
    np.testing.assert_allclose(np.asarray(pq) / np.asarray(pf), 4.0,
                               rtol=1e-5)


def test_ggx_sample_bug_broadens_half_vector():
    """Material.hpp:212-214: a^2 = roughness^2 * alpha (the opacity!)
    instead of (roughness^2)^2. With roughness 0.5 and alpha 1 the buggy
    a^2 is 0.25 vs the correct 0.0625 — a visibly broader half-vector
    distribution. The GGX inverse CDF gives cos(theta_h) =
    sqrt((1-r)/(r*(a2-1)+1)); both paths must match their closed form."""
    from tuturenderer_tpu.materials import bxdf_sample, gather_material

    b = SceneBuilder()
    ggx = b.add_material(MICROFACET_R, diffuse=(0.8, 0.8, 0.8),
                         roughness=0.5, metallic=0.0)
    v = np.asarray([[(0, 0, 0), (1, 0, 0), (0, 1, 0)]], np.float32)
    b.add_triangles(v, None, None, ggx)
    scene = b.build()

    m = 2048
    params = gather_material(scene, jnp.zeros((m,), jnp.int32))
    n = jnp.zeros((m,))
    normal = type(params.diffuse)(n, n, n + 1.0)       # +z
    wo = normal                                        # normal incidence
    r0 = jnp.linspace(1e-3, 1 - 1e-3, m)
    r1 = jnp.full((m,), 0.23)
    lot = jnp.full((m,), 0.5)

    def mean_cos_h(bug):
        s = bxdf_sample(params, wo, normal, r0, r1, lot,
                        jnp.float32(1.0), bug, types=scene.mtype_set)
        h = (s.wi + wo).normalized(1e-20)
        return np.asarray(h.dot(normal))

    def closed_form(a2):
        r = np.asarray(r0)
        return np.sqrt((1 - r) / (r * (a2 - 1) + 1))

    rough2 = 0.25
    cos_bug = mean_cos_h(True)
    cos_fix = mean_cos_h(False)
    np.testing.assert_allclose(cos_bug, closed_form(rough2 * 1.0),
                               atol=2e-3)
    np.testing.assert_allclose(cos_fix, closed_form(rough2 ** 2),
                               atol=2e-3)
    # the bug broadens the lobe: lower mean cos(theta_h)
    assert cos_bug.mean() < cos_fix.mean() - 0.05


def test_world_to_pixel_index_truncation_band():
    """The reference bounds-checks the TRUNCATED ints (`int x =
    (int)raster.x; if (x < 0...)`, Camera.hpp:52-55), so raster values in
    (-1, 0) fold onto row/column 0 and are ACCEPTED — checking the float
    instead turns frame-edge pixels dark in every We-weighted estimator
    (caught by the mesh_bdpt oracle's one-row light-patch offset)."""
    import jax.numpy as jnp
    import numpy as np

    from tuturenderer_tpu.camera import (make_camera, pixel_position,
                                         world_to_pixel_index)
    from tuturenderer_tpu.utils.vec import Vec3

    cam = make_camera(64, 64, 55, eye=(0, 0.35, 2.6),
                      viewdir=(0, -0.12, -1), updir=(0, 1, 0))
    # points straddling the top edge: the center of pixel row 0 must map
    # to row 0, and a point well above the frame must map to -1
    p0 = pixel_position(cam, jnp.array([32]), jnp.array([0]))
    idx0 = int(world_to_pixel_index(cam, p0)[0])
    assert idx0 == 32, idx0   # row 0, col 32 — not -1
    # the fold band is one raster unit deep; half a pixel above row 0's
    # center stays in it (reference C-cast semantics)...
    half = Vec3(cam.delta_v.x * -0.5, cam.delta_v.y * -0.5,
                cam.delta_v.z * -0.5)
    p_band = Vec3(p0.x + half.x, p0.y + half.y, p0.z + half.z)
    assert int(world_to_pixel_index(cam, p_band)[0]) == 32
    # ...while 2 pixels above is outside
    p_out = Vec3(p0.x + 4 * half.x, p0.y + 4 * half.y, p0.z + 4 * half.z)
    assert int(world_to_pixel_index(cam, p_out)[0]) == -1
