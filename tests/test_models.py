"""Procedural mesh generators + large-scene presets + profiling utils."""
import numpy as np

from tuturenderer_tpu.models import (heightfield, plane, quad,
                                     sphere_showcase, terrain, uv_sphere)


def test_quad_and_plane():
    q = quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
    assert q.shape == (2, 3, 3)
    p = plane((0, 0, 0), (1, 0, 0), (0, 1, 0), nu=4, nv=3)
    assert p.shape == (2 * 4 * 3, 3, 3)
    # total area of the subdivided parallelogram = |2u x 2v| = 4
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1).sum()
    np.testing.assert_allclose(area, 4.0, rtol=1e-5)


def test_uv_sphere_geometry():
    verts, normals = uv_sphere(radius=2.0, nu=32, nv=32)
    assert verts.shape == (2 * 32 * 32, 3, 3)
    r = np.linalg.norm(verts.reshape(-1, 3), axis=1)
    np.testing.assert_allclose(r, 2.0, atol=1e-3)
    # smooth normals point radially outward
    n = normals.reshape(-1, 3)
    v = verts.reshape(-1, 3) / r[:, None]
    assert (np.sum(n * v, axis=1) > 0.999).all()
    # surface area approaches 4 pi r^2
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1).sum()
    np.testing.assert_allclose(area, 4 * np.pi * 4.0, rtol=0.02)


def test_heightfield():
    v = heightfield(nx=16, nz=16, size=2.0, amplitude=0.3, seed=1)
    assert v.shape == (2 * 16 * 16, 3, 3)
    assert np.abs(v[:, :, 1]).max() <= 0.3 + 1e-6
    assert np.abs(v[:, :, [0, 2]]).max() <= 1.0 + 1e-6


def test_scene_presets_render():
    import jax
    from tuturenderer_tpu.integrators.path import render
    from tuturenderer_tpu.options import RenderOptions
    # small variants so the CPU suite stays fast
    scene, cam = terrain(width=24, height=24, nx=12, nz=12)
    assert scene.n_lights > 0
    img = np.asarray(jax.block_until_ready(
        render(scene, cam, RenderOptions(spp=2, max_depth=3), 0)))
    assert img.shape == (24, 24, 3)
    assert np.isfinite(img).all() and img.max() > 0

    scene2, cam2 = sphere_showcase(width=16, height=16, nu=16, nv=16)
    img2 = np.asarray(jax.block_until_ready(
        render(scene2, cam2, RenderOptions(spp=2, max_depth=3), 0)))
    assert np.isfinite(img2).all() and img2.max() > 0


def test_large_preset_builds_bvh():
    """Above BVH_THRESHOLD the preset carries a BVH whose leaves partition
    the triangles: every triangle in exactly one leaf range."""
    from tuturenderer_tpu.ops.bvh import BVH_THRESHOLD
    scene, _ = sphere_showcase(width=8, height=8, nu=64, nv=64)  # 8k tris
    assert scene.n_tris >= BVH_THRESHOLD and scene.bvh is not None
    bvh = scene.bvh
    assert sorted(np.asarray(bvh.prim).tolist()) == list(range(scene.n_tris))
    leaves = np.asarray(bvh.left) < 0
    assert np.asarray(bvh.count)[leaves].sum() == scene.n_tris


def test_profiler_and_counters():
    from tuturenderer_tpu.utils.profiling import (Profiler, rays_per_path,
                                                  measure_render)
    prof = Profiler()
    with prof.phase("a", sync=False):
        pass
    with prof.phase("a", sync=False):
        pass
    totals = prof.report(file=__import__("io").StringIO())
    assert "a" in totals and totals["a"] >= 0
    assert rays_per_path(6) == 2.0 * 7 + 0.1
    stats = measure_render(lambda: np.zeros(()), 10, 10, 4, 6)
    assert stats.paths == 400 and stats.rays_per_sec > 0
