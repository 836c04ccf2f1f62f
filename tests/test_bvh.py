"""BVH traversal must agree exactly with dense streaming intersection."""
import dataclasses

import jax.numpy as jnp
import numpy as np

from tuturenderer_tpu.ops.bvh import build_bvh, bvh_intersect
from tuturenderer_tpu.ops.intersect import intersect_core, occluded
from tuturenderer_tpu.scene.data import SceneBuilder
from tuturenderer_tpu.utils.vec import Vec3


def random_tri_scene(n_tris=200, seed=0, use_bvh=False):
    r = np.random.RandomState(seed)
    b = SceneBuilder()
    m = b.add_material()
    centers = r.randn(n_tris, 3) * 2.0
    offsets = r.randn(n_tris, 3, 3) * 0.4
    b.add_triangles((centers[:, None, :] + offsets).astype(np.float32),
                    None, None, m)
    return b.build(use_bvh=use_bvh)


def random_rays(n=256, seed=1):
    r = np.random.RandomState(seed)
    o = r.randn(n, 3).astype(np.float32) * 4.0
    d = r.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (Vec3(*[jnp.asarray(o[:, i]) for i in range(3)]),
            Vec3(*[jnp.asarray(d[:, i]) for i in range(3)]))


def test_bvh_matches_dense():
    dense_scene = random_tri_scene(use_bvh=False)
    bvh_scene = random_tri_scene(use_bvh=True)
    assert bvh_scene.bvh is not None and dense_scene.bvh is None
    o, d = random_rays()
    a = intersect_core(dense_scene, o, d)
    b = intersect_core(bvh_scene, o, d)
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
    hits = np.asarray(a.hit)
    np.testing.assert_allclose(np.asarray(a.t)[hits], np.asarray(b.t)[hits],
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(a.idx)[hits],
                                  np.asarray(b.idx)[hits])


def test_bvh_occlusion_matches_dense():
    dense_scene = random_tri_scene(use_bvh=False)
    bvh_scene = random_tri_scene(use_bvh=True)
    o, d = random_rays(seed=2)
    dist = jnp.full((256,), 3.0)
    a = occluded(dense_scene, o, d, dist)
    b = occluded(bvh_scene, o, d, dist)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bvh_build_partitions_all_prims():
    scene = random_tri_scene(n_tris=133, use_bvh=True)
    bvh = scene.bvh
    assert sorted(np.asarray(bvh.prim).tolist()) == list(range(133))
    # leaves cover exactly the primitive array
    counts = np.asarray(bvh.count)
    starts = np.asarray(bvh.start)
    leaves = np.asarray(bvh.left) < 0
    spans = sorted((int(s), int(c)) for s, c in
                   zip(starts[leaves], counts[leaves]))
    pos = 0
    for s, c in spans:
        assert s == pos
        pos += c
    assert pos == 133


def test_bvh_occluded_matches_nearest_hit_occlusion():
    """bvh_occluded (dedicated any-hit early-out, hasIntersection
    BVH.hpp:170-194) must agree with occlusion derived from the
    nearest-hit traversal for every distance regime."""
    import numpy as np
    import jax.numpy as jnp

    from tuturenderer_tpu.ops.bvh import bvh_intersect, bvh_occluded
    from tuturenderer_tpu.ops.intersect import PARALLEL_EPS
    from tuturenderer_tpu.scene.data import SceneBuilder
    from tuturenderer_tpu.utils.vec import Vec3

    r = np.random.RandomState(21)
    b = SceneBuilder()
    m = b.add_material()
    centers = r.randn(500, 3) * 3.0
    b.add_triangles(
        (centers[:, None, :] + 0.5 * r.randn(500, 3, 3)).astype(np.float32),
        None, None, m)
    s = b.build(use_bvh=True)

    n = 256
    o_np = (r.randn(n, 3) * 4.0).astype(np.float32)
    d_np = r.randn(n, 3).astype(np.float32)
    d_np /= np.linalg.norm(d_np, axis=1, keepdims=True)
    o = Vec3(*[jnp.asarray(o_np[:, i]) for i in range(3)])
    d = Vec3(*[jnp.asarray(d_np[:, i]) for i in range(3)])

    core = bvh_intersect(s, s.bvh, o, d)
    t_ref = np.asarray(jnp.where(core.hit, core.t, 1.0))
    for scale in (0.5, 1.0, 2.0):
        dist = jnp.asarray(t_ref * scale + 0.3)
        want = np.asarray(core.hit) & (np.asarray(core.t) < np.asarray(dist)) \
            & (np.abs(np.asarray(core.t) - np.asarray(dist)) >= PARALLEL_EPS)
        got = np.asarray(bvh_occluded(s, s.bvh, o, d, dist))
        assert (got == want).mean() > 0.995, scale


def test_bvh_gradient_through_compacted_wavefront():
    """jax.grad of render_diff on a BVH scene whose wavefront is compacted
    (rays come out of the compaction gather carrying tangents) runs, and
    equals the gradient on the same scene intersected densely."""
    import jax

    from tuturenderer_tpu.grad import get_params, render_diff
    from tuturenderer_tpu.options import RenderOptions
    from tuturenderer_tpu.scene.presets import simple_box

    # 32 x 32 x 2 = 2048 lanes; the 0.5 fraction shrinks them to 1024
    opts = RenderOptions(spp=2, samples_per_launch=2, max_depth=2,
                         compaction=(1.0, 0.5))
    grads = []
    for use_bvh in (True, False):
        scene, cam = simple_box(32, 32, use_bvh=use_bvh)
        assert (scene.bvh is not None) == use_bvh
        grads.append(jax.grad(lambda p: jnp.mean(
            render_diff(p, scene, cam, opts, 1)))(get_params(scene)))
    for a, b in zip(*(jax.tree.leaves(g) for g in grads)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)
    assert any(np.abs(np.asarray(a)).max() > 0
               for a in jax.tree.leaves(grads[0]))
