"""The GPU intersection kernel (ops/pallas/intersect.py) against the XLA
dense reference path: interpret-mode parity on the CPU, the wrapper's
padding, the kernel choice by platform, and the gradient rule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tuturenderer_tpu.ops import intersect as I
from tuturenderer_tpu.ops.pallas import intersect as K
from tuturenderer_tpu.scene.data import SceneBuilder
from tuturenderer_tpu.utils.vec import Vec3


def random_scene_and_rays(n_tris=48, n_rays=256, seed=3):
    r = np.random.RandomState(seed)
    b = SceneBuilder()
    m = b.add_material()
    centers = r.randn(n_tris, 3) * 2.0
    b.add_triangles(
        (centers[:, None, :] + 0.6 * r.randn(n_tris, 3, 3)).astype(np.float32),
        None, None, m)
    s = b.build()
    o_np = (r.randn(n_rays, 3) * 3.0).astype(np.float32)
    d_np = r.randn(n_rays, 3).astype(np.float32)
    d_np /= np.linalg.norm(d_np, axis=1, keepdims=True)
    o = Vec3(*[jnp.asarray(o_np[:, i]) for i in range(3)])
    d = Vec3(*[jnp.asarray(d_np[:, i]) for i in range(3)])
    return s, o, d


def assert_nearest_matches(got, ref):
    """Tolerances of the kernel-vs-XLA comparison. Both sides are float32
    elementwise arithmetic (no matrix product, so no TF32); they differ
    only in operation order, hence knife-edge hits near triangle edges."""
    t, idx, bu, bv = (np.asarray(a) for a in got)
    hit_p = idx >= 0
    hit_r = np.asarray(ref.hit)
    assert (hit_p == hit_r).mean() > 0.99
    both = hit_p & hit_r & (idx == np.asarray(ref.idx))
    assert both.sum() >= 0.95 * hit_r.sum()
    np.testing.assert_allclose(t[both], np.asarray(ref.t)[both], rtol=1e-4)
    np.testing.assert_allclose(bu[both], np.asarray(ref.bu)[both], atol=1e-4)
    np.testing.assert_allclose(bv[both], np.asarray(ref.bv)[both], atol=1e-4)


def test_pallas_nearest_matches_xla():
    s, o, d = random_scene_and_rays()
    ref = I.intersect_core(s, o, d)
    assert_nearest_matches(K.tri_nearest(s, o, d, interpret=True), ref)


def _spy_kernels(monkeypatch):
    """Route the kernel to interpret mode and record its calls."""
    calls = []
    nearest = K.tri_nearest

    def spy(*a, **kw):
        calls.append("tri_nearest")
        return nearest(*a, interpret=True, **kw)

    monkeypatch.setattr(K, "tri_nearest", spy)
    return calls


def _kernel_occluded(monkeypatch, s, o, d, dist):
    """occluded() down the GPU branch, the kernel in interpret mode."""
    calls = _spy_kernels(monkeypatch)
    monkeypatch.setattr(I, "_use_kernel", lambda: True)
    got = np.asarray(I.occluded(s, o, d, dist))
    assert calls == ["tri_nearest"]
    return got


def test_pallas_anyhit_matches_xla_occlusion(monkeypatch):
    """Shadow rays through the kernel's nearest hit and the endpoint rule
    give the XLA path's decisions."""
    s, o, d = random_scene_and_rays(seed=7)
    ref = I.intersect_core(s, o, d)
    for scale in (0.5, 1.0, 2.0):
        t_ref = np.asarray(jnp.where(ref.hit, ref.t, 1.0))
        dist = jnp.asarray(t_ref * scale + 0.3)
        want = np.asarray(ref.hit) & (np.asarray(ref.t) < np.asarray(dist)) & \
            (np.abs(np.asarray(ref.t) - np.asarray(dist)) >= I.PARALLEL_EPS)
        got = _kernel_occluded(monkeypatch, s, o, d, dist)
        monkeypatch.undo()
        assert (got == want).mean() > 0.99


def test_pallas_anyhit_endpoint_guard(monkeypatch):
    """dist exactly at the hit distance -> not occluded (BVH.hpp:184)."""
    b = SceneBuilder()
    m = b.add_material()
    b.add_triangles(
        np.asarray([[[-1, -1, 1], [1, -1, 1], [0, 1, 1]]], np.float32),
        None, None, m)
    s = b.build()
    o = Vec3(jnp.zeros((4,)), jnp.zeros((4,)), jnp.zeros((4,)))
    d = Vec3(jnp.zeros((4,)), jnp.zeros((4,)), jnp.ones((4,)))
    # within-eps endpoint (1.0, 1.0+5e-5) -> unoccluded; beyond eps -> occluded
    dist = jnp.asarray([2.0, 1.0, 0.5, 1.0 + 5e-5])
    got = _kernel_occluded(monkeypatch, s, o, d, dist)
    assert got.tolist() == [True, False, False, False]


@pytest.mark.parametrize("n_tris,n_rays", [(45, 300), (8, 128), (1, 5)])
def test_pallas_pads_rays_and_table(n_tris, n_rays):
    """Ray counts that are no multiple of the block and triangle counts
    that are no multiple of the tile: padding lanes and zero rows must
    not change any result, and the outputs keep the caller's length."""
    s, o, d = random_scene_and_rays(n_tris=n_tris, n_rays=n_rays, seed=5)
    table = K.pack_triangles(s)
    assert table.shape == (-(-n_tris // K.TRI_TILE) * K.TRI_TILE * K.ROW,)
    np.testing.assert_array_equal(np.asarray(table)[n_tris * K.ROW:], 0.0)
    assert n_rays % K.BLOCK
    got = K.tri_nearest(s, o, d, interpret=True)
    assert all(a.shape == (n_rays,) for a in got)
    assert_nearest_matches(got, I.intersect_core(s, o, d))


@pytest.mark.parametrize("backend,use_bvh,want", [
    ("gpu", False, ["tri_nearest", "tri_nearest"]),
    ("cpu", False, []),
    ("gpu", True, []),
])
def test_kernel_choice_by_platform(monkeypatch, backend, use_bvh, want):
    """Dense triangle scenes take the kernel, for nearest hits and shadow
    rays, exactly when the default backend is the GPU; BVH scenes never
    do."""
    s, o, d = random_scene_and_rays(n_tris=16, n_rays=64, seed=1)
    if use_bvh:
        b = SceneBuilder()
        b.add_triangles(np.stack([np.asarray(v.stack()) for v in
                                  (s.tv0, s.tv1, s.tv2)], axis=1),
                        None, None, b.add_material())
        s = b.build(use_bvh=True)
        assert s.bvh is not None
    calls = _spy_kernels(monkeypatch)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert I._use_kernel() == (backend == "gpu")
    I.intersect_core(s, o, d)
    I.occluded(s, o, d, jnp.full((64,), 3.0))
    assert calls == want


def test_gradient_through_kernel_path_matches_xla(monkeypatch):
    """jax.grad of render_diff through the kernel (tangents stripped at
    the kernel boundary) equals the XLA path's gradient."""
    from tuturenderer_tpu.grad import get_params, render_diff
    from tuturenderer_tpu.options import RenderOptions
    from tuturenderer_tpu.scene.presets import cornell_box

    scene, cam = cornell_box(width=8, height=8)
    opts = RenderOptions(spp=1, max_depth=2)
    params = get_params(scene)

    def grad():
        return jax.grad(lambda p: jnp.mean(
            render_diff(p, scene, cam, opts, 3)))(params)

    ref = grad()
    calls = _spy_kernels(monkeypatch)
    monkeypatch.setattr(I, "_use_kernel", lambda: True)
    got = grad()
    assert "tri_nearest" in calls
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)
    assert any(np.abs(np.asarray(a)).max() > 0 for a in jax.tree.leaves(ref))


@pytest.mark.gpu
def test_kernels_compiled_for_the_card_match_xla(gpu):
    """The kernel as compiled for the card (no interpret mode) against
    the XLA reference on the same card, for nearest hits and, through
    occluded(), for shadow rays."""
    s, o, d = random_scene_and_rays(n_tris=300, n_rays=4096, seed=2)
    ref = I.xla_nearest(s, o, d)
    assert_nearest_matches(K.tri_nearest(s, o, d), ref)
    dist = jnp.where(ref.hit, ref.t, 1.0) * 1.5 + 0.2
    want = np.asarray(ref.hit) & (np.asarray(ref.t) < np.asarray(dist))
    assert I._use_kernel()
    got = np.asarray(I.occluded(s, o, d, dist))
    assert (got == want).mean() > 0.99

