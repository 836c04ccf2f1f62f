"""Multi-device sharding: distributed render must equal the single-device
render bit-for-bit (counter-based RNG is shard-invariant), and the sharded
train step must produce finite loss/gradients."""
import jax
import numpy as np
import pytest

from tuturenderer_tpu.grad import get_params
from tuturenderer_tpu.integrators.path import render
from tuturenderer_tpu.options import RenderOptions
from tuturenderer_tpu.parallel.sharding import (make_mesh, render_sharded,
                                                train_step_sharded)
from tuturenderer_tpu.scene.presets import simple_box

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (fake) devices")


def test_sharded_render_matches_single_device():
    scene, cam = simple_box(32, 32)
    opts = RenderOptions(spp=4, max_depth=3)
    mesh = make_mesh(8)
    assert mesh.shape["tile"] * mesh.shape["sample"] == 8
    img1 = np.asarray(render(scene, cam, opts, seed=5))
    img8 = np.asarray(render_sharded(scene, cam, opts, mesh, seed=5))
    np.testing.assert_allclose(img8, img1, rtol=2e-5, atol=2e-6)


def test_sharded_render_cluster_scene_matches_single_device():
    """BVH-carrying SceneData through shard_map: use_bvh=True forces the
    BVH tables onto the tiny scene, pinning the sharded pipeline's
    replication/combiner handling of the large-scene layout at 8 ways
    (the golden gate's sharded_bvh check pins it on the card)."""
    scene, cam = simple_box(32, 32, use_bvh=True)
    opts = RenderOptions(spp=4, max_depth=3)
    mesh = make_mesh(8)
    img1 = np.asarray(render(scene, cam, opts, seed=5))
    img8 = np.asarray(render_sharded(scene, cam, opts, mesh, seed=5))
    np.testing.assert_allclose(img8, img1, rtol=2e-5, atol=2e-6)


def test_sharded_train_step():
    scene, cam = simple_box(16, 16)
    opts = RenderOptions(spp=2, max_depth=2)
    mesh = make_mesh(8)
    params = get_params(scene)
    target = np.zeros((16, 16, 3), np.float32)
    new_params, loss = jax.block_until_ready(
        train_step_sharded(params, target, scene, cam, opts, mesh, lr=1e-3))
    assert np.isfinite(float(loss)) and float(loss) > 0
    moved = jax.tree.map(
        lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()),
        params, new_params)
    assert max(jax.tree.leaves(moved)) > 0  # the update did something


def test_sharded_train_step_gradient_matches_single_device():
    """The 8-way step's loss and gradient equal a 1-device step's: the
    sample axis must not scale either."""
    scene, cam = simple_box(16, 16)
    opts = RenderOptions(spp=4, max_depth=2)
    params = get_params(scene)
    target = np.full((16, 16, 3), 0.1, np.float32)
    p8, l8 = train_step_sharded(params, target, scene, cam, opts,
                                make_mesh(8), lr=1.0)
    p1, l1 = train_step_sharded(params, target, scene, cam, opts,
                                make_mesh(1), lr=1.0)
    np.testing.assert_allclose(float(l8), float(l1), rtol=2e-5)
    for a, b in zip(jax.tree.leaves(p8), jax.tree.leaves(p1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-5)


def test_sharded_light_tracing_matches_single_device():
    from tuturenderer_tpu.integrators.light import render as render_light
    from tuturenderer_tpu.parallel.sharding import render_light_sharded
    scene, cam = simple_box(32, 32)
    opts = RenderOptions(spp=4, lt_max_depth=2)
    mesh = make_mesh(8)
    img1 = np.asarray(render_light(scene, cam, opts, seed=3))
    img8 = np.asarray(render_light_sharded(scene, cam, opts, mesh, seed=3))
    # splats whose projection lands exactly on a pixel boundary can round
    # into the neighboring pixel under a different jit program, so compare
    # statistically: almost every pixel exact, total energy conserved
    close = np.isclose(img8, img1, rtol=2e-5, atol=2e-6)
    assert close.mean() > 0.97
    np.testing.assert_allclose(img8.sum(), img1.sum(), rtol=1e-3)


def test_sharded_bdpt_matches_single_device():
    from tuturenderer_tpu.integrators.bdpt import render as render_bdpt
    from tuturenderer_tpu.parallel.sharding import render_bdpt_sharded
    scene, cam = simple_box(24, 24)
    opts = RenderOptions(spp=2, bdpt_max_path_length=3)
    mesh = make_mesh(8)
    img1 = np.asarray(render_bdpt(scene, cam, opts, seed=7))
    img8 = np.asarray(render_bdpt_sharded(scene, cam, opts, mesh, seed=7))
    np.testing.assert_allclose(img8, img1, rtol=2e-4, atol=1e-5)


def test_multihost_mesh_single_process():
    """The ('host','tile','sample') mesh degenerates gracefully to one
    host and drives the same sharded render path."""
    from tuturenderer_tpu.parallel.distributed import (make_multihost_mesh,
                                                       pixel_axes)
    mesh = make_multihost_mesh()
    assert mesh.axis_names == ("host", "tile", "sample")
    assert mesh.shape["host"] == 1
    assert pixel_axes(mesh) == ("host", "tile")
    # 32x32: at 16x16 the diagonal pixel centers land exactly on the box
    # quads' shared edge (strict-exclusive knife-edge), and the two jit
    # programs round the edge case differently
    scene, cam = simple_box(32, 32)
    opts = RenderOptions(spp=mesh.shape["sample"], max_depth=2)
    img = np.asarray(render_sharded(scene, cam, opts, mesh, seed=1))
    img1 = np.asarray(render(scene, cam, opts, seed=1))
    np.testing.assert_allclose(img, img1, rtol=2e-5, atol=2e-6)
