"""The in-repo Cornell box: geometry, light and materials as the
reference's main_cornellBox.cpp builds them."""
import numpy as np

from tuturenderer_tpu.scene.data import LAMBERTIAN
from tuturenderer_tpu.scene.presets import CORNELL_MESHES, cornell_box


def test_cornell_box_inline_geometry():
    scene, cam = cornell_box(width=16, height=16)
    assert scene.n_tris == 32 and scene.n_spheres == 0
    assert scene.bvh is None                       # dense streaming
    # six meshes of quads, fan-triangulated: 3+1+1+1+5+5 quads
    assert [len(CORNELL_MESHES[k]) for k in
            ("floor", "light", "right", "left", "tallbox", "shortbox")] \
        == [3, 1, 1, 1, 5, 5]

    ng = np.asarray(scene.tri_shade)[:, 9:12]      # unit geometric normals
    v = np.stack([np.asarray(x.stack()) for x in
                  (scene.tv0, scene.tv1, scene.tv2)], axis=1)
    # walls, floor, ceiling and light face into the box
    centre = np.asarray([278.0, 274.4, 279.6])
    room = slice(0, 12)
    to_centre = centre - v[room].mean(axis=1)
    assert (np.einsum("ij,ij->i", ng[room], to_centre) > 0).all()
    # every box face points away from its box's vertical axis or up
    for lo, hi in ((12, 22), (22, 32)):
        axis = v[lo:hi].reshape(-1, 3).mean(axis=0)
        out = v[lo:hi].mean(axis=1) - axis
        out[:, 1] = np.where(np.abs(ng[lo:hi, 1]) > 0.99, 1.0, 0.0)
        assert (np.einsum("ij,ij->i", ng[lo:hi], out) > 0).all()

    # the light: two triangles 0.1 below the ceiling, facing down
    assert scene.n_lights == 2
    light_tris = np.asarray(scene.light_idx)
    np.testing.assert_array_equal(light_tris, [6, 7])
    np.testing.assert_allclose(ng[light_tris], [[0, -1, 0]] * 2, atol=1e-6)
    np.testing.assert_allclose(v[light_tris][..., 1], 548.7)
    np.testing.assert_allclose(np.asarray(scene.light_area).sum(),
                               130.0 * 105.0, rtol=1e-5)

    mats = scene.materials
    assert np.asarray(mats.mtype).tolist() == [LAMBERTIAN] * 4
    np.testing.assert_allclose(np.asarray(mats.diffuse.stack()), [
        [0.725, 0.71, 0.68], [0.725, 0.71, 0.68],
        [0.14, 0.45, 0.091], [0.63, 0.065, 0.05]], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(mats.emission.stack())[1],
                               [47.8348007, 38.5663986, 31.0807991])
    tmat = np.asarray(scene.tmat)
    assert tmat.tolist() == [0] * 6 + [1] * 2 + [2] * 2 + [3] * 2 + [0] * 20
    # green on the x=0 wall, red on the x~555 wall
    assert v[tmat == 2][..., 0].max() == 0.0
    assert v[tmat == 3][..., 0].min() > 549.0
    np.testing.assert_allclose(np.asarray(cam.position.stack()),
                               [278, 273, -800])
    np.testing.assert_allclose(np.asarray(cam.fwd.stack()), [0, 0, 1],
                               atol=1e-6)
    assert cam.hfov == 40
