"""Native C++ host runtime vs pure-Python fallbacks."""
import os
import tempfile

import numpy as np
import pytest

from tuturenderer_tpu import native



@pytest.fixture(autouse=True)
def _native_library():
    if native.load_library() is None:
        pytest.skip("native library unavailable (build failed)")

OBJ_TEXT = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1/1 2/2/1 3/3/1 4/4/1
"""


def test_native_obj_matches_python():
    from tuturenderer_tpu.scene.objloader import _load_obj_py
    with tempfile.NamedTemporaryFile("w", suffix=".obj", delete=False) as f:
        f.write(OBJ_TEXT)
        path = f.name
    try:
        nv, nn, nt = native.obj_load(path)
        py = _load_obj_py(path)
        assert nv.shape == (2, 3, 3)   # quad fan-triangulated
        np.testing.assert_allclose(nv, py.verts)
        np.testing.assert_allclose(nn, py.normals)
        np.testing.assert_allclose(nt, py.uvs)
    finally:
        os.unlink(path)


def test_native_obj_reference_assets():
    from tuturenderer_tpu.scene.objloader import _load_obj_py
    path = "/root/reference/model/cornellBox/shortbox.obj"
    if not os.path.exists(path):
        pytest.skip("reference assets not mounted")
    nv, nn, nt = native.obj_load(path)
    py = _load_obj_py(path)
    np.testing.assert_allclose(nv, py.verts)
    np.testing.assert_allclose(nn, py.normals, atol=1e-6)


def test_native_bvh_valid_partition():
    r = np.random.RandomState(3)
    verts = (r.randn(97, 1, 3) + 0.3 * r.randn(97, 3, 3)).astype(np.float32)
    bvh = native.bvh_build(verts, leaf_size=4)
    assert sorted(bvh['prim'].tolist()) == list(range(97))
    leaves = bvh['left'] < 0
    assert bvh['count'][leaves].sum() == 97
    # bounds contain their primitives
    for node in np.nonzero(leaves)[0][:10]:
        s, c = bvh['start'][node], bvh['count'][node]
        prims = bvh['prim'][s:s + c]
        lo = verts[prims].reshape(-1, 3).min(axis=0)
        hi = verts[prims].reshape(-1, 3).max(axis=0)
        assert (bvh['bb_min'][node] <= lo + 1e-6).all()
        assert (bvh['bb_max'][node] >= hi - 1e-6).all()


def test_native_ppm_roundtrip():
    img = np.random.RandomState(0).rand(7, 5, 3).astype(np.float32)
    with tempfile.NamedTemporaryFile(suffix=".ppm", delete=False) as f:
        path = f.name
    try:
        assert native.ppm_write(path, img, gamma=1.0)
        back = native.ppm_read(path)
        assert back.shape == (7, 5, 3)
        np.testing.assert_allclose(back, img, atol=1.0 / 255 + 1e-3)
        # python reader agrees
        from tuturenderer_tpu.io.ppm import read_ppm
        np.testing.assert_allclose(read_ppm(path), back, atol=1e-6)
    finally:
        os.unlink(path)
