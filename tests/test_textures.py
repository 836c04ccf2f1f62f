"""Texture pipeline: atlas lookup, material override, TBN normal mapping."""
import os
import tempfile

import jax.numpy as jnp
import numpy as np

from tuturenderer_tpu.integrators.path import apply_textures
from tuturenderer_tpu.materials import gather_material
from tuturenderer_tpu.ops.intersect import intersect_scene
from tuturenderer_tpu.scene.data import LAMBERTIAN, SceneBuilder
from tuturenderer_tpu.utils.vec import Vec3


def checker(n=8):
    img = np.zeros((n, n, 3), np.float32)
    for y in range(n):
        for x in range(n):
            img[y, x] = (1, 0, 0) if (x + y) % 2 == 0 else (0, 0, 1)
    return img


def textured_scene():
    b = SceneBuilder()
    tex = b.add_texture("diffuse", "checker", checker())
    rough = b.add_texture("roughness", "r", np.full((4, 4, 3), 0.25, np.float32))
    m = b.add_material(LAMBERTIAN, diffuse=(0.5, 0.5, 0.5),
                       diffuse_map=tex, roughness_map=rough)
    verts = np.asarray([[[0, 0, 0], [4, 0, 0], [0, 4, 0]]], np.float32)
    uvs = np.asarray([[[0, 0], [1, 0], [0, 1]]], np.float32)
    b.add_triangles(verts, None, uvs, m)
    return b.build()


def rays(origins, dirs):
    o = np.asarray(origins, np.float32)
    d = np.asarray(dirs, np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return (Vec3(*[jnp.asarray(o[:, i]) for i in range(3)]),
            Vec3(*[jnp.asarray(d[:, i]) for i in range(3)]))


def test_atlas_repeat_wrap():
    s = textured_scene()
    atlas = s.diffuse_maps
    # u=0.05,v=0.05 -> texel (0,0) = red ; u=0.18 -> texel (1,0) = blue
    c0 = atlas.sample(jnp.asarray([0]), jnp.asarray([0.05]), jnp.asarray([0.05]))
    c1 = atlas.sample(jnp.asarray([0]), jnp.asarray([0.18]), jnp.asarray([0.05]))
    assert float(c0.x[0]) == 1.0 and float(c0.z[0]) == 0.0
    assert float(c1.x[0]) == 0.0 and float(c1.z[0]) == 1.0
    # wrap: u=1.05 equals u=0.05
    cw = atlas.sample(jnp.asarray([0]), jnp.asarray([1.05]), jnp.asarray([0.05]))
    assert float(cw.x[0]) == 1.0
    # idx -1 -> zeros
    cz = atlas.sample(jnp.asarray([-1]), jnp.asarray([0.1]), jnp.asarray([0.1]))
    assert float(cz.x[0]) == 0.0


def test_apply_textures_overrides_material():
    s = textured_scene()
    # hit near the (0,0) uv corner -> red texel; roughness -> 0.25
    o, d = rays([[0.3, 0.3, 1.0]], [[0, 0, -1]])
    hit = intersect_scene(s, o, d)
    assert bool(hit.hit[0])
    params = gather_material(s, hit.mat)
    assert float(params.diffuse.x[0]) == 0.5   # before override
    params2, ns = apply_textures(s, hit, params)
    assert abs(float(params2.diffuse.x[0]) - 1.0) < 1e-5
    assert abs(float(params2.diffuse.z[0]) - 0.0) < 1e-5
    assert abs(float(params2.roughness[0]) - 0.25) < 1e-5


def test_normal_map_perturbs_shading_normal():
    b = SceneBuilder()
    # normal map texel pointing along tangent +T
    nm = np.zeros((2, 2, 3), np.float32)
    nm[:, :] = (0.6, 0.0, 0.8)   # already decoded [-1,1] space
    nmap = b.add_texture("normal", "n", nm)
    m = b.add_material(LAMBERTIAN, normal_map=nmap)
    verts = np.asarray([[[0, 0, 0], [4, 0, 0], [0, 4, 0]]], np.float32)
    uvs = np.asarray([[[0, 0], [1, 0], [0, 1]]], np.float32)
    b.add_triangles(verts, None, uvs, m)
    s = b.build()
    o, d = rays([[0.5, 0.5, 1.0]], [[0, 0, -1]])
    hit = intersect_scene(s, o, d)
    params = gather_material(s, hit.mat)
    p2, ns = apply_textures(s, hit, params)
    # unperturbed Ns is +z; after mapping it should tilt toward the
    # tangent (du direction = v1-v0 = +x) with z = 0.8 weight
    assert float(ns.z[0]) > 0.5
    assert abs(float(ns.x[0])) > 0.3
    nrm = float(jnp.sqrt(ns.x**2 + ns.y**2 + ns.z**2)[0])
    assert abs(nrm - 1.0) < 1e-5


def test_config_texture_roundtrip(tmp_path):
    """Config-driven texture binding through the full parser."""
    from tuturenderer_tpu.io.ppm import write_ppm
    from tuturenderer_tpu.scene.config import parse_config
    tex_path = tmp_path / "check.ppm"
    write_ppm(str(tex_path), checker(), gamma=1.0)
    cfg = tmp_path / "scene.txt"
    cfg.write_text(f"""
imsize 16 16
eye 0 0 -3
viewdir 0 0 1
hfov 60
updir 0 1 0
bkgcolor 0 0 0 1.0
integrator path
texture {tex_path.name}
v -1 -1 0
v 1 -1 0
v 0 1 0
vt 0 0
vt 1 0
vt 0.5 1
f 1/1 2/2 3/3
""")
    pc = parse_config(str(cfg))
    scene = pc.builder.build()
    assert scene.has_textures
    assert scene.diffuse_maps.k == 1
    assert int(scene.materials.diffuse_map[int(scene.tmat[0])]) == 0


def test_golden_texture_scene_loads_from_a_copy(tmp_path):
    """golden/tex_128.txt names its maps relative to itself, so a checkout
    at any path (or a copy of golden/) renders it: every map is read from
    the copy (2x2 stand-ins here), none from the tree it was copied from."""
    from tuturenderer_tpu.io.ppm import write_ppm
    from tuturenderer_tpu.scene.config import parse_config
    golden = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "golden")
    copy = tmp_path / "golden"
    (copy / "tex").mkdir(parents=True)
    for name in ("checker", "bump", "rough", "metal"):
        write_ppm(str(copy / "tex" / f"{name}.ppm"),
                  np.full((2, 2, 3), 0.2, np.float32), gamma=1.0)
    with open(os.path.join(golden, "tex_128.txt")) as f:
        (copy / "tex_128.txt").write_text(f.read())
    scene = parse_config(str(copy / "tex_128.txt")).builder.build()
    assert scene.has_textures
    for atlas in (scene.diffuse_maps, scene.normal_maps,
                  scene.roughness_maps, scene.metallic_maps):
        assert atlas.k == 1
        assert (int(atlas.w[0]), int(atlas.h[0])) == (2, 2)
