"""Built-in scenes mirroring the reference entry points.

The reference hard-codes scene composition in its mains
(src/main_cornellBox.cpp:23-71, src/main.cpp:24-86); these builders
reproduce the same materials and geometry so renders are comparable.
The Cornell box is inline geometry (below); the Veach room reads the
reference's OBJ assets from ``model_dir`` and is available only where
that tree is mounted (``veach_assets_present``).
"""
from __future__ import annotations

import os

import numpy as np

from ..camera import Camera, make_camera
from .data import (LAMBERTIAN, MICROFACET_R, PERFECT_REFRACTIVE, SceneBuilder,
                   SceneData)
from .objloader import load_obj

DEFAULT_MODEL_DIR = "/root/reference/model"

# The Cornell box of Cornell's Program of Computer Graphics, as distributed
# with the GAMES101 course (the reference's model/cornellBox/*.obj). Each
# mesh is a list of quads, corners in file order; the light sits 0.1 below
# the ceiling (548.7), which the in-repo oracle images pin.
CORNELL_MESHES = {
    "floor": [   # floor, ceiling, back wall
        [(552.8, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 559.2),
         (549.6, 0.0, 559.2)],
        [(556.0, 548.8, 0.0), (556.0, 548.8, 559.2), (0.0, 548.8, 559.2),
         (0.0, 548.8, 0.0)],
        [(549.6, 0.0, 559.2), (0.0, 0.0, 559.2), (0.0, 548.8, 559.2),
         (556.0, 548.8, 559.2)],
    ],
    "light": [
        [(343.0, 548.7, 227.0), (343.0, 548.7, 332.0), (213.0, 548.7, 332.0),
         (213.0, 548.7, 227.0)],
    ],
    "right": [
        [(0.0, 0.0, 559.2), (0.0, 0.0, 0.0), (0.0, 548.8, 0.0),
         (0.0, 548.8, 559.2)],
    ],
    "left": [
        [(552.8, 0.0, 0.0), (549.6, 0.0, 559.2), (556.0, 548.8, 559.2),
         (556.0, 548.8, 0.0)],
    ],
    "tallbox": [
        [(423.0, 330.0, 247.0), (265.0, 330.0, 296.0), (314.0, 330.0, 456.0),
         (472.0, 330.0, 406.0)],
        [(423.0, 0.0, 247.0), (423.0, 330.0, 247.0), (472.0, 330.0, 406.0),
         (472.0, 0.0, 406.0)],
        [(472.0, 0.0, 406.0), (472.0, 330.0, 406.0), (314.0, 330.0, 456.0),
         (314.0, 0.0, 456.0)],
        [(314.0, 0.0, 456.0), (314.0, 330.0, 456.0), (265.0, 330.0, 296.0),
         (265.0, 0.0, 296.0)],
        [(265.0, 0.0, 296.0), (265.0, 330.0, 296.0), (423.0, 330.0, 247.0),
         (423.0, 0.0, 247.0)],
    ],
    "shortbox": [
        [(130.0, 165.0, 65.0), (82.0, 165.0, 225.0), (240.0, 165.0, 272.0),
         (290.0, 165.0, 114.0)],
        [(290.0, 0.0, 114.0), (290.0, 165.0, 114.0), (240.0, 165.0, 272.0),
         (240.0, 0.0, 272.0)],
        [(130.0, 0.0, 65.0), (130.0, 165.0, 65.0), (290.0, 165.0, 114.0),
         (290.0, 0.0, 114.0)],
        [(82.0, 0.0, 225.0), (82.0, 165.0, 225.0), (130.0, 165.0, 65.0),
         (130.0, 0.0, 65.0)],
        [(240.0, 0.0, 272.0), (240.0, 165.0, 272.0), (82.0, 165.0, 225.0),
         (82.0, 0.0, 225.0)],
    ],
}


def _add_mesh(b: SceneBuilder, path: str, mat: int):
    m = load_obj(path)
    b.add_triangles(m.verts, m.normals, m.uvs, mat)


def _add_quads(b: SceneBuilder, quads, mat: int):
    """Fan-triangulate each quad as the OBJ loader does (0,1,2)(0,2,3);
    flat face normals come from the winding, as for an OBJ without vn."""
    q = np.asarray(quads, np.float32)
    tris = np.stack([q[:, [0, 1, 2]], q[:, [0, 2, 3]]], axis=1)
    b.add_triangles(tris.reshape(-1, 3, 3), None, None, mat)


def cornell_box(width: int = 1024, height: int = 1024):
    """Cornell box exactly as src/main_cornellBox.cpp:23-71 + camera from
    configs/config_cornellBox.txt: 32 triangles in six meshes."""
    b = SceneBuilder(bkgcolor=(0.0, 0.0, 0.0), eta=1.0)
    white = b.add_material(LAMBERTIAN, diffuse=(0.725, 0.71, 0.68))
    light = b.add_material(LAMBERTIAN, diffuse=(0.725, 0.71, 0.68),
                           emission=(47.8348007, 38.5663986, 31.0807991))
    green = b.add_material(LAMBERTIAN, diffuse=(0.14, 0.45, 0.091))
    red = b.add_material(LAMBERTIAN, diffuse=(0.63, 0.065, 0.05))
    for name, mat in (("floor", white), ("light", light), ("right", green),
                      ("left", red), ("tallbox", white),
                      ("shortbox", white)):
        _add_quads(b, CORNELL_MESHES[name], mat)
    scene = b.build()
    cam = make_camera(width, height, 40, eye=(278, 273, -800),
                      viewdir=(0, 0, 1), updir=(0, 1, 0))
    return scene, cam


def veach_assets_present(model_dir: str = DEFAULT_MODEL_DIR) -> bool:
    """True where the reference's Veach OBJ tree is mounted."""
    return os.path.isdir(os.path.join(model_dir, "veach_bdpt"))


def veach_bdpt(model_dir: str = DEFAULT_MODEL_DIR,
               width: int = 800, height: int = 600):
    """Veach BDPT room exactly as src/main.cpp:24-86 + camera from
    configs/config_veach_bdpt.txt. (The reference's lowercase
    ``veach_slight.obj`` path only works on case-insensitive filesystems,
    main.cpp:49; the real file name is used here.)"""
    d = os.path.join(model_dir, "veach_bdpt")
    b = SceneBuilder(bkgcolor=(0.0, 0.0, 0.0), eta=1.0)
    room = b.add_material(LAMBERTIAN, diffuse=(0.725, 0.71, 0.68))
    llight = b.add_material(LAMBERTIAN, diffuse=(0.725, 0.71, 0.68),
                            emission=(250.0, 250.0, 250.0))
    slight = b.add_material(LAMBERTIAN, diffuse=(0.725, 0.71, 0.68),
                            emission=(6999.999881 * 0.5, 5450.000167 * 0.5,
                                      3630.000055 * 0.5))
    table = b.add_material(LAMBERTIAN,
                           diffuse=(0.32962962985, 0.257976263762, 0.150291711092))
    glass = b.add_material(PERFECT_REFRACTIVE, eta=1.5)
    tall_lamp = b.add_material(MICROFACET_R, roughness=0.2775146484375,
                               metallic=0.5,
                               diffuse=(0.32962962985, 0.257976263762,
                                        0.150291711092))
    _add_mesh(b, os.path.join(d, "veach_room.obj"), room)
    _add_mesh(b, os.path.join(d, "veach_Llight.obj"), llight)
    _add_mesh(b, os.path.join(d, "veach_sLight.obj"), slight)
    _add_mesh(b, os.path.join(d, "veach_table.obj"), table)
    _add_mesh(b, os.path.join(d, "veach_glass.obj"), glass)
    _add_mesh(b, os.path.join(d, "veach_tallLamp.obj"), tall_lamp)
    _add_mesh(b, os.path.join(d, "veach_wallLamp.obj"), room)
    scene = b.build()
    cam = make_camera(width, height, 40, eye=(-0.5, 0, 7.6),
                      viewdir=(-0.005, 0, -1), updir=(0, 1, 0))
    return scene, cam


def simple_box(width: int = 256, height: int = 256, use_bvh=None):
    """Small self-contained test scene (no external assets): a Cornell-like
    box built from explicit quads plus a mirror and a glass sphere.

    ``use_bvh=True`` forces a BVH onto this tiny scene (SceneBuilder.build's
    auto threshold would pick dense streaming) so sharding checks can pin
    the BVH-carrying SceneData layout through shard_map."""
    import numpy as np
    b = SceneBuilder(bkgcolor=(0.0, 0.0, 0.0), eta=1.0)
    white = b.add_material(LAMBERTIAN, diffuse=(0.73, 0.73, 0.73))
    red = b.add_material(LAMBERTIAN, diffuse=(0.65, 0.05, 0.05))
    green = b.add_material(LAMBERTIAN, diffuse=(0.12, 0.45, 0.15))
    light = b.add_material(LAMBERTIAN, diffuse=(0.73, 0.73, 0.73),
                           emission=(30.0, 30.0, 30.0))
    mirror = b.add_material(1)  # PERFECT_REFLECTIVE
    glass = b.add_material(2, eta=1.5)  # PERFECT_REFRACTIVE

    def quad(p0, p1, p2, p3, mat):
        v = np.asarray([[p0, p1, p2], [p0, p2, p3]], np.float32)
        b.add_triangles(v, None, None, mat)

    # windings chosen so geometric normals point into the box
    s = 1.0
    quad((-s, -s, -s), (-s, -s, s), (s, -s, s), (s, -s, -s), white)   # floor +y
    quad((-s, s, -s), (s, s, -s), (s, s, s), (-s, s, s), white)       # ceiling -y
    quad((-s, -s, s), (-s, s, s), (s, s, s), (s, -s, s), white)       # back -z
    quad((-s, -s, s), (-s, -s, -s), (-s, s, -s), (-s, s, s), red)     # left +x
    quad((s, -s, -s), (s, -s, s), (s, s, s), (s, s, -s), green)       # right -x
    q = 0.35
    quad((-q, s - 1e-3, -q), (q, s - 1e-3, -q), (q, s - 1e-3, q),
         (-q, s - 1e-3, q), light)                                    # light -y
    b.add_sphere((-0.45, -0.6, 0.2), 0.4, mirror)
    b.add_sphere((0.45, -0.6, -0.2), 0.4, glass)
    scene = b.build(use_bvh=use_bvh)
    cam = make_camera(width, height, 60, eye=(0, 0, -3.6),
                      viewdir=(0, 0, 1), updir=(0, 1, 0))
    return scene, cam
