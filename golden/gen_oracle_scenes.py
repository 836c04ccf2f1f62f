"""Generate the round-3 oracle scene configs + texture assets.

Writes, for each scene, a *_ref.txt variant (consumed by the reference
binary ref_oracle, which hard-codes the emissive light quad — the
reference config grammar cannot express emission, main_cornellBox.cpp:
31-38) and a *.txt variant for this framework (identical plus the
inline light quad through the `emission` grammar extension). Both are
produced from ONE body string so the geometry cannot drift.

Textures are tiny ASCII-P3 files in golden/tex/ (our own assets, not
reference-derived): a checker diffuse map, a sinusoidal tangent-space
normal map, a roughness gradient, and a metallic block pattern.
"""
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TEX = os.path.join(HERE, "tex")


def write_p3(path, rgb):
    h, w, _ = rgb.shape
    q = np.clip(np.round(rgb * 255.0), 0, 255).astype(int)
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        for row in q:
            f.write(" ".join(str(v) for px in row for v in px) + "\n")


def gen_textures():
    os.makedirs(TEX, exist_ok=True)
    n = 32
    yy, xx = np.mgrid[0:n, 0:n]
    checker = ((xx // 8 + yy // 8) % 2).astype(np.float32)
    rgb = np.stack([0.2 + 0.7 * checker,
                    0.6 - 0.4 * checker,
                    0.3 + 0.2 * checker], axis=-1)
    write_p3(os.path.join(TEX, "checker.ppm"), rgb)

    # tangent-space normal map, encoded [0,1] -> decoded to [-1,1]
    nx = 0.3 * np.sin(2 * np.pi * xx / 16.0)
    ny = 0.3 * np.cos(2 * np.pi * yy / 16.0)
    nz = np.sqrt(np.maximum(1.0 - nx * nx - ny * ny, 0.0))
    bump = np.stack([(nx + 1) / 2, (ny + 1) / 2, (nz + 1) / 2], axis=-1)
    write_p3(os.path.join(TEX, "bump.ppm"), bump)

    rough = np.repeat((0.1 + 0.8 * xx / (n - 1))[:, :, None], 3, axis=2)
    write_p3(os.path.join(TEX, "rough.ppm"), rough)

    metal = np.repeat(((yy // 16) % 2).astype(np.float32)[:, :, None] * 0.9,
                      3, axis=2)
    write_p3(os.path.join(TEX, "metal.ppm"), metal)


HEADER = """imsize 128 128
eye 0 0.35 2.6
viewdir 0 -0.12 -1
updir 0 1 0
hfov 55
bkgcolor 0.05 0.05 0.08 1.0
integrator path
"""

# the light quad ref_oracle hard-codes (emission 10, diffuse 0.9); the
# framework variant expresses it inline, FIRST — before any material-type
# keyword, because mtype persists across mtlcolor (the reference parser
# state machine, PPMGenerator.hpp:583-609) and the light must stay
# LAMBERTIAN like ref_oracle's hard-coded Material
LIGHT_QUAD = """mtlcolor 0.9 0.9 0.9 1 1 1 1.0 1.0
emission 10 10 10
v -0.5 1.4 -0.5
v 0.5 1.4 -0.5
v 0.5 1.4 0.5
v -0.5 1.4 0.5
vn 0 -1 0
f 1//1 2//1 3//1
f 1//1 3//1 4//1
mtlcolor 0.9 0.9 0.9 1 1 1 1.0 1.0
"""


def mft_body(o):
    return f"""mtlcolor 0.7 0.7 0.7 1 1 1 1.0 1.0
v -2 -0.5 2
v 2 -0.5 2
v 2 -0.5 -2
v -2 -0.5 -2
f {1+o} {2+o} {3+o}
f {1+o} {3+o} {4+o}
v -2 -0.5 -1.6
v 2 -0.5 -1.6
v 2 2 -1.6
v -2 2 -1.6
f {5+o} {6+o} {7+o}
f {5+o} {7+o} {8+o}
MICROFACET_T 0.95 0.95 0.95 0.5 1.5 0.2 0.0
sphere 0 0.05 0 0.55
"""

def tex_body(o):
    # the framework's parser resolves texture names against the config's
    # directory, so its variant names them relative to golden/ and works
    # from any checkout; the reference binary opens them from its working
    # directory, so its variant keeps this checkout's absolute paths
    tex = "tex" if o else TEX
    return f"""MICROFACET_R 0.8 0.6 0.4 1.0 1.0 0.4 0.3
texture {tex}/checker.ppm
roughnessTexture {tex}/rough.ppm
metallicTexture {tex}/metal.ppm
sphere 0 0.05 0 0.55
mtlcolor 0.7 0.7 0.7 1 1 1 1.0 1.0
texture {tex}/checker.ppm
bump {tex}/bump.ppm
v -2 -0.5 2
v 2 -0.5 2
v 2 -0.5 -2
v -2 -0.5 -2
vt 0 0
vt 4 0
vt 4 4
vt 0 4
f {1+o}/1 {2+o}/2 {3+o}/3
f {1+o}/1 {3+o}/3 {4+o}/4
"""


def mesh_bdpt_body(o, nu=96, nv=96):
    """A ~18k-triangle smooth UV sphere (MICROFACET_R) over a diffuse
    floor, all INLINE v/vn/f geometry — the mesh-scale end-to-end oracle
    (VERDICT r3 missing #2): the reference parses it through readObject
    (PPMGenerator.hpp:328-482) into its BVH + BDPT; this framework parses
    the same file into the BVH intersector + wavefront BDPT.
    Inline geometry rather than OBJ because the reference's config
    grammar has no obj keyword (OBJ loads are hard-coded in the mains);
    OBJ-loader parity is pinned separately in tests/test_native.py."""
    lines = ["mtlcolor 0.7 0.7 0.7 1 1 1 1.0 1.0",
             "v -2 -0.5 2", "v 2 -0.5 2", "v 2 -0.5 -2", "v -2 -0.5 -2",
             f"f {1+o} {2+o} {3+o}", f"f {1+o} {3+o} {4+o}",
             "MICROFACET_R 0.8 0.3 0.2 1.0 1.0 0.3 0.2"]
    vo = 4 + o          # vertex index offset (floor quad above)
    no = 1 if o else 0  # the framework variant's light quad adds ONE vn
    r, cy = 0.55, 0.05
    import math
    for i in range(nu + 1):
        th = 2 * math.pi * i / nu
        for j in range(nv + 1):
            ph = math.pi * j / nv
            x = math.cos(th) * math.sin(ph)
            y = math.cos(ph)
            z = math.sin(th) * math.sin(ph)
            lines.append(f"v {r*x:.6f} {cy + r*y:.6f} {r*z:.6f}")
            lines.append(f"vn {x:.6f} {y:.6f} {z:.6f}")
    def vid(i, j):
        return vo + i * (nv + 1) + j + 1
    def nid(i, j):
        return no + i * (nv + 1) + j + 1
    for i in range(nu):
        for j in range(nv):
            a, b = (i, j), (i + 1, j)
            c, d = (i + 1, j + 1), (i, j + 1)
            if j > 0:        # degenerate at the pole
                lines.append(
                    f"f {vid(*a)}//{nid(*a)} {vid(*b)}//{nid(*b)} "
                    f"{vid(*c)}//{nid(*c)}")
            if j < nv - 1:
                lines.append(
                    f"f {vid(*a)}//{nid(*a)} {vid(*c)}//{nid(*c)} "
                    f"{vid(*d)}//{nid(*d)}")
    return "\n".join(lines) + "\n"


def main():
    gen_textures()
    for name, body in (("mft_128", mft_body), ("tex_128", tex_body)):
        with open(os.path.join(HERE, f"{name}_ref.txt"), "w") as f:
            f.write(HEADER + body(0))
        with open(os.path.join(HERE, f"{name}.txt"), "w") as f:
            f.write(HEADER + LIGHT_QUAD + body(4))
    bdpt_header = HEADER.replace("integrator path", "integrator bdpt")
    with open(os.path.join(HERE, "mesh_bdpt_128_ref.txt"), "w") as f:
        f.write(bdpt_header + mesh_bdpt_body(0))
    with open(os.path.join(HERE, "mesh_bdpt_128.txt"), "w") as f:
        f.write(bdpt_header + LIGHT_QUAD + mesh_bdpt_body(4))
    print("wrote mft_128[_ref].txt tex_128[_ref].txt "
          "mesh_bdpt_128[_ref].txt + tex/")


if __name__ == "__main__":
    main()
