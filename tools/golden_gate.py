"""Run the reference-oracle golden comparisons and report pass/fail.

The pytest goldens (tests/test_golden.py) are env-gated because they cost
minutes on a CPU; on the GPU they take seconds each, so chip_smoke.py runs
THIS module and records oracle status. Uses the same oracle quirk profile
+ truncating quantization as the pytest suite.

Usage: python tools/golden_gate.py   (or chip_smoke.py calls run_fast())
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "golden")
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _opts(**kw):
    from tuturenderer_tpu.options import RenderOptions
    kw.setdefault("tutu_light_pick", True)
    kw.setdefault("tutu_tri_sample", True)
    kw.setdefault("ggx_sample_bug", True)
    return RenderOptions(**kw)


def _quant(img):
    return np.floor(np.clip(np.asarray(img), 0.0, 1.0) ** 0.78 * 255.0) / 255.0


def _block(img, b):
    h, w, c = img.shape
    return img.reshape(h // b, b, w // b, b, c).mean(axis=(1, 3))


def _check(golden, ours, blk, t_block, t_meanabs, t_mean):
    db = float(np.abs(_block(golden, blk) - _block(ours, blk)).max())
    da = float(np.abs(golden - ours).mean())
    dm = float(abs(golden.mean() - ours.mean()))
    ok = db < t_block and da < t_meanabs and dm < t_mean
    return ok, f"blk={db:.4f}/{t_block} abs={da:.4f}/{t_meanabs} " \
               f"mean={dm:.4f}/{t_mean}"


def _load(ppm):
    from tuturenderer_tpu.io.ppm import read_ppm
    path = os.path.join(GOLDEN_DIR, ppm)
    if not os.path.exists(path):
        return None
    return read_ppm(path)


def run_fast(include_veach: bool = True) -> dict:
    """Run the fast oracle set; returns {name: 'pass'|'FAIL <stats>'}."""
    from tuturenderer_tpu.integrators.bdpt import render as render_bdpt
    from tuturenderer_tpu.integrators.light import render as render_light
    from tuturenderer_tpu.integrators.path import render as render_path
    from tuturenderer_tpu.render import render_config
    from tuturenderer_tpu.scene.presets import (cornell_box, veach_bdpt,
                                                veach_assets_present)

    out = {}

    def run(name, fn):
        t0 = time.time()
        try:
            golden, ours, bounds = fn()
            if golden is None:
                out[name] = "skip (golden missing)"
                return
            ok, stats = _check(golden, ours, *bounds)
            out[name] = ("pass " if ok else "FAIL ") + \
                f"{stats} [{time.time() - t0:.1f}s]"
        except Exception as e:          # noqa: BLE001 — report, don't die
            out[name] = f"ERROR {type(e).__name__}: {e}"

    def cornell():
        scene, cam = cornell_box(width=128, height=128)
        img = render_path(scene, cam, _opts(spp=64), seed=3)
        return _load("cornell_128.ppm"), _quant(img), (16, 0.02, 0.025, 0.004)

    def light():
        scene, cam = cornell_box(width=128, height=128)
        img = render_light(scene, cam, _opts(spp=64, lt_max_depth=2), seed=5)
        return _load("cornell_light_128.ppm"), _quant(img), \
            (16, 0.03, 0.025, 0.006)

    def nee():
        scene, cam = cornell_box(width=128, height=128)
        img = render_path(scene, cam, _opts(spp=64, mis=False), seed=9)
        return _load("cornell_nomis_128.ppm"), _quant(img), \
            (16, 0.035, 0.03, 0.006)

    def mft():
        img = render_config(os.path.join(GOLDEN_DIR, "mft_128.txt"),
                            _opts(spp=64), seed=9, verbose=False)
        return _load("mft_128_ref.ppm"), _quant(img), (16, 0.025, 0.03, 0.006)

    def tex():
        img = render_config(os.path.join(GOLDEN_DIR, "tex_128.txt"),
                            _opts(spp=64), seed=9, verbose=False)
        return _load("tex_128_ref.ppm"), _quant(img), (16, 0.025, 0.03, 0.006)

    def veach():
        scene, cam = veach_bdpt(width=160, height=120)
        img = render_bdpt(scene, cam, _opts(spp=64, samples_per_launch=16),
                          seed=7)
        return _load("veach_160.ppm"), _quant(img), (8, 0.1, 0.04, 0.012)

    def naive():
        # deterministic under the leaked MAXDEPTH=2: the oracle is exactly
        # the directly-visible light patch (tests/test_golden.py docstring)
        from tuturenderer_tpu.integrators.naive import render as render_naive
        scene, cam = cornell_box(width=128, height=128)
        img = render_naive(scene, cam, _opts(spp=4, lt_max_depth=2), seed=5)
        return _load("cornell_naive_512spp.ppm"), _quant(img), \
            (16, 0.01, 0.005, 0.002)

    def flagship():
        # BASELINE.md's headline row: Cornell @ 512 spp vs the reference
        # (256^2 oracle; thresholds sqrt(8) tighter than the 64-spp ones)
        scene, cam = cornell_box(width=256, height=256)
        img = render_path(scene, cam,
                          _opts(spp=512, samples_per_launch=8), seed=13)
        return _load("cornell_flagship_256.ppm"), _quant(img), \
            (16, 0.008, 0.012, 0.003)

    def flagship_1024():
        # the EXACT published flagship: 1024x1024 @ 512 spp
        # (README.md:74-75, img/spp512_1900sec.png; reference oracle
        # rendered single-threaded at full scale)
        scene, cam = cornell_box(width=1024, height=1024)
        img = render_path(scene, cam,
                          _opts(spp=512, samples_per_launch=2), seed=13)
        return _load("cornell_flagship_1024.ppm"), _quant(img), \
            (16, 0.008, 0.012, 0.003)

    def mesh_bdpt():
        # mesh-scale end-to-end: ~18k-tri inline sphere through the BVH
        # + wavefront BDPT (tests/test_golden.py docstring)
        img = render_config(os.path.join(GOLDEN_DIR, "mesh_bdpt_128.txt"),
                            _opts(spp=64, samples_per_launch=16), seed=9,
                            verbose=False)
        return _load("mesh_bdpt_128_ref.ppm"), _quant(img), \
            (8, 0.1, 0.04, 0.012)

    def sharded_bvh():
        """shard_map x BVH traversal on a scene above BVH_THRESHOLD: a
        1-device-mesh render_sharded(sphere_showcase) must equal the
        single-device render."""
        from tuturenderer_tpu.models.scenes import sphere_showcase
        from tuturenderer_tpu.parallel.sharding import (make_mesh,
                                                        render_sharded)
        scene, cam = sphere_showcase(width=128, height=128)
        opts = _opts(spp=2)
        mesh = make_mesh(1)
        sh = np.asarray(render_sharded(scene, cam, opts, mesh, seed=3))
        single = np.asarray(render_path(scene, cam, opts, seed=3))
        err = float(np.abs(sh - single).max())
        rel = err / max(float(np.abs(single).max()), 1e-6)
        ok = rel < 2e-3 and np.isfinite(sh).all() and scene.bvh is not None
        return ok, f"maxabs={err:.2e} rel={rel:.2e}"

    def run_direct(name, fn):
        t0 = time.time()
        try:
            ok, stats = fn()
            out[name] = ("pass " if ok else "FAIL ") + \
                f"{stats} [{time.time() - t0:.1f}s]"
        except Exception as e:          # noqa: BLE001 — report, don't die
            out[name] = f"ERROR {type(e).__name__}: {e}"

    run("cornell_pt", cornell)
    run("cornell_lt", light)
    run("cornell_nee", nee)
    run_direct("sharded_bvh", sharded_bvh)
    run("naive_pt", naive)
    run("mesh_bdpt", mesh_bdpt)
    run("mft", mft)
    run("tex", tex)
    if include_veach and veach_assets_present():
        run("veach_bdpt", veach)
    elif include_veach:
        out["veach_bdpt"] = "skip (Veach OBJ assets not mounted)"
        print("golden_gate: veach_bdpt skipped: the reference's Veach OBJ "
              "assets are not mounted", file=sys.stderr)
    run("cornell_flagship_512spp", flagship)
    run("cornell_flagship_1024px", flagship_1024)
    return out


if __name__ == "__main__":
    res = run_fast()
    for k, v in res.items():
        print(f"{k}: {v}")
    sys.exit(0 if all(v.startswith(("pass", "skip")) for v in res.values())
             else 1)
