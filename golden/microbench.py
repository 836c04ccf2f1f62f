"""Microbenchmark the hot pieces of the wavefront on the GPU.

Times (per call, 1M lanes, Cornell scene): scene intersection, occlusion,
full bounce shading, and a full single-sample trace.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np

from tuturenderer_tpu.camera import primary_ray
from tuturenderer_tpu.integrators.path import render_sample, trace_rays
from tuturenderer_tpu.materials import bxdf_eval, bxdf_pdf, bxdf_sample, gather_material
from tuturenderer_tpu.ops.intersect import intersect_core, occluded, shade_hit
from tuturenderer_tpu.options import RenderOptions
from tuturenderer_tpu.scene.presets import cornell_box
from tuturenderer_tpu.utils import rng


def timeit(fn, *args, reps=5):
    out = jax.block_until_ready(fn(*args))      # compile
    t0 = time.time()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return (time.time() - t0) / reps


def main():
    scene, cam = cornell_box(width=1024, height=1024)
    n = cam.n_pixels
    lane = jnp.arange(n, dtype=jnp.int32)
    px = lane % cam.width
    py = lane // cam.width
    o, d, _ = primary_ray(cam, px, py)
    opts = RenderOptions(spp=1)

    t_int = timeit(jax.jit(lambda o, d: intersect_core(scene, o, d).t), o, d)
    print(f"intersect_core   1M rays x 32 tris: {t_int*1e3:8.2f} ms "
          f"-> {n/t_int/1e6:7.1f} M rays/s")

    dist = jnp.full((n,), 100.0)
    t_occ = timeit(jax.jit(lambda o, d: occluded(scene, o, d, dist)), o, d)
    print(f"occluded                           : {t_occ*1e3:8.2f} ms "
          f"-> {n/t_occ/1e6:7.1f} M rays/s")

    @jax.jit
    def shade_only(o, d):
        core = intersect_core(scene, o, d)
        hit = shade_hit(scene, o, d, core)
        params = gather_material(scene, hit.mat)
        wo = -d
        u = lambda p: rng.uniform(0, lane, 0, 0, p)
        samp = bxdf_sample(params, wo, hit.ns, u(3), u(4), u(5),
                           scene.eta, types=scene.mtype_set)
        pdf = bxdf_pdf(params, samp.wi, wo, hit.ns, scene.eta,
                       params.eta, types=scene.mtype_set)
        f = bxdf_eval(params, samp.wi, wo, hit.ng, hit.ns, scene.eta,
                      types=scene.mtype_set)
        return f.x + pdf

    t_shade = timeit(shade_only, o, d)
    print(f"intersect+shade+sample+pdf+eval    : {t_shade*1e3:8.2f} ms "
          f"(shading-only ~{(t_shade-t_int)*1e3:.2f} ms)")

    @jax.jit
    def one_sample(o, d):
        L = trace_rays(scene, cam, o, d, lane, 0, 0, opts)
        return L.x

    t_full = timeit(one_sample, o, d, reps=3)
    print(f"full 1-spp trace (8 bounches)      : {t_full*1e3:8.2f} ms")
    total_trav = 2 * (opts.max_depth + 1) + 1
    print(f"  = {t_full/total_trav*1e3:.2f} ms per traversal-equivalent; "
          f"intersect share {(total_trav*t_int)/t_full*100:.0f}%")


if __name__ == "__main__":
    main()
