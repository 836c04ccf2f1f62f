"""Ablation timing of the sphere_100k bench render: how much of the wall
is nearest-intersect, how much NEE occlusion, how much everything else
(sampling, shading, compaction, film)?

Monkeypatches the integrator's intersect_core/occluded bindings with
cheap stand-ins and re-times the same jitted render. The stand-ins keep
shapes and (roughly) live-lane statistics so the rest of the pipeline
does comparable work.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import tuturenderer_tpu.integrators.path as pathmod
from tuturenderer_tpu.models.scenes import sphere_showcase
from tuturenderer_tpu.options import RenderOptions
from tuturenderer_tpu.ops.intersect import HitCore, intersect_core, occluded

scene, cam = sphere_showcase(width=512, height=512)
SPP = int(os.environ.get("PA_SPP", "16"))
# compaction schedule from the scene's live-lane fractions per bounce
fracs = [1.0, 0.606, 0.213, 0.068, 0.033, 0.019, 0.005, 0.002]
sched = tuple(float(min(1.0, max(2.0 * f, 0.01))) for f in fracs)
opts = RenderOptions(spp=SPP, compaction=sched, samples_per_launch=SPP)


def timed(name, reps=1):
    from tuturenderer_tpu.integrators.path import render
    render.clear_cache()
    t0 = time.time()
    img = jax.block_until_ready(render(scene, cam, opts, 1))
    compile_t = time.time() - t0
    t0 = time.time()
    for _ in range(reps):
        img = jax.block_until_ready(render(scene, cam, opts, 1))
    dt = (time.time() - t0) / reps
    print(f"{name}: {dt*1000:.0f} ms (compile+1st {compile_t:.1f}s) "
          f"mean={float(jnp.mean(img)):.4f}")
    return dt


real_ic, real_oc = pathmod.intersect_core, pathmod.occluded

t_full = timed("full render")

# --- no NEE occlusion (shadow rays free, never blocked)
pathmod.occluded = lambda sc, o, d, dist, mask=None, **kw: jnp.zeros(
    o.x.shape, bool)
t_noshadow = timed("no occlusion")

# --- no nearest intersect either: fake hits for ~60% of lanes (keeps the
# live-lane decay roughly on the bench profile so shading/compaction do
# comparable work)
def fake_core(sc, o, d, mask=None, **kw):
    n = o.x.shape[0]
    h = jnp.abs(d.x * 12345.678 + d.y * 777.7) % 1.0
    hit = h < 0.62
    return HitCore(t=jnp.where(hit, 1.0, 3.4e38),
                   kind=jnp.zeros((n,), jnp.int32),
                   idx=jnp.where(hit, 0, -1),
                   bu=jnp.full((n,), 0.3), bv=jnp.full((n,), 0.3))
pathmod.intersect_core = fake_core
t_skeleton = timed("no intersect, no occlusion (skeleton, ~60% fake hits)")

# --- intersect real, occlusion off already measured; restore
pathmod.intersect_core, pathmod.occluded = real_ic, real_oc

print(f"\nsplit of {t_full*1000:.0f} ms:")
print(f"  NEE occlusion : {(t_full - t_noshadow)*1000:7.0f} ms")
print(f"  nearest isect : {(t_noshadow - t_skeleton)*1000:7.0f} ms "
      f"(upper bound; all-miss skeleton kills bounces)")
print(f"  skeleton      : {t_skeleton*1000:7.0f} ms")
