"""Benchmark suite on one device: Cornell fwd + fwd/bwd and a
100k-triangle large scene.

Prints ONE JSON line whose headline metric is Cornell-box path-tracing
forward throughput (the reference CPU renders ~1-2 M rays/s on 20
threads, BASELINE.md); the other measurements ride in ``extras``:

- cornell_fwdbwd_rays_per_sec: forward+backward (jax.grad through the
  differentiable renderer, grad.py) at the same resolution — rays counted
  are the FORWARD rays of the differentiated render, so the number is
  directly comparable to the forward line.
- sphere_100k_rays_per_sec: models/scenes.py sphere_showcase (~100k
  triangles) through the BVH intersector (ops/bvh.py).
- sphere_fwdbwd_rays_per_sec: its forward+backward, with a
  finite-difference check.

Ray accounting is per-scene HONEST: live-lane fractions per bounce are
measured on-device with trace_rays(collect_alive=True) (2 rays per live
bounce: scene intersection + NEE shadow; +1 epilogue intersection for
pending emissive-hit lanes), not assumed.

The device (platform, kind, count, and the card's name and power limit)
is printed before the result. A cell that fails makes the run exit
non-zero.
"""
from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def _probe_alive_fractions(scene, cam, opts, seed=0, max_lanes=1 << 18):
    """Measured live-lane fraction entering each bounce + final pending
    fraction, subsampling the frame to <= max_lanes lanes."""
    from tuturenderer_tpu.camera import primary_ray
    from tuturenderer_tpu.integrators.path import trace_rays

    n = cam.n_pixels
    step = max(1, n // max_lanes)
    lane = jnp.arange(0, n, step, dtype=jnp.int32)
    px = lane % cam.width
    py = lane // cam.width
    o, d, _ = primary_ray(cam, px, py)

    @jax.jit
    def probe(o, d):
        _, counts = trace_rays(scene, cam, o, d, lane, 0, seed, opts,
                               collect_alive=True)
        return counts

    counts = np.asarray(jax.block_until_ready(probe(o, d)))
    return counts / float(lane.shape[0])


def _rays_per_path(fracs):
    """2 rays (intersect + NEE shadow) per live bounce, 1 epilogue
    intersection for the final pending fraction."""
    return 2.0 * float(fracs[:-1].sum()) + float(fracs[-1])


def _timed(fn, *args, reps=1):
    out = jax.block_until_ready(fn(*args))        # compile
    t0 = time.time()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return (time.time() - t0) / reps, out


def bench_cornell_fwd(width=1024, height=1024, spp=64):
    from tuturenderer_tpu.integrators.path import render
    from tuturenderer_tpu.options import RenderOptions
    from tuturenderer_tpu.scene.presets import cornell_box

    scene, cam = cornell_box(width=width, height=height)
    opts = RenderOptions(spp=spp)
    fracs = _probe_alive_fractions(scene, cam, opts)
    dt, img = _timed(lambda s: render(scene, cam, opts, s), 1)
    rays = width * height * spp * _rays_per_path(fracs)
    arr = np.asarray(img)
    print(f"# cornell fwd wall={dt:.3f}s spp={spp} mean={arr.mean():.4f} "
          f"nan={np.isnan(arr).sum()} fracs={np.round(fracs, 3).tolist()}",
          file=sys.stderr)
    return rays / dt, fracs


def bench_cornell_fwdbwd(fracs, width=1024, height=1024, spp=8):
    from tuturenderer_tpu.grad import get_params, render_diff
    from tuturenderer_tpu.options import RenderOptions
    from tuturenderer_tpu.scene.presets import cornell_box

    scene, cam = cornell_box(width=width, height=height)
    opts = RenderOptions(spp=spp)
    params = get_params(scene)

    @jax.jit
    def loss_grad(p, seed):
        return jax.grad(
            lambda q: jnp.mean(render_diff(q, scene, cam, opts, seed)))(p)

    dt, g = _timed(lambda s: loss_grad(params, s), 1)
    leaf0 = np.asarray(jax.tree.flatten(g)[0][0])
    print(f"# cornell fwd+bwd wall={dt:.3f}s spp={spp} "
          f"grad[0]={leaf0.tolist()}", file=sys.stderr)
    rays = width * height * spp * _rays_per_path(fracs)
    return rays / dt


def bench_sphere_100k(width=512, height=512, spp=16):
    from tuturenderer_tpu.integrators.path import render
    from tuturenderer_tpu.models.scenes import sphere_showcase
    from tuturenderer_tpu.options import RenderOptions

    scene, cam = sphere_showcase(width=width, height=height)
    opts = RenderOptions(spp=spp)
    fracs = _probe_alive_fractions(scene, cam, opts)
    # wavefront compaction schedule auto-derived from the measured live
    # fractions. 1.5x safety margin: overflow is handled by the UNBIASED
    # lane roulette and surfaced via render(stats=True)
    sched = tuple(float(min(1.0, max(1.5 * f, 0.01))) for f in fracs[:-1])
    # all spp share one wavefront
    copts = RenderOptions(spp=spp, compaction=sched, samples_per_launch=spp)
    dt, img = _timed(lambda s: render(scene, cam, copts, s), 1)
    rays = width * height * spp * _rays_per_path(fracs)
    arr = np.asarray(img)
    print(f"# sphere_100k ({scene.n_tris} tris) wall={dt:.3f}s spp={spp} "
          f"mean={arr.mean():.4f} fracs={np.round(fracs, 3).tolist()} "
          f"compaction={np.round(sched, 3).tolist()}", file=sys.stderr)
    return rays / dt


def bench_sphere_fwdbwd(width=256, height=256, spp=8):
    """Large-scene differentiability evidence: forward+backward through
    the BVH intersector (detached-sampling autodiff never differentiates
    through traversal), plus a finite-difference check of one material
    parameter on the same scene. The batched differentiable renderer
    (samples_per_launch + compaction schedule, grad.py) traces the
    streams at 0.5M-lane width."""
    from tuturenderer_tpu.grad import get_params, render_diff
    from tuturenderer_tpu.models.scenes import sphere_showcase
    from tuturenderer_tpu.options import RenderOptions

    scene, cam = sphere_showcase(width=width, height=height)
    fracs = _probe_alive_fractions(scene, cam, RenderOptions(spp=spp))
    sched = tuple(float(min(1.0, max(1.5 * f, 0.01))) for f in fracs[:-1])
    opts = RenderOptions(spp=spp, samples_per_launch=spp, compaction=sched)
    params = get_params(scene)

    @jax.jit
    def loss(p, seed):
        return jnp.mean(render_diff(p, scene, cam, opts, seed))

    grad_fn = jax.jit(jax.grad(loss))
    dt, g = _timed(lambda s: grad_fn(params, s), 1)
    rays = width * height * spp * _rays_per_path(fracs)

    # FD check: sphere material's diffuse red channel (mat 0)
    eps = 1e-2
    bump = jax.tree.map(jnp.zeros_like, params)
    bump = bump._replace(diffuse=bump.diffuse._replace(
        x=bump.diffuse.x.at[0].set(1.0)))
    lp = float(loss(jax.tree.map(lambda a, b: a + eps * b, params, bump), 1))
    lm = float(loss(jax.tree.map(lambda a, b: a - eps * b, params, bump), 1))
    fd = (lp - lm) / (2 * eps)
    ad = float(g.diffuse.x[0])
    rel = abs(fd - ad) / max(abs(fd), 1e-12)
    print(f"# sphere fwd+bwd wall={dt:.3f}s spp={spp} grad_ad={ad:.6g} "
          f"grad_fd={fd:.6g} rel_err={rel:.3f}", file=sys.stderr)
    assert rel < 0.05, f"large-scene FD mismatch: ad={ad} fd={fd}"
    return rays / dt


def _device_line():
    import subprocess
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip() or "nvidia-smi: no card"
    return (f"# device: platform={dev.platform} kind={dev.device_kind} "
            f"count={len(jax.devices())} card={card}")


def main():
    print(_device_line(), file=sys.stderr, flush=True)
    fwd_rays_s, fracs = bench_cornell_fwd()
    extras = {}
    failed = []
    cells = (("cornell_fwdbwd_rays_per_sec",
              lambda: round(bench_cornell_fwdbwd(fracs), 0)),
             ("sphere_100k_rays_per_sec",
              lambda: round(bench_sphere_100k(), 0)),
             ("sphere_fwdbwd_rays_per_sec",
              lambda: round(bench_sphere_fwdbwd(), 0)))
    for name, cell in cells:
        try:
            extras[name] = cell()
        except Exception as e:          # reported, and the run fails below
            print(f"# {name} FAILED: {e!r}", file=sys.stderr)
            failed.append(name)
    # oracle status line: the golden comparisons run on-device so the
    # artifacts carry pass/fail, not just perf numbers
    sys.path.insert(0, "tools")
    from golden_gate import run_fast
    goldens = run_fast()
    for k, v in goldens.items():
        print(f"# golden {k}: {v}", file=sys.stderr)
    extras["goldens"] = {k: v.split()[0] for k, v in goldens.items()}
    failed += [k for k, v in goldens.items()
               if not v.startswith(("pass", "skip"))]

    baseline_rays_per_s = 1.5e6   # midpoint of BASELINE.md 1-2 M rays/s
    print(json.dumps({
        "metric": "cornell_1024_rays_per_sec",
        "value": round(fwd_rays_s, 0),
        "unit": "rays/s/chip",
        "vs_baseline": round(fwd_rays_s / baseline_rays_per_s, 2),
        "extras": extras,
    }))
    if failed:
        print(f"# failed: {', '.join(failed)}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
