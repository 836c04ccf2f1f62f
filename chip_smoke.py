"""Run the renderer's main path on an NVIDIA GPU and check what comes out.

    python chip_smoke.py          # one card, six phases
    python chip_smoke.py --four   # four cards: the sharded path against card 0

One card:
  1. kernel: the dense intersection kernel against the plain XLA form
     (1,048,576 rays; Cornell's 32 triangles and a 3,840-triangle mesh),
     nearest hits and shadow rays, parity and timing;
  2. forward: Cornell 1024^2 at 64 spp through integrators.path.render;
  3. forward+backward: jax.grad of grad.render_diff at 1024^2 x 8 spp,
     one material parameter against a central finite difference;
  4. oracles: tools/golden_gate.run_fast() against the reference images;
  5. large mesh: sphere_showcase (100k triangles, BVH) at 512^2 x 16 spp;
  6. CLI: cli.main on golden/mesh_bdpt_128.txt, PPM written and read back.

Each phase prints its compile time, wall time and the device's peak bytes
in use so far. Any failed phase makes the script exit non-zero without a
result line. The script runs in one process and needs JAX's first device
to be a GPU: anywhere else it exits non-zero and prints no result. Its
last line on success is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
# compile-related events JAX reports through jax.monitoring
COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                  "/jax/core/compile/jaxpr_to_mlir_module_duration",
                  "/jax/core/compile/backend_compile_duration")
_compile_seconds = [0.0]


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    """name and power limit as nvidia-smi reports them (no JAX here)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().replace("\n", " | ")


def peak_bytes(device) -> int:
    """Peak device bytes in use so far in this process (-1: not reported)."""
    return (device.memory_stats() or {}).get("peak_bytes_in_use", -1)


def timed(fn, *args, reps: int = 3):
    """(first-call seconds incl. compile, median steady seconds, output)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, sorted(times)[len(times) // 2], out


# ------------------------------------------------------------- phase 1
def _mesh_scene_and_rays(n_rays: int, seed: int):
    """3,840-triangle uv sphere and rays from a shell around it aimed at
    points near its centre: a mix of hits and misses."""
    import jax
    import jax.numpy as jnp

    from tuturenderer_tpu.models.meshes import uv_sphere
    from tuturenderer_tpu.scene.data import SceneBuilder
    from tuturenderer_tpu.utils.vec import Vec3

    b = SceneBuilder()
    verts, normals = uv_sphere(nu=40, nv=48)
    b.add_triangles(verts, normals, None, b.add_material())
    scene = b.build()
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    o = jax.random.normal(k1, (n_rays, 3))
    o = 3.0 * o / jnp.linalg.norm(o, axis=1, keepdims=True)
    aim = 1.3 * jax.random.uniform(k2, (n_rays, 3), minval=-1.0, maxval=1.0)
    d = aim - o
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    return scene, Vec3(o[:, 0], o[:, 1], o[:, 2]), Vec3(d[:, 0], d[:, 1],
                                                        d[:, 2])


def phase_kernel():
    """Kernel vs plain XLA on the card. Both are float32 elementwise
    arithmetic with no matrix product, so TF32 cannot enter; they may
    differ in operation order, so hits may flip on knife edges. Limits,
    ten times tighter than the CPU tests' (tests/test_pallas.py) because
    the two forms agreed bit for bit on the H100: hit/miss agreement
    >= 99.9% of lanes; same primitive on >= 99.9% of hits; there t to
    rtol 1e-5 and u, v to atol 1e-5; shadow rays (occluded() on the
    card, the kernel's nearest hit and the endpoint rule) agree with the
    XLA form's decision, endpoint guard included, on >= 99.9% of lanes."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tuturenderer_tpu.camera import primary_ray
    from tuturenderer_tpu.ops import intersect as I
    from tuturenderer_tpu.ops.pallas import intersect as K
    from tuturenderer_tpu.scene.presets import cornell_box

    scene_c, cam = cornell_box(width=1024, height=1024)
    lane = jnp.arange(cam.n_pixels, dtype=jnp.int32)
    o_c, d_c, _ = primary_ray(cam, lane % cam.width, lane // cam.width)
    scene_m, o_m, d_m = _mesh_scene_and_rays(cam.n_pixels, seed=0)

    for name, scene, o, d in (("cornell_32", scene_c, o_c, d_c),
                              ("mesh_3840", scene_m, o_m, d_m)):
        kn = jax.jit(lambda o, d, s=scene: K.tri_nearest(s, o, d))
        xn = jax.jit(lambda o, d, s=scene: I.xla_nearest(s, o, d))
        _, t_k, (t, idx, bu, bv) = timed(kn, o, d)
        _, t_x, ref = timed(xn, o, d)
        t, idx, bu, bv = (np.asarray(a) for a in (t, idx, bu, bv))
        r_t, r_idx = np.asarray(ref.t), np.asarray(ref.idx)
        hit_k, hit_r = idx >= 0, np.asarray(ref.hit)
        agree = float((hit_k == hit_r).mean())
        same = hit_k & hit_r & (idx == r_idx)
        same_frac = float(same.sum() / max(hit_r.sum(), 1))
        t_rel = float((np.abs(t - r_t) / np.abs(r_t))[same].max(initial=0))
        u_abs = float(np.abs(bu - np.asarray(ref.bu))[same].max(initial=0))
        v_abs = float(np.abs(bv - np.asarray(ref.bv))[same].max(initial=0))

        # shadow distances: at the hit (endpoint guard -> unblocked),
        # before it, beyond it; misses get a far endpoint
        t_hit = jnp.where(ref.hit, ref.t, 1e4)
        sel = jnp.arange(t_hit.shape[0]) % 4
        dist = jnp.where(sel == 0, t_hit, jnp.where(
            sel == 1, 0.5 * t_hit, jnp.where(sel == 2, 2.0 * t_hit,
                                             t_hit + 3e-4)))
        check(I._use_kernel(), "occluded() would not take the kernel")
        ka = jax.jit(lambda o, d, r, s=scene: I.occluded(s, o, d, r))

        def xla_occluded(o, d, r, s=scene):
            c = I.xla_nearest(s, o, d)
            return c.hit & (c.t < r) & (jnp.abs(c.t - r) >= I.PARALLEL_EPS)

        xa = jax.jit(xla_occluded)
        _, a_k, blk_k = timed(ka, o, d, dist)
        _, a_x, blk_x = timed(xa, o, d, dist)
        any_agree = float((np.asarray(blk_k) == np.asarray(blk_x)).mean())
        n = o.x.shape[0]
        say(f"  {name}: {n} rays, {scene.n_tris} tris, hits {hit_r.mean():.4f}"
            f" | hit agree {agree:.6f} same-prim {same_frac:.6f} "
            f"t rel {t_rel:.2e} u {u_abs:.2e} v {v_abs:.2e} "
            f"| shadow agree {any_agree:.6f} blocked "
            f"{np.asarray(blk_x).mean():.4f}")
        say(f"  {name}: nearest kernel {t_k * 1e3:.3f} ms "
            f"({n / t_k / 1e9:.3f} Grays/s), xla {t_x * 1e3:.3f} ms "
            f"({n / t_x / 1e9:.3f} Grays/s) | shadow kernel "
            f"{a_k * 1e3:.3f} ms, xla {a_x * 1e3:.3f} ms")
        check(agree >= 0.999, f"{name}: hit agreement {agree}")
        check(same_frac >= 0.999, f"{name}: same primitive on {same_frac}")
        check(t_rel <= 1e-5, f"{name}: t rel err {t_rel}")
        check(u_abs <= 1e-5 and v_abs <= 1e-5, f"{name}: u/v {u_abs} {v_abs}")
        check(any_agree >= 0.999, f"{name}: shadow agreement {any_agree}")


# ------------------------------------------------------------- phase 2
def phase_forward():
    import numpy as np

    from tuturenderer_tpu.integrators.path import render
    from tuturenderer_tpu.options import RenderOptions
    from tuturenderer_tpu.scene.presets import cornell_box

    scene, cam = cornell_box(width=1024, height=1024)
    opts = RenderOptions(spp=64)
    first, steady, img = timed(lambda s: render(scene, cam, opts, s), 1,
                               reps=2)
    img = np.asarray(img)
    bad = int((~np.isfinite(img)).sum())
    say(f"  cornell 1024^2 x 64 spp: first call {first:.3f} s, steady "
        f"{steady:.3f} s, mean {img.mean():.6f}, non-finite {bad}")
    check(img.shape == (cam.height, cam.width, 3), f"shape {img.shape}")
    check(bad == 0, f"{bad} non-finite pixels")
    check(img.mean() > 0.05, f"image mean {img.mean()}")


# ------------------------------------------------------------- phase 3
def phase_forward_backward():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tuturenderer_tpu.grad import get_params, render_diff
    from tuturenderer_tpu.options import RenderOptions
    from tuturenderer_tpu.scene.presets import cornell_box

    scene, cam = cornell_box(width=1024, height=1024)
    opts = RenderOptions(spp=8)
    params = get_params(scene)

    @jax.jit
    def loss(p, seed):
        return jnp.mean(render_diff(p, scene, cam, opts, seed))

    grad_fn = jax.jit(jax.grad(loss))
    first, steady, g = timed(grad_fn, params, 1, reps=2)
    # central difference on the white material's red albedo
    eps = 1e-2
    bump = jax.tree.map(jnp.zeros_like, params)
    bump = bump._replace(diffuse=bump.diffuse._replace(
        x=bump.diffuse.x.at[0].set(1.0)))
    lp = float(loss(jax.tree.map(lambda a, b: a + eps * b, params, bump), 1))
    lm = float(loss(jax.tree.map(lambda a, b: a - eps * b, params, bump), 1))
    fd = (lp - lm) / (2 * eps)
    ad = float(g.diffuse.x[0])
    rel = abs(fd - ad) / max(abs(fd), 1e-12)
    finite = all(bool(np.isfinite(np.asarray(a)).all())
                 for a in jax.tree.leaves(g))
    say(f"  cornell 1024^2 x 8 spp fwd+bwd: first call {first:.3f} s, "
        f"steady {steady:.3f} s | d/d albedo_r[white]: ad {ad:.6g} "
        f"fd {fd:.6g} rel err {rel:.4f}")
    check(finite, "non-finite gradient")
    check(rel < 0.05, f"finite-difference mismatch {rel}")


# ------------------------------------------------------------- phase 4
ORACLES = ("cornell_pt", "cornell_lt", "cornell_nee", "naive_pt",
           "mesh_bdpt", "mft", "tex", "cornell_flagship_512spp",
           "cornell_flagship_1024px", "sharded_bvh")


def phase_oracles():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from golden_gate import run_fast

    res = run_fast()
    for k, v in res.items():
        say(f"  {k}: {v}")
    for k in ORACLES:
        check(res.get(k, "").startswith("pass"), f"oracle {k}: {res.get(k)}")


# ------------------------------------------------------------- phase 5
def phase_large_mesh():
    import jax
    import numpy as np

    from tuturenderer_tpu.integrators.path import render
    from tuturenderer_tpu.models.scenes import sphere_showcase
    from tuturenderer_tpu.options import RenderOptions

    scene, cam = sphere_showcase(width=512, height=512)
    check(scene.bvh is not None, "sphere_showcase carries no BVH")
    opts = RenderOptions(spp=16, samples_per_launch=16)
    first, steady, img = timed(lambda s: render(scene, cam, opts, s), 2,
                               reps=1)
    img = np.asarray(img)
    peak = peak_bytes(jax.devices()[0])
    say(f"  sphere_showcase {scene.n_tris} tris 512^2 x 16 spp "
        f"(4,194,304 lanes): first call {first:.3f} s, steady "
        f"{steady:.3f} s, mean {img.mean():.6f}, peak bytes {peak}")
    check(np.isfinite(img).all(), "non-finite pixels")
    check(img.mean() > 0.0, "black image")


# ------------------------------------------------------------- phase 6
def phase_cli():
    import numpy as np

    from tuturenderer_tpu import cli
    from tuturenderer_tpu.io.ppm import read_ppm

    config = os.path.join(REPO, "golden", "mesh_bdpt_128.txt")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "mesh_bdpt_128.ppm")
        cli.main([config, "--spp", "4", "-o", out])
        img = read_ppm(out)
    say(f"  cli {os.path.basename(config)} -> {img.shape}, mean "
        f"{img.mean():.6f}")
    check(img.shape == (128, 128, 3), f"shape {img.shape}")
    check(np.isfinite(img).all() and img.max() > 0, "empty or non-finite")


# ------------------------------------------------------------- --four
def phase_four_cards():
    """Sharded PT, BDPT, light tracing and the training step on a
    (tile 2 x sample 2) mesh, each against the same job on card 0, at
    rtol 2e-4 / atol 2e-5; every output must span the four cards."""
    import jax
    import numpy as np

    from tuturenderer_tpu.grad import get_params
    from tuturenderer_tpu.integrators.bdpt import render as render_bdpt
    from tuturenderer_tpu.integrators.light import render as render_light
    from tuturenderer_tpu.integrators.path import render
    from tuturenderer_tpu.options import RenderOptions
    from tuturenderer_tpu.parallel.sharding import (make_mesh,
                                                    render_bdpt_sharded,
                                                    render_light_sharded,
                                                    render_sharded,
                                                    train_step_sharded)
    from tuturenderer_tpu.scene.presets import cornell_box, simple_box

    devices = jax.devices()
    check(len(devices) >= 4, f"needs 4 devices, found {len(devices)}")
    mesh = make_mesh(4)
    check(dict(mesh.shape) == {"tile": 2, "sample": 2}, f"mesh {mesh.shape}")

    def compare(name, sharded, single):
        spans = len(sharded.sharding.device_set)
        a, b = np.asarray(sharded), np.asarray(single)
        err = float(np.abs(a - b).max())
        say(f"  {name}: spans {spans} devices, max abs diff {err:.3e}, "
            f"mean {b.mean():.6f}")
        check(spans == 4, f"{name}: output on {spans} devices")
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5,
                                   err_msg=name)

    scene, cam = cornell_box(width=512, height=512)
    opts = RenderOptions(spp=16)
    t0 = time.perf_counter()
    sh = jax.block_until_ready(render_sharded(scene, cam, opts, mesh, 3))
    say(f"  render_sharded cornell 512^2 x 16 spp: "
        f"{time.perf_counter() - t0:.3f} s incl. compile")
    compare("path", sh, render(scene, cam, opts, 3))

    box, bcam = simple_box(256, 256)
    bopts = RenderOptions(spp=4, bdpt_max_path_length=4)
    compare("bdpt", render_bdpt_sharded(box, bcam, bopts, mesh, 4),
            render_bdpt(box, bcam, bopts, 4))
    lopts = RenderOptions(spp=8, max_depth=3)
    compare("light", render_light_sharded(box, bcam, lopts, mesh, 5),
            render_light(box, bcam, lopts, 5))

    tbox, tcam = simple_box(64, 64)
    topts = RenderOptions(spp=4, max_depth=3)
    params = get_params(tbox)
    target = np.zeros((tcam.height, tcam.width, 3), np.float32)
    one = make_mesh(1, devices=devices[:1])
    p4, l4 = train_step_sharded(params, target, tbox, tcam, topts, mesh,
                                lr=1.0)
    p1, l1 = train_step_sharded(params, target, tbox, tcam, topts, one,
                                lr=1.0)
    say(f"  train_step_sharded loss: 4 cards {float(l4):.6g}, card 0 "
        f"{float(l1):.6g}")
    np.testing.assert_allclose(float(l4), float(l1), rtol=2e-4, atol=2e-5)
    grads = lambda new: jax.tree.map(lambda p, q: p - q, params, new)
    for a, b in zip(jax.tree.leaves(grads(p4)), jax.tree.leaves(grads(p1))):
        check(len(a.sharding.device_set) == 4, "gradient not on 4 devices")
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4,
                                   atol=2e-5, err_msg="train step gradient")


PHASES = (("kernel", phase_kernel), ("forward", phase_forward),
          ("forward_backward", phase_forward_backward),
          ("oracles", phase_oracles), ("large_mesh", phase_large_mesh),
          ("cli", phase_cli))


def run_phase(name, fn, device) -> bool:
    say(f"phase {name}:")
    _compile_seconds[0] = 0.0
    t0 = time.perf_counter()
    ok = True
    try:
        fn()
    except Exception:  # noqa: BLE001 — reported, and the run fails below
        traceback.print_exc()
        ok = False
    wall = time.perf_counter() - t0
    peak = peak_bytes(device)
    say(f"phase {name}: {'ok' if ok else 'FAILED'} | compile "
        f"{_compile_seconds[0]:.3f} s, wall {wall:.3f} s, peak bytes in "
        f"use {peak}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path and its "
                         "card-0 comparison")
    args = ap.parse_args(argv)

    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, but JAX's first device is "
              f"on platform {device.platform!r} ({device.device_kind})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import tuturenderer_tpu  # noqa: F401 — sets up the compile cache

    def on_event(event, duration, **kw):
        if event in COMPILE_EVENTS:
            _compile_seconds[0] += duration

    jax.monitoring.register_event_duration_secs_listener(on_event)
    say(f"card: {card_line()}")
    say(f"jax {jax.__version__}: {device.device_kind} x {len(jax.devices())} "
        f"(platform {device.platform})")
    phases = (("four_cards", phase_four_cards),) if args.four else PHASES
    failed = [name for name, fn in phases
              if not run_phase(name, fn, device)]
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    say(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
