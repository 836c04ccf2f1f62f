"""Device-time breakdown of a bench render from a jax.profiler trace.

Usage: python tools/prof_xplane.py [veach|sphere|sphere_fwdbwd|cornell]

Runs the selected workload once compiled, traces ONE repetition into a
temporary directory, then parses the Perfetto trace (*.trace.json.gz) and
prints device-lane op durations grouped by op name. The veach workload
needs the reference's Veach OBJ assets and exits with a message when they
are not mounted.
"""
import glob
import gzip
import json
import os
import re
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp
import numpy as np


def build_workload(which: str):
    from tuturenderer_tpu.options import RenderOptions

    if which == "veach":
        from tuturenderer_tpu.integrators.bdpt import render
        from tuturenderer_tpu.scene.presets import (veach_assets_present,
                                                    veach_bdpt)
        if not veach_assets_present():
            raise SystemExit("veach: skipped, the reference's Veach OBJ "
                             "assets are not mounted")
        scene, cam = veach_bdpt(width=400, height=300)
        opts = RenderOptions(spp=8, samples_per_launch=8)
        return lambda s: render(scene, cam, opts, s)
    if which == "sphere":
        from tuturenderer_tpu.integrators.path import render
        from tuturenderer_tpu.models.scenes import sphere_showcase
        import bench
        scene, cam = sphere_showcase(width=512, height=512)
        fracs = bench._probe_alive_fractions(scene, cam, RenderOptions(spp=16))
        sched = tuple(float(min(1.0, max(1.5 * f, 0.01)))
                      for f in fracs[:-1])
        opts = RenderOptions(spp=16, compaction=sched, samples_per_launch=16)
        return lambda s: render(scene, cam, opts, s)
    if which == "sphere_fwdbwd":
        from tuturenderer_tpu.grad import get_params, render_diff
        from tuturenderer_tpu.models.scenes import sphere_showcase
        scene, cam = sphere_showcase(width=256, height=256)
        opts = RenderOptions(spp=2)
        params = get_params(scene)

        @jax.jit
        def loss_grad(seed):
            return jax.grad(lambda q: jnp.mean(
                render_diff(q, scene, cam, opts, seed)))(params)
        return loss_grad
    if which == "cornell":
        from tuturenderer_tpu.integrators.path import render
        from tuturenderer_tpu.scene.presets import cornell_box
        scene, cam = cornell_box(width=1024, height=1024)
        opts = RenderOptions(spp=64)
        return lambda s: render(scene, cam, opts, s)
    raise SystemExit(f"unknown workload {which!r}")


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "cornell"
    fn = build_workload(which)

    t0 = time.time()
    jax.block_until_ready(fn(1))
    print(f"# compile+first run: {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    jax.block_until_ready(fn(1))
    print(f"# steady-state wall: {time.time() - t0:.3f}s", flush=True)

    with tempfile.TemporaryDirectory() as logdir:
        with jax.profiler.trace(logdir, create_perfetto_trace=True):
            jax.block_until_ready(fn(1))
        paths = glob.glob(f"{logdir}/**/*.trace.json.gz", recursive=True)
        if not paths:
            raise SystemExit(f"no trace under {logdir}")
        with gzip.open(sorted(paths)[-1]) as f:
            data = json.load(f)
    ev = data.get("traceEvents", [])

    # device lanes: pids whose process_name metadata names a device
    dev_pids = set()
    for e in ev:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            nm = e.get("args", {}).get("name", "")
            if re.search(r"/device:|XLA", nm, re.I):
                dev_pids.add(e["pid"])
    rows = {}
    total = 0.0
    for e in ev:
        if e.get("ph") != "X" or e.get("pid") not in dev_pids:
            continue
        name = e.get("name", "")
        dur = e.get("dur", 0) / 1e3      # us -> ms
        # strip uniquifying suffixes: fusion.123 -> fusion
        base = re.sub(r"[.\d]+$", "", name)
        rows[base] = rows.get(base, [0.0, 0])
        rows[base][0] += dur
        rows[base][1] += 1
        total += dur
    print(f"\n# device total {total:.0f} ms across {len(rows)} op groups")
    for name, (ms, cnt) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:40]:
        print(f"{ms:9.1f} ms  x{cnt:<5d} {name}")

    # top INDIVIDUAL ops (full names) — which specific fusions dominate
    indiv = {}
    for e in ev:
        if e.get("ph") != "X" or e.get("pid") not in dev_pids:
            continue
        name = e.get("name", "")
        if name.startswith("jit_"):
            continue
        src = e.get("args", {}).get("source", "")
        d_ = indiv.setdefault(name, [0.0, 0, src])
        d_[0] += e.get("dur", 0) / 1e3
        d_[1] += 1
    print("\n# top individual ops")
    for name, (ms, cnt, src) in sorted(indiv.items(),
                                       key=lambda kv: -kv[1][0])[:25]:
        src = os.path.relpath(src, REPO) if src.startswith(REPO) else src
        print(f"{ms:9.1f} ms  x{cnt:<4d} {name}  {src}")


if __name__ == "__main__":
    main()
