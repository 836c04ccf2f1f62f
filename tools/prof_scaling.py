"""Communication-volume evidence for the multi-device design (a count of
bytes from compiled programs on virtual CPU devices, not a device timing).

Scaling efficiency on real hardware is compute_time / (compute_time +
exposed collective time). What CAN be measured honestly here is the
communication VOLUME the compiled programs actually emit: this tool
compiles render_sharded / train_step_sharded over 1/2/4/8 fake CPU
devices (weak scaling: fixed pixels per device) and reports every
collective in the optimized HLO with its byte size, plus the per-device
film bytes for comparison.

The design claim this backs: per-step collectives are O(pixels) — one
film psum over the sample axis (+ one gradient psum of the material
table for training) — independent of spp, depth and triangle count, so
the communicated bytes per unit of compute FALL as spp/depth grow.

Usage: python tools/prof_scaling.py   (re-execs itself with fake devices)
"""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main():
    import jax
    if len(jax.devices()) < 8:
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            " --xla_force_host_platform_device_count=8").strip()
        r = subprocess.run([sys.executable, os.path.abspath(__file__)],
                           env=env)
        sys.exit(r.returncode)

    import numpy as np

    from tuturenderer_tpu.grad import get_params
    from tuturenderer_tpu.options import RenderOptions
    from tuturenderer_tpu.parallel.sharding import (make_mesh,
                                                    render_sharded,
                                                    train_step_sharded)
    from tuturenderer_tpu.scene.presets import simple_box

    import jax

    TILE = 32            # pixels per device edge (weak scaling)

    def collectives(hlo_text):
        out = {}
        for m in re.finditer(
                r"= ([a-z0-9]+)\[([\d,]*)\][^=]*? (all-reduce|all-gather|"
                r"all-to-all|reduce-scatter|collective-permute)\(",
                hlo_text):
            dtype, dims, kind = m.group(1), m.group(2), m.group(3)
            nums = [int(x) for x in dims.split(",") if x]
            elems = int(np.prod(nums)) if nums else 1
            bytes_ = elems * (2 if dtype in ("bf16", "f16") else 4)
            shape = f"{dtype}[{dims}]"
            out.setdefault(kind, [0, 0])
            out[kind][0] += bytes_
            out[kind][1] += 1
        return out

    for n in (1, 2, 4, 8):
        mesh = make_mesh(n)
        w = TILE * mesh.shape["tile"] * (2 if "host" in mesh.axis_names
                                         else 1)
        scene, cam = simple_box(w, TILE)
        opts = RenderOptions(spp=2 * mesh.shape["sample"], max_depth=3)
        lowered = jax.jit(
            lambda: render_sharded(scene, cam, opts, mesh)).lower()
        hlo = lowered.compile().as_text()
        cols = collectives(hlo)
        film_bytes = TILE * TILE * 3 * 4
        print(f"render  n={n} mesh={dict(mesh.shape)} "
              f"film/device={film_bytes}B collectives="
              f"{ {k: f'{v[0]}B x{v[1]}' for k, v in cols.items()} }",
              flush=True)

        params = get_params(scene)
        tgt = np.zeros((TILE, w, 3), np.float32)
        lowered = jax.jit(
            lambda p: train_step_sharded(p, tgt, scene, cam, opts, mesh)
        ).lower(params)
        hlo = lowered.compile().as_text()
        cols = collectives(hlo)
        pbytes = sum(np.asarray(x).nbytes for x in jax.tree.leaves(params))
        print(f"train   n={n} params={pbytes}B collectives="
              f"{ {k: f'{v[0]}B x{v[1]}' for k, v in cols.items()} }",
              flush=True)


if __name__ == "__main__":
    main()
