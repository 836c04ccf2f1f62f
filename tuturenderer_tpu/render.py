"""Renderer orchestration: scene + camera + options -> image.

The analogue of Renderer (Renderer.hpp:32-72): selects the integrator
(path / light / naivept / bdpt, matching integrateType 0-3), runs it, and
hands the linear framebuffer to post-processing / I/O.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import jax
import numpy as np

from .camera import Camera
from .options import RenderOptions
from .scene.data import SceneData


def render_image(scene: SceneData, cam: Camera, opts: RenderOptions,
                 integrator: str = "path", seed: int = 0,
                 postprocess: bool = False) -> np.ndarray:
    """-> linear float32 [H, W, 3]."""
    if integrator == "path":
        from .integrators.path import render as run
    elif integrator == "light":
        from .integrators.light import render as run
    elif integrator == "naivept":
        from .integrators.naive import render as run
    elif integrator == "bdpt":
        from .integrators.bdpt import render as run
    else:
        raise ValueError(f"unknown integrator {integrator!r}")
    if integrator == "path" and opts.compaction:
        # overflow observability: surface the unbiased-roulette drop count
        img, st = jax.block_until_ready(
            run(scene, cam, opts, seed, stats=True))
        over = int(st["compaction_overflow"])
        if over > 0:
            import sys
            print(f"tuturenderer_tpu: compaction overflow engaged — "
                  f"{over} live lanes dropped+reweighted (unbiased); "
                  f"widen opts.compaction for lower variance",
                  file=sys.stderr)
        img = np.asarray(img)
    else:
        img = np.asarray(jax.block_until_ready(run(scene, cam, opts, seed)))
    if postprocess:
        from .post import bloom_and_tonemap
        img = np.asarray(bloom_and_tonemap(img))
    return img


def render_progressive(scene: SceneData, cam: Camera, opts: RenderOptions,
                       integrator: str = "path", seed: int = 0,
                       chunk_spp: int = 8,
                       checkpoint_path: Optional[str] = None,
                       resume: bool = True,
                       progress: bool = True) -> np.ndarray:
    """Render in spp chunks with optional film checkpointing.

    The reference renders all-or-nothing (a crash loses everything; its
    only artifact is the final PPM, PPMGenerator.hpp:140-160). Sample-
    batched accumulation makes periodic film checkpoints trivial: the
    running (film_sum, spp_done) pair is saved to ``checkpoint_path``
    after every chunk and reloaded on restart — elastic recovery the
    reference cannot do. Counter-based RNG keys samples by global index
    (every integrator's render() takes a ``sample_base``), so a resumed
    render is bit-identical to an uninterrupted one. Works for all four
    integrators; light tracing checkpoints its raw accumulators (splat
    sums + the direct-splat running max) so the max-combined direct pane
    also resumes exactly.
    """
    import dataclasses as _dc

    if integrator == "path":
        from .integrators.path import render as run
    elif integrator == "naivept":
        from .integrators.naive import render as run
    elif integrator == "bdpt":
        from .integrators.bdpt import render as run
    elif integrator == "light":
        from .integrators.light import render as run
    else:
        raise ValueError(f"unknown integrator {integrator!r}")
    is_light = integrator == "light"

    film = np.zeros((cam.height, cam.width, 3), np.float64)
    direct = np.zeros((cam.height, cam.width, 3), np.float64)
    dmask = np.zeros((cam.height, cam.width), bool)
    done = 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path)
        if ck["film"].shape == film.shape and int(ck["seed"]) == seed:
            film = ck["film"].astype(np.float64)
            done = int(ck["spp_done"])
            if is_light and "direct" in ck:
                direct = ck["direct"].astype(np.float64)
                dmask = ck["dmask"]
            if progress:
                print(f"resumed at {done}/{opts.spp} spp")

    while done < opts.spp:
        n = min(chunk_spp, opts.spp - done)
        chunk_opts = _dc.replace(opts, spp=n)
        if is_light:
            sp, dm, msk = jax.block_until_ready(
                run(scene, cam, chunk_opts, seed, done, return_parts=True))
            film += np.asarray(sp)          # raw splat sums
            direct = np.maximum(direct, np.asarray(dm))
            dmask |= np.asarray(msk)
        else:
            img = np.asarray(jax.block_until_ready(
                run(scene, cam, chunk_opts, seed, done)))
            film += img * n
        done += n
        if checkpoint_path:
            np.savez(checkpoint_path, film=film, spp_done=done, seed=seed,
                     direct=direct, dmask=dmask)
        if progress:
            bar = int(60 * done / opts.spp)
            print("=" * bar + ">" + " " * (60 - bar) +
                  f" {int(100 * done / opts.spp)} %", flush=True)

    done = max(done, 1)
    if is_light:
        from .integrators.light import compose_light_film
        import jax.numpy as jnp
        out = compose_light_film(scene, cam,
                                 jnp.asarray(film, jnp.float32),
                                 jnp.asarray(direct, jnp.float32),
                                 jnp.asarray(dmask), done)
        return np.asarray(out)
    return (film / done).astype(np.float32)


def estimator_grid(scene: SceneData, cam: Camera, opts: RenderOptions,
                   seed: int = 0) -> np.ndarray:
    """2x2 estimator A/B grid: BSDF-only | light-only // NEE | NEE+MIS.

    The reference publishes this comparison as a README image grid
    (README.md:103-109: BSDF-sample-only vs light-sample-only vs NEE vs
    NEE+MIS on the same scene) rendered from four compile-time variants;
    here it is one call over the four compiled estimators.
    -> [2H, 2W, 3] linear float32.
    """
    import dataclasses as _dc

    bsdf_only = render_image(scene, cam, opts, "naivept", seed)
    light_only = render_image(scene, cam, opts, "light", seed)
    nee = render_image(scene, cam, _dc.replace(opts, mis=False), "path", seed)
    mis = render_image(scene, cam, _dc.replace(opts, mis=True), "path", seed)
    top = np.concatenate([bsdf_only, light_only], axis=1)
    bottom = np.concatenate([nee, mis], axis=1)
    return np.concatenate([top, bottom], axis=0)


def render_config(config_path: str, opts: Optional[RenderOptions] = None,
                  seed: int = 0, verbose: bool = True) -> np.ndarray:
    """Full pipeline from a reference-format config file (the equivalent of
    ``./PathTracer config.txt``, README.md:59-62)."""
    from .scene.config import parse_config
    t0 = time.time()
    pc = parse_config(config_path)
    scene = pc.builder.build()
    cam = pc.camera()
    if verbose:
        print(f"scene build: {time.time() - t0:.2f}s  "
              f"(tris={scene.n_tris} spheres={scene.n_spheres} "
              f"lights={scene.n_lights})")
    opts = opts or RenderOptions()
    t0 = time.time()
    img = render_image(scene, cam, opts, integrator=pc.integrator, seed=seed)
    if verbose:
        print(f"render ({pc.integrator}, {opts.spp} spp): "
              f"{time.time() - t0:.2f}s")
    return img
