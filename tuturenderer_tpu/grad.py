"""Differentiable rendering: gradients of the image w.r.t. material
parameters (albedo / roughness / metallic / emission).

A capability the reference does not have (it is a pure forward renderer);
required by the project north star. The estimator in integrators/path.py
supports detached-sampling autodiff (opts.differentiable=True): sampled
directions, pdfs, Russian-roulette probabilities and MIS weights are
treated as piecewise-constant, so reverse-mode AD through the bounce scan
yields the standard detached path-replay gradient — exact for parameters
the sampler does not importance-sample (albedo, emission; also roughness/
metallic under the NEE-only estimator and metallic under full MIS, all
FD-validated in tests/test_grad.py) and a low-bias estimate for roughness
under full MIS (the GGX half-vector sampler consumes roughness; measured
bias below MC noise at 16 seeds x 16 spp — see tests/test_grad.py).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .camera import Camera
from .integrators.path import render_sample
from .options import RenderOptions
from .scene.data import SceneData
from .utils.vec import Vec3


class MaterialParams(NamedTuple):
    """The differentiable subset of the material table."""
    diffuse: Vec3
    emission: Vec3
    roughness: jnp.ndarray
    metallic: jnp.ndarray


def get_params(scene: SceneData) -> MaterialParams:
    m = scene.materials
    return MaterialParams(diffuse=m.diffuse, emission=m.emission,
                          roughness=m.roughness, metallic=m.metallic)


def put_params(scene: SceneData, p: MaterialParams) -> SceneData:
    m = dataclasses.replace(scene.materials, diffuse=p.diffuse,
                            emission=p.emission, roughness=p.roughness,
                            metallic=p.metallic)
    scene = dataclasses.replace(scene, materials=m)
    # refresh the DENORMALIZED light-emission table (built by
    # SceneBuilder for fast NEE selects): without this, an emission
    # update changes direct-hit radiance but NOT the NEE / light-tracing
    # / BDPT light-subpath contributions — an inconsistent forward
    # render for inverse-rendering loops, and a silently-dropped share
    # of the emission gradient (round-5 find)
    if scene.n_lights:
        from .scene.data import TRIANGLE
        li = scene.light_idx
        if scene.n_tris:
            tm = scene.tmat[jnp.clip(li, 0, scene.n_tris - 1)]
        else:
            tm = jnp.zeros_like(li)
        if scene.n_spheres:
            sm = scene.smat[jnp.clip(li, 0, scene.n_spheres - 1)]
        else:
            sm = jnp.zeros_like(li)
        mat = jnp.where(scene.light_kind == TRIANGLE, tm, sm)
        em = m.emission
        scene = dataclasses.replace(scene, light_emission=Vec3(
            em.x[mat], em.y[mat], em.z[mat]))
    return scene


def render_diff(params: MaterialParams, scene: SceneData, cam: Camera,
                opts: RenderOptions, seed=0):
    """Differentiable full-frame render -> [H, W, 3].

    Uses lax.scan over sample batches with rematerialization so the
    backward pass replays each batch's paths instead of storing them (the
    path-replay backward pass: memory O(1) in spp).

    Honors ``opts.samples_per_launch`` and emits lanes in the same 32x32
    screen-block order as the forward renderer: at small frames a
    one-sample launch leaves the device dispatch-bound, so wider
    wavefronts pay. The RNG stream is keyed by (pixel, sample), so the
    result is identical to the one-sample-at-a-time schedule."""
    import numpy as _np

    from .integrators.path import _block_order

    opts = dataclasses.replace(opts, differentiable=True)
    scene = put_params(scene, params)
    p = cam.n_pixels
    order_np = _block_order(cam.width, cam.height)
    inv_order = jnp.asarray(_np.argsort(order_np).astype(_np.int32))
    sb = max(1, min(opts.samples_per_launch or 1, opts.spp))
    while opts.spp % sb:
        sb -= 1
    pix = jnp.tile(jnp.asarray(order_np), sb)
    px = pix % cam.width
    py = pix // cam.width
    soff = jnp.repeat(jnp.arange(sb, dtype=jnp.int32), p)

    @jax.checkpoint
    def one_batch(s):
        L = render_sample(scene, cam, px, py, pix, s * sb + soff, seed,
                          opts)
        return (L.x.reshape(sb, p).sum(0), L.y.reshape(sb, p).sum(0),
                L.z.reshape(sb, p).sum(0))

    def body(acc, s):
        L = one_batch(s)
        return (acc[0] + L[0], acc[1] + L[1], acc[2] + L[2]), None

    zeros = jnp.zeros((p,), jnp.float32)
    acc, _ = jax.lax.scan(body, (zeros, zeros, zeros),
                          jnp.arange(opts.spp // sb, dtype=jnp.int32))
    inv = 1.0 / opts.spp
    img = jnp.stack([acc[0] * inv, acc[1] * inv, acc[2] * inv], axis=-1)
    return img[inv_order].reshape(cam.height, cam.width, 3)


def render_light_diff(params: MaterialParams, scene: SceneData, cam: Camera,
                      opts: RenderOptions, seed=0):
    """Differentiable LIGHT-TRACING render -> [H, W, 3].

    The splat estimator differentiates cleanly: the vertex-connection
    scatter-adds (``.at[].add``) have exact gather transposes, and the
    direct visible-light max-combine (``.at[].max``) routes the gradient
    to the winning sample. Sampling decisions are detached inside
    trace_sample (integrators/light.py); gradients flow through
    emission, the adjoint-BSDF values and the We/Geo throughput chain.
    Samples ride a rematerialized lax.scan: memory O(1) in spp."""
    from .integrators.light import compose_light_film, trace_sample

    opts = dataclasses.replace(opts, differentiable=True)
    scene = put_params(scene, params)
    p = cam.n_pixels
    lane = jnp.arange(p, dtype=jnp.int32)

    @jax.checkpoint
    def one_sample(s):
        idx_list, rgb_list, didx, drgb = trace_sample(
            scene, cam, lane, s, seed, opts)
        return idx_list, rgb_list, didx, drgb

    def body(carry, s):
        fr, fg, fb, dr, dg, db, dmask = carry
        idx_list, rgb_list, didx, drgb = one_sample(s)
        vdid = jnp.where(didx >= 0, didx, p)
        dr = dr.at[vdid].max(drgb.x, mode='drop')
        dg = dg.at[vdid].max(drgb.y, mode='drop')
        db = db.at[vdid].max(drgb.z, mode='drop')
        dmask = dmask.at[vdid].set(True, mode='drop')
        for i, (idx, rgb) in enumerate(zip(idx_list, rgb_list)):
            if i == 0:
                continue
            vidx = jnp.where(idx >= 0, idx, p)
            fr = fr.at[vidx].add(jnp.where(idx >= 0, rgb.x, 0.0), mode='drop')
            fg = fg.at[vidx].add(jnp.where(idx >= 0, rgb.y, 0.0), mode='drop')
            fb = fb.at[vidx].add(jnp.where(idx >= 0, rgb.z, 0.0), mode='drop')
        return (fr, fg, fb, dr, dg, db, dmask), None

    zeros = jnp.zeros((p,), jnp.float32)
    fmask = jnp.zeros((p,), bool)
    (fr, fg, fb, dr, dg, db, dmask), _ = jax.lax.scan(
        body, (zeros, zeros, zeros, zeros, zeros, zeros, fmask),
        jnp.arange(opts.spp, dtype=jnp.int32))
    hw = (cam.height, cam.width)
    return compose_light_film(
        scene, cam, jnp.stack([fr, fg, fb], axis=-1).reshape(*hw, 3),
        jnp.stack([dr, dg, db], axis=-1).reshape(*hw, 3),
        dmask.reshape(*hw), opts.spp)


def render_bdpt_diff(params: MaterialParams, scene: SceneData, cam: Camera,
                     opts: RenderOptions, seed=0):
    """Differentiable BDPT render -> [H, W, 3] (the reference's own
    default integrator, config.txt:6). Per-pixel strategy estimates and
    the t=1 splat scatter-adds both differentiate; MIS weights and every
    sampling decision are detached (integrators/bdpt.py), so gradients
    flow through the two subpaths' BSDF values, emission and the
    connection geometry terms. Samples ride a rematerialized lax.scan."""
    from .integrators.bdpt import render_sample_bdpt

    opts = dataclasses.replace(opts, differentiable=True)
    scene = put_params(scene, params)
    p = cam.n_pixels
    lane = jnp.arange(p, dtype=jnp.int32)
    px = lane % cam.width
    py = lane // cam.width

    @jax.checkpoint
    def one_sample(s):
        return render_sample_bdpt(scene, cam, px, py, lane, s, seed, opts)

    inv = 1.0 / opts.spp

    def body(carry, s):
        fr, fg, fb = carry
        est, sidx, srgb = one_sample(s)
        # estimates average over spp here; the t=1 splats carry 1/spp
        # internally (render_sample_bdpt prefac) and accumulate raw —
        # matching integrators/bdpt.render exactly
        fr = fr + est.x * inv
        fg = fg + est.y * inv
        fb = fb + est.z * inv
        for idx, rgb in zip(sidx, srgb):
            vidx = jnp.where(idx >= 0, idx, p)
            fr = fr.at[vidx].add(jnp.where(idx >= 0, rgb.x, 0.0),
                                 mode='drop')
            fg = fg.at[vidx].add(jnp.where(idx >= 0, rgb.y, 0.0),
                                 mode='drop')
            fb = fb.at[vidx].add(jnp.where(idx >= 0, rgb.z, 0.0),
                                 mode='drop')
        return (fr, fg, fb), None

    zeros = jnp.zeros((p,), jnp.float32)
    (fr, fg, fb), _ = jax.lax.scan(
        body, (zeros, zeros, zeros), jnp.arange(opts.spp, dtype=jnp.int32))
    # reference film semantics: bkg underlies every pixel, estimates and
    # splats accumulate on top (Camera.hpp:28; integrators/bdpt.render)
    bkg = scene.bkgcolor
    img = jnp.stack([fr + bkg.x, fg + bkg.y, fb + bkg.z], axis=-1)
    img = jnp.where(jnp.isnan(img), 0.0, img)
    return img.reshape(cam.height, cam.width, 3)


@partial(jax.jit, static_argnames=("opts",))
def image_loss_and_grad(params: MaterialParams, target, scene: SceneData,
                        cam: Camera, opts: RenderOptions, seed=0):
    """L2 image loss against ``target`` and its gradient w.r.t. params —
    the core op of inverse-rendering / appearance-optimization loops."""

    def loss_fn(p):
        img = render_diff(p, scene, cam, opts, seed)
        return jnp.mean((img - target) ** 2)

    return jax.value_and_grad(loss_fn)(params)
