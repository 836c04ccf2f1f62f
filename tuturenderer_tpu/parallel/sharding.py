"""Multi-chip scaling: pixel-tile x sample data parallelism over a device
mesh, with replicated scene and all-reduced film/gradients.

The reference's only parallel layer is std::thread row slicing on one CPU
(PathTracing.hpp:393-430, N_THREAD=20). This design shards the
embarrassing axes over a 2D ``jax.sharding.Mesh``:

- axis ``tile``: the flat pixel/lane axis (the analogue of row bands);
- axis ``sample``: spp groups (each device traces spp/n_sample samples of
  its pixel slice and the partial films are ``psum``-reduced).

Scene/BVH/material/texture buffers are replicated per chip (they are
small); the wavefront state lives entirely in the shard. Counter-based
RNG (utils/rng.py) makes results bit-identical for any mesh shape.

Gradients in the training step are ``psum``-reduced over both axes, which
XLA overlaps with the backward sweep.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..camera import Camera
from ..grad import MaterialParams, put_params
from ..integrators.path import render_sample
from ..options import RenderOptions
from ..scene.data import SceneData


def make_mesh(n_devices: Optional[int] = None,
              devices=None) -> Mesh:
    """Factor the device count into a (tile, sample) mesh, favoring the
    tile axis (film partitioning) for the larger factor."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    sample = 1
    for cand in (4, 2):
        if n % cand == 0 and n // cand >= cand:
            sample = cand
            break
    if n % sample:
        sample = 1
    tile = n // sample
    dev_array = np.asarray(devices).reshape(tile, sample)
    return Mesh(dev_array, ("tile", "sample"))


def _padded_lane_count(n_pixels: int, n_tile: int) -> int:
    return ((n_pixels + n_tile - 1) // n_tile) * n_tile


def _pixel_axes(mesh: Mesh) -> tuple:
    """Axes the pixel/lane dimension shards over: every mesh axis except
    'sample' (so a ('host','tile','sample') multi-host mesh tiles the
    film over host x tile with no code changes)."""
    return tuple(a for a in mesh.axis_names if a != "sample")


def _n_pixel_shards(mesh: Mesh) -> int:
    n = 1
    for a in _pixel_axes(mesh):
        n *= mesh.shape[a]
    return n


def render_sharded(scene: SceneData, cam: Camera, opts: RenderOptions,
                   mesh: Mesh, seed: int = 0):
    """Full-frame render distributed over ``mesh`` -> [H, W, 3] (replicated).

    Pixels are sharded over 'tile'; each 'sample' row of the mesh traces an
    interleaved subset of spp and partial films are psum-reduced.
    """
    px_axes = _pixel_axes(mesh)
    n_tile = _n_pixel_shards(mesh)
    n_sample = mesh.shape["sample"]
    assert opts.spp % n_sample == 0, \
        f"spp={opts.spp} must divide by sample axis {n_sample}"
    spp_local = opts.spp // n_sample

    p = cam.n_pixels
    p_pad = _padded_lane_count(p, n_tile)
    lane = jnp.arange(p_pad, dtype=jnp.int32)

    def shard_fn(lane_shard):
        sample_id = jax.lax.axis_index("sample")
        px = lane_shard % cam.width
        py = jnp.minimum(lane_shard // cam.width, cam.height - 1)

        def body(s, acc):
            # global sample index: interleaved over the sample axis
            gs = s * n_sample + sample_id
            L = render_sample(scene, cam, px, py, lane_shard, gs, seed, opts)
            return (acc[0] + L.x, acc[1] + L.y, acc[2] + L.z)

        zeros = jnp.zeros_like(lane_shard, dtype=jnp.float32)
        acc = jax.lax.fori_loop(0, spp_local, body, (zeros, zeros, zeros))
        inv = 1.0 / opts.spp
        film = jnp.stack([a * inv for a in acc], axis=-1)
        return jax.lax.psum(film, "sample")

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=P(px_axes),
                   out_specs=P(px_axes, None), check_vma=False)
    film = fn(lane)[:p]
    return film.reshape(cam.height, cam.width, 3)


def train_step_sharded(params: MaterialParams, target, scene: SceneData,
                       cam: Camera, opts: RenderOptions, mesh: Mesh,
                       lr: float = 0.01, seed: int = 0):
    """One inverse-rendering SGD step distributed over ``mesh``: each shard
    renders its pixel/sample slice differentiably, computes its partial L2
    loss against ``target``, and gradients are psum-reduced over both mesh
    axes before the update. Returns (new_params, loss)."""
    opts = dataclasses.replace(opts, differentiable=True)
    px_axes = _pixel_axes(mesh)
    n_tile = _n_pixel_shards(mesh)
    n_sample = mesh.shape["sample"]
    spp_local = max(opts.spp // n_sample, 1)

    p = cam.n_pixels
    p_pad = _padded_lane_count(p, n_tile)
    lane = jnp.arange(p_pad, dtype=jnp.int32)
    tgt = jnp.asarray(target, jnp.float32).reshape(-1, 3)
    if p_pad != p:
        tgt = jnp.concatenate(
            [tgt, jnp.zeros((p_pad - p, 3), jnp.float32)], axis=0)

    def shard_fn(prm, lane_shard, tgt_shard):
        sample_id = jax.lax.axis_index("sample")
        px = lane_shard % cam.width
        py = jnp.minimum(lane_shard // cam.width, cam.height - 1)
        sc = put_params(scene, prm)

        def loss_fn(prm_inner):
            sc_i = put_params(scene, prm_inner)

            def body(acc, s):
                gs = s * n_sample + sample_id
                L = render_sample(sc_i, cam, px, py, lane_shard, gs, seed, opts)
                return (acc[0] + L.x, acc[1] + L.y, acc[2] + L.z), None

            zeros = jnp.zeros_like(lane_shard, dtype=jnp.float32)
            acc, _ = jax.lax.scan(
                body, (zeros, zeros, zeros),
                jnp.arange(spp_local, dtype=jnp.int32))
            inv = 1.0 / (spp_local * n_sample)
            film = jnp.stack([a * inv for a in acc], axis=-1)
            film = jax.lax.psum(film, "sample")
            return jnp.sum((film - tgt_shard) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(prm)
        # gradient all-reduce over every mesh axis. Every sample row holds
        # the same tile loss, and (check_vma=False) the transpose of the
        # film's psum over "sample" hands each row the cotangent of all
        # n_sample copies, so the sum over rows counts the true gradient
        # n_sample times
        grads = jax.tree.map(
            lambda g: g / n_sample,
            jax.lax.psum(grads, px_axes + ("sample",)))
        loss = jax.lax.psum(loss, px_axes) / p
        new_params = jax.tree.map(lambda w, g: w - lr * g, prm, grads)
        return new_params, loss

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=(P(), P(px_axes), P(px_axes, None)),
                   out_specs=(P(), P()), check_vma=False)
    return fn(params, lane, tgt)


def render_light_sharded(scene: SceneData, cam: Camera, opts: RenderOptions,
                         mesh: Mesh, seed: int = 0):
    """Light-tracing render distributed over ``mesh``.

    Light paths are not tied to pixels, so the lane axis (path slots) is
    sharded; every shard scatter-adds its splats into a FULL-frame partial
    film. The vertex-connection splats are summed across shards (psum over
    every axis — the all-reduce replacement for the reference's
    mutex-guarded addRGB, LightTracing.hpp:181-200); the direct
    visible-light component has setRGB overwrite semantics with identical
    values, so partial films combine with pmax instead.
    """
    from ..integrators.light import trace_sample

    px_axes = _pixel_axes(mesh)
    n_tile = _n_pixel_shards(mesh)
    n_sample = mesh.shape["sample"]
    assert opts.spp % n_sample == 0
    spp_local = opts.spp // n_sample

    p = cam.n_pixels
    p_pad = _padded_lane_count(p, n_tile)
    lane = jnp.arange(p_pad, dtype=jnp.int32)
    spp_inv = 1.0 / opts.spp

    def shard_fn(lane_shard):
        sample_id = jax.lax.axis_index("sample")
        # padded lanes (>= p) must not trace: they would duplicate RNG
        # streams of real lanes elsewhere. Mask them out.
        live = lane_shard < p

        def body(s, carry):
            fr, fg, fb, dr, dg, db, dmask = carry
            gs = s * n_sample + sample_id
            idx_list, rgb_list, didx, drgb = trace_sample(
                scene, cam, lane_shard, gs, seed, opts)
            vdid = jnp.where((didx >= 0) & live, didx, p)
            dr = dr.at[vdid].max(drgb.x * spp_inv, mode='drop')
            dg = dg.at[vdid].max(drgb.y * spp_inv, mode='drop')
            db = db.at[vdid].max(drgb.z * spp_inv, mode='drop')
            dmask = dmask.at[vdid].set(1, mode='drop')
            for i, (idx, rgb) in enumerate(zip(idx_list, rgb_list)):
                if i == 0:
                    continue
                vidx = jnp.where((idx >= 0) & live, idx, p)
                fr = fr.at[vidx].add(rgb.x * spp_inv, mode='drop')
                fg = fg.at[vidx].add(rgb.y * spp_inv, mode='drop')
                fb = fb.at[vidx].add(rgb.z * spp_inv, mode='drop')
            return fr, fg, fb, dr, dg, db, dmask

        zeros = jnp.zeros((p,), jnp.float32)
        imask = jnp.zeros((p,), jnp.int32)
        fr, fg, fb, dr, dg, db, dmask = jax.lax.fori_loop(
            0, spp_local, body,
            (zeros, zeros, zeros, zeros, zeros, zeros, imask))
        all_axes = px_axes + ("sample",)
        fr = jax.lax.psum(fr, all_axes)
        fg = jax.lax.psum(fg, all_axes)
        fb = jax.lax.psum(fb, all_axes)
        dr = jax.lax.pmax(dr, all_axes)
        dg = jax.lax.pmax(dg, all_axes)
        db = jax.lax.pmax(db, all_axes)
        dmask = jax.lax.pmax(dmask, all_axes)
        bkg = scene.bkgcolor
        r = jnp.where(dmask > 0, dr, bkg.x) + fr
        g = jnp.where(dmask > 0, dg, bkg.y) + fg
        b = jnp.where(dmask > 0, db, bkg.z) + fb
        img = jnp.stack([r, g, b], axis=-1)
        return jnp.where(jnp.isnan(img), 0.0, img)

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=P(px_axes),
                   out_specs=P(None, None), check_vma=False)
    return fn(lane).reshape(cam.height, cam.width, 3)


def render_bdpt_sharded(scene: SceneData, cam: Camera, opts: RenderOptions,
                        mesh: Mesh, seed: int = 0):
    """BDPT render distributed over ``mesh``: per-pixel strategy estimates
    stay in the owning shard; t=1 light-trace splats go into full-frame
    partial films that are psum-reduced over every axis (the collective
    replacement for the reference's mutex addRGB, BDPT.hpp:819-832)."""
    from ..integrators.bdpt import render_sample_bdpt

    px_axes = _pixel_axes(mesh)
    n_tile = _n_pixel_shards(mesh)
    n_sample = mesh.shape["sample"]
    assert opts.spp % n_sample == 0
    spp_local = opts.spp // n_sample

    p = cam.n_pixels
    p_pad = _padded_lane_count(p, n_tile)
    lane = jnp.arange(p_pad, dtype=jnp.int32)
    spp_inv = 1.0 / opts.spp

    def shard_fn(lane_shard):
        sample_id = jax.lax.axis_index("sample")
        live = lane_shard < p
        px = lane_shard % cam.width
        py = jnp.minimum(lane_shard // cam.width, cam.height - 1)

        def body(s, carry):
            er, eg, eb, sr, sg_, sb = carry
            gs = s * n_sample + sample_id
            est, sidx, srgb = render_sample_bdpt(scene, cam, px, py,
                                                 lane_shard, gs, seed, opts)
            er = er + est.x * spp_inv
            eg = eg + est.y * spp_inv
            eb = eb + est.z * spp_inv
            for idx, rgb in zip(sidx, srgb):
                vidx = jnp.where((idx >= 0) & live, idx, p)
                sr = sr.at[vidx].add(jnp.where(idx >= 0, rgb.x, 0.0),
                                     mode='drop')
                sg_ = sg_.at[vidx].add(jnp.where(idx >= 0, rgb.y, 0.0),
                                       mode='drop')
                sb = sb.at[vidx].add(jnp.where(idx >= 0, rgb.z, 0.0),
                                     mode='drop')
            return er, eg, eb, sr, sg_, sb

        ez = jnp.zeros_like(lane_shard, dtype=jnp.float32)
        fz = jnp.zeros((p,), jnp.float32)
        er, eg, eb, sr, sg_, sb = jax.lax.fori_loop(
            0, spp_local, body, (ez, ez, ez, fz, fz, fz))
        # own-pixel estimates: reduce over the sample axis only
        er = jax.lax.psum(er, "sample")
        eg = jax.lax.psum(eg, "sample")
        eb = jax.lax.psum(eb, "sample")
        # splats: full all-reduce
        all_axes = px_axes + ("sample",)
        sr = jax.lax.psum(sr, all_axes)
        sg_ = jax.lax.psum(sg_, all_axes)
        sb = jax.lax.psum(sb, all_axes)
        est = jnp.stack([er, eg, eb], axis=-1)
        splat = jnp.stack([sr, sg_, sb], axis=-1)
        return est, splat

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=P(px_axes),
                   out_specs=(P(px_axes, None), P(None, None)),
                   check_vma=False)
    est, splat = fn(lane)
    # reference film semantics: bkgcolor underlies every pixel and BDPT
    # adds on top (Camera.hpp:28 + addRGB; see integrators/bdpt.render) —
    # added ONCE here, after the cross-shard reductions
    bkg = jnp.stack([scene.bkgcolor.x, scene.bkgcolor.y,
                     scene.bkgcolor.z])[None, :]
    img = est[:p] + splat + bkg
    img = jnp.where(jnp.isnan(img), 0.0, img)
    return img.reshape(cam.height, cam.width, 3)
