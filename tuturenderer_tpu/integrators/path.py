"""Wavefront unidirectional path tracer with NEE + power-heuristic MIS.

This is the wavefront re-architecture of the reference's recursive ``traceRay``
(PathTracing.hpp:136-349): the per-ray recursion becomes a static
bounce loop (``lax.scan``) over a flat SoA wavefront; per-material virtual
calls become masked blends; terminated lanes carry a dead mask instead of
returning. The estimator is numerically the same:

- camera rays through pixel centers (PathTracing.hpp:377-391, 444);
- at each vertex: NEE light sample with solid-angle-converted MIS weight
  (PathTracing.hpp:180-219), BSDF sample with the mirrored MIS weight on
  emissive hits (PathTracing.hpp:222-261), Russian roulette gated by
  MIN_DEPTH on the running throughput (PathTracing.hpp:263-277);
- PERFECT_REFRACTIVE / MICROFACET_T vertices take the delta/rough
  dielectric path with TIR handling (calcForRefractive,
  PathTracing.hpp:80-134), which skips NEE and resets the RR throughput;
- emissive surfaces: weight-1 on direct hits, zero on indirect hits not
  reached through a BSDF-sample MIS strategy (PathTracing.hpp:164-170);
- misses contribute bkgcolor only for camera rays and refractive-chain
  continuations (PathTracing.hpp:150 and the structure of the MIS branch,
  where a missed BSDF sample adds nothing, PathTracing.hpp:234);
- MIN_DIVISOR kill thresholds reproduced (PathTracing.hpp:215, 257, 272).

Differentiability: with ``stop_gradient`` applied to sampling decisions
(directions, pdfs, RR) the radiance estimate is differentiable w.r.t. the
material table (albedo/roughness/metallic/emission) — detached-sampling
path-replay; see grad.py.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..camera import Camera, primary_ray
from ..materials import (MatParams, bxdf_eval, bxdf_pdf, bxdf_sample,
                         d_ndf, gather_material, mis_power_weight)
from ..ops.intersect import (intersect_core, occluded, shade_hit,
                             transmittance)
from ..ops.lights import light_pdf_of_hit, sample_light
from ..options import EPSILON, MIN_DIVISOR, RenderOptions
from ..scene.data import (MICROFACET_T, PERFECT_REFLECTIVE, UNLIT, SceneData)
from ..utils import rng
from ..utils.vec import Vec3, reflect, where as vwhere

# lane provenance at loop top (what produced the current ray)
FROM_CAMERA = 0
FROM_BSDF = 1       # BSDF sample of a non-refractive vertex (MIS pending)
FROM_REFRACT = 2    # calcForRefractive continuation
FROM_MIRROR = 3     # NEE-only mode: calcForMirror continuation
FROM_INDIRECT = 4   # NEE-only mode: indirect-illumination continuation


def _zeros3(n):
    z = jnp.zeros((n,), jnp.float32)
    return Vec3(z, z, z)


def _permute_state(state, order):
    """Reorder (or subset, when ``order`` is shorter than the state) every
    per-lane column of a wavefront-state pytree with packed row gathers
    instead of one gather per column: all f32 columns ride one [N, Kf]
    matrix, int columns and the bit-packed bool word (up to 32 bools in
    one i32) ride a second, and below 2^24 lanes the int columns ride the
    f32 plane through an exact float round-trip, making the whole
    permutation one row gather. The f32 plane stays differentiable
    (a gather of genuine f32 values has a clean scatter-add transpose).
    The packing was tuned for an earlier accelerator's gather lowering and
    is not measured on the H100 (ROADMAP D3)."""
    leaves, treedef = jax.tree.flatten(state)
    out = list(leaves)
    n_rows = leaves[0].shape[0]
    f32 = [i for i, l in enumerate(leaves) if l.dtype == jnp.float32]
    bools = [i for i, l in enumerate(leaves) if l.dtype == jnp.bool_]
    ints = [i for i, l in enumerate(leaves)
            if l.dtype not in (jnp.float32, jnp.bool_)]
    assert len(bools) <= 32
    int_cols = [leaves[i].astype(jnp.int32) for i in ints]
    if bools:
        word = leaves[bools[0]].astype(jnp.int32)
        for j, i in enumerate(bools[1:], start=1):
            word = word | (leaves[i].astype(jnp.int32) << j)
        int_cols.append(word)
    # every int value is exactly representable in f32 when ids < 2^24
    # (the wavefront is < 16.7M lanes, checked statically)
    unified = n_rows < (1 << 24) and f32
    if unified:
        cols = [leaves[i] for i in f32] + \
            [c.astype(jnp.float32) for c in int_cols]
        packed = jnp.stack(cols, axis=1)[order]
        for j, i in enumerate(f32):
            out[i] = packed[:, j]
        int_packed = [packed[:, len(f32) + j].astype(jnp.int32)
                      for j in range(len(int_cols))]
    else:
        if f32:
            packed = jnp.stack([leaves[i] for i in f32], axis=1)[order]
            for j, i in enumerate(f32):
                out[i] = packed[:, j]
        int_packed = []
        if int_cols:
            packed = jnp.stack(int_cols, axis=1)[order]
            int_packed = [packed[:, j] for j in range(len(int_cols))]
    for j, i in enumerate(ints):
        out[i] = int_packed[j].astype(leaves[i].dtype)
    if bools:
        word = int_packed[len(ints)]
        for j, i in enumerate(bools):
            out[i] = ((word >> j) & 1).astype(jnp.bool_)
    return jax.tree.unflatten(treedef, out)


def apply_textures(scene: SceneData, hit, params: MatParams):
    """textureModify + changeNormalDir (IIntegrator.hpp:27-127): override
    diffuse/roughness/metallic from maps and perturb the shading normal via
    the TBN frame. Returns (params, ns)."""
    ns = hit.ns
    if not scene.has_textures:
        return params, ns
    dm = scene.materials.diffuse_map[jnp.maximum(hit.mat, 0)]
    nm = scene.materials.normal_map[jnp.maximum(hit.mat, 0)]
    rm = scene.materials.roughness_map[jnp.maximum(hit.mat, 0)]
    mm = scene.materials.metallic_map[jnp.maximum(hit.mat, 0)]

    diffuse = vwhere(dm >= 0, scene.diffuse_maps.sample(dm, hit.u, hit.v),
                     params.diffuse)
    rough_tex = scene.roughness_maps.sample(rm, hit.u, hit.v).x
    roughness = jnp.where(rm >= 0, rough_tex, params.roughness)
    metal_tex = scene.metallic_maps.sample(mm, hit.u, hit.v).x
    metallic = jnp.where(mm >= 0, metal_tex, params.metallic)

    # normal map: decoded texel (already in [-1,1]) through TBN
    texel = scene.normal_maps.sample(nm, hit.u, hit.v)
    # triangle TBN from UV deltas (IIntegrator.hpp:45-56) — precomputed
    # per triangle on host (scene.tri_tbn) so this is ONE packed row
    # gather instead of ~17 per-column gathers of triangle constants
    ti = jnp.where(hit.kind == 0, jnp.maximum(hit.idx, 0), 0)
    tbn = scene.tri_tbn[ti]                      # [N, 6]
    t_tri = Vec3(tbn[:, 0], tbn[:, 1], tbn[:, 2])
    b_tri = Vec3(tbn[:, 3], tbn[:, 4], tbn[:, 5])
    # sphere analytic tangent (IIntegrator.hpp:67-81)
    ndir = hit.ng
    rxy = jnp.sqrt(jnp.maximum(ndir.x * ndir.x + ndir.y * ndir.y, 1e-20))
    t_sph = Vec3(-ndir.y / rxy, ndir.x / rxy, jnp.zeros_like(ndir.x))
    b_sph = ndir.cross(t_sph)
    t_v = vwhere(hit.kind == 0, t_tri, t_sph)
    b_v = vwhere(hit.kind == 0, b_tri, b_sph)
    base_n = vwhere(hit.kind == 0, hit.ns, hit.ng)
    mapped = (t_v * texel.x + b_v * texel.y + base_n * texel.z).normalized(1e-20)
    ns = vwhere(nm >= 0, mapped, ns)

    return params._replace(diffuse=diffuse, roughness=roughness,
                           metallic=metallic), ns


def trace_rays(scene: SceneData, cam: Camera, orig: Vec3, d: Vec3,
               lane, sample_idx, seed, opts: RenderOptions,
               collect_alive: bool = False,
               collect_overflow: bool = False) -> Vec3:
    """Trace one wavefront of primary rays to completion; returns per-lane
    radiance (one Monte Carlo sample per lane).

    ``collect_alive=True`` (scan path only) additionally returns the live
    lane count entering each bounce plus the post-loop pending count — the
    per-scene data behind honest rays/s accounting in bench.py.

    ``collect_overflow=True`` additionally returns the total number of
    live lanes dropped (and compensated for, unbiasedly) by compaction
    overflow roulette, so callers can surface it beside the image."""
    n = orig.x.shape[0]
    eta_scene = scene.eta
    types = scene.mtype_set
    from ..scene.data import PERFECT_REFRACTIVE as _PR
    refr_possible = (MICROFACET_T in types) or (_PR in types)
    # detached-sampling autodiff: sampling decisions are piecewise-constant
    # w.r.t. material parameters; gradients flow only through BSDF values,
    # emission and cosine terms (see module docstring / grad.py)
    sg = jax.lax.stop_gradient if opts.differentiable else (lambda x: x)

    # per-lane sample index: scalar for single-sample launches, a vector
    # when the caller batches several spp into one wavefront (the RNG
    # stream stays keyed by (seed, pixel-lane, sample) either way, so a
    # batched render equals the sum of its per-sample renders bit-exactly)
    smp = jnp.broadcast_to(jnp.asarray(sample_idx, jnp.int32), (n,))

    state = dict(
        o=orig, d=d,
        L=_zeros3(n),
        w=Vec3(jnp.ones((n,)), jnp.ones((n,)), jnp.ones((n,))),  # prefix weight
        tp=Vec3(jnp.ones((n,)), jnp.ones((n,)), jnp.ones((n,))),  # RR throughput
        alive=jnp.ones((n,), bool),
        from_kind=jnp.full((n,), FROM_CAMERA, jnp.int32),
        prev_pdf=jnp.zeros((n,)),          # BSDF pdf at previous vertex
        prev_mirror1=jnp.zeros((n,), bool),  # PERFECT_REFLECTIVE pdf==1 case
        w_em=_zeros3(n),                    # weight if next hit is emissive
        rr_inv=jnp.zeros((n,)),             # 1/rr_prob; continuation
                                            # weight = w_em * rr_inv (3
                                            # fewer sorted f32 columns
                                            # than carrying it directly)
        cont_ok=jnp.zeros((n,), bool),      # RR survived + divisor gates
        em_ok=jnp.zeros((n,), bool),
        lane=lane,                          # original lane id (RNG key)
        smp=smp,                            # per-lane sample id (RNG key)
        fkey=jnp.arange(n, dtype=jnp.int32),   # film slot (compaction flush)
    )

    def bounce(state, depth):
        o, d = state['o'], state['d']
        alive = state['alive']
        w = state['w']
        L = state['L']
        from_kind = state['from_kind']
        nn = o.x.shape[0]                   # current (possibly compacted) width
        z3 = _zeros3(nn)
        one = jnp.ones((nn,))

        u = lambda purpose: rng.uniform(seed, state['lane'], state['smp'],
                                        depth, purpose)

        core = intersect_core(scene, o, d, mask=alive)
        hit = shade_hit(scene, o, d, core)
        params = gather_material(scene, hit.mat)
        params, ns = apply_textures(scene, hit, params)
        hit = hit._replace(ns=ns)

        wo = -d

        # recursion depth limit: traceRay(depth > MAX_DEPTH) returns 0
        # before looking at anything (PathTracing.hpp:140); the final loop
        # iteration only resolves the pending BSDF-sample emissive strategy
        within_depth = depth <= opts.max_depth

        # ---------- miss: bkg for camera/refract chain, nothing for BSDF
        miss = alive & ~hit.hit
        add_bkg = miss & (from_kind != FROM_BSDF) & within_depth
        L = L + vwhere(add_bkg, w * scene.bkgcolor, z3)
        alive = alive & hit.hit

        # ---------- emissive hit resolution
        emissive = params.emissive & alive
        #   camera ray: weight-1 emission (PathTracing.hpp:169-170)
        direct_em = emissive & (from_kind == FROM_CAMERA)
        L = L + vwhere(direct_em, w * params.emission, z3)
        #   BSDF-sample hit: MIS weighted (PathTracing.hpp:239-260)
        bsdf_em = emissive & (from_kind == FROM_BSDF)
        light_pdf_a = light_pdf_of_hit(scene, hit.kind, hit.idx, hit.mat,
                                       hit.area)
        cos_prime = hit.ns.normalized(1e-20).dot(-d)
        t_hit = jnp.where(hit.hit, core.t, 1.0)
        r2 = t_hit * t_hit
        l_pdf_sa = light_pdf_a * r2 / jnp.maximum(cos_prime, 1e-20)
        w_m = sg(mis_power_weight(state['prev_pdf'], l_pdf_sa))
        w_m = jnp.where(state['prev_mirror1'], 1.0, w_m)
        good_em = bsdf_em & (cos_prime > 0.0) & state['em_ok'] & (light_pdf_a > 0)
        w_m = jnp.where(good_em, w_m, 0.0)   # keep masked infs out of products
        L = L + vwhere(good_em, state['w_em'] * w_m * params.emission, z3)
        #   refract-chain hit on emissive: contributes 0 (PathTracing.hpp:164-165)
        alive = alive & ~emissive

        # ---------- UNLIT returns diffuse (PathTracing.hpp:161)
        unlit = alive & (params.mtype == UNLIT) & within_depth
        L = L + vwhere(unlit & (from_kind != FROM_BSDF), w * params.diffuse,
                       z3)
        # a BSDF-sampled UNLIT hit falls into the indirect branch; its
        # continuation returns diffuse next round, carried as w_em*rr_inv
        w_cont_prev = state['w_em'] * state['rr_inv']
        L = L + vwhere(unlit & (from_kind == FROM_BSDF) & state['cont_ok'],
                       w_cont_prev * params.diffuse, z3)
        alive = alive & ~unlit & within_depth

        # ---------- indirect continuation bookkeeping for FROM_BSDF lanes
        # (reference: RR + MIN_DIVISOR gates were evaluated at the previous
        #  vertex; apply them now that we know the hit is non-emissive)
        w = vwhere(alive & (from_kind == FROM_BSDF), w_cont_prev, w)
        alive = alive & jnp.where(from_kind == FROM_BSDF, state['cont_ok'], True)

        refr = params.is_refractive_kind
        tp = state['tp']

        # ======================================================== NEE
        do_nee = alive & ~refr
        ls = sample_light(scene, u(rng.LIGHT_PICK), u(rng.LIGHT_U),
                          u(rng.LIGHT_V), opts.tutu_light_pick,
                          opts.tutu_tri_sample)
        ls = ls._replace(pos=sg(ls.pos), ng=sg(ls.ng),
                         pdf_area=sg(ls.pdf_area))
        ray_inside = hit.ns.dot(wo) < 0.0
        sh_orig = hit.pos + vwhere(ray_inside, -hit.ns, hit.ns) * EPSILON
        lpos_off = ls.pos + ls.ng * EPSILON
        to_l = lpos_off - sh_orig
        dist_l = to_l.norm()
        sh_dir = to_l * (1.0 / jnp.maximum(dist_l, 1e-20))
        if opts.alpha_shadows:
            # soft visibility: product of (1-alpha) over every occluder
            # (getShadowCoeffi, BVHStrategy.hpp:13-45)
            sh_trans = transmittance(scene, sh_orig, sh_dir, dist_l,
                                     mask=do_nee & ls.valid)
            blocked = sh_trans <= 0.0
        else:
            sh_trans = None
            blocked = occluded(scene, sh_orig, sh_dir, dist_l,
                               mask=do_nee & ls.valid)
        wi_l = (ls.pos - hit.pos)
        r2_l = wi_l.norm2()
        wi_l = wi_l.normalized(1e-20)
        facing = wi_l.dot(ls.ng) <= 0.0          # PathTracing.hpp:197
        cos_p = ls.ng.normalized(1e-20).dot(-wi_l)
        nee_live = do_nee & ls.valid & ~blocked & facing & (cos_p > 0.0)
        mat_pdf_l = sg(bxdf_pdf(params, wi_l, wo, hit.ns, eta_scene,
                                params.eta, types=types))
        l_pdf_sa2 = ls.pdf_area * r2_l / jnp.maximum(cos_p, 1e-20)
        w_l = sg(mis_power_weight(l_pdf_sa2, mat_pdf_l))
        f_r_l = bxdf_eval(params, wi_l, wo, hit.ng, hit.ns, eta_scene,
                          types=types)
        cos_t = jnp.abs(hit.ng.dot(wi_l))
        denom = r2_l * ls.pdf_area
        #   reference kills the whole path when r2*pdf_l < MIN_DIVISOR
        kill = nee_live & (denom < MIN_DIVISOR)
        live = nee_live & ~kill
        scale = jnp.where(live, w_l * cos_t * cos_p /
                          jnp.maximum(denom, 1e-20), 0.0)
        if sh_trans is not None:
            scale = scale * sh_trans
        L = L + vwhere(live, w * ls.emission * f_r_l * scale, z3)
        alive = alive & ~kill

        # ======================================================== BSDF sample
        #   regular lanes (PathTracing.hpp:222-231)
        samp = bxdf_sample(params, wo, hit.ns, u(rng.BSDF_U0), u(rng.BSDF_U1),
                           u(rng.BSDF_LOTTERY), eta_scene,
                           opts.ggx_sample_bug, types=types)
        samp = samp._replace(wi=sg(samp.wi))
        wi = samp.wi
        mat_pdf = sg(bxdf_pdf(params, wi, wo, hit.ns, eta_scene, params.eta,
                              types=types))

        #   refractive lanes: calcForRefractive (PathTracing.hpp:80-134)
        tir = samp.tir
        wi_tir = reflect(wo, hit.ns).normalized(1e-20)
        #   MICROFACET_T TIR pdf correction (PathTracing.hpp:101-114)
        flip_r = wo.dot(hit.ng) < 0.0
        i_ns = vwhere(flip_r, -hit.ns, hit.ns)
        eta_pass = jnp.where(flip_r & (params.mtype == MICROFACET_T) & tir,
                             params.eta, eta_scene)
        h_tir = (wo + wi_tir).normalized(1e-20)
        cos_h = jnp.abs(i_ns.dot(h_tir))
        pdf_tir_mt = d_ndf(h_tir, i_ns, params.roughness) * cos_h / \
            jnp.maximum(4.0 * wo.dot(h_tir), 1e-20)
        pdf_tir = jnp.where(params.mtype == MICROFACET_T, pdf_tir_mt, 1.0)
        wi = vwhere(refr & tir, wi_tir, wi)
        mat_pdf = jnp.where(refr & tir, sg(pdf_tir), mat_pdf)
        eta_for_eval = jnp.where(refr, eta_pass, eta_scene)
        eta_for_eval = jnp.where(refr & ~tir, eta_scene, eta_for_eval)

        f_r = bxdf_eval(params, wi, wo, hit.ng, hit.ns, eta_for_eval,
                        adjoint=False, tir=refr & tir)

        fail = alive & ~refr & ~samp.success
        alive = alive & (refr | samp.success)

        cos_n = jnp.abs(hit.ng.dot(wi))

        #   RR draw happens at this vertex (PathTracing.hpp:263-268)
        tp_eff = vwhere(depth > opts.min_depth, tp, Vec3(
            one, one, one))
        rr_prob = sg(jnp.clip(tp_eff.max_component(), 0.0, 1.0)) \
            if opts.russian_roulette else one
        rr_survive = u(rng.RR) <= rr_prob

        # zero the inverse pdf below its kill threshold instead of letting
        # a masked 1e20 leak NaNs into reverse-mode products
        inv_pdf = jnp.where(mat_pdf >= MIN_DIVISOR,
                            1.0 / jnp.maximum(mat_pdf, 1e-20), 0.0)
        base = f_r * (cos_n * inv_pdf)
        em_ok = mat_pdf >= MIN_DIVISOR
        cont_ok = rr_survive & (mat_pdf * rr_prob >= MIN_DIVISOR)
        rr_inv = jnp.where(rr_prob > 0.0,
                           1.0 / jnp.maximum(rr_prob, 1e-20), 0.0)
        coe = base * rr_inv

        #   refractive lanes: no NEE/RR; gate pdf >= MIN_DIVISOR, reset tp
        refr_ok = mat_pdf >= MIN_DIVISOR

        new_from = jnp.where(refr, FROM_REFRACT, FROM_BSDF)
        w_em = w * base
        w_next = vwhere(refr, w * base, w)
        tp_next = vwhere(refr, Vec3(one, one,
                                    one), tp_eff * coe)

        alive_next = alive & jnp.where(refr, refr_ok, True)
        # non-refractive lanes stay "alive" into the next bounce even if
        # cont_ok is false, because the emissive-hit strategy (em_ok) may
        # still pay out; fully dead only if both gates fail
        alive_next = alive_next & jnp.where(refr, True, em_ok | cont_ok)

        ray_o = hit.pos + vwhere(wi.dot(hit.ns) < 0.0, -hit.ns, hit.ns) * EPSILON

        new_state = dict(
            o=ray_o, d=wi, L=L, w=w_next, tp=tp_next,
            alive=alive_next & ~fail,
            from_kind=new_from,
            prev_pdf=mat_pdf,
            prev_mirror1=(params.mtype == PERFECT_REFLECTIVE) & (mat_pdf == 1.0),
            w_em=w_em, rr_inv=rr_inv,
            cont_ok=cont_ok & alive, em_ok=em_ok & alive,
            lane=state['lane'], smp=state['smp'], fkey=state['fkey'],
        )
        return new_state, None

    def epilogue(state):
        """Resolve the final pending BSDF-sample emissive hit (recursion
        depth max_depth+1, where the reference's traceRay returns 0 for
        everything else, PathTracing.hpp:140): one intersection, no
        NEE/sampling."""
        nn = state['o'].x.shape[0]
        L = state['L']
        pending = state['alive'] & (state['from_kind'] == FROM_BSDF)
        core = intersect_core(scene, state['o'], state['d'], mask=pending)
        hit = shade_hit(scene, state['o'], state['d'], core)
        params = gather_material(scene, hit.mat)
        emissive = params.emissive & pending & hit.hit
        light_pdf_a = light_pdf_of_hit(scene, hit.kind, hit.idx, hit.mat,
                                       hit.area)
        cos_prime = hit.ns.normalized(1e-20).dot(-state['d'])
        t_hit = jnp.where(hit.hit, core.t, 1.0)
        l_pdf_sa = light_pdf_a * t_hit * t_hit / jnp.maximum(cos_prime, 1e-20)
        w_m = sg(mis_power_weight(state['prev_pdf'], l_pdf_sa))
        w_m = jnp.where(state['prev_mirror1'], 1.0, w_m)
        good = emissive & (cos_prime > 0.0) & state['em_ok'] & (light_pdf_a > 0)
        w_m = jnp.where(good, w_m, 0.0)
        return L + vwhere(good, state['w_em'] * w_m * params.emission,
                          _zeros3(nn))

    if not opts.mis:
        # ---------------- NEE-only estimator (the reference's !MIS branch,
        # PathTracing.hpp:281-347): light sampling is the ONLY direct-light
        # strategy; there is no BSDF-sample emissive payout, so emission is
        # seen only on camera rays. Perfect mirrors take the calcForMirror
        # special case (PathTracing.hpp:50-70): unweighted recursion through
        # the delta reflection; refractives take calcForRefractive exactly as
        # in the MIS branch. The wavefront form mirrors the MIS bounce: each
        # vertex commits its NEE contribution inline, continuations carry a
        # prefix weight, and the child vertex resolves the parent's
        # "intersected && non-emissive" recursion gate (PathTracing.hpp:337).
        state = dict(
            o=orig, d=d,
            L=_zeros3(n),
            w=Vec3(jnp.ones((n,)), jnp.ones((n,)), jnp.ones((n,))),
            tp=Vec3(jnp.ones((n,)), jnp.ones((n,)), jnp.ones((n,))),
            alive=jnp.ones((n,), bool),
            from_kind=jnp.full((n,), FROM_CAMERA, jnp.int32),
            lane=lane, smp=smp,
            fkey=jnp.arange(n, dtype=jnp.int32),
        )

        def bounce(state, depth):   # noqa: F811 — NEE-mode replacement
            o, d = state['o'], state['d']
            alive = state['alive']
            w = state['w']
            L = state['L']
            from_kind = state['from_kind']
            nn = o.x.shape[0]
            z3 = _zeros3(nn)
            one = jnp.ones((nn,))

            u = lambda purpose: rng.uniform(seed, state['lane'],
                                            state['smp'], depth, purpose)

            core = intersect_core(scene, o, d, mask=alive)
            hit = shade_hit(scene, o, d, core)
            params = gather_material(scene, hit.mat)
            params, ns = apply_textures(scene, hit, params)
            hit = hit._replace(ns=ns)
            wo = -d

            # miss: bkgcolor for camera rays and refractive continuations
            # (traceRay:150); a missed mirror ray returns 0 (calcForMirror
            # checks x_inter before recursing, PathTracing.hpp:59-68); the
            # indirect recursion is handed a known hit so it cannot miss
            miss = alive & ~hit.hit
            add_bkg = miss & ((from_kind == FROM_CAMERA) |
                              (from_kind == FROM_REFRACT))
            L = L + vwhere(add_bkg, w * scene.bkgcolor, z3)
            alive = alive & hit.hit

            # emissive: weight-1 on camera rays; every depth>0 provenance
            # returns 0 (traceRay:163-170 — and the indirect recursion never
            # enters emissive hits at all, PathTracing.hpp:337)
            emissive = params.emissive & alive
            L = L + vwhere(emissive & (from_kind == FROM_CAMERA),
                           w * params.emission, z3)
            alive = alive & ~emissive

            refr = params.is_refractive_kind
            mirror = (params.mtype == PERFECT_REFLECTIVE)

            # UNLIT returns diffuse from any provenance (the indirect
            # recursion enters non-emissive hits; UNLIT qualifies)
            unlit = alive & (params.mtype == UNLIT)
            L = L + vwhere(unlit, w * params.diffuse, z3)
            alive = alive & ~unlit

            diff = alive & ~refr & ~mirror
            tp = state['tp']

            # ============================== direct illumination (NEE,
            # PathTracing.hpp:287-312): no MIS weight, no MIN_DIVISOR kill;
            # geometry uses Ng for the shadow offset and the light's Ng for
            # cos_theta_prime, and cos_theta = wi.Ns is SIGNED
            ls = sample_light(scene, u(rng.LIGHT_PICK), u(rng.LIGHT_U),
                              u(rng.LIGHT_V), opts.tutu_light_pick,
                              opts.tutu_tri_sample)
            ls = ls._replace(pos=sg(ls.pos), ng=sg(ls.ng),
                             pdf_area=sg(ls.pdf_area))
            ray_inside = hit.ng.dot(wo) < 0.0       # Ng (PathTracing.hpp:293)
            sh_orig = hit.pos + vwhere(ray_inside, -hit.ng, hit.ng) * EPSILON
            to_l = ls.pos - sh_orig                 # light pos not offset
            dist_l = to_l.norm()
            sh_dir = to_l * (1.0 / jnp.maximum(dist_l, 1e-20))
            if opts.alpha_shadows:
                sh_trans = transmittance(scene, sh_orig, sh_dir, dist_l,
                                         mask=diff & ls.valid)
                blocked = sh_trans <= 0.0
            else:
                sh_trans = None
                blocked = occluded(scene, sh_orig, sh_dir, dist_l,
                                   mask=diff & ls.valid)
            p2l = (ls.pos - hit.pos).normalized(1e-20)
            cos_p = ls.ng.normalized(1e-20).dot(-p2l)
            cos_t = p2l.dot(hit.ns)                 # signed (hpp:306)
            dis2 = (ls.pos - hit.pos).norm2()
            f_r_l = bxdf_eval(params, p2l, wo, hit.ng, hit.ns, eta_scene,
                              types=types)
            # cos_theta_prime < 0 rejected, == 0 kept (hpp:300)
            dir_live = diff & ls.valid & ~blocked & (cos_p >= 0.0)
            denom = jnp.maximum(dis2 * ls.pdf_area, 1e-20)
            dir_scale = jnp.where(dir_live, cos_t * cos_p / denom, 0.0)
            if sh_trans is not None:
                dir_scale = dir_scale * sh_trans
            dir_illu = ls.emission * f_r_l * dir_scale

            # ============================== RR before sampling (hpp:315-319)
            tp_eff = vwhere(depth > opts.min_depth, tp, Vec3(one, one, one))
            rr_prob = sg(jnp.clip(tp_eff.max_component(), 0.0, 1.0)) \
                if opts.russian_roulette else one
            rr_survive = u(rng.RR) <= rr_prob

            # ============================== BSDF sample (shared by the
            # mirror / refractive / indirect-illumination cases)
            samp = bxdf_sample(params, wo, hit.ns, u(rng.BSDF_U0),
                               u(rng.BSDF_U1), u(rng.BSDF_LOTTERY), eta_scene,
                               opts.ggx_sample_bug, types=types)
            samp = samp._replace(wi=sg(samp.wi))
            wi = samp.wi
            mat_pdf = sg(bxdf_pdf(params, wi, wo, hit.ns, eta_scene,
                                  params.eta, types=types))

            # refractive lanes: calcForRefractive, identical to the MIS mode
            tir = samp.tir
            wi_tir = reflect(wo, hit.ns).normalized(1e-20)
            flip_r = wo.dot(hit.ng) < 0.0
            i_ns = vwhere(flip_r, -hit.ns, hit.ns)
            eta_pass = jnp.where(flip_r & (params.mtype == MICROFACET_T) & tir,
                                 params.eta, eta_scene)
            h_tir = (wo + wi_tir).normalized(1e-20)
            cos_h = jnp.abs(i_ns.dot(h_tir))
            pdf_tir_mt = d_ndf(h_tir, i_ns, params.roughness) * cos_h / \
                jnp.maximum(4.0 * wo.dot(h_tir), 1e-20)
            pdf_tir = jnp.where(params.mtype == MICROFACET_T, pdf_tir_mt, 1.0)
            wi = vwhere(refr & tir, wi_tir, wi)
            mat_pdf = jnp.where(refr & tir, sg(pdf_tir), mat_pdf)
            eta_for_eval = jnp.where(refr, eta_pass, eta_scene)
            eta_for_eval = jnp.where(refr & ~tir, eta_scene, eta_for_eval)
            f_r = bxdf_eval(params, wi, wo, hit.ng, hit.ns, eta_for_eval,
                            adjoint=False, tir=refr & tir, types=types)

            # commit dir_illu: a failed RR draw or a failed BSDF sample
            # returns sampleValue=0 BEFORE dir_illu is added — the reference
            # quirk that Russian roulette kills the already-computed direct
            # light too (PathTracing.hpp:317-327)
            commit = dir_live & rr_survive & samp.success
            L = L + vwhere(commit, w * dir_illu, z3)

            # ---- per-case continuation weights
            inv_pdf = jnp.where(mat_pdf >= MIN_DIVISOR,
                                1.0 / jnp.maximum(mat_pdf, 1e-20), 0.0)
            #   mirror: res * f_r * (Ng.wi signed) / pdf, no RR, no divisor
            #   gate (calcForMirror:60-66); pdf is 1 for the delta mirror
            cos_mirror = hit.ng.dot(wi)
            w_mirror = w * f_r * (cos_mirror / jnp.maximum(mat_pdf, 1e-20))
            #   refractive: Li * cos * f_r / pdf with pdf >= MIN_DIVISOR
            cos_refr = jnp.abs(hit.ng.dot(wi))
            w_refr = w * f_r * (cos_refr * inv_pdf)
            #   indirect: coe = f_r * |Ns.wi| / (pdf * rr_prob), gated by
            #   pdf*rr_prob >= MIN_DIVISOR (hpp:335-343)
            cos_ind = jnp.abs(hit.ns.dot(wi))
            pdf_rr = mat_pdf * rr_prob
            inv_pdf_rr = jnp.where(pdf_rr >= MIN_DIVISOR,
                                   1.0 / jnp.maximum(pdf_rr, 1e-20), 0.0)
            coe = f_r * (cos_ind * inv_pdf_rr)

            new_from = jnp.where(refr, FROM_REFRACT,
                                 jnp.where(mirror, FROM_MIRROR, FROM_INDIRECT))
            w_next = vwhere(refr, w_refr, vwhere(mirror, w_mirror, w * coe))
            #   mirror and refractive recursions reset tp to 1
            #   (calcForMirror:65, calcForRefractive:130)
            tp_next = vwhere(diff, tp_eff * coe, Vec3(one, one, one))

            alive_next = alive & jnp.where(
                refr, mat_pdf >= MIN_DIVISOR,
                jnp.where(mirror, True,
                          rr_survive & samp.success & (pdf_rr >= MIN_DIVISOR)))

            #   ray origins: indirect offsets along ±Ng (hpp:331-333),
            #   refractive along ±Ns (calcForRefractive:118-126), mirror
            #   always +Ns (calcForMirror:57)
            ray_o_diff = hit.pos + vwhere(wi.dot(hit.ng) < 0.0,
                                          -hit.ng, hit.ng) * EPSILON
            ray_o_refr = hit.pos + vwhere(wi.dot(hit.ns) < 0.0,
                                          -hit.ns, hit.ns) * EPSILON
            ray_o_mirr = hit.pos + hit.ns * EPSILON
            ray_o = vwhere(refr, ray_o_refr,
                           vwhere(mirror, ray_o_mirr, ray_o_diff))

            new_state = dict(
                o=ray_o, d=wi, L=L, w=w_next, tp=tp_next,
                alive=alive_next, from_kind=new_from,
                lane=state['lane'], smp=state['smp'], fkey=state['fkey'],
            )
            return new_state, None

        def epilogue(state):        # noqa: F811 — NEE-mode replacement
            # nothing pays at depth max_depth+1: traceRay returns 0 before
            # the miss/emissive checks (PathTracing.hpp:140), and the NEE
            # branch has no pending inline emissive strategy
            return state['L']

    # per-bounce rematerialization for the differentiable path: without it
    # the scan's backward stores every bounce intermediate ([N]-wide hit
    # records, BSDF terms, ...) as residuals in device memory; recomputing
    # the bounce from its carry trades that traffic for compute
    bounce_core = jax.checkpoint(bounce) if opts.differentiable else bounce

    sched = opts.compaction
    if not sched:
        depths = jnp.arange(opts.max_depth + 1, dtype=jnp.int32)
        if collect_alive:
            def counting_body(st, depth):
                cnt = jnp.sum(st['alive'].astype(jnp.int32))
                new, _ = bounce_core(st, depth)
                return new, cnt
            state, counts = jax.lax.scan(counting_body, state, depths)
            final = jnp.sum(state['alive'].astype(jnp.int32))
            return epilogue(state), jnp.concatenate([counts, final[None]])
        state, _ = jax.lax.scan(bounce_core, state, depths)
        if collect_overflow:
            return epilogue(state), jnp.zeros((), jnp.int32)
        return epilogue(state)

    # ---- compacted execution: unrolled bounce loop with a static shrink
    # schedule. Live lanes are gathered to the front of a smaller buffer
    # (the wavefront-compaction step that replaces RR lane waste); per-lane
    # radiance is flushed into a full-size film keyed by original lane id
    # before each shrink.
    film = (jnp.zeros((n,)), jnp.zeros((n,)), jnp.zeros((n,)))

    def flush(film, state):
        ids = state['fkey']
        return ((film[0].at[ids].add(state['L'].x, mode='drop'),
                 film[1].at[ids].add(state['L'].y, mode='drop'),
                 film[2].at[ids].add(state['L'].z, mode='drop')))

    def compact(state, film, k, depth):
        """Shrink the wavefront to k lanes, flushing the radiance of the
        lanes that leave it into the film. If more than k lanes are live
        (the schedule under-predicted), a uniformly random k-subset
        survives and is upweighted by cnt/k — stochastic lane roulette, an
        UNBIASED overflow policy (inclusion probability k/cnt exactly
        compensated), unlike the silent energy loss of truncation. A
        runtime warning is printed when it engages. Compaction costs one
        full flush plus a packed-row-gather reorder (see _permute_state)."""
        cnt = jnp.sum(state['alive'].astype(jnp.int32))
        over = cnt > k
        film = flush(film, state)
        pri = rng.uniform(seed, state['lane'], state['smp'], depth,
                          rng.COMPACT)
        order = jnp.argsort(jnp.where(state['alive'], pri, 2.0))
        new = _permute_state(state, order[:k])
        new['L'] = _zeros3(k)
        new['alive'] = new['alive'] & (jnp.arange(k) < cnt)
        jax.lax.cond(
            over,
            lambda: jax.debug.print(
                "tuturenderer_tpu: compaction overflow at depth {d}: "
                "{c} live lanes > buffer {k}; surviving lanes "
                "upweighted (unbiased) — widen opts.compaction for "
                "lower variance", d=depth, c=cnt, k=k),
            lambda: None)
        factor = jnp.where(over, cnt.astype(jnp.float32) / k, 1.0)
        # scaling w and w_em also scales the continuation weight
        # (w_em * rr_inv), so the roulette upweight covers every payout
        for f in ('w', 'w_em'):
            if f in new:
                new[f] = new[f] * factor
        return new, film, jnp.maximum(cnt - k, 0)

    # group consecutive equal fractions into segments so each segment is a
    # single lax.scan over a shared bounce body at one width — the unrolled
    # per-bounce variant produced a 7x larger module that the compiler
    # struggles with at 1M lanes
    segments = []   # (width_fraction, [depths])
    for depth in range(opts.max_depth + 1):
        frac = sched[depth] if depth < len(sched) else sched[-1]
        if segments and segments[-1][0] == frac:
            segments[-1][1].append(depth)
        else:
            segments.append((frac, [depth]))

    def seg_width(frac):
        return min(int(-(-int(n * frac) // 1024) * 1024), n)

    cur = state
    over_total = jnp.zeros((), jnp.int32)
    for frac, depths in segments:
        k = seg_width(frac)
        if k < cur['o'].x.shape[0]:
            cur, film, over = compact(cur, film, k, depths[0])
            over_total = over_total + over
        if len(depths) == 1:
            # single-bounce segment, unrolled (no scan wrapper)
            cur, _ = bounce_core(cur, jnp.int32(depths[0]))
        else:
            cur, _ = jax.lax.scan(bounce_core, cur,
                                  jnp.asarray(depths, dtype=jnp.int32))
    L_final = epilogue(cur)
    ids = cur['fkey']
    film = (film[0].at[ids].add(L_final.x, mode='drop'),
            film[1].at[ids].add(L_final.y, mode='drop'),
            film[2].at[ids].add(L_final.z, mode='drop'))
    out = Vec3(film[0], film[1], film[2])
    if collect_overflow:
        return out, over_total
    return out


def render_sample(scene: SceneData, cam: Camera, px, py, lane, sample_idx,
                  seed, opts: RenderOptions, collect_overflow: bool = False):
    if opts.jitter:
        jx = rng.uniform(seed, lane, sample_idx, 0, rng.PIXEL_JX)
        jy = rng.uniform(seed, lane, sample_idx, 0, rng.PIXEL_JY)
        o, d, _ = primary_ray(cam, px, py, jx, jy)
    else:
        o, d, _ = primary_ray(cam, px, py)
    out = trace_rays(scene, cam, o, d, lane, sample_idx, seed, opts,
                     collect_overflow=collect_overflow)
    L, over = out if collect_overflow else (out, None)
    # NaN sample rejection (PathTracing.hpp:510-511)
    bad = jnp.isnan(L.x) | jnp.isnan(L.y) | jnp.isnan(L.z)
    L = vwhere(bad, _zeros3(px.shape[0]), L)
    return (L, over) if collect_overflow else L


def _block_order(width: int, height: int, block: int = 32):
    """Pixel visit order in (block x block) screen tiles. Consecutive
    groups of block^2 lanes then cover one compact screen square, so
    neighbouring lanes trace coherent rays (BVH traversal in lockstep
    visits similar nodes)."""
    import numpy as np
    ys, xs = np.mgrid[0:height, 0:width]
    bw = -(-width // block)
    key = ((ys // block) * bw + (xs // block)) * (block * block) \
        + (ys % block) * block + (xs % block)
    return np.argsort(key.reshape(-1), kind="stable").astype(np.int32)


@partial(jax.jit, static_argnames=("opts", "stats"))
def render(scene: SceneData, cam: Camera, opts: RenderOptions, seed=0,
           sample_base=0, stats: bool = False):
    """Full-frame render -> [H, W, 3] linear radiance. ``sample_base``
    shifts the global sample indices (counter-based RNG) so chunked/
    progressive renders continue the exact stream.

    Lanes are emitted in 32x32 screen-block order (see _block_order), and
    ``opts.samples_per_launch`` > 1 batches that many spp into one
    wavefront (lane = (sample, blocked-pixel)) — both purely for ray-tile
    coherence; the RNG stream and the per-pixel sums are identical to the
    one-sample row-major schedule.

    ``stats=True`` returns (img, {"compaction_overflow": i32}) — the
    total live lanes dropped by overflow roulette (unbiased, but a
    variance signal the caller should surface)."""
    import numpy as _np
    p = cam.n_pixels
    order_np = _block_order(cam.width, cam.height)
    order = jnp.asarray(order_np)
    # inverse permutation, host-side: the film accumulates in LANE order
    # with pure adds (no per-sample scatter) and unpermutes ONCE at the
    # end via a gather
    inv_order = jnp.asarray(_np.argsort(order_np).astype(_np.int32))
    sb = max(1, min(opts.samples_per_launch or 1, opts.spp))
    while opts.spp % sb:
        sb -= 1
    pix = jnp.tile(order, sb)                      # [p*sb] pixel id per lane
    px = pix % cam.width
    py = pix // cam.width
    soff = jnp.repeat(jnp.arange(sb, dtype=jnp.int32), p)

    def body(s, acc):
        L, over = render_sample(scene, cam, px, py, pix,
                                sample_base + s * sb + soff, seed, opts,
                                collect_overflow=True)
        return (acc[0] + L.x, acc[1] + L.y, acc[2] + L.z, acc[3] + over)

    zeros = jnp.zeros((p * sb,), jnp.float32)
    acc = jax.lax.fori_loop(0, opts.spp // sb, body,
                            (zeros, zeros, zeros, jnp.zeros((), jnp.int32)))
    inv = 1.0 / opts.spp
    img = jnp.stack([a.reshape(sb, p).sum(axis=0) * inv for a in acc[:3]],
                    axis=-1)
    img = img[inv_order].reshape(cam.height, cam.width, 3)
    if stats:
        return img, {"compaction_overflow": acc[3]}
    return img
