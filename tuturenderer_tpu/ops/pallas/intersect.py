"""Dense ray/triangle intersection kernel for the GPU (Pallas, Triton route).

The XLA form (ops/intersect.py ``_tri_chunk_best``) builds ``[N, C]``
t/u/v tiles, takes an argmin and gathers the winner's t, u and v. Here
each program owns a 1-D block of ``BLOCK`` rays and keeps every ray's
running best in registers while it walks the triangle table; nothing but
the result leaves the chip's registers: 16 bytes per ray (t, idx, u, v).
Shadow rays reuse it with the endpoint rule (ops/intersect.py
``occluded``).

Triangle table (``pack_triangles``): flat ``[T_pad * 12]`` float32 rows
v0(3) e1(3) e2(3) n_hat(3), ``T_pad`` a multiple of ``TRI_TILE`` (a power
of two). Padding rows are all zero, so their det is 0 and the acceptance
test rejects them. The kernel loops over tiles of ``TRI_TILE`` triangles;
within a tile the triangles are unrolled, each one a broadcast scalar
load.

One triangle test (Moller-Trumbore), with the acceptance rules of
ops/intersect.py: |dir . n_hat| >= 1e-4, det != 0, t > 0, u > 0, v > 0,
1 - u - v > 0. All arithmetic is float32 and elementwise (no matrix
product, so no TF32 rounding can enter).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

F32_MAX = 3.4e38  # python float: jnp constants get captured as kernel consts
PARALLEL_EPS = 1e-4
ROW = 12          # floats per packed triangle
# launch shape, from an H100 sweep of tiles of 4-16 triangles, blocks of
# 128-1024 rays and 1-8 warps at 1M rays: most settings came within a few
# per cent of each other; 1 warp per 512+ rays was several times slower
TRI_TILE = 4      # triangles per unrolled inner tile (power of two)
BLOCK = 256       # rays per program (power of two)
NUM_WARPS = 2


def _tri_test(tri_ref, i, o, d):
    """Moller-Trumbore of triangle ``i`` against the block's rays ->
    (ok, t, u, v) with the reference's acceptance rules."""
    base = i * ROW
    (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
     nux, nuy, nuz) = [tri_ref[base + j] for j in range(ROW)]
    ox, oy, oz = o
    dx, dy, dz = d
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    # s1 = d x e2 ; s2 = s x e1  (Triangle.hpp:25-47 semantics)
    s1x = dy * e2z - dz * e2y
    s1y = dz * e2x - dx * e2z
    s1z = dx * e2y - dy * e2x
    s2x = sy * e1z - sz * e1y
    s2y = sz * e1x - sx * e1z
    s2z = sx * e1y - sy * e1x
    det = s1x * e1x + s1y * e1y + s1z * e1z
    dn = dx * nux + dy * nuy + dz * nuz
    inv = 1.0 / jnp.where(det == 0.0, 1.0, det)
    t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv
    u = (s1x * sx + s1y * sy + s1z * sz) * inv
    v = (s2x * dx + s2y * dy + s2z * dz) * inv
    ok = (jnp.abs(dn) >= PARALLEL_EPS) & (det != 0.0) & (t > 0.0) & \
        (u > 0.0) & (v > 0.0) & (1.0 - u - v > 0.0)
    return ok, t, u, v


def _nearest_kernel(tri_ref, ox, oy, oz, dx, dy, dz,
                    t_out, idx_out, u_out, v_out, *, n_tiles: int):
    o = (ox[...], oy[...], oz[...])
    d = (dx[...], dy[...], dz[...])
    shape = o[0].shape

    def tile(k, carry):
        for j in range(TRI_TILE):
            t_best, i_best, u_best, v_best = carry
            i = k * TRI_TILE + j
            ok, t, u, v = _tri_test(tri_ref, i, o, d)
            ok = ok & (t < t_best)
            carry = (jnp.where(ok, t, t_best), jnp.where(ok, i, i_best),
                     jnp.where(ok, u, u_best), jnp.where(ok, v, v_best))
        return carry

    init = (jnp.full(shape, F32_MAX, jnp.float32),
            jnp.full(shape, -1, jnp.int32),
            jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    t_best, i_best, u_best, v_best = jax.lax.fori_loop(0, n_tiles, tile, init)
    t_out[...] = t_best
    idx_out[...] = i_best
    u_out[...] = u_best
    v_out[...] = v_best


def pack_triangles(scene) -> jnp.ndarray:
    """Flat triangle table, rows padded with zeros to a multiple of
    TRI_TILE."""
    e1 = scene.tv1 - scene.tv0
    e2 = scene.tv2 - scene.tv0
    n = e1.cross(e2)
    nu = n * (1.0 / jnp.maximum(n.norm(), 1e-30))
    rows = jnp.stack([
        scene.tv0.x, scene.tv0.y, scene.tv0.z,
        e1.x, e1.y, e1.z,
        e2.x, e2.y, e2.z,
        nu.x, nu.y, nu.z,
    ], axis=1)
    pad = -scene.n_tris % TRI_TILE
    return jnp.pad(rows, ((0, pad), (0, 0))).reshape(-1)


def tri_nearest(scene, orig, d, *, interpret: bool = False):
    """Nearest triangle hit -> (t, idx, u, v), flat [N]; t = F32_MAX and
    idx = -1 on a miss. Rays are padded to a multiple of ``BLOCK``."""
    n = orig.x.shape[0]
    orig, d = jax.lax.stop_gradient((orig, d))   # no JVP through a kernel
    pad = -n % BLOCK
    rays = [jnp.pad(a, (0, pad)) for a in
            (orig.x, orig.y, orig.z, d.x, d.y, d.z)]
    tri = pack_triangles(scene)
    spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    t, idx, u, v = pl.pallas_call(
        functools.partial(_nearest_kernel,
                          n_tiles=tri.shape[0] // (ROW * TRI_TILE)),
        out_shape=[jax.ShapeDtypeStruct((n + pad,), dt) for dt in
                   (jnp.float32, jnp.int32, jnp.float32, jnp.float32)],
        grid=((n + pad) // BLOCK,),
        in_specs=[pl.BlockSpec(tri.shape, lambda i: (0,))] + [spec] * 6,
        out_specs=[spec] * 4,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="tri_nearest",
    )(tri, *rays)
    return t[:n], idx[:n], u[:n], v[:n]
