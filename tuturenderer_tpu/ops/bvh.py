"""BVH: host-side build + flattened-array stack traversal on device.

The reference builds a binary BVH with one primitive per leaf by sorting
on the longest-axis centroid and splitting at the median
(BVHAccel::recursiveBuild, BVH.hpp:47-123), then traverses recursively
visiting BOTH children unconditionally (BVH.hpp:145-167). The
re-design:

- build on host (numpy) with the same median-split heuristic but
  multi-primitive leaves (LEAF_SIZE) — pointer nodes become flat arrays
  (bounds, child indices, leaf ranges over a primitive permutation);
- traversal is a vectorized ``lax.while_loop``: every ray keeps its own
  explicit stack and pops until empty, with ordered descent (near child
  first) and t-based early-out — strictly better than the reference's
  both-children recursion while returning identical nearest hits;
- slab test semantics match BoundBox::IntersectRay (BoundBox.hpp:55-92):
  accept when t_enter <= t_exit and t_exit >= 0.

Used for scenes too large for the dense streaming path (ops/intersect.py
remains the fast path for small scenes, selected by BVH_THRESHOLD).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.data import TRIANGLE, SceneData
from ..utils.vec import Vec3
from .intersect import F32_MAX, PARALLEL_EPS, HitCore

LEAF_SIZE = 4
MAX_STACK = 64
# dense streaming below this many triangles, BVH traversal above. Tuned on
# an earlier accelerator; not measured on the H100 (ROADMAP S2).
BVH_THRESHOLD = 4096


class FlatBVH(NamedTuple):
    """Flattened binary BVH over the scene's triangles."""
    bb_min: jnp.ndarray   # [M, 3]
    bb_max: jnp.ndarray   # [M, 3]
    left: jnp.ndarray     # [M] child index or -1
    right: jnp.ndarray    # [M]
    start: jnp.ndarray    # [M] leaf primitive range start
    count: jnp.ndarray    # [M] leaf primitive count (0 for inner)
    prim: jnp.ndarray     # [T] permutation into the triangle arrays


def build_bvh(verts: np.ndarray, leaf_size: int = LEAF_SIZE,
              prefer_native: bool = True) -> FlatBVH:
    """verts: [T, 3, 3] triangle vertices (host numpy). Uses the native
    C++ builder (native/host.cpp) when available; pure-numpy fallback."""
    if prefer_native and verts.shape[0] > 0:
        try:
            from ..native import bvh_build
            r = bvh_build(verts, leaf_size)
            if r is not None:
                return FlatBVH(
                    bb_min=jnp.asarray(r['bb_min']),
                    bb_max=jnp.asarray(r['bb_max']),
                    left=jnp.asarray(r['left']),
                    right=jnp.asarray(r['right']),
                    start=jnp.asarray(r['start']),
                    count=jnp.asarray(r['count']),
                    prim=jnp.asarray(r['prim']))
        except Exception:
            pass
    return _build_bvh_py(verts, leaf_size)


def _build_bvh_py(verts: np.ndarray, leaf_size: int = LEAF_SIZE) -> FlatBVH:
    t = verts.shape[0]
    lo = verts.min(axis=1)   # [T,3]
    hi = verts.max(axis=1)
    centroid = 0.5 * (lo + hi)

    bb_min, bb_max, left, right, start, count = [], [], [], [], [], []
    order = []

    def new_node():
        bb_min.append(None)
        bb_max.append(None)
        left.append(-1)
        right.append(-1)
        start.append(0)
        count.append(0)
        return len(bb_min) - 1

    def rec(idx: np.ndarray) -> int:
        node = new_node()
        bb_min[node] = lo[idx].min(axis=0)
        bb_max[node] = hi[idx].max(axis=0)
        if len(idx) <= leaf_size:
            start[node] = len(order)
            count[node] = len(idx)
            order.extend(idx.tolist())
            return node
        # median split on the longest axis of the node bound
        # (BVH.hpp:81-113 semantics)
        ext = bb_max[node] - bb_min[node]
        axis = int(np.argmax(ext))
        srt = idx[np.argsort(centroid[idx, axis], kind="stable")]
        mid = len(srt) // 2
        l = rec(srt[:mid])
        r = rec(srt[mid:])
        left[node] = l
        right[node] = r
        return node

    if t == 0:
        return FlatBVH(
            bb_min=jnp.zeros((1, 3)), bb_max=jnp.zeros((1, 3)),
            left=jnp.full((1,), -1, jnp.int32),
            right=jnp.full((1,), -1, jnp.int32),
            start=jnp.zeros((1,), jnp.int32),
            count=jnp.zeros((1,), jnp.int32),
            prim=jnp.zeros((0,), jnp.int32))

    import sys
    rec_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(rec_limit, 10000))
    try:
        rec(np.arange(t))
    finally:
        sys.setrecursionlimit(rec_limit)

    return FlatBVH(
        bb_min=jnp.asarray(np.stack(bb_min).astype(np.float32)),
        bb_max=jnp.asarray(np.stack(bb_max).astype(np.float32)),
        left=jnp.asarray(np.asarray(left, np.int32)),
        right=jnp.asarray(np.asarray(right, np.int32)),
        start=jnp.asarray(np.asarray(start, np.int32)),
        count=jnp.asarray(np.asarray(count, np.int32)),
        prim=jnp.asarray(np.asarray(order, np.int32)))


def _slab_test(bvh: FlatBVH, node, ox, oy, oz, ix, iy, iz, t_best):
    """AABB slab test (BoundBox.hpp:55-92) with early-out against the
    current best t. Returns (hit, t_enter)."""
    mn = bvh.bb_min[node]   # [N,3]
    mx = bvh.bb_max[node]
    t0x = (mn[:, 0] - ox) * ix
    t1x = (mx[:, 0] - ox) * ix
    t0y = (mn[:, 1] - oy) * iy
    t1y = (mx[:, 1] - oy) * iy
    t0z = (mn[:, 2] - oz) * iz
    t1z = (mx[:, 2] - oz) * iz
    tmin = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                   jnp.minimum(t0y, t1y)),
                       jnp.minimum(t0z, t1z))
    tmax = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                   jnp.maximum(t0y, t1y)),
                       jnp.maximum(t0z, t1z))
    hit = (tmin <= tmax) & (tmax >= 0.0) & (tmin < t_best)
    return hit, tmin


def _leaf_intersect(scene: SceneData, bvh: FlatBVH, node,
                    o: Vec3, d: Vec3, best: HitCore, active) -> HitCore:
    """Moller-Trumbore over a leaf's primitive slots (masked)."""
    for k in range(LEAF_SIZE):
        slot = bvh.start[node] + k
        in_leaf = (k < bvh.count[node]) & active
        ti = bvh.prim[jnp.clip(slot, 0, bvh.prim.shape[0] - 1)]
        v0 = Vec3(scene.tv0.x[ti], scene.tv0.y[ti], scene.tv0.z[ti])
        v1 = Vec3(scene.tv1.x[ti], scene.tv1.y[ti], scene.tv1.z[ti])
        v2 = Vec3(scene.tv2.x[ti], scene.tv2.y[ti], scene.tv2.z[ti])
        e1 = v1 - v0
        e2 = v2 - v0
        nrm = e1.cross(e2)
        n_unit = nrm * (1.0 / jnp.maximum(nrm.norm(), 1e-30))
        s = o - v0
        s1 = d.cross(e2)
        s2 = s.cross(e1)
        det = s1.dot(e1)
        dn = d.dot(n_unit)
        inv = 1.0 / jnp.where(det == 0.0, 1.0, det)
        t = s2.dot(e2) * inv
        u = s1.dot(s) * inv
        v = s2.dot(d) * inv
        ok = in_leaf & (jnp.abs(dn) >= PARALLEL_EPS) & (det != 0.0) & \
            (t > 0.0) & (u > 0.0) & (v > 0.0) & (1.0 - u - v > 0.0) & \
            (t < best.t)
        best = HitCore(
            t=jnp.where(ok, t, best.t),
            kind=jnp.where(ok, TRIANGLE, best.kind),
            idx=jnp.where(ok, ti, best.idx),
            bu=jnp.where(ok, u, best.bu),
            bv=jnp.where(ok, v, best.bv))
    return best


def bvh_intersect(scene: SceneData, bvh: FlatBVH, o: Vec3, d: Vec3) -> HitCore:
    """Nearest-hit traversal, vectorized over rays with per-ray stacks.

    Tangents stop here, as at the dense kernel's boundary: reverse mode
    cannot pass a ``while_loop``, and rays that come out of a compaction
    gather carry (zero-valued) tangents from the lanes' weights."""
    o, d = jax.lax.stop_gradient((o, d))
    n = o.x.shape[0]
    inv = lambda c: 1.0 / jnp.where(c == 0.0, 1e-30, c)
    ix, iy, iz = inv(d.x), inv(d.y), inv(d.z)

    stack = jnp.zeros((n, MAX_STACK), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)          # root pre-pushed at slot 0
    best = HitCore(t=jnp.full((n,), F32_MAX),
                   kind=jnp.zeros((n,), jnp.int32),
                   idx=jnp.full((n,), -1, jnp.int32),
                   bu=jnp.zeros((n,)), bv=jnp.zeros((n,)))

    def cond(carry):
        stack, sp, best = carry
        return jnp.any(sp > 0)

    def body(carry):
        stack, sp, best = carry
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = stack[jnp.arange(n), top]
        sp = jnp.where(active, sp - 1, sp)

        hit_box, _ = _slab_test(bvh, node, o.x, o.y, o.z, ix, iy, iz, best.t)
        hit_box = hit_box & active
        is_leaf = bvh.left[node] < 0

        # leaf: test primitives
        best = _leaf_intersect(scene, bvh, node, o, d, best,
                               hit_box & is_leaf)

        # inner: push children ordered near-first (far pushed first)
        push = hit_box & ~is_leaf
        l = bvh.left[node]
        r = bvh.right[node]
        _, tl = _slab_test(bvh, l, o.x, o.y, o.z, ix, iy, iz, best.t)
        _, tr = _slab_test(bvh, r, o.x, o.y, o.z, ix, iy, iz, best.t)
        near = jnp.where(tl <= tr, l, r)
        far = jnp.where(tl <= tr, r, l)
        rows = jnp.arange(n)
        s0 = jnp.minimum(sp, MAX_STACK - 1)
        stack = stack.at[rows, s0].set(jnp.where(push, far, stack[rows, s0]))
        sp = jnp.where(push, jnp.minimum(sp + 1, MAX_STACK), sp)
        s1 = jnp.minimum(sp, MAX_STACK - 1)
        stack = stack.at[rows, s1].set(jnp.where(push, near, stack[rows, s1]))
        sp = jnp.where(push, jnp.minimum(sp + 1, MAX_STACK), sp)
        return stack, sp, best

    _, _, best = jax.lax.while_loop(cond, body, (stack, sp, best))
    miss = best.t >= F32_MAX
    return best._replace(idx=jnp.where(miss, -1, best.idx))


def bvh_occluded(scene: SceneData, bvh: FlatBVH, o: Vec3, d: Vec3,
                 dist) -> jnp.ndarray:
    """Dedicated any-hit traversal (the reference's hasIntersection,
    BVH.hpp:170-194): no nearest-hit bookkeeping, and a lane STOPS
    traversing the moment any primitive blocks it (stack cleared) —
    the early-out the nearest-hit fallback could not give the occlusion
    path. Accept rule: t < dist with the FLOAT_EQUAL endpoint guard
    (BVH.hpp:184). Tangents stop here, as in bvh_intersect."""
    o, d, dist = jax.lax.stop_gradient((o, d, dist))
    n = o.x.shape[0]
    inv = lambda c: 1.0 / jnp.where(c == 0.0, 1e-30, c)
    ix, iy, iz = inv(d.x), inv(d.y), inv(d.z)
    dist = jnp.broadcast_to(jnp.asarray(dist), (n,))

    stack = jnp.zeros((n, MAX_STACK), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)          # root pre-pushed at slot 0
    blocked = jnp.zeros((n,), bool)

    def leaf_any(node, active):
        hit = jnp.zeros((n,), bool)
        for k in range(LEAF_SIZE):
            slot = bvh.start[node] + k
            in_leaf = (k < bvh.count[node]) & active
            ti = bvh.prim[jnp.clip(slot, 0, bvh.prim.shape[0] - 1)]
            v0 = Vec3(scene.tv0.x[ti], scene.tv0.y[ti], scene.tv0.z[ti])
            v1 = Vec3(scene.tv1.x[ti], scene.tv1.y[ti], scene.tv1.z[ti])
            v2 = Vec3(scene.tv2.x[ti], scene.tv2.y[ti], scene.tv2.z[ti])
            e1 = v1 - v0
            e2 = v2 - v0
            nrm = e1.cross(e2)
            n_unit = nrm * (1.0 / jnp.maximum(nrm.norm(), 1e-30))
            s = o - v0
            s1 = d.cross(e2)
            s2 = s.cross(e1)
            det = s1.dot(e1)
            dn = d.dot(n_unit)
            invd = 1.0 / jnp.where(det == 0.0, 1.0, det)
            t = s2.dot(e2) * invd
            u = s1.dot(s) * invd
            v = s2.dot(d) * invd
            ok = in_leaf & (jnp.abs(dn) >= PARALLEL_EPS) & (det != 0.0) & \
                (t > 0.0) & (u > 0.0) & (v > 0.0) & (1.0 - u - v > 0.0) & \
                (t < dist) & (jnp.abs(t - dist) >= PARALLEL_EPS)
            hit = hit | ok
        return hit

    def cond(carry):
        stack, sp, blocked = carry
        return jnp.any(sp > 0)

    def body(carry):
        stack, sp, blocked = carry
        active = (sp > 0) & ~blocked
        top = jnp.maximum(sp - 1, 0)
        node = stack[jnp.arange(n), top]
        sp = jnp.where(sp > 0, sp - 1, sp)

        # slab test bounded by the shadow-ray length, not a best-t
        hit_box, _ = _slab_test(bvh, node, o.x, o.y, o.z, ix, iy, iz, dist)
        hit_box = hit_box & active
        is_leaf = bvh.left[node] < 0

        newly = leaf_any(node, hit_box & is_leaf)
        blocked = blocked | newly
        # blocked lanes stop traversing entirely
        sp = jnp.where(newly, 0, sp)

        push = hit_box & ~is_leaf & ~blocked
        l = bvh.left[node]
        r = bvh.right[node]
        rows = jnp.arange(n)
        s0 = jnp.minimum(sp, MAX_STACK - 1)
        stack = stack.at[rows, s0].set(jnp.where(push, l, stack[rows, s0]))
        sp = jnp.where(push, jnp.minimum(sp + 1, MAX_STACK), sp)
        s1 = jnp.minimum(sp, MAX_STACK - 1)
        stack = stack.at[rows, s1].set(jnp.where(push, r, stack[rows, s1]))
        sp = jnp.where(push, jnp.minimum(sp + 1, MAX_STACK), sp)
        return stack, sp, blocked

    _, _, blocked = jax.lax.while_loop(cond, body, (stack, sp, blocked))
    return blocked
