"""3-vector math over structure-of-arrays.

The reference renderer (TutuRenderer, include/Vector.hpp) uses an AoS
``Vector3f`` class. Here each component is its own ``[N]`` array, so
every wavefront operation reads and writes contiguous, fully used rows.
``Vec3`` is a NamedTuple of three arrays with full elementwise algebra;
XLA fuses the component ops exactly as it would a hand-written kernel.

All functions work equally on scalars, numpy arrays and traced jnp arrays.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import jax
import jax.numpy as jnp

Array = jnp.ndarray
Scalar = Union[float, Array]


class Vec3(NamedTuple):
    x: Array
    y: Array
    z: Array

    # ---- algebra ----
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __rtruediv__(self, o):
        return Vec3(o / self.x, o / self.y, o / self.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # ---- geometry ----
    def dot(self, o: "Vec3") -> Array:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm2(self) -> Array:
        return self.dot(self)

    def norm(self) -> Array:
        return jnp.sqrt(self.norm2())

    def normalized(self, eps: float = 0.0) -> "Vec3":
        if eps:
            # clamp INSIDE the sqrt: sqrt'(0) is inf and would poison
            # reverse-mode AD through masked-out lanes (the where-trap)
            inv = jax.lax.rsqrt(jnp.maximum(self.norm2(), eps * eps))
        else:
            inv = 1.0 / self.norm()
        return self * inv

    def max_component(self) -> Array:
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def abs(self) -> "Vec3":
        return Vec3(jnp.abs(self.x), jnp.abs(self.y), jnp.abs(self.z))

    # ---- structural ----
    def astype(self, dtype) -> "Vec3":
        return Vec3(self.x.astype(dtype), self.y.astype(dtype), self.z.astype(dtype))

    def stack(self, axis: int = -1) -> Array:
        """Materialize as a dense [..., 3] array (host/IO boundary only)."""
        return jnp.stack([self.x, self.y, self.z], axis=axis)

    @property
    def shape(self):
        return jnp.shape(self.x)


def vec3(x: Scalar, y: Scalar = None, z: Scalar = None) -> Vec3:
    if y is None:
        y = x
        z = x
    return Vec3(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                jnp.asarray(z, jnp.float32))


def from_stacked(a: Array) -> Vec3:
    """[..., 3] dense array -> Vec3 (host/IO boundary only)."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def where(mask: Array, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.where(mask, a.x, b.x), jnp.where(mask, a.y, b.y),
                jnp.where(mask, a.z, b.z))


def select_scalar(mask: Array, a: Scalar, b: Scalar) -> Array:
    return jnp.where(mask, a, b)


def lerp(v0: Vec3, v1: Vec3, t: Scalar) -> Vec3:
    """v0 + t * (v1 - v0)  (reference global.hpp:39-50 semantics)."""
    return v0 + (v1 - v0) * t


def reflect(incident: Vec3, n: Vec3) -> Vec3:
    """Mirror direction of ``incident`` about ``n``.

    Matches reference ``getReflectionDir`` (global.hpp:264-269): both args
    normalized, ``incident`` points AWAY from the surface; result is the
    outgoing mirror direction 2(N.I)N - I (unnormalized there, unit here
    when inputs are unit).
    """
    return n * (2.0 * n.dot(incident)) - incident


def refract(incident: Vec3, n: Vec3, eta_i: Scalar, eta_t: Scalar):
    """Transmitted direction; mirrors reference ``getRefractionDir``
    (global.hpp:272-301). ``incident`` points away from the surface.

    Returns (dir: Vec3, tir: bool-array). On total internal reflection the
    direction is zeroed and ``tir`` is True (the reference signals TIR with
    a zero vector).
    """
    cos_i = jnp.clip(n.dot(incident), -1.0, 1.0)
    flip = cos_i < 0.0
    n = where(flip, -n, n)
    cos_i = jnp.abs(cos_i)
    sin_i = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_i * cos_i))
    sin_t = (eta_i / eta_t) * sin_i
    tir = sin_i > (eta_t / eta_i)
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_t * sin_t))
    d = (-n) * cos_t + (n * cos_i - incident) * (eta_i / eta_t)
    zero = jnp.zeros_like(d.x)
    d = where(tir, Vec3(zero, zero, zero), d)
    return d, tir


def orthonormal_basis(n: Vec3):
    """Build (s, t) completing unit normal ``n`` to an ONB.

    Same construction as reference ``SphereLocal2world`` (global.hpp:387-410):
    pick helper axis a = +y when |n.x|>0.9 else +x; s = normalize(n x a);
    t = n x s.
    """
    big = jnp.abs(n.x) > 0.9
    ax = jnp.where(big, 0.0, 1.0)
    ay = jnp.where(big, 1.0, 0.0)
    a = Vec3(ax, ay, jnp.zeros_like(ax))
    s = n.cross(a).normalized(1e-20)
    t = n.cross(s)
    return s, t


def local_to_world(n: Vec3, local: Vec3) -> Vec3:
    """Map ``local`` (z-up) into the hemisphere frame of unit normal ``n``.

    Reference ``SphereLocal2world`` (global.hpp:387-410), including its
    final normalize.
    """
    s, t = orthonormal_basis(n)
    return (s * local.x + t * local.y + n * local.z).normalized(1e-20)
