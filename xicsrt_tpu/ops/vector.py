"""Vector math primitives (jnp, stateless).

Vectorized replacements for the reference ``xicsrt/tools/xicsrt_math.py``:
everything is batched over the leading ray axis, branch-free, and safe to
differentiate (no NaN-producing normalizations on masked lanes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Row-wise dot product for [..., 3] arrays."""
    return jnp.sum(a * b, axis=-1)


def magnitude(v: jax.Array) -> jax.Array:
    return jnp.sqrt(jnp.sum(v * v, axis=-1))


def normalize(v: jax.Array, eps: float = 0.0) -> jax.Array:
    """Normalize along the last axis.

    With ``eps > 0`` the norm is clamped away from zero so masked/degenerate
    lanes produce finite values instead of NaN (important for gradients).
    """
    n = magnitude(v)
    if eps:
        n = jnp.maximum(n, eps)
    return v / n[..., None]


def safe_normalize(v: jax.Array) -> jax.Array:
    return normalize(v, eps=1e-30)


def reflect(direction: jax.Array, normal: jax.Array) -> jax.Array:
    """Specular reflection D' = D - 2 (D.n) n.

    Physics per ``_InteractMirror.py:29-42``.
    """
    return direction - 2.0 * dot(direction, normal)[..., None] * normal


def vector_rotate(a: jax.Array, b: jax.Array, theta) -> jax.Array:
    """Rodrigues rotation of vector(s) ``a`` about unit axis ``b`` by theta.

    Same math as ``xicsrt_math.vector_rotate`` (``xicsrt_math.py:72-99``).
    """
    theta = jnp.asarray(theta)
    c = jnp.cos(theta)[..., None]
    s = jnp.sin(theta)[..., None]
    return (
        a * c
        + jnp.cross(b, a) * s
        + b * dot(b, a)[..., None] * (1.0 - c)
    )


def rotation_matrix(axis: jax.Array, theta) -> jax.Array:
    """Rotation matrix about a unit axis (quaternion-derived form,
    cf. ``xicsrt_math.rotation_matrix``)."""
    axis = normalize(axis, eps=1e-30)
    a = jnp.cos(theta / 2.0)
    bcd = -axis * jnp.sin(theta / 2.0)
    b, c, d = bcd[0], bcd[1], bcd[2]
    return jnp.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c + a * d), 2 * (b * d - a * c)],
            [2 * (b * c - a * d), a * a + c * c - b * b - d * d, 2 * (c * d + a * b)],
            [2 * (b * d + a * c), 2 * (c * d - a * b), a * a + d * d - b * b - c * c],
        ]
    )


def orthogonal_basis(normal: jax.Array, hint1: jax.Array, hint2: jax.Array) -> jax.Array:
    """Per-ray orthonormal basis [N,3,3] with rows (o2, o1, normal).

    The reference builds per-ray rotation bases as
    ``o1 = cross(n, xaxis) + cross(n, zaxis)`` then ``o2 = cross(n, o1)``
    (``_XicsrtSourceGeneric.py:282-292``); replicated here so xy-asymmetric
    angular distributions orient identically.
    """
    o1 = jnp.cross(normal, hint1) + jnp.cross(normal, hint2)
    o1 = safe_normalize(o1)
    o2 = jnp.cross(normal, o1)
    o2 = safe_normalize(o2)
    return jnp.stack([o2, o1, normal], axis=-2)


def rotate_to_frame(local_dirs: jax.Array, basis: jax.Array) -> jax.Array:
    """Map local z-aligned unit vectors through per-ray bases.

    ``local_dirs``: [N,3]; ``basis``: [N,3,3] rows (x,y,z) -> returns [N,3]
    global vectors. Equivalent of ``einsum('ij,ijk->ik', dir_local, R)``,
    written elementwise so it runs at full precision (a K=3 dot_general
    may run at reduced input precision, TF32 on a GPU, which is fatal for
    Bragg-scale angular accuracy).
    """
    return jnp.sum(local_dirs[:, :, None] * basis, axis=1)


def cylindrical_from_cartesian(p: jax.Array) -> jax.Array:
    """[..., 3] (x,y,z) -> (r, phi, z)."""
    r = jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    phi = jnp.arctan2(p[..., 1], p[..., 0])
    return jnp.stack([r, phi, p[..., 2]], axis=-1)


def cartesian_from_cylindrical(c: jax.Array) -> jax.Array:
    """[..., 3] (r, phi, z) -> (x,y,z)."""
    return jnp.stack(
        [c[..., 0] * jnp.cos(c[..., 1]), c[..., 0] * jnp.sin(c[..., 1]), c[..., 2]],
        axis=-1,
    )


def toroidal_from_cartesian(p: jax.Array, major_radius) -> jax.Array:
    """(x,y,z) -> (minor radius rho, poloidal angle theta, toroidal angle phi)
    for a torus whose axis is the z-axis (cf. ``xicsrt_math.tor_from_car``)."""
    r = jnp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    phi = jnp.arctan2(p[..., 1], p[..., 0])
    d = r - major_radius
    rho = jnp.sqrt(d**2 + p[..., 2] ** 2)
    theta = jnp.arctan2(p[..., 2], d)
    return jnp.stack([rho, theta, phi], axis=-1)


def cartesian_from_toroidal(t: jax.Array, major_radius) -> jax.Array:
    """(rho, theta, phi) -> (x,y,z); inverse of :func:`toroidal_from_cartesian`
    (cf. ``xicsrt_math.car_from_tor``)."""
    rho, theta, phi = t[..., 0], t[..., 1], t[..., 2]
    r = major_radius + rho * jnp.cos(theta)
    z = rho * jnp.sin(theta)
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def sinusoidal_spiral(phi, b, r0, theta0):
    """Sinusoidal-spiral radius r(phi) (cf. ``xicsrt_math.sinusoidal_spiral``
    :132-134); used for spiral-bent crystal design studies."""
    return r0 * (jnp.sin(theta0 + (b - 1) * phi) / jnp.sin(theta0)) ** (
        1.0 / (b - 1)
    )


def point_in_triangle_2d(p: jax.Array, a: jax.Array, b: jax.Array, c: jax.Array) -> jax.Array:
    """Barycentric inside-test for 2D points; p: [...,2], a/b/c: [2] or [...,2].

    Same predicate as ``xicsrt_math.point_in_triangle_2d`` (:290-307), batched.
    """

    def sign(p1, p2, p3):
        return (p1[..., 0] - p3[..., 0]) * (p2[..., 1] - p3[..., 1]) - (
            p2[..., 0] - p3[..., 0]
        ) * (p1[..., 1] - p3[..., 1])

    d1 = sign(p, a, b)
    d2 = sign(p, b, c)
    d3 = sign(p, c, a)
    has_neg = (d1 < 0) | (d2 < 0) | (d3 < 0)
    has_pos = (d1 > 0) | (d2 > 0) | (d3 > 0)
    return ~(has_neg & has_pos)
