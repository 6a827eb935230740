"""Angular emission samplers (stateless, fixed-shape, differentiable).

Vectorized replacement for ``xicsrt/tools/xicsrt_spread.py``. All samplers
take an explicit ``jax.random`` key and a *static* count ``n`` and return
``[n, 3]`` unit vectors whose mean emission axis is +z.

Key design difference vs the reference: ``isotropic_xy`` there is a host
rejection loop with data-dependent trip count (``xicsrt_spread.py:128-196``).
Here it is an exact analytic inverse-CDF sampler (Newton-inverted marginal +
closed-form conditional), which is fixed-shape, jit-able and differentiable.

Spread parsing follows the reference convention: 1 value -> symmetric in x/y,
2 values -> [x, y] half-angles, 4 values -> [xmin, xmax, ymin, ymax].
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Spread parsing (host side, static).
# ---------------------------------------------------------------------------

def parse_spread_single(spread) -> float:
    arr = np.atleast_1d(np.asarray(spread, dtype=np.float64))
    if arr.size != 1:
        raise ValueError("This distribution requires a single spread value.")
    return float(arr[0])


def parse_spread_xy(spread) -> tuple:
    arr = np.atleast_1d(np.asarray(spread, dtype=np.float64))
    if arr.size == 1:
        return (-float(arr[0]), float(arr[0]), -float(arr[0]), float(arr[0]))
    if arr.size == 2:
        return (-float(arr[0]), float(arr[0]), -float(arr[1]), float(arr[1]))
    if arr.size == 4:
        return tuple(float(v) for v in arr)
    raise ValueError("Spread must have 1, 2 or 4 elements.")


# ---------------------------------------------------------------------------
# Samplers.
# ---------------------------------------------------------------------------

def sample_isotropic(key, n: int, spread, dtype=jnp.float32) -> jax.Array:
    """Uniform-sphere directions within a cone of half-angle ``spread``.

    Same distribution as ``vector_dist_isotropic`` (:80-110): z uniform in
    [cos(theta), 1], azimuth uniform.
    """
    theta = parse_spread_single(spread)
    kz, kphi = jax.random.split(key)
    z = jax.random.uniform(
        kz, (n,), dtype=dtype, minval=math.cos(theta), maxval=1.0
    )
    phi = jax.random.uniform(kphi, (n,), dtype=dtype, minval=0.0, maxval=2.0 * math.pi)
    rho = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack([rho * jnp.cos(phi), rho * jnp.sin(phi), z], axis=-1)


def solid_angle_isotropic(spread) -> float:
    """Solid angle of the isotropic cone: 4 pi sin^2(theta/2)."""
    theta = parse_spread_single(spread)
    return 4.0 * math.pi * math.sin(theta / 2.0) ** 2


def _isotropic_xy_marginal(sx, sb0, sb1):
    """Integral over the y-bounds of the uniform-sphere density at sin(alpha)=sx.

    G(sx) = arcsin(sx*sin(ty1)) - arcsin(sx*sin(ty0)); the corner-arcsin form
    is the same identity behind ``solid_angle_isotropic_xy`` (:198-211).
    """
    return jnp.arcsin(jnp.clip(sx * sb1, -1.0, 1.0)) - jnp.arcsin(
        jnp.clip(sx * sb0, -1.0, 1.0)
    )


def sample_isotropic_xy(key, n: int, spread, dtype=jnp.float32, newton_iters: int = 12):
    """Uniform-sphere directions restricted to an xy-rectangular angular window.

    Region (matching ``vector_dist_isotropic_xy``): directions v with
    ``sin(alpha) = v_x / sqrt(v_x^2+v_z^2)`` in [sin tx0, sin tx1] and the
    analogous y-projection angle in [sin ty0, sin ty1].

    In gnomonic coordinates (tx, ty) = (v_x/v_z, v_y/v_z) this region is an
    axis-aligned rectangle and the sphere measure is (1+tx^2+ty^2)^(-3/2), so:
    the marginal CDF in sin(alpha) is a difference of arcsins (Newton-inverted
    here) and the conditional CDF in ty is closed-form invertible.
    """
    tx0, tx1, ty0, ty1 = parse_spread_xy(spread)
    for v in (tx0, tx1, ty0, ty1):
        if abs(v) >= math.pi / 2:
            raise ValueError("isotropic_xy spreads must be within (-pi/2, pi/2).")
    sx0, sx1 = math.sin(tx0), math.sin(tx1)
    sb0, sb1 = math.sin(ty0), math.sin(ty1)

    ku, kv = jax.random.split(key)
    u = jax.random.uniform(ku, (n,), dtype=dtype)
    v = jax.random.uniform(kv, (n,), dtype=dtype)

    if sb0 == -sb1 and sb1 > 0.0:
        # Symmetric y-bounds (1- and 2-element spreads — the common case):
        # G(sx) = 2 arcsin(sx sb1), so the marginal inverts in CLOSED FORM.
        # This removes the Newton loop (2 arcsin + 2 rsqrt per iteration per
        # ray) from the hot sampling path.
        g0 = 2.0 * math.asin(sx0 * sb1)
        g1 = 2.0 * math.asin(sx1 * sb1)
        target = g0 + u * (g1 - g0)
        sx = jnp.sin(target * 0.5) / sb1
    else:
        g0 = _isotropic_xy_marginal(jnp.asarray(sx0, dtype), sb0, sb1)
        g1 = _isotropic_xy_marginal(jnp.asarray(sx1, dtype), sb0, sb1)
        target = g0 + u * (g1 - g0)

        # Newton with bracket clamping on the monotonic marginal CDF.
        sx = sx0 + u * (sx1 - sx0)
        for _ in range(newton_iters):
            g = _isotropic_xy_marginal(sx, sb0, sb1)
            dg = sb1 / jnp.sqrt(
                jnp.maximum(1.0 - (sx * sb1) ** 2, 1e-12)
            ) - sb0 / jnp.sqrt(jnp.maximum(1.0 - (sx * sb0) ** 2, 1e-12))
            sx = jnp.clip(sx - (g - target) / jnp.maximum(dg, 1e-12), sx0, sx1)

    tx = sx / jnp.sqrt(jnp.maximum(1.0 - sx * sx, 1e-12))
    k2 = 1.0 + tx * tx
    k = jnp.sqrt(k2)

    # Conditional in ty: H(ty) = ty / sqrt(k^2 + ty^2), inverted exactly.
    tyl = math.tan(ty0)
    tyh = math.tan(ty1)
    h0 = tyl / jnp.sqrt(k2 + tyl * tyl)
    h1 = tyh / jnp.sqrt(k2 + tyh * tyh)
    h = h0 + v * (h1 - h0)
    ty = k * h / jnp.sqrt(jnp.maximum(1.0 - h * h, 1e-12))

    w = 1.0 / jnp.sqrt(1.0 + tx * tx + ty * ty)
    return jnp.stack([tx * w, ty * w, w], axis=-1)


def solid_angle_isotropic_xy(spread) -> float:
    """Solid angle of the xy-rectangular window (corner arcsin formula)."""
    t = parse_spread_xy(spread)
    return (
        math.asin(abs(math.sin(t[0]) * math.sin(t[2])))
        + math.asin(abs(math.sin(t[0]) * math.sin(t[3])))
        + math.asin(abs(math.sin(t[1]) * math.sin(t[2])))
        + math.asin(abs(math.sin(t[1]) * math.sin(t[3])))
    )


def sample_flat(key, n: int, spread, dtype=jnp.float32) -> jax.Array:
    """Uniform planar density within a cone of half-angle ``spread``.

    Uniform areal density on the plane z=1 inside radius tan(theta), i.e.
    r = tan(theta) * sqrt(u).

    .. note:: The reference implementation (``vector_dist_flat``, :213-245)
       draws ``r = sqrt(U(0, tan theta))`` which yields a uniform disk of
       radius ``sqrt(tan theta)`` — its cone edge only equals the documented
       half-angle when ``tan(theta) == 1``. This implementation follows the
       documented semantics (edge exactly at ``spread``) instead.
    """
    theta = parse_spread_single(spread)
    kr, kphi = jax.random.split(key)
    u = jax.random.uniform(kr, (n,), dtype=dtype)
    r = math.tan(theta) * jnp.sqrt(u)
    phi = jax.random.uniform(kphi, (n,), dtype=dtype, minval=0.0, maxval=2.0 * math.pi)
    angle0 = jnp.arctan(r)
    return jnp.stack(
        [
            jnp.cos(phi) * jnp.sin(angle0),
            jnp.sin(phi) * jnp.sin(angle0),
            jnp.cos(angle0),
        ],
        axis=-1,
    )


def sample_flat_xy(key, n: int, spread, dtype=jnp.float32) -> jax.Array:
    """Uniform planar density over an xy-rectangular window (SHADOW-style,
    matching ``vector_dist_flat_xy`` :247-294)."""
    t = parse_spread_xy(spread)
    kx, ky = jax.random.split(key)
    x = jax.random.uniform(
        kx, (n,), dtype=dtype, minval=math.tan(t[0]), maxval=math.tan(t[1])
    )
    y = jax.random.uniform(
        ky, (n,), dtype=dtype, minval=math.tan(t[2]), maxval=math.tan(t[3])
    )
    angle0 = jnp.arctan(jnp.sqrt(x * x + y * y))
    angle1 = jnp.arctan2(y, x)
    return jnp.stack(
        [
            jnp.cos(angle1) * jnp.sin(angle0),
            jnp.sin(angle1) * jnp.sin(angle0),
            jnp.cos(angle0),
        ],
        axis=-1,
    )


def sample_flat_gaussian(key, n: int, spread, dtype=jnp.float32) -> jax.Array:
    """Gaussian density on the z=1 plane; ``spread`` is the angular HWHM.

    Used for mosaic crystallite normals (``vector_dist_flat_gaussian``
    :297-339 and ``_InteractMosaicCrystal.py:109-139``).
    """
    hwhm = parse_spread_single(spread)
    sigma = math.sin(hwhm / math.sqrt(2.0 * math.log(2.0)))
    xy = sigma * jax.random.normal(key, (n, 2), dtype=dtype)
    v = jnp.concatenate([xy, jnp.ones((n, 1), dtype=dtype)], axis=-1)
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


_SAMPLERS = {
    "isotropic": sample_isotropic,
    "isotropic_xy": sample_isotropic_xy,
    "flat": sample_flat,
    "flat_xy": sample_flat_xy,
    # The reference's dispatcher names a 'gaussian' distribution whose
    # implementation is the flat-gaussian sampler (xicsrt_spread.py:54-55
    # refers to an undefined symbol; the only gaussian sampler in the file is
    # vector_dist_flat_gaussian). We wire 'gaussian' to the working sampler.
    "gaussian": sample_flat_gaussian,
    "flat_gaussian": sample_flat_gaussian,
}


def sample_direction(key, n: int, spread, name: str = "isotropic", dtype=jnp.float32):
    """Dispatch by distribution name (mirrors ``vector_distribution``)."""
    name = (name or "isotropic").lower()
    if name not in _SAMPLERS:
        raise ValueError(f'Angular distribution "{name}" is not known.')
    return _SAMPLERS[name](key, n, spread, dtype=dtype)


def solid_angle(spread, name: str = "isotropic") -> float:
    """Solid angle matching a named distribution (mirrors ``solid_angle``)."""
    name = (name or "isotropic").lower()
    if name == "isotropic":
        return solid_angle_isotropic(spread)
    if name == "isotropic_xy":
        return solid_angle_isotropic_xy(spread)
    raise ValueError(f'Solid angle for "{name}" is not available.')
