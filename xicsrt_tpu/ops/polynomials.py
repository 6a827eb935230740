"""Vectorized closed-form polynomial solvers (quadratic/cubic/quartic).

Vectorized replacement for ``xicsrt/tools/xicssrt_quartic.py`` (reference cites
NKrvavica/fqs). Design differences from the reference:

- pure real arithmetic with validity masks instead of complex dtypes;
- branch-free ``where`` selection instead of boolean indexing (static shapes);
- every root gets a final Newton polish on the original quartic so that
  float32 reaches the accuracy the reference only gets from float64
  (see SURVEY.md section 7.3 item 2);
- real roots are returned in ascending order with NaN (missing/complex roots)
  sorted last. For a ray approaching a torus from outside this matches the
  reference's algebraic ordering (``_ShapeTorus.py:161-181``), i.e. index k is
  the (k+1)-th intersection along the ray.
"""

from __future__ import annotations

import jax.numpy as jnp

_TINY = 1e-30


def solve_quadratic(a, b, c):
    """Roots of a x^2 + b x + c = 0, elementwise.

    Returns (x0, x1, valid) with x0 <= x1. Uses the numerically-stable
    citardauq form to avoid cancellation. NaN where complex.
    """
    disc = b * b - 4.0 * a * c
    valid = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    # q = -(b + sign(b) sqrt(disc)) / 2 avoids subtracting near-equal numbers.
    sgn = jnp.where(b >= 0.0, 1.0, -1.0)
    q = -0.5 * (b + sgn * sq)
    # Guard the divisions; invalid lanes become NaN below.
    x0 = q / jnp.where(jnp.abs(a) > _TINY, a, _TINY)
    x1 = c / jnp.where(jnp.abs(q) > _TINY, q, _TINY)
    # If b ~ 0 then q ~ +-sqrt(-ac); handle q == 0 (double root at 0).
    x1 = jnp.where(jnp.abs(q) > _TINY, x1, x0)
    lo = jnp.minimum(x0, x1)
    hi = jnp.maximum(x0, x1)
    nan = jnp.full_like(lo, jnp.nan)
    return jnp.where(valid, lo, nan), jnp.where(valid, hi, nan), valid


def _cbrt(x):
    return jnp.sign(x) * jnp.abs(x) ** (1.0 / 3.0)


def cubic_largest_real_root(b, c, d):
    """Largest real root of x^3 + b x^2 + c x + d = 0, elementwise.

    Cardano for the single-real-root case; trigonometric form for three real
    roots. Both branches are evaluated and selected with ``where``.
    """
    # Depressed cubic t^3 + P t + Q with x = t - b/3.
    b2 = b * b
    P = c - b2 / 3.0
    Q = d - b * c / 3.0 + 2.0 * b2 * b / 27.0

    half_q = 0.5 * Q
    third_p = P / 3.0
    disc = half_q * half_q + third_p * third_p * third_p

    # One real root (disc >= 0): Cardano.
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_one = _cbrt(-half_q + sq) + _cbrt(-half_q - sq)

    # Three real roots (disc < 0): largest is 2 sqrt(-P/3) cos(theta/3).
    rho = jnp.sqrt(jnp.maximum(-third_p, _TINY))
    cos_arg = jnp.clip(-half_q / jnp.maximum(rho**3, _TINY), -1.0, 1.0)
    theta = jnp.arccos(cos_arg)
    t_three = 2.0 * rho * jnp.cos(theta / 3.0)

    t = jnp.where(disc >= 0.0, t_one, t_three)
    x = t - b / 3.0
    # One Newton step to tighten the cubic root (cheap, helps f32).
    f = ((x + b) * x + c) * x + d
    df = (3.0 * x + 2.0 * b) * x + c
    x = x - f / jnp.where(jnp.abs(df) > _TINY, df, _TINY)
    return x


def _quartic_newton_polish(x, c0, c1, c2, c3, c4, iters=2):
    """Newton-polish roots of c0 x^4 + ... + c4 (NaN-safe)."""
    for _ in range(iters):
        f = (((c0 * x + c1) * x + c2) * x + c3) * x + c4
        df = ((4.0 * c0 * x + 3.0 * c1) * x + 2.0 * c2) * x + c3
        step = f / jnp.where(jnp.abs(df) > _TINY, df, _TINY)
        xn = x - step
        x = jnp.where(jnp.isfinite(xn), xn, x)
    return x


def solve_quartic_unsorted(c0, c1, c2, c3, c4):
    """Real roots of c0 x^4 + ... + c4, elementwise; list of 4 unsorted
    arrays, NaN where complex.
    """
    inv_c0 = 1.0 / jnp.where(jnp.abs(c0) > _TINY, c0, _TINY)
    a = c1 * inv_c0
    b = c2 * inv_c0
    c = c3 * inv_c0
    d = c4 * inv_c0

    # Depress: x = y - a/4 -> y^4 + p y^2 + q y + r.
    a2 = a * a
    p = b - 3.0 * a2 / 8.0
    q = c - a * b / 2.0 + a2 * a / 8.0
    r = d - a * c / 4.0 + a2 * b / 16.0 - 3.0 * a2 * a2 / 256.0

    # Resolvent cubic: m^3 + p m^2 + (p^2/4 - r) m - q^2/8 = 0.
    m = cubic_largest_real_root(p, 0.25 * p * p - r, -q * q / 8.0)
    m = jnp.maximum(m, 0.0)

    s2 = 2.0 * m
    s = jnp.sqrt(jnp.maximum(s2, 0.0))
    use_biquad = s2 <= 1e-12 * (1.0 + jnp.abs(p))

    # Ferrari factorization (y^2 + s y + A)(y^2 - s y + B).
    q_over_s = q / jnp.where(s > _TINY, s, _TINY)
    A = 0.5 * (p + s2 - q_over_s)
    B = 0.5 * (p + s2 + q_over_s)

    y0a, y1a, _ = solve_quadratic(jnp.ones_like(s), s, A)
    y0b, y1b, _ = solve_quadratic(jnp.ones_like(s), -s, B)

    # Biquadratic fallback (q ~ 0): z^2 + p z + r = 0, y = +-sqrt(z).
    z0, z1, _ = solve_quadratic(jnp.ones_like(p), p, r)
    nan = jnp.full_like(p, jnp.nan)

    def _sqrt_pair(z):
        ok = z >= 0.0
        sz = jnp.sqrt(jnp.maximum(z, 0.0))
        return jnp.where(ok, -sz, nan), jnp.where(ok, sz, nan)

    b0m, b0p = _sqrt_pair(z0)
    b1m, b1p = _sqrt_pair(z1)

    y_roots = [
        jnp.where(use_biquad, b0m, y0a),
        jnp.where(use_biquad, b0p, y1a),
        jnp.where(use_biquad, b1m, y0b),
        jnp.where(use_biquad, b1p, y1b),
    ]

    shift = a / 4.0
    return [
        _quartic_newton_polish(y - shift, c0, c1, c2, c3, c4)
        for y in y_roots
    ]


def solve_quartic(c0, c1, c2, c3, c4):
    """Real roots of c0 x^4 + c1 x^3 + c2 x^2 + c3 x + c4 = 0, elementwise.

    Returns roots [..., 4] sorted ascending, NaN-padded (complex pairs and
    the sorted tail are NaN). Ferrari's method through the resolvent cubic,
    followed by Newton polish on the original quartic.
    """
    roots = jnp.stack(solve_quartic_unsorted(c0, c1, c2, c3, c4), axis=-1)
    # Ascending sort; NaN sorts to the end.
    return jnp.sort(roots, axis=-1)
