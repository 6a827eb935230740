"""Custom tent-transpose VJP for bilinear binning (ops/binning.py).

The differentiable image path must produce identical values AND gradients
whether it runs through the scatter splat (``bin_image_bilinear``, the CPU
route with autodiff through ``.at[].add``) or the tent contraction with the
hand-written backward (``_tent_images``, the GPU route). The custom
backward stores only O(N) residuals instead of the O(N * (nx + ny)) tent
matrices autodiff would save.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from xicsrt_tpu.ops.binning import (
    _tent_images,
    bin_image_bilinear,
    bin_image_bilinear_matmul,
)


def _random_hits(key, n, nx, ny, pixel_size, frac_masked=0.2):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    # Positions spanning the grid plus a margin of out-of-bounds hits.
    half_x = nx * pixel_size * 0.7
    half_y = ny * pixel_size * 0.7
    x = jax.random.uniform(k1, (n,), jnp.float64, -half_x, half_x)
    y = jax.random.uniform(k2, (n,), jnp.float64, -half_y, half_y)
    x_local = jnp.stack([x, y, jnp.zeros_like(x)], axis=1)
    mask = jax.random.uniform(k3, (n,)) > frac_masked
    weight = jax.random.uniform(k4, (n,), jnp.float64, 0.1, 2.0)
    return x_local, mask, weight


@pytest.mark.parametrize("n,chunk", [(1000, 1 << 16), (3000, 1024)])
def test_forward_matches_scatter(n, chunk):
    nx, ny, ps = 37, 23, 0.01
    x_local, mask, weight = _random_hits(jax.random.key(0), n, nx, ny, ps)
    a = bin_image_bilinear(x_local, mask, weight, nx, ny, ps)
    b = bin_image_bilinear_matmul(x_local, mask, weight, nx, ny, ps,
                                  chunk=chunk)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("chunk", [1 << 16, 1024])
def test_grads_match_scatter(chunk):
    """d(loss)/d(x_local), d/d(weight) identical between scatter autodiff
    and the custom tent-transpose backward."""
    nx, ny, ps = 19, 31, 0.01
    n = 2500
    x_local, mask, weight = _random_hits(jax.random.key(1), n, nx, ny, ps)
    pw = jax.random.normal(jax.random.key(2), (nx, ny), jnp.float64)

    def loss_scatter(x_local, weight):
        return jnp.sum(bin_image_bilinear(x_local, mask, weight, nx, ny, ps)
                       * pw)

    def loss_matmul(x_local, weight):
        return jnp.sum(
            bin_image_bilinear_matmul(x_local, mask, weight, nx, ny, ps,
                                      chunk=chunk) * pw
        )

    ga = jax.grad(loss_scatter, argnums=(0, 1))(x_local, weight)
    gb = jax.grad(loss_matmul, argnums=(0, 1))(x_local, weight)
    for a, b in zip(ga, gb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)


def test_multi_image_tent_vjp():
    """The fused multi-image op: per-image grads match independent scatter
    grads; masked rays get zero position gradients."""
    n = 1800
    specs = ((16, 24), (9, 130))
    ps = (0.01, 0.004)
    keys = jax.random.split(jax.random.key(3), 2)
    items = [
        _random_hits(k, n, nx, ny, p)
        for k, (nx, ny), p in zip(keys, specs, ps)
    ]
    pws = [
        jax.random.normal(jax.random.key(10 + i), s, jnp.float64)
        for i, s in enumerate(specs)
    ]

    def prep(x_local, mask, weight, nx, ny, pixel_size):
        px = x_local[:, 0] / pixel_size + (nx - 1) / 2.0
        py = x_local[:, 1] / pixel_size + (ny - 1) / 2.0
        w = jnp.where(mask, weight, 0.0)
        return px, py, w

    masks = [it[1] for it in items]

    def loss_fused(xs, ws_in):
        pxs, pys, ws = [], [], []
        for x_local, mask, w, (nx, ny), p in zip(xs, masks, ws_in, specs, ps):
            px, py, w_ = prep(x_local, mask, w, nx, ny, p)
            pxs.append(px)
            pys.append(py)
            ws.append(w_)
        images = _tent_images(specs, 512, None, tuple(pxs), tuple(pys),
                              tuple(ws))
        return sum(jnp.sum(img * pw) for img, pw in zip(images, pws))

    def loss_scatter(xs, ws_in):
        total = 0.0
        for x_local, mask, w, (nx, ny), p, pw in zip(
            xs, masks, ws_in, specs, ps, pws
        ):
            total = total + jnp.sum(
                bin_image_bilinear(x_local, mask, w, nx, ny, p) * pw
            )
        return total

    xs = tuple(it[0] for it in items)
    ws_in = tuple(it[2] for it in items)

    va = loss_fused(xs, ws_in)
    vb = loss_scatter(xs, ws_in)
    np.testing.assert_allclose(float(va), float(vb), rtol=1e-12)

    ga = jax.grad(loss_fused, argnums=(0, 1))(xs, ws_in)
    gb = jax.grad(loss_scatter, argnums=(0, 1))(xs, ws_in)
    for ta, tb in zip(ga, gb):
        for a, b in zip(ta, tb):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-10, atol=1e-12)

    # Masked rays contribute no position gradient.
    for a, mask in zip(ga[0], masks):
        dead = ~np.asarray(mask)
        assert np.all(np.asarray(a)[dead] == 0.0)


def test_grad_finite_difference():
    """Central-difference check of the custom backward itself (f64)."""
    nx, ny, ps = 11, 13, 0.02
    n = 40
    x_local, mask, weight = _random_hits(jax.random.key(5), n, nx, ny, ps,
                                         frac_masked=0.0)
    pw = jax.random.normal(jax.random.key(6), (nx, ny), jnp.float64)

    def loss(x_local):
        return jnp.sum(
            bin_image_bilinear_matmul(x_local, mask, weight, nx, ny, ps) * pw
        )

    g = np.asarray(jax.grad(loss)(x_local))
    eps = 1e-6
    rng = np.random.default_rng(0)
    base = np.asarray(x_local)
    for _ in range(10):
        r, c = rng.integers(0, n), rng.integers(0, 2)
        xp = base.copy()
        xp[r, c] += eps
        xm = base.copy()
        xm[r, c] -= eps
        fd = (float(loss(jnp.asarray(xp))) - float(loss(jnp.asarray(xm)))) / (
            2 * eps
        )
        np.testing.assert_allclose(g[r, c], fd, rtol=1e-4, atol=1e-7)
