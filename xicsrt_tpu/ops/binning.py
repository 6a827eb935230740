"""Detector pixel binning.

Replaces the per-ray Python accumulation loop in the reference
(``_TraceObject.py:289-291`` — the hottest loop in its profile) with two
vectorized forms: a scatter-add over flat pixel indices, and a factorized
one-hot/tent matrix product over chunks of rays. ``binning_route`` picks one
of them from the platform.

Every float32 contraction here asks for ``Precision.HIGHEST``: on a GPU an
f32 product otherwise runs in TF32, which would round ray weights and tent
fractions to a 10-bit mantissa and change the gradients of bilinear images.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_PRECISION = jax.lax.Precision.HIGHEST


def binning_route(platform: str) -> str:
    """The binning implementation for a JAX platform name.

    ``"cpu"`` -> ``"scatter"`` (``bin_image``/``bin_image_bilinear``);
    ``"gpu"`` -> ``"matmul"`` (the chunked one-hot/tent contraction of
    ``bin_images_fused``). Any other platform raises ``ValueError``.
    """
    routes = {"cpu": "scatter", "gpu": "matmul"}
    if platform not in routes:
        raise ValueError(
            f"No image binning route for platform {platform!r}; "
            f"supported: {sorted(routes)}."
        )
    return routes[platform]


def bin_image(
    x_local: jax.Array,
    mask: jax.Array,
    weight: jax.Array,
    nx: int,
    ny: int,
    pixel_size: float,
) -> jax.Array:
    """Accumulate ray hits into an [nx, ny] image.

    Pixel convention matches the reference (``_TraceObject.py:257-291``):
    local coordinates are divided by ``pixel_size`` and shifted so that
    channel (0,0) is centered on the bottom-left pixel; hits are rounded to
    the nearest channel; out-of-grid hits are dropped.

    Weighted accumulation generalizes the reference's +1 per ray: with unit
    weights the images agree; in ``weight`` interaction mode the image is the
    expected photon count (differentiable w.r.t. upstream parameters through
    ``weight``; pixel assignment itself is a hard binning).
    """
    px = x_local[:, 0] / pixel_size + (nx - 1) / 2.0
    py = x_local[:, 1] / pixel_size + (ny - 1) / 2.0
    ix = jnp.round(px).astype(jnp.int32)
    iy = jnp.round(py).astype(jnp.int32)
    ok = mask & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    # Masked-out rays scatter weight 0 into pixel (0, 0).
    ix = jnp.where(ok, ix, 0)
    iy = jnp.where(ok, iy, 0)
    w = jnp.where(ok, weight, 0.0)
    flat = jnp.zeros((nx * ny,), dtype=x_local.dtype)
    flat = flat.at[ix * ny + iy].add(w)
    return flat.reshape(nx, ny)


def bin_image_matmul(
    x_local: jax.Array,
    mask: jax.Array,
    weight: jax.Array,
    nx: int,
    ny: int,
    pixel_size: float,
    chunk: int = 1 << 16,
) -> jax.Array:
    """Binning as a factorized one-hot matrix product.

    Build per-axis one-hot matrices OX [C, nx] (scaled by the ray weight)
    and OY [C, ny] for a chunk of C rays; then ``image += OX^T @ OY``
    accumulates the joint histogram as a matrix product:

        sum_r OX[r, i] * OY[r, j] * w[r]  ==  image[i, j].

    One-hot formation costs O(C * (nx + ny)) compares; the product
    O(C * nx * ny) multiply-adds. Chunked with ``lax.scan`` so the one-hot
    tiles stay small. Results equal ``bin_image`` (same nearest-pixel
    convention).
    """
    n = x_local.shape[0]
    dtype = x_local.dtype
    px = x_local[:, 0] / pixel_size + (nx - 1) / 2.0
    py = x_local[:, 1] / pixel_size + (ny - 1) / 2.0
    ix = jnp.round(px).astype(jnp.int32)
    iy = jnp.round(py).astype(jnp.int32)
    ok = mask & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    # Out-of-grid rays bin with weight 0 (index value then irrelevant).
    w = jnp.where(ok, weight, 0.0).astype(dtype)

    chunk = min(chunk, max(n, 1))
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        ix = jnp.concatenate([ix, jnp.zeros((pad,), jnp.int32)])
        iy = jnp.concatenate([iy, jnp.zeros((pad,), jnp.int32)])
        w = jnp.concatenate([w, jnp.zeros((pad,), dtype)])
    ix = ix.reshape(n_chunks, chunk)
    iy = iy.reshape(n_chunks, chunk)
    w = w.reshape(n_chunks, chunk)

    xbins = jnp.arange(nx, dtype=jnp.int32)
    ybins = jnp.arange(ny, dtype=jnp.int32)

    def body(img, args):
        ixc, iyc, wc = args
        ox = (ixc[:, None] == xbins[None, :]).astype(dtype) * wc[:, None]
        oy = (iyc[:, None] == ybins[None, :]).astype(dtype)
        img = img + jax.lax.dot_general(
            ox, oy,
            dimension_numbers=(((0,), (0,)), ((), ())),
            precision=_PRECISION,
            preferred_element_type=jnp.promote_types(jnp.float32, dtype),
        ).astype(dtype)
        return img, None

    img0 = jnp.zeros((nx, ny), dtype=dtype)
    img, _ = jax.lax.scan(body, img0, (ix, iy, w))
    return img


def bin_image_bilinear_matmul(
    x_local: jax.Array,
    mask: jax.Array,
    weight: jax.Array,
    nx: int,
    ny: int,
    pixel_size: float,
    chunk: int = 1 << 16,
) -> jax.Array:
    """Differentiable binning as a tent-function matrix product.

    The bilinear splat weight of ray r on pixel (i, j) is
    ``max(0, 1-|px-i|) * max(0, 1-|py-j|)``, which factorizes per axis —
    so the bilinear image is the same two-matrix contraction as
    ``bin_image_matmul`` with tent columns instead of one-hot columns:

        image = (TX * w)^T @ TY,  TX[r, i] = relu(1 - |px[r] - i|).

    Identical values and gradients to ``bin_image_bilinear`` (piecewise
    linear in the hit position). Backward runs through the custom
    tent-transpose VJP (no materialized residuals).
    """
    dtype = x_local.dtype
    px = x_local[:, 0] / pixel_size + (nx - 1) / 2.0
    py = x_local[:, 1] / pixel_size + (ny - 1) / 2.0
    w = jnp.where(mask, weight, 0.0).astype(dtype)
    (img,) = _tent_images(((nx, ny),), chunk, None, (px,), (py,), (w,))
    return img


# ---------------------------------------------------------------------------
# Custom-VJP tent contraction (the differentiable binning workhorse).
# ---------------------------------------------------------------------------

def _tent_cols(p, nbins, dtype):
    d = p[:, None] - jnp.arange(nbins, dtype=dtype)[None, :]
    return jnp.maximum(0.0, 1.0 - jnp.abs(d))


def _dtent_cols(p, nbins, dtype):
    """d/dp of the tent columns: -sign(p - i) on the open support |d| < 1.

    The kink at |d| = 1 (and the apex d = 0) takes subgradient 0 — a
    measure-zero set for MC ray positions.
    """
    d = p[:, None] - jnp.arange(nbins, dtype=dtype)[None, :]
    return jnp.where(jnp.abs(d) < 1.0, -jnp.sign(d), 0.0)


def _pad_chunks(p, n_chunks, chunk, fill):
    pad = n_chunks * chunk - p.shape[0]
    if pad:
        p = jnp.concatenate([p, jnp.full((pad,), fill, p.dtype)])
    return p.reshape(n_chunks, chunk)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _tent_images(specs, chunk, op_dtype_name, pxs, pys, ws):
    """Fused multi-image bilinear binning with a hand-written backward.

    ``specs``: tuple of (nx, ny) per image; ``pxs``/``pys``/``ws``: tuples
    of (N,) pixel coordinates and weights sharing the ray axis. Returns the
    tuple of [nx, ny] images.

    Without this VJP, autodiff of the scan-of-matmuls saves every chunk's
    (C, nx)/(C, ny) tent matrices as residuals — O(rays * (nx + ny)) HBM
    (measured 33 GB at 2^22 rays x 4 iterations), which forced whole-trace
    rematerialization. The transpose of a tent contraction is itself a tent
    contraction:

        d/dw[r]  = TX[r,:] @ g @ TY[r,:]
        d/dpx[r] = w[r] * (TX'[r,:] @ g @ TY[r,:])
        d/dpy[r] = w[r] * (TX[r,:] @ g @ TY'[r,:])

    so the backward recomputes the tent columns from the O(N) residuals
    (px, py, w) and runs two extra chunk products of the forward's shape,
    nothing materialized.
    """
    images, _ = _tent_images_fwd(specs, chunk, op_dtype_name, pxs, pys, ws)
    return images


def _tent_images_fwd(specs, chunk, op_dtype_name, pxs, pys, ws):
    dtype = pxs[0].dtype
    acc_dtype = jnp.promote_types(jnp.float32, dtype)
    op_dtype = dtype if op_dtype_name is None else jnp.dtype(op_dtype_name)
    n = pxs[0].shape[0]
    c = min(chunk, max(n, 1))
    n_chunks = -(-n // c)
    # Padding rays sit at -10: outside every tent's support, zero weight.
    pxr = tuple(_pad_chunks(p, n_chunks, c, -10.0) for p in pxs)
    pyr = tuple(_pad_chunks(p, n_chunks, c, -10.0) for p in pys)
    wr = tuple(_pad_chunks(w, n_chunks, c, 0.0) for w in ws)

    def body(images, args):
        pxc, pyc, wc = args
        new = []
        for img, px_i, py_i, w_i, (nx, ny) in zip(
            images, pxc, pyc, wc, specs
        ):
            tx = _tent_cols(px_i, nx, dtype)
            ty = _tent_cols(py_i, ny, dtype)
            new.append(
                img
                + jax.lax.dot_general(
                    (tx * w_i[:, None]).astype(op_dtype), ty.astype(op_dtype),
                    dimension_numbers=(((0,), (0,)), ((), ())),
                    precision=_PRECISION,
                    preferred_element_type=acc_dtype,
                ).astype(dtype)
            )
        return tuple(new), None

    init = tuple(jnp.zeros((nx, ny), dtype=dtype) for (nx, ny) in specs)
    images, _ = jax.lax.scan(body, init, (pxr, pyr, wr))
    return images, (pxs, pys, ws)


def _tent_images_bwd(specs, chunk, op_dtype_name, res, g):
    pxs, pys, ws = res
    dtype = pxs[0].dtype
    acc_dtype = jnp.promote_types(jnp.float32, dtype)
    n = pxs[0].shape[0]
    c = min(chunk, max(n, 1))
    n_chunks = -(-n // c)
    pxr = tuple(_pad_chunks(p, n_chunks, c, -10.0) for p in pxs)
    pyr = tuple(_pad_chunks(p, n_chunks, c, -10.0) for p in pys)
    wr = tuple(_pad_chunks(w, n_chunks, c, 0.0) for w in ws)
    # Cotangent images are tiny and loop-invariant; keep them f32-accurate.
    gs = tuple(gi.astype(dtype) for gi in g)

    def body(_, args):
        pxc, pyc, wc = args
        douts = []
        for px_i, py_i, w_i, g_i, (nx, ny) in zip(pxc, pyc, wc, gs, specs):
            tx = _tent_cols(px_i, nx, dtype)
            ty = _tent_cols(py_i, ny, dtype)
            dtx = _dtent_cols(px_i, nx, dtype)
            dty = _dtent_cols(py_i, ny, dtype)
            # m[r, j]  = sum_i TX[r, i]  g[i, j]
            # md[r, j] = sum_i TX'[r, i] g[i, j]
            m = jax.lax.dot_general(
                tx, g_i, dimension_numbers=(((1,), (0,)), ((), ())),
                precision=_PRECISION, preferred_element_type=acc_dtype,
            ).astype(dtype)
            md = jax.lax.dot_general(
                dtx, g_i, dimension_numbers=(((1,), (0,)), ((), ())),
                precision=_PRECISION, preferred_element_type=acc_dtype,
            ).astype(dtype)
            dw = jnp.sum(m * ty, axis=1)
            dpx = w_i * jnp.sum(md * ty, axis=1)
            dpy = w_i * jnp.sum(m * dty, axis=1)
            douts.append((dpx, dpy, dw))
        return None, tuple(douts)

    _, stacked = jax.lax.scan(body, None, (pxr, pyr, wr))
    dpxs = tuple(s[0].reshape(-1)[:n] for s in stacked)
    dpys = tuple(s[1].reshape(-1)[:n] for s in stacked)
    dws = tuple(s[2].reshape(-1)[:n] for s in stacked)
    return dpxs, dpys, dws


_tent_images.defvjp(_tent_images_fwd, _tent_images_bwd)


def bin_images_fused(items: list, image_mode: str = "nearest",
                     chunk: int = 1 << 17, op_dtype=None,
                     platform: str | None = None) -> list:
    """Accumulate SEVERAL images in one chunked pass over the ray axis.

    ``items``: list of (x_local, mask, weight, nx, ny, pixel_size), all with
    the same ray count. Running each image as its own chunked scan defeats
    XLA's fusion of the trace pipeline; a single scan whose carry holds
    every accumulator keeps the one-hot/tent tiles small and the
    surrounding pipeline fused.

    Returns the images in input order. ``platform`` (default: JAX's default
    backend) picks the route through ``binning_route``: per-item scatter on
    the CPU, the chunked matrix product on the GPU.

    ``op_dtype``: dtype of the one-hot/tent operands of the product (config
    ``general.binning_dtype``). Accumulation is always at least f32 via
    ``preferred_element_type``; ``bfloat16`` operands are EXACT for
    nearest-mode binning with unit ray weights (0/1 matrix entries are
    representable), but round non-unit weights to 8 mantissa bits.
    Default: the ray dtype.
    """
    if not items:
        return []
    if platform is None:
        platform = jax.default_backend()
    scatter_fn = bin_image_bilinear if image_mode == "bilinear" else bin_image
    if binning_route(platform) == "scatter":
        return [scatter_fn(*item) for item in items]

    # The matmul form costs O(rays * nx * ny) multiply-adds. Route huge
    # images (megapixel detectors) through scatter and keep the fused pass
    # for the rest.
    big = [item[3] * item[4] > (1 << 18) for item in items]
    if any(big):
        small_items = [it for it, b in zip(items, big) if not b]
        small_out = iter(
            bin_images_fused(small_items, image_mode, chunk, op_dtype,
                             platform)
        )
        return [
            scatter_fn(*it) if b else next(small_out)
            for it, b in zip(items, big)
        ]

    n = items[0][0].shape[0]
    dtype = items[0][0].dtype
    acc_dtype = jnp.promote_types(jnp.float32, dtype)
    op_dtype_name = None if op_dtype is None else jnp.dtype(op_dtype).name
    op_dtype = dtype if op_dtype is None else jnp.dtype(op_dtype)
    bilinear = image_mode == "bilinear"

    if bilinear:
        # Differentiable path: the fused multi-image tent contraction with
        # the custom tent-transpose VJP (O(N) residuals instead of
        # O(N * (nx + ny)) tent matrices).
        specs, pxs, pys, ws = [], [], [], []
        for (x_local, mask, weight, nx, ny, pixel_size) in items:
            specs.append((nx, ny))
            pxs.append(x_local[:, 0] / pixel_size + (nx - 1) / 2.0)
            pys.append(x_local[:, 1] / pixel_size + (ny - 1) / 2.0)
            ws.append(jnp.where(mask, weight, 0.0).astype(dtype))
        return list(
            _tent_images(
                tuple(specs), chunk, op_dtype_name,
                tuple(pxs), tuple(pys), tuple(ws),
            )
        )

    chunk = min(chunk, max(n, 1))
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n

    prepped = []
    for (x_local, mask, weight, nx, ny, pixel_size) in items:
        px = x_local[:, 0] / pixel_size + (nx - 1) / 2.0
        py = x_local[:, 1] / pixel_size + (ny - 1) / 2.0
        ix = jnp.round(px).astype(jnp.int32)
        iy = jnp.round(py).astype(jnp.int32)
        ok = mask & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
        px = ix.astype(dtype)
        py = iy.astype(dtype)
        w = jnp.where(ok, weight, 0.0).astype(dtype)
        if pad:
            far = jnp.full((pad,), -10.0, dtype)
            px = jnp.concatenate([px, far])
            py = jnp.concatenate([py, far])
            w = jnp.concatenate([w, jnp.zeros((pad,), dtype)])
        prepped.append(
            (px.reshape(n_chunks, chunk), py.reshape(n_chunks, chunk),
             w.reshape(n_chunks, chunk), nx, ny)
        )

    def columns(p, bins):
        return (p[:, None] == bins[None, :]).astype(dtype)

    def body(images, chunk_args):
        new_images = []
        for img, (pxc, pyc, wc), (_, _, _, nx, ny) in zip(
            images, chunk_args, prepped
        ):
            tx = columns(pxc, jnp.arange(nx, dtype=dtype))
            ty = columns(pyc, jnp.arange(ny, dtype=dtype))
            new_images.append(
                img
                + jax.lax.dot_general(
                    (tx * wc[:, None]).astype(op_dtype), ty.astype(op_dtype),
                    dimension_numbers=(((0,), (0,)), ((), ())),
                    precision=_PRECISION,
                    preferred_element_type=acc_dtype,
                ).astype(dtype)
            )
        return tuple(new_images), None

    init = tuple(
        jnp.zeros((nx, ny), dtype=dtype) for (_, _, _, nx, ny) in prepped
    )
    xs = tuple((p[0], p[1], p[2]) for p in prepped)
    images, _ = jax.lax.scan(body, init, xs)
    return list(images)


def select_bin_fn(image_mode: str, platform: str | None = None):
    """The single-image binning function for a platform (default: JAX's
    default backend), chosen by ``binning_route``."""
    if platform is None:
        platform = jax.default_backend()
    scatter = binning_route(platform) == "scatter"
    if image_mode == "bilinear":
        return bin_image_bilinear if scatter else bin_image_bilinear_matmul
    return bin_image if scatter else bin_image_matmul


def bin_image_bilinear(
    x_local: jax.Array,
    mask: jax.Array,
    weight: jax.Array,
    nx: int,
    ny: int,
    pixel_size: float,
) -> jax.Array:
    """Differentiable accumulation: bilinear splat onto 4 neighbor pixels.

    Unlike ``bin_image`` (hard nearest-pixel assignment with zero positional
    gradient), each hit distributes its weight linearly to the four
    surrounding pixel centers, so the image is piecewise-linear in the local
    hit coordinates and ``jax.grad`` flows through optic pose. Integral is
    preserved for in-bounds hits; expected images converge to ``bin_image``
    up to half-pixel smoothing.
    """
    px = x_local[:, 0] / pixel_size + (nx - 1) / 2.0
    py = x_local[:, 1] / pixel_size + (ny - 1) / 2.0
    x0 = jnp.floor(px)
    y0 = jnp.floor(py)
    fx = px - x0
    fy = py - y0
    ix0 = x0.astype(jnp.int32)
    iy0 = y0.astype(jnp.int32)

    flat = jnp.zeros((nx * ny,), dtype=x_local.dtype)
    for dx, wx in ((0, 1.0 - fx), (1, fx)):
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            ix = ix0 + dx
            iy = iy0 + dy
            ok = mask & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
            idx = jnp.where(ok, ix * ny + iy, 0)
            w = jnp.where(ok, weight * wx * wy, 0.0)
            flat = flat.at[idx].add(w)
    return flat.reshape(nx, ny)
