"""``make_differentiable`` gradients against central finite differences.

Each case differentiates a pixel-weighted loss of every image of a small
weight-mode, bilinear chain (``tests/configs.variant_config``) with respect
to one parameter, through the GPU's binning route (the tent contraction and
its hand-written transpose). The finite difference re-traces the same rays
(common random numbers) at float64 with a step small enough that no ray
crosses an optic edge, a hard mask or a pixel-centre kink, so the two agree
to float64 rounding, not to Monte-Carlo error. The parameters cover poses,
d-spacings, rocking widths, radii of spheres, cylinders and tori, and
plasma temperature.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.configs import variant_config
from xicsrt_tpu.gradients import make_differentiable

CASES = [
    ("plane_crystal_flat", ("optics", "crystal", "origin_y")),
    ("plane_crystal_flat", ("optics", "crystal", "crystal_spacing")),
    ("sphere_mirror_isotropic", ("optics", "mirror", "origin_y")),
    ("sphere_mirror_isotropic", ("optics", "mirror", "radius")),
    ("convex_sphere_flat_xy", ("optics", "crystal", "radius")),
    ("convex_sphere_flat_xy", ("optics", "crystal", "origin_y")),
    ("cylinder_crystal", ("optics", "crystal", "crystal_spacing")),
    ("cylinder_crystal", ("optics", "crystal", "radius")),
    ("convex_cylinder_mirror", ("optics", "mirror", "origin_y")),
    ("convex_cylinder_mirror", ("optics", "mirror", "radius")),
    ("uniform_wavelength", ("optics", "crystal", "crystal_spacing")),
    ("uniform_wavelength", ("optics", "crystal", "rocking_fwhm")),
    ("torus_crystal", ("optics", "crystal", "radius_minor")),
    ("torus_crystal", ("optics", "crystal", "radius_major")),
    ("convex_torus_mirror", ("optics", "mirror", "origin_y")),
    ("convex_torus_mirror", ("optics", "mirror", "radius_minor")),
    ("file_rocking", ("optics", "crystal", "crystal_spacing")),
    ("step_rocking", ("optics", "crystal", "origin_y")),
    ("zsize_sphere_mirror", ("optics", "mirror", "origin_y")),
    ("plasma_cubic", ("sources", "plasma", "temperature")),
    ("plasma_cubic", ("optics", "crystal", "crystal_spacing")),
    ("mosaic_sphere", ("optics", "crystal", "crystal_spacing")),
    ("focused_gaussian_voigt", ("optics", "crystal", "crystal_spacing")),
    ("asym_xy_crystal", ("optics", "crystal", "origin_y")),
    ("asym_xy_crystal", ("optics", "detector", "origin_y")),
]


def _with_value(params, path, value):
    """A copy of ``params`` with the leaf at ``path`` set to ``value``;
    ``origin_y`` shifts the element's frame along global y."""
    section, name, leaf = path
    out = dict(params)
    out[section] = dict(params[section])
    element = dict(params[section][name])
    if leaf == "origin_y":
        frame = element["frame"]
        shift = jnp.asarray([0.0, 1.0, 0.0], frame.origin.dtype) * value
        element["frame"] = dataclasses.replace(frame,
                                               origin=frame.origin + shift)
    else:
        element[leaf] = value
    out[section][name] = element
    return out


@pytest.mark.parametrize("kind,path", CASES,
                         ids=[f"{k}-{p[1]}.{p[2]}" for k, p in CASES])
def test_grad_matches_central_difference(kind, path):
    config = variant_config(kind)
    config["general"]["dtype"] = "float64"
    if kind.startswith("mosaic"):
        # The cutoff prefilter is a hard mask, like an optic's edge.
        config["optics"]["crystal"]["mosaic_cutoff"] = None
    image_fn, pipeline = make_differentiable(config, platform="gpu")
    params = pipeline.params
    key = jax.random.key(11)
    rng = np.random.default_rng(0)
    pixel_w = {o.name: jnp.asarray(rng.normal(size=tuple(
        int(v) for v in o.image_shape))) for o in pipeline.optics
        if o.enable_image}
    if kind.startswith("mosaic"):
        # The mosaic picks each ray's reflecting layer at random with
        # parameter-dependent odds, so downstream images jump where a pick
        # flips; the crystal image (hit position times survival weight)
        # is smooth.
        pixel_w = {"crystal": pixel_w["crystal"]}

    v0 = (jnp.zeros((), jnp.float64) if path[2] == "origin_y"
          else jnp.asarray(params[path[0]][path[1]][path[2]]))

    @jax.jit
    def loss(v):
        images = image_fn(_with_value(params, path, v), key)
        return sum(jnp.sum(images[n] * w) for n, w in pixel_w.items())

    g = float(jax.grad(loss)(v0))
    eps = 1e-7 * max(abs(float(v0)), 1e-3)
    fd = float((loss(v0 + eps) - loss(v0 - eps)) / (2 * eps))
    assert g != 0.0, "the parameter does not reach the images"
    np.testing.assert_allclose(g, fd, rtol=1e-4)
