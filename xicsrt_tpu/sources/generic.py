"""Volumetric ray sources.

Vectorized rebuild of ``xicsrt/sources/_XicsrtSourceGeneric.py`` (and the
Directed/Focused variants): a source compiles to a pure function
``generate(params, key) -> Rays`` with a *static* ray budget. Poisson ray
counts (``use_poisson``) are drawn on device and realized by masking the
fixed-size bundle — photon statistics stay exactly Poisson while shapes stay
static for XLA.
"""

from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp

from xicsrt_tpu.dispatch import GeometryElement, register
from xicsrt_tpu.ops import spread as spread_ops
from xicsrt_tpu.ops import voigt as voigt_ops
from xicsrt_tpu.ops import vector as vec
from xicsrt_tpu.rays import Rays

_C_LIGHT = 299792458.0
_SIGMA_TO_FWHM = 2.0 * math.sqrt(2.0 * math.log(2.0))


def poisson_budget(expected: float) -> int:
    """Static array size comfortably above a Poisson draw of ``expected``.

    6.5 sigma + margin: overflow probability < 1e-10 per draw.
    """
    expected = float(expected)
    return int(expected + 6.5 * math.sqrt(max(expected, 1.0)) + 16)


@register("XicsrtSourceGeneric", "source_generic")
class SourceGeneric(GeometryElement):
    """Extended rectangular source emitting along its z-axis."""

    def default_config(self) -> dict:
        """
        Config mirrors ``XicsrtSourceGeneric.default_config`` (:26-186):
        xsize/ysize/zsize, spatial_dist ('uniform'|'gaussian'), angular_dist
        ('isotropic'|'isotropic_xy'|'flat'|'flat_xy'|'gaussian'), spread,
        intensity, use_poisson, wavelength_dist ('voigt'|'uniform'|
        'monochrome'), wavelength, wavelength_range, linewidth, temperature,
        mass_number, velocity, filters.
        """
        config = super().default_config()
        config["xsize"] = 0.0
        config["ysize"] = 0.0
        config["zsize"] = 0.0
        config["intensity"] = 0.0
        config["use_poisson"] = False
        config["spatial_dist"] = "uniform"
        config["angular_dist"] = "isotropic"
        config["spread"] = np.pi
        config["wavelength_dist"] = "voigt"
        config["wavelength"] = 1.0
        config["mass_number"] = 1.0
        config["linewidth"] = 0.0
        config["temperature"] = 0.0
        config["velocity"] = np.array([0.0, 0.0, 0.0])
        config["wavelength_range"] = np.array([0.0, 0.0])
        config["filters"] = []
        # Internal: per-device work fraction set by the sharded engine
        # (parallel/mesh.py). Scales the Poisson rate (or ray count) so an
        # n-device psum reproduces single-device photon statistics exactly
        # (independent-Poisson split; cf. the reference's one-full-run-per-
        # process division, xicsrt_multiprocessing.py:48-56).
        config["intensity_scale"] = 1.0
        return config

    def initialize(self):
        super().initialize()
        scale = float(self.param["intensity_scale"])
        intensity = float(self.param["intensity"]) * scale
        if self.param["use_poisson"]:
            self.num_rays = poisson_budget(intensity)
        else:
            n = int(round(intensity))
            if abs(intensity - n) > 1e-9:
                import logging

                logging.getLogger("xicsrt_tpu").warning(
                    'Source "%s": intensity*intensity_scale = %g is not an '
                    "integer; using %d rays.", self.name, intensity, n,
                )
            if n < 1:
                raise ValueError(
                    "intensity of less than one encountered (after "
                    "intensity_scale). Turn on poisson statistics."
                )
            self.num_rays = n
        self._scaled_intensity = intensity
        self._setup_wavelength()

    # ------------------------------------------------------------------
    def _setup_wavelength(self):
        """Precompute the Voigt CDF table on the host (float64)."""
        self.voigt_table = None
        wtype = str(self.param["wavelength_dist"]).lower()
        if wtype != "voigt":
            return
        gamma = voigt_ops.natural_gamma(
            float(self.param["linewidth"]), float(self.param["wavelength"])
        )
        sigma = voigt_ops.doppler_sigma(
            float(self.param["temperature"]),
            float(self.param["mass_number"]),
            float(self.param["wavelength"]),
        )
        if gamma <= 0.0 and sigma <= 0.0:
            return  # degenerates to monochrome
        self.voigt_table = voigt_ops.voigt_cdf_table(gamma, sigma)

    # ------------------------------------------------------------------
    def build_params(self) -> dict:
        params = super().build_params()
        params["velocity"] = self.as_array(self.param["velocity"], (3,))
        params["wavelength"] = self.as_array(self.param["wavelength"])
        if self.voigt_table is not None:
            params["voigt_x"] = self.as_array(self.voigt_table[0])
            params["voigt_cdf"] = self.as_array(self.voigt_table[1])
        return params

    # --- sampling stages ------------------------------------------------
    def make_sample_origin(self):
        spatial = str(self.param["spatial_dist"]).lower()
        sizes = tuple(
            float(self.param[k] or 0.0) for k in ("xsize", "ysize", "zsize")
        )
        n = self.num_rays
        dtype = self.dtype

        if all(s == 0.0 for s in sizes):
            # Point source: no spatial randomness — skip the 3 uniform
            # draws per ray entirely (the bench profile showed RNG on the
            # hot path).
            def local_offsets(key):
                return jnp.zeros((n, 3), dtype=dtype)

        elif spatial == "uniform":

            def local_offsets(key):
                u = jax.random.uniform(
                    key, (n, 3), dtype=dtype, minval=-0.5, maxval=0.5
                )
                return u * jnp.asarray(sizes, dtype=dtype)

        elif spatial == "gaussian":
            sigmas = tuple(s / _SIGMA_TO_FWHM for s in sizes)

            def local_offsets(key):
                g = jax.random.normal(key, (n, 3), dtype=dtype)
                return g * jnp.asarray(sigmas, dtype=dtype)

        else:
            raise NotImplementedError(f"spatial_dist: {spatial} not implemented.")

        def sample_origin(params, key):
            frame = params["frame"]
            return frame.point_to_external(local_offsets(key))

        return sample_origin

    def make_normal(self):
        """Returns fn(params, origin) -> [N,3] emission-axis per ray."""

        def normal(params, origin):
            frame = params["frame"]
            return jnp.broadcast_to(frame.zaxis, origin.shape)

        return normal

    def make_sample_direction(self):
        angular = str(self.param["angular_dist"]).lower()
        spread = self.param["spread"]
        n = self.num_rays
        dtype = self.dtype
        normal_fn = self.make_normal()

        def sample_direction(params, key, origin):
            frame = params["frame"]
            normal = normal_fn(params, origin)
            local = spread_ops.sample_direction(key, n, spread, angular, dtype=dtype)
            # Per-ray basis hinted by the source axes so xy-asymmetric
            # distributions orient as in the reference (:282-292).
            basis = vec.orthogonal_basis(normal, frame.xaxis, frame.zaxis)
            return vec.rotate_to_frame(local, basis)

        return sample_direction

    def make_sample_wavelength(self):
        wtype = str(self.param["wavelength_dist"]).lower()
        n = self.num_rays
        dtype = self.dtype
        has_voigt = self.voigt_table is not None
        wl_range = np.asarray(self.param["wavelength_range"], dtype=np.float64)
        velocity_nonzero = bool(np.any(np.asarray(self.param["velocity"]) != 0.0))

        if wtype == "monochrome" or (wtype == "voigt" and not has_voigt):

            def base(params, key):
                return jnp.full((n,), 1.0, dtype=dtype) * params["wavelength"]

        elif wtype == "uniform":

            def base(params, key):
                return jax.random.uniform(
                    key, (n,), dtype=dtype,
                    minval=float(wl_range[0]), maxval=float(wl_range[1]),
                )

        elif wtype == "voigt":

            def base(params, key):
                offsets = voigt_ops.sample_voigt_tabulated(
                    key, n, params["voigt_x"], params["voigt_cdf"], dtype=dtype
                )
                return params["wavelength"] + offsets

        else:
            raise ValueError(f"Wavelength distribution {wtype} unknown")

        def sample_wavelength(params, key, direction):
            w = base(params, key)
            if velocity_nonzero:
                # First-order Doppler shift from the bulk velocity (:314-318).
                w = w * (1.0 - vec.dot(direction, params["velocity"]) / _C_LIGHT)
            return w

        return sample_wavelength

    def make_mask(self):
        n = self.num_rays
        use_poisson = bool(self.param["use_poisson"])
        intensity = self._scaled_intensity

        def make(params, key):
            if not use_poisson:
                return jnp.ones((n,), dtype=bool)
            count = jax.random.poisson(key, intensity)
            return jnp.arange(n) < count

        return make

    # ------------------------------------------------------------------
    def make_generate(self, filter_fns=None):
        """Compose the sampling pipeline (cf. ``generate_rays`` :198-227).

        ``filter_fns``: list of (filter_params_key, fn(fparams, origin, mask))
        wired by the engine from the config ``filters`` option.
        """
        sample_origin = self.make_sample_origin()
        sample_direction = self.make_sample_direction()
        sample_wavelength = self.make_sample_wavelength()
        make_mask = self.make_mask()
        dtype = self.dtype
        n = self.num_rays
        filter_fns = filter_fns or []

        def generate(params, filter_params, key):
            k_origin, k_dir, k_wave, k_mask = jax.random.split(key, 4)
            origin = sample_origin(params, k_origin)
            direction = sample_direction(params, k_dir, origin)
            wavelength = sample_wavelength(params, k_wave, direction)
            mask = make_mask(params, k_mask)
            for fkey, fn in filter_fns:
                mask = fn(filter_params[fkey], origin, mask)
            return Rays(
                origin=origin,
                direction=direction,
                wavelength=wavelength,
                weight=jnp.ones((n,), dtype=dtype),
                mask=mask,
            )

        return generate


@register("XicsrtSourceDirected", "source_directed")
class SourceDirected(SourceGeneric):
    """Source emitting a cone along a fixed ``direction`` (default zaxis).

    Cf. ``_XicsrtSourceDirected.py:15-50``.
    """

    def default_config(self) -> dict:
        config = super().default_config()
        config["direction"] = None
        return config

    def setup(self):
        super().setup()
        if self.param["direction"] is None:
            self.param["direction"] = np.asarray(self.param["zaxis"], dtype=np.float64)

    def build_params(self) -> dict:
        params = super().build_params()
        d = np.asarray(self.param["direction"], dtype=np.float64)
        params["direction"] = self.as_array(d / np.linalg.norm(d), (3,))
        return params

    def make_normal(self):
        def normal(params, origin):
            d = params["direction"]
            return jnp.broadcast_to(d / jnp.linalg.norm(d), origin.shape)

        return normal


@register("XicsrtSourceFocused", "source_focused")
class SourceFocused(SourceGeneric):
    """Source aiming each ray's emission cone at a fixed ``target`` point.

    Cf. ``_XicsrtSourceFocused.py:15-44``.
    """

    def default_config(self) -> dict:
        config = super().default_config()
        config["target"] = None
        return config

    def check_param(self):
        super().check_param()
        if self.param["target"] is None:
            raise ValueError(f'Source "{self.name}": target is required.')

    def build_params(self) -> dict:
        params = super().build_params()
        params["target"] = self.as_array(self.param["target"], (3,))
        return params

    def make_normal(self):
        def normal(params, origin):
            return vec.safe_normalize(params["target"][None, :] - origin)

        return normal
