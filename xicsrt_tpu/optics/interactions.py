"""Interaction mixins: pass-through, mirror, Bragg crystal, mosaic crystal.

Physics matches the reference interactions:

- mirror: specular reflection (``optics/_InteractMirror.py:29-42``)
- crystal: rocking-curve Bragg acceptance (``optics/_InteractCrystal.py:90-196``)
- mosaic: fixed-depth multi-layer crystallite model
  (``optics/_InteractMosaicCrystal.py:53-139``)

Differences from the reference:

- randomness is an explicit key (no global RNG state);
- two acceptance modes: ``mc`` reproduces the reference's Bernoulli
  acceptance; ``weight`` multiplies the ray weight by the reflection
  probability instead — differentiable w.r.t. pose, d-spacing and rocking
  width, and lower variance;
- the mosaic layer loop is a fixed-trip ``lax.fori_loop`` with masked
  convergence (static shapes, no early exit).
"""

from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp

from xicsrt_tpu.ops import vector as vec
from xicsrt_tpu.ops.spread import sample_flat_gaussian
from xicsrt_tpu.optics.base import TraceElement
from xicsrt_tpu.rays import Rays
from xicsrt_tpu.utils import bragg_files

_FWHM_TO_SIGMA = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))


class InteractNone(TraceElement):
    """Pass-through surface (detectors, apertures)."""

    def make_interact(self):
        def interact(params, rays: Rays, xloc, norm, mask, key):
            return rays.replace(mask=mask)

        return interact


class InteractMirror(TraceElement):
    """Perfect specular mirror."""

    def make_interact(self):
        def interact(params, rays: Rays, xloc, norm, mask, key):
            reflected = vec.reflect(rays.direction, norm)
            direction = jnp.where(mask[:, None], reflected, rays.direction)
            return rays.replace(direction=direction, mask=mask)

        return interact


class InteractCrystal(InteractMirror):
    """Bragg-reflecting crystal with step/gaussian/file rocking curves."""

    def default_config(self) -> dict:
        """
        crystal_spacing: nominal 'd' plane spacing [Angstrom] (not '2d').
        reflectivity: scalar probability multiplier.
        check_bragg: if False, acts as a perfect mirror.
        rocking_type: 'step' | 'gaussian' | 'file'.
        rocking_fwhm: curve width [rad] for step/gaussian.
        rocking_file / rocking_filetype: tabulated curve ('xop' supported).
        rocking_mix: sigma/pi mixing factor: p = mix*sigma + (1-mix)*pi.
        """
        config = super().default_config()
        config["crystal_spacing"] = 0.0
        config["reflectivity"] = 1.0
        config["check_bragg"] = True
        config["rocking_type"] = "gaussian"
        config["rocking_fwhm"] = None
        config["rocking_file"] = None
        config["rocking_filetype"] = None
        config["rocking_mix"] = 0.5
        return config

    def initialize(self):
        super().initialize()
        self.param["rocking_type"] = str(self.param["rocking_type"]).lower()
        if self.param["rocking_type"] == "file":
            self.rocking_table = bragg_files.read(
                self.param["rocking_file"], self.param["rocking_filetype"]
            )
        else:
            self.rocking_table = None

    def build_params(self) -> dict:
        params = super().build_params()
        params["crystal_spacing"] = self.as_array(self.param["crystal_spacing"])
        params["reflectivity"] = self.as_array(self.param["reflectivity"])
        if not self.param["check_bragg"]:
            return params
        if self.param["rocking_type"] in ("step", "gaussian"):
            fwhm = self.param["rocking_fwhm"]
            if fwhm is None:
                raise ValueError(
                    f'Optic "{self.name}": rocking_fwhm required for '
                    f'rocking_type={self.param["rocking_type"]}.'
                )
            params["rocking_fwhm"] = self.as_array(fwhm)
        if self.rocking_table is not None:
            params["rocking_dtheta"] = self.as_array(self.rocking_table["dtheta"])
            params["rocking_sigma"] = self.as_array(self.rocking_table["reflect_s"])
            params["rocking_pi"] = self.as_array(self.rocking_table["reflect_p"])
            params["rocking_mix"] = self.as_array(self.param["rocking_mix"])
        return params

    # ------------------------------------------------------------------
    def make_reflection_probability(self):
        """Returns fn(params, delta_angle) -> probability in [0, 1].

        ``delta_angle`` = incident - bragg. Curve shapes per
        ``_InteractCrystal.rocking_curve_filter`` (:136-186).
        """
        rocking_type = self.param["rocking_type"]

        if rocking_type == "step":

            def prob(params, delta):
                return jnp.where(
                    jnp.abs(delta) <= params["rocking_fwhm"] / 2.0, 1.0, 0.0
                )

        elif rocking_type == "gaussian":

            def prob(params, delta):
                sigma = params["rocking_fwhm"] * _FWHM_TO_SIGMA
                return jnp.exp(-0.5 * (delta / sigma) ** 2)

        elif rocking_type == "file":

            def prob(params, delta):
                s = jnp.interp(
                    delta, params["rocking_dtheta"], params["rocking_sigma"],
                    left=0.0, right=0.0,
                )
                p = jnp.interp(
                    delta, params["rocking_dtheta"], params["rocking_pi"],
                    left=0.0, right=0.0,
                )
                mix = params["rocking_mix"]
                return mix * s + (1.0 - mix) * p

        else:
            raise ValueError(f"Rocking curve type not understood: {rocking_type}")

        def scaled(params, delta):
            return prob(params, delta) * params["reflectivity"]

        return scaled

    @staticmethod
    def angle_calc(params, rays: Rays, norm):
        """(bragg_angle, incident_angle) per ray; cf. ``angle_calc`` :96-114."""
        bragg = jnp.arcsin(
            jnp.clip(rays.wavelength / (2.0 * params["crystal_spacing"]), -1.0, 1.0)
        )
        dot = jnp.abs(vec.dot(rays.direction, norm))
        incident = jnp.arcsin(jnp.clip(dot, 0.0, 1.0))
        return bragg, incident

    def make_interact(self):
        if not self.param["check_bragg"]:
            return super().make_interact()
        prob_fn = self.make_reflection_probability()
        mode = self.interact_mode
        if mode not in ("mc", "weight"):
            raise ValueError(f"Unknown interact_mode: {mode}")

        def interact(params, rays: Rays, xloc, norm, mask, key):
            bragg, incident = self.angle_calc(params, rays, norm)
            p = prob_fn(params, incident - bragg)
            if mode == "mc":
                u = jax.random.uniform(key, (rays.n,), dtype=rays.dtype)
                mask = mask & (p >= u)
                weight = rays.weight
            else:
                weight = jnp.where(mask, rays.weight * p, rays.weight)
            reflected = vec.reflect(rays.direction, norm)
            direction = jnp.where(mask[:, None], reflected, rays.direction)
            return rays.replace(direction=direction, mask=mask, weight=weight)

        return interact


class InteractMosaicCrystal(InteractCrystal):
    """Multi-layer mosaic (HOPG) crystal model.

    Crystallite normals are drawn per layer from a flat-gaussian distribution
    around the surface normal; rays reflect at the first layer whose
    crystallite satisfies the rocking-curve acceptance. Fixed depth with
    masked convergence replaces the reference's data-dependent early break
    (``_InteractMosaicCrystal.py:83-104``).
    """

    def default_config(self) -> dict:
        """
        mosaic_spread: fwhm [rad] of the crystallite normal distribution.
        mosaic_depth: number of crystallite layers to model (static).
        mosaic_cutoff: optional probability cutoff prefilter.
        """
        config = super().default_config()
        config["mosaic_spread"] = 0.0
        config["mosaic_depth"] = 15
        config["mosaic_cutoff"] = None
        return config

    def make_interact(self):
        if not self.param["check_bragg"]:
            return InteractMirror.make_interact(self)
        prob_fn = self.make_reflection_probability()
        mode = self.interact_mode
        depth = int(self.param["mosaic_depth"])
        spread_hwhm = float(self.param["mosaic_spread"]) / 2.0
        cutoff = self.param["mosaic_cutoff"]
        mosaic_sigma = float(self.param["mosaic_spread"]) * _FWHM_TO_SIGMA

        def mosaic_normals(norm, layer_key, n, dtype):
            dir_local = sample_flat_gaussian(layer_key, n, spread_hwhm, dtype=dtype)
            # Per-ray basis around the macroscopic normal; hint axes chosen
            # as in the reference (``mosaic_normals`` :109-139).
            e1 = jnp.asarray([1.0, 0.0, 0.0], dtype=dtype)
            e3 = jnp.asarray([0.0, 0.0, 1.0], dtype=dtype)
            basis = vec.orthogonal_basis(norm, e1, e3)
            return vec.rotate_to_frame(dir_local, basis)

        def interact(params, rays: Rays, xloc, norm, mask, key):
            n = rays.n
            dtype = rays.dtype
            if cutoff is not None:
                bragg, incident = self.angle_calc(params, rays, norm)
                angle_cutoff = math.sqrt(-math.log(cutoff) * 2.0) * mosaic_sigma
                mask = mask & (jnp.abs(bragg - incident) < angle_cutoff)

            if mode == "mc":

                def layer(ii, carry):
                    direction, reflected_mask = carry
                    layer_key = jax.random.fold_in(key, ii)
                    k_norm, k_accept = jax.random.split(layer_key)
                    norm_m = mosaic_normals(norm, k_norm, n, dtype)
                    tmp_rays = rays.replace(direction=direction)
                    bragg, incident = self.angle_calc(params, tmp_rays, norm_m)
                    p = prob_fn(params, incident - bragg)
                    active = mask & ~reflected_mask
                    u = jax.random.uniform(k_accept, (n,), dtype=dtype)
                    accept = active & (p >= u)
                    refl = vec.reflect(direction, norm_m)
                    direction = jnp.where(accept[:, None], refl, direction)
                    return direction, reflected_mask | accept

                direction, reflected_mask = jax.lax.fori_loop(
                    0, depth, layer,
                    (rays.direction, jnp.zeros(n, dtype=bool)),
                )
                return rays.replace(
                    direction=direction, mask=mask & reflected_mask
                )

            # Weight mode: depth-aware survival weighting. With per-layer
            # acceptance probabilities p_i over the same sampled crystallite
            # normals as mc mode, the ray reflects with total probability
            # P = 1 - prod_i(1 - p_i), at layer i with probability
            # q_i = p_i * prod_{j<i}(1 - p_j). The weight multiplies by P
            # (differentiable through every layer's p_i); the outgoing
            # direction is drawn from the exact conditional distribution
            # q_i / P by online categorical (reservoir) sampling, so the
            # expected image matches the mc estimator while gradients flow
            # through pose, d-spacing, rocking width and mosaic spread.
            # (Replaces the round-1 single-layer approximation;
            # cf. _InteractMosaicCrystal.py:53-139.)
            def layer(ii, carry):
                chosen_dir, surv, cum = carry
                layer_key = jax.random.fold_in(key, ii)
                k_norm, k_pick = jax.random.split(layer_key)
                norm_m = mosaic_normals(norm, k_norm, n, dtype)
                bragg, incident = self.angle_calc(params, rays, norm_m)
                p = prob_fn(params, incident - bragg)
                q = p * surv
                cum_new = cum + q
                u = jax.random.uniform(k_pick, (n,), dtype=dtype)
                pick = u * cum_new < q  # replace prob q / cum_new
                refl = vec.reflect(rays.direction, norm_m)
                chosen_dir = jnp.where(pick[:, None], refl, chosen_dir)
                return chosen_dir, surv * (1.0 - p), cum_new

            ones = jnp.ones(n, dtype=dtype)
            chosen_dir, surv, cum = jax.lax.fori_loop(
                0, depth, layer, (rays.direction, ones, ones * 0.0)
            )
            p_total = cum  # == 1 - prod_i(1 - p_i)
            weight = jnp.where(mask, rays.weight * p_total, rays.weight)
            reflected = mask & (p_total > 0.0)
            direction = jnp.where(
                reflected[:, None], chosen_dir, rays.direction
            )
            return rays.replace(direction=direction, mask=mask, weight=weight)

        return interact
