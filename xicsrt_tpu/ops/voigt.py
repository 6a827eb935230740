"""Voigt line-shape sampling.

Replaces ``xicsrt/tools/xicsrt_voigt.py``: the CDF table is precomputed once
on the host (float64, scipy Faddeeva function) and inverse-transform sampling
runs on device as a fixed-shape ``jnp.interp`` — the device analog of the
reference's tabulated-CDF `voigt_random` (:119-130).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from scipy.special import wofz


def voigt_profile(x, intensity, location, sigma, gamma):
    """Voigt profile via the Faddeeva function (host-side, numpy)."""
    z = (np.asarray(x) - location + 1j * gamma) / math.sqrt(2.0) / sigma
    return wofz(z).real / math.sqrt(2.0 * math.pi) / sigma * intensity


def voigt_cdf_table(gamma, sigma, gridsize: int = 1000, cutoff: float = 1e-5):
    """Tabulate the Voigt CDF on a variable-density grid (host-side).

    Grid design: points are spaced geometrically denser near the line center
    (spacing proportional to the half-width) and extend to where the profile
    falls to ``cutoff`` of its peak — the same variable-density idea as the
    reference's ``voigt_cdf_tab`` (:30-92) without its fixed constants.

    Returns (x, cdf) as float64 numpy arrays.
    """
    if gamma <= 0.0 and sigma <= 0.0:
        raise ValueError("voigt_cdf_table requires gamma > 0 or sigma > 0.")
    if sigma <= 0.0:
        # Pure Lorentzian: analytic CDF, tabulate directly.
        hw = gamma
    elif gamma <= 0.0:
        hw = sigma * math.sqrt(2.0 * math.log(2.0))
    else:
        g_hw = sigma * math.sqrt(2.0 * math.log(2.0))
        hw = 0.5346 * gamma + math.sqrt(0.2166 * gamma**2 + g_hw**2)

    # Extent covering the cutoff for both components.
    lorentz_cut = gamma * math.sqrt(1.0 / cutoff - 1.0) if gamma > 0 else 0.0
    gauss_cut = (
        sigma * math.sqrt(max(-2.0 * math.log(cutoff * sigma * math.sqrt(2 * math.pi)), 1.0))
        if sigma > 0
        else 0.0
    )
    extent = max(lorentz_cut, gauss_cut, 10.0 * hw)

    # Symmetric sinh-spaced grid: dense (spacing ~ hw/10) near 0, stretching
    # geometrically to the cutoff extent.
    half = gridsize // 2
    t = np.linspace(0.0, 1.0, half + 1)
    stretch = np.arcsinh(extent / (hw / 2.0))
    pos = (hw / 2.0) * np.sinh(t * stretch)
    bounds = np.concatenate([-pos[::-1], pos[1:]])
    centers = 0.5 * (bounds[:-1] + bounds[1:])

    if sigma <= 0.0:
        pdf = gamma / math.pi / (centers**2 + gamma**2)
    else:
        pdf = voigt_profile(centers, 1.0, 0.0, sigma, max(gamma, 0.0))
    cdf = np.cumsum(pdf * np.diff(bounds))
    if cdf.max() < 0.99:
        raise ValueError("Voigt CDF table domain too small.")
    return bounds[1:], cdf


def sample_voigt_tabulated(key, n: int, x_tab, cdf_tab, dtype=jnp.float32):
    """Inverse-transform sampling on device from a precomputed CDF table."""
    x_tab = jnp.asarray(x_tab, dtype=dtype)
    cdf_tab = jnp.asarray(cdf_tab, dtype=dtype)
    u = jax.random.uniform(
        key, (n,), dtype=dtype, minval=cdf_tab[0], maxval=cdf_tab[-1]
    )
    return jnp.interp(u, cdf_tab, x_tab)


def doppler_sigma(temperature_ev, mass_number, wavelength) -> float:
    """Gaussian sigma [Angstrom] from ion temperature (eV).

    sigma = sqrt(T / (m c^2)) * wavelength, with the constants spelled out in
    ``_XicsrtSourceGeneric.py:341-354``.
    """
    c = 299792458.0
    amu_kg = 1.66053906892e-27
    ev_j = 1.602176634e-19
    return math.sqrt(max(temperature_ev, 0.0) * ev_j / (mass_number * amu_kg * c**2)) * wavelength


def natural_gamma(linewidth_hz, wavelength) -> float:
    """Lorentzian gamma [Angstrom] from natural linewidth [1/s]."""
    c = 299792458.0
    return linewidth_hz * wavelength**2 / (4.0 * math.pi * c * 1e10)
