"""Image binning routes on the sources: the GPU's chunked one-hot/tent
matrix product equals the CPU's scatter-add on the same rays, in mc and
weight interaction modes and for nearest and bilinear images.

The sources cover extended, gaussian and focused sources, every angular
distribution, Voigt and uniform wavelengths with Doppler shifts, Poisson
budgets, a sightline filter, and plasmas with 100 and 6000 bundles.
"""

import pytest

from tests.configs import CHAINS, MODES, assert_routes_agree

SOURCE_CHAINS = [
    "extended_voigt_source", "gaussian_uniform_velocity", "poisson_budget",
    "focused_source", "angular_flat", "angular_flat_xy", "angular_gaussian",
    "angular_isotropic_xy_asymmetric", "sightline_filter",
    "plasma_spherical", "plasma_toroidal_multi_iter", "plasma_6000_bundles",
]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("chain", SOURCE_CHAINS)
def test_routes_agree(chain, mode):
    assert_routes_agree(CHAINS[chain](2048), mode)
