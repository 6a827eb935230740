"""Image binning routes on the optic chains: the GPU's chunked one-hot/tent
matrix product equals the CPU's scatter-add on the same rays, in mc and
weight interaction modes and for nearest and bilinear images.

The chains cover plane, spherical, cylindrical and toroidal surfaces
(concave and convex), mosaic crystals, file and step rocking curves, and
triangle meshes.
"""

import pytest

from tests.configs import CHAINS, MODES, assert_routes_agree

OPTIC_CHAINS = [
    "spectrometer", "plane_mirror_step_crystal", "convex_sphere_mirror",
    "cylindrical_crystal", "toroidal_crystal", "file_rocking",
    "mosaic_crystal", "mosaic_cutoff", "mosaic_file_rocking",
    "convex_torus_both", "convex_torus_major", "torus_wide_grazing",
    "convex_cylinder_mirror", "mesh_sphere", "mesh_cylinder", "mesh_torus",
    "faceted_mesh",
]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("chain", OPTIC_CHAINS)
def test_routes_agree(chain, mode):
    assert_routes_agree(CHAINS[chain](2048), mode)
