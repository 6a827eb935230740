"""Statistical parity vs the CPU reference for the remaining optic families.

Golden data under tests/golden/ is produced by *executing* the reference
implementation (PrincetonUniversity/xicsrt v0.8.13 at /root/reference) via
``tests/golden/generate_goldens.py`` on three crystal variants of the
example_01 spectrometer geometry:

- ``torus``       — XicsrtOpticToroidalCrystal (quartic solver,
                    reference ``_ShapeTorus.py:110-183``)
- ``mesh_sphere`` — XicsrtOpticMeshSphericalCrystal (Möller–Trumbore +
                    refinement, reference ``_ShapeMesh.py:289-426``)
- ``mosaic``      — XicsrtOpticSphericalMosaicCrystal (multi-layer mosaic
                    loop, reference ``_InteractMosaicCrystal.py:53-107``)

The two codes use independent RNGs, so all comparisons are distributional:
Poisson tolerances on acceptance/efficiency, chi-square on coarse-grained
images, and moment matching of the spectral line.
"""

import os

import numpy as np
import pytest

import xicsrt_tpu

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

CRYSTALS = {
    # The torus focusing accepts very few rays at the stock 48-urad rocking
    # width (16 counts / 1e6 rays in the round-1 golden, which made the
    # image chi-square test vacuous); a 1e-3 width exercises the identical
    # quartic-solver path with usable statistics.
    "torus": dict(
        class_name="XicsrtOpticToroidalCrystal",
        radius_major=1.0,
        radius_minor=0.2,
        rocking_fwhm=1e-3,
    ),
    "mesh_sphere": dict(
        class_name="XicsrtOpticMeshSphericalCrystal",
        radius=1.0,
        mesh_size=(21, 21),
        mesh_coarse_size=(7, 7),
    ),
    "mosaic": dict(
        class_name="XicsrtOpticSphericalMosaicCrystal",
        radius=1.0,
        mosaic_spread=np.radians(0.05),
        mosaic_depth=15,
        rocking_fwhm=150e-6,
    ),
}

# The mosaic line is broadened by the crystallite distribution; allow a
# looser width match there (moment widths are sensitive to far tails).
WIDTH_RTOL = {"torus": 0.05, "mesh_sphere": 0.08, "mosaic": 0.15}


def _config(crystal, intensity=1e5, num_iter=5):
    crystal_config = dict(crystal)
    crystal_config.update(
        origin=[0.0, 0.0, 0.80374151],
        zaxis=[0.0, 0.59497864, -0.80374151],
        xsize=0.2,
        ysize=0.2,
        crystal_spacing=2.45676,
        rocking_type="gaussian",
    )
    crystal_config.setdefault("rocking_fwhm", 48.070e-6)
    return {
        "general": {
            "number_of_iter": num_iter,
            "random_seed": 11,
            "print_results": False,
            "keep_history": False,
        },
        "sources": {
            "source": {
                "class_name": "XicsrtSourceDirected",
                "intensity": intensity,
                "wavelength": 3.9492,
                "spread": np.radians(10.0),
            }
        },
        "optics": {
            "crystal": crystal_config,
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084],
                "xsize": 0.4,
                "ysize": 0.2,
                "pixel_size": 0.004,
            },
        },
    }


def _load_golden(name):
    path = os.path.join(GOLDEN_DIR, f"{name}_reference_image.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden data missing: {path}")
    data = np.load(path)
    return {k: data[k] for k in data.files}


@pytest.fixture(scope="module", params=sorted(CRYSTALS))
def scenario(request):
    name = request.param
    golden = _load_golden(name)
    num_iter = 2 if name == "mesh_sphere" else 5  # mesh is CPU-slow in tests
    ours = xicsrt_tpu.raytrace(_config(CRYSTALS[name], num_iter=num_iter))
    return name, golden, ours


def _ratio_sigma(k_ours, n_ours, k_ref, n_ref):
    p = (k_ours + k_ref) / (n_ours + n_ref)
    return np.sqrt(p / n_ours + p / n_ref)


class TestFamilyParity:
    def test_crystal_acceptance(self, scenario):
        name, golden, ours = scenario
        n_gen = ours["total"]["meta"]["source"]["num_out"]
        k_ours = ours["total"]["meta"]["crystal"]["num_out"]
        n_ref = float(golden["n_generated"])
        k_ref = float(golden["meta_crystal"])
        sigma = _ratio_sigma(k_ours, n_gen, k_ref, n_ref)
        assert abs(k_ours / n_gen - k_ref / n_ref) < 5 * sigma, (
            f"{name}: acceptance {k_ours / n_gen:.5f} vs ref {k_ref / n_ref:.5f}"
        )

    def test_efficiency(self, scenario):
        name, golden, ours = scenario
        n_gen = ours["total"]["meta"]["source"]["num_out"]
        k_ours = ours["total"]["meta"]["detector"]["num_out"]
        n_ref = float(golden["n_generated"])
        k_ref = float(golden["meta_detector"])
        sigma = _ratio_sigma(k_ours, n_gen, k_ref, n_ref)
        assert abs(k_ours / n_gen - k_ref / n_ref) < 5 * sigma, (
            f"{name}: efficiency {k_ours / n_gen:.5f} vs ref {k_ref / n_ref:.5f}"
        )

    def test_image_distribution_superpixels(self, scenario):
        name, golden, ours = scenario
        ref = golden["image"].astype(np.float64)
        img = ours["total"]["image"]["detector"].astype(np.float64)
        assert img.shape == ref.shape
        sp = lambda a: a.reshape(10, 10, 5, 10).sum(axis=(1, 3))
        R = sp(ref)
        O = sp(img)
        scale = R.sum() / O.sum()
        O = O * scale
        keep = (R + O) > 50
        # The comparison must never silently test nothing.
        assert keep.sum() > 0, f"{name}: no superpixel has enough counts"
        # Variance of scaled ours is scale * O; of ref is R.
        chi2 = ((O[keep] - R[keep]) ** 2 / (R[keep] + scale * O[keep])).sum()
        ndof = int(keep.sum())
        assert chi2 / ndof < 3.0, f"{name}: chi2/ndof = {chi2 / ndof:.2f}"

    def test_line_position_and_width(self, scenario):
        name, golden, ours = scenario
        ref = golden["image"].astype(np.float64).sum(axis=0)
        img = ours["total"]["image"]["detector"].astype(np.float64).sum(axis=0)
        ys = np.arange(len(ref))

        def moments(p):
            p = p / p.sum()
            mu = (p * ys).sum()
            sd = np.sqrt((p * (ys - mu) ** 2).sum())
            return mu, sd

        mu_r, sd_r = moments(ref)
        mu_o, sd_o = moments(img)
        assert abs(mu_o - mu_r) < 0.75, f"{name}: centroid {mu_o:.2f} vs {mu_r:.2f}"
        if sd_r < 1.0:
            # The line is unresolved at this pixel size (torus/mesh focusing
            # is tighter than 1 px); the moment width then measures pixel
            # aliasing, not physics — require ours to be unresolved too.
            assert sd_o < 1.0, f"{name}: width {sd_o:.2f} px vs ref <1 px"
        else:
            rtol = WIDTH_RTOL[name]
            assert abs(sd_o - sd_r) < rtol * sd_r, (
                f"{name}: width {sd_o:.2f} vs {sd_r:.2f}"
            )
