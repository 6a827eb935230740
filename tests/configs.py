"""Configurations shared by the route-parity and gradient tests.

``CHAINS`` holds the optic chains and sources the engine supports, each a
``builder(intensity) -> config`` in mc mode with nearest images; the tests
switch interaction and image modes themselves. ``variant_config(kind)``
holds small weight-mode, bilinear-image chains for gradient checks.
``assert_routes_agree`` runs one iteration of a chain through both image
binning routes on the same rays.
"""

import numpy as np

# Interaction mode, image mode, dtype and tolerance of each route-parity
# case: counts of unit-weight rays are exact in any order of summation.
MODES = {
    "mc_nearest": ("mc", "nearest", "float32", 0.0),
    "weight_nearest": ("weight", "nearest", "float64", 1e-6),
    "weight_bilinear": ("weight", "bilinear", "float64", 1e-6),
}


def assert_routes_agree(config, mode, seed=5):
    """The engine's GPU binning route (the chunked matrix product, selected
    with ``platform='gpu'``) equals the CPU scatter route on the same key."""
    import jax

    from xicsrt_tpu.engine import Pipeline

    interact_mode, image_mode, dtype, rtol = MODES[mode]
    config["general"].update(interact_mode=interact_mode,
                             image_mode=image_mode, dtype=dtype)
    its = [Pipeline(config, platform=p).make_iteration(
        keep_history=False, keep_images=True) for p in ("gpu", "cpu")]
    params = Pipeline(config).params
    out_mm, out_sc = jax.jit(lambda p, k: [it(p, k) for it in its])(
        params, jax.random.key(seed))
    assert set(out_mm["image"]) == set(out_sc["image"]) != set()
    assert out_mm["meta"] == out_sc["meta"]
    signal = 0.0
    for name, img in out_sc["image"].items():
        a = np.asarray(out_mm["image"][name])
        b = np.asarray(img)
        assert a.dtype == np.dtype(dtype), (name, a.dtype)
        if rtol == 0.0:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol,
                                       atol=rtol * np.abs(b).max(),
                                       err_msg=name)
        signal += float(np.abs(b).sum())
    assert signal > 0, "no ray reached an imaging optic"

CRYSTAL_POSE = {
    "origin": [0.0, 0.0, 0.80374151],
    "zaxis": [0.0, 0.59497864, -0.80374151],
}
DETECTOR = {
    "class_name": "XicsrtOpticDetector",
    "origin": [0.0, 0.76871290, 0.56904832],
    "zaxis": [0.0, -0.95641806, 0.29200084],
    "xsize": 0.4, "ysize": 0.2,
}


def _general(**general):
    g = {"number_of_iter": 1, "random_seed": 0, "keep_history": False,
         "print_results": False}
    g.update(general)
    return g


def spectrometer(intensity, **general):
    """The flagship: directed source -> boolean aperture -> spherical
    crystal -> detector."""
    return {
        "general": _general(**general),
        "sources": {"source": {
            "class_name": "XicsrtSourceDirected",
            "intensity": intensity, "wavelength": 3.9492,
            "angular_dist": "isotropic_xy", "spread": np.radians(10.0),
        }},
        "optics": {
            "aperture": {
                "class_name": "XicsrtOpticAperture",
                "origin": [0.0, 0.0, 0.4], "zaxis": [0.0, 0.0, -1.0],
                "aperture": [
                    {"shape": "circle", "size": [0.09], "logic": "and"},
                    {"shape": "circle", "size": [0.03],
                     "origin": [-0.02, 0.0], "logic": "not"},
                ],
            },
            "crystal": dict(
                CRYSTAL_POSE, class_name="XicsrtOpticSphericalCrystal",
                xsize=0.2, ysize=0.2, radius=1.0, crystal_spacing=2.45676,
                rocking_type="gaussian", rocking_fwhm=48.070e-6),
            "detector": dict(DETECTOR),
        },
    }


def _crystal_chain(intensity, detector=True, **optic):
    """Directed source -> one optic (a crystal unless ``optic`` names a
    mirror class) -> detector."""
    optics = {"crystal": dict(CRYSTAL_POSE, xsize=0.2, ysize=0.2)}
    if "Mirror" not in optic["class_name"]:
        optics["crystal"].update(crystal_spacing=2.45676,
                                 rocking_type="gaussian",
                                 rocking_fwhm=150e-6)
    optics["crystal"].update(optic)
    if detector:
        optics["detector"] = dict(DETECTOR)
    return {
        "general": _general(),
        "sources": {"source": {
            "class_name": "XicsrtSourceDirected",
            "intensity": intensity, "wavelength": 3.9492,
            "angular_dist": "isotropic_xy", "spread": np.radians(10.0),
        }},
        "optics": optics,
    }


def _normal_incidence(intensity, spread_deg, **optic):
    """A narrow cone straight down onto a curved optic at z = 0.5."""
    config = _crystal_chain(intensity, detector=False, **optic)
    config["optics"]["crystal"].update(origin=[0.0, 0.0, 0.5],
                                       zaxis=[0.0, 0.0, -1.0])
    config["sources"]["source"].update(angular_dist="isotropic",
                                       spread=np.radians(spread_deg))
    return config


def _with_source(**source):
    def build(intensity):
        config = spectrometer(intensity)
        config["sources"]["source"].update(source)
        config["optics"]["crystal"]["rocking_fwhm"] = 200e-6
        return config
    return build


def _plane_mirror_step_crystal(intensity):
    """Mirror fold (plane) + step-rocking flat crystal at 45 degrees."""
    return {
        "general": _general(),
        "sources": {"source": {
            "class_name": "XicsrtSourceDirected",
            "intensity": intensity, "wavelength": 3.9492,
            "angular_dist": "isotropic", "spread": np.radians(5.0),
        }},
        "optics": {
            "mirror": {
                "class_name": "XicsrtOpticPlanarMirror",
                "origin": [0.0, 0.0, 0.5],
                "zaxis": [0.0, 0.3826834, -0.9238795],
                "xsize": 0.5, "ysize": 0.5,
            },
            "crystal": {
                "class_name": "XicsrtOpticPlanarCrystal",
                "origin": [0.0, 0.21213203, 0.28786797],
                "zaxis": [0.0, -1.0, 0.0],
                "xsize": 0.5, "ysize": 0.5,
                "crystal_spacing": 3.9492 / (2.0 * np.sin(np.pi / 4)),
                "rocking_type": "step", "rocking_fwhm": 5e-3,
            },
        },
    }


def _file_rocking(mosaic):
    def build(intensity):
        import tempfile

        from tests.test_coverage_extra import _write_xop_file

        xop = tempfile.mkdtemp() + "/diff_pat.dat"
        _write_xop_file(xop, fwhm=150e-6)
        crystal = dict(
            class_name="XicsrtOpticSphericalCrystal", radius=1.0,
            rocking_type="file", rocking_fwhm=None, rocking_file=xop,
            rocking_filetype="xop", rocking_mix=0.7)
        if mosaic:
            crystal.update(class_name="XicsrtOpticSphericalMosaicCrystal",
                           rocking_mix=0.6, mosaic_spread=np.radians(0.05),
                           mosaic_depth=8)
        return _crystal_chain(intensity, **crystal)
    return build


def _mesh(cls, **kw):
    def build(intensity):
        return _crystal_chain(intensity, class_name=cls, mesh_size=(41, 41),
                              mesh_coarse_size=(11, 11), **kw)
    return build


def _plasma(intensity, bundle_count=100, num_iter=1, **crystal):
    """Cubic plasma -> spherical (or given) crystal -> detector; the
    expected photon count per iteration is about ``intensity``."""
    spread = np.radians(10.0)
    emissivity = intensity / (1e-3 * 0.02**3 * np.sin(spread / 2) ** 2)
    config = _crystal_chain(intensity, **(crystal or dict(
        class_name="XicsrtOpticSphericalCrystal", radius=1.0)))
    config["general"]["number_of_iter"] = num_iter
    config["sources"] = {"plasma": {
        "class_name": "XicsrtPlasmaCubic",
        "origin": [0.0, 0.0, 0.0],
        "xsize": 0.02, "ysize": 0.02, "zsize": 0.02,
        "target": [0.0, 0.0, 0.80374151],
        "spread": spread, "emissivity": emissivity,
        "temperature": 500.0, "mass_number": 40.0,
        "wavelength": 3.9492, "time_resolution": 1e-3,
        "bundle_volume": 1e-6, "bundle_count": bundle_count,
        "max_bundles": max(bundle_count, 10000),
        "use_poisson": True,
    }}
    return config


def _sightline(intensity):
    config = spectrometer(intensity)
    config["optics"]["crystal"]["rocking_fwhm"] = 1e-3
    config["sources"]["source"].update(
        xsize=0.06, ysize=0.06, zsize=0.0, filters=["sight"])
    config["filters"] = {"sight": {
        "class_name": "XicsrtBundleFilterSightline",
        "origin": [0.01, 0.0, 0.0], "zaxis": [0.0, 0.0, 1.0],
        "radius": 0.02,
    }}
    return config


def _faceted_mesh(intensity):
    return _crystal_chain(
        intensity, class_name="XicsrtOpticMeshCrystal",
        mesh_points=[[-0.1, -0.1, 0.0], [0.1, -0.1, 0.0],
                     [-0.1, 0.1, 0.0], [0.1, 0.1, 0.0]],
        mesh_faces=[[0, 1, 2], [1, 3, 2]], mesh_interpolate=False,
        trace_local=True, rocking_fwhm=2e-3)


def _focused(intensity):
    config = spectrometer(intensity)
    src = config["sources"]["source"]
    src.pop("angular_dist")
    src.update(class_name="XicsrtSourceFocused",
               target=[0.0, 0.0, 0.80374151], xsize=0.02, ysize=0.02,
               zsize=0.0, spread=np.radians(8.0))
    return config


CHAINS = {
    "spectrometer": spectrometer,
    "plane_mirror_step_crystal": _plane_mirror_step_crystal,
    "convex_sphere_mirror": lambda n: _normal_incidence(
        n, 3.0, class_name="XicsrtOpticSphericalMirror", xsize=0.3,
        ysize=0.3, radius=2.0, convex=True),
    "extended_voigt_source": _with_source(
        xsize=0.01, ysize=0.01, zsize=0.005, wavelength_dist="voigt",
        linewidth=1e12, temperature=500.0, mass_number=40.0),
    "gaussian_uniform_velocity": _with_source(
        spatial_dist="gaussian", xsize=0.01, ysize=0.01, zsize=0.0,
        wavelength_dist="uniform", wavelength_range=[3.94, 3.96],
        velocity=[0.0, 0.0, 1e5]),
    "poisson_budget": _with_source(use_poisson=True),
    "focused_source": _focused,
    "angular_flat": _with_source(angular_dist="flat",
                                 spread=np.radians(8.0)),
    "angular_flat_xy": _with_source(
        angular_dist="flat_xy", spread=[np.radians(6.0), np.radians(9.0)]),
    "angular_gaussian": _with_source(angular_dist="gaussian",
                                     spread=np.radians(4.0)),
    "angular_isotropic_xy_asymmetric": _with_source(
        spread=[-np.radians(4.0), np.radians(9.0),
                -np.radians(5.0), np.radians(8.0)]),
    "cylindrical_crystal": lambda n: _crystal_chain(
        n, class_name="XicsrtOpticCylindricalCrystal", radius=1.0),
    "toroidal_crystal": lambda n: _crystal_chain(
        n, class_name="XicsrtOpticToroidalCrystal", radius_major=1.0,
        radius_minor=0.64, rocking_fwhm=1e-3),
    "file_rocking": _file_rocking(mosaic=False),
    "mosaic_crystal": lambda n: _crystal_chain(
        n, class_name="XicsrtOpticSphericalMosaicCrystal", radius=1.0,
        mosaic_spread=np.radians(0.05), mosaic_depth=10),
    "mosaic_cutoff": lambda n: _crystal_chain(
        n, class_name="XicsrtOpticSphericalMosaicCrystal", radius=1.0,
        mosaic_spread=np.radians(0.05), mosaic_depth=10, mosaic_cutoff=1e-4),
    "mosaic_file_rocking": _file_rocking(mosaic=True),
    "convex_torus_both": lambda n: _normal_incidence(
        n, 3.0, class_name="XicsrtOpticToroidalCrystal", xsize=0.15,
        ysize=0.15, radius_major=1.0, radius_minor=0.5,
        convex=[True, True], check_bragg=False),
    "convex_torus_major": lambda n: _normal_incidence(
        n, 3.0, class_name="XicsrtOpticToroidalCrystal", xsize=0.15,
        ysize=0.15, radius_major=1.0, radius_minor=0.5,
        convex=[True, False], check_bragg=False),
    "torus_wide_grazing": lambda n: _normal_incidence(
        n, 28.0, class_name="XicsrtOpticToroidalCrystal", xsize=0.5,
        ysize=0.5, radius_major=1.0, radius_minor=0.1, check_bragg=False,
        pixel_size=0.03125),
    "convex_cylinder_mirror": lambda n: _normal_incidence(
        n, 3.0, class_name="XicsrtOpticCylindricalMirror", xsize=0.3,
        ysize=0.3, radius=2.0, convex=True),
    "mesh_sphere": _mesh("XicsrtOpticMeshSphericalCrystal", radius=1.0),
    "mesh_cylinder": _mesh("XicsrtOpticMeshCylindricalCrystal", radius=1.0),
    "mesh_torus": _mesh("XicsrtOpticMeshToroidalCrystal", radius_major=1.0,
                        radius_minor=0.64, rocking_fwhm=2e-3),
    "faceted_mesh": _faceted_mesh,
    "sightline_filter": _sightline,
    "plasma_spherical": _plasma,
    "plasma_toroidal_multi_iter": lambda n: _plasma(
        n, num_iter=3, class_name="XicsrtOpticToroidalCrystal",
        radius_major=1.0, radius_minor=0.64, rocking_fwhm=2e-3),
    "plasma_6000_bundles": lambda n: _plasma(n, bundle_count=6000),
}


def variant_config(kind):
    """A small weight-mode, bilinear-image chain of one kind (1536 rays)."""
    base = {
        "general": {"number_of_iter": 1, "random_seed": 0,
                    "print_results": False, "keep_history": False,
                    "interact_mode": "weight", "image_mode": "bilinear"},
        "sources": {"source": {
            "class_name": "XicsrtSourceDirected",
            "intensity": 1536, "wavelength": 3.9492,
        }},
        "optics": {},
    }
    det = {
        "class_name": "XicsrtOpticDetector",
        "origin": [0.0, 0.76871290, 0.56904832],
        "zaxis": [0.0, -0.95641806, 0.29200084],
        "xsize": 0.4, "ysize": 0.2, "pixel_size": 0.01,
    }
    src = base["sources"]["source"]
    if kind == "plane_crystal_flat":
        src.update(angular_dist="flat", spread=np.radians(8.0))
        base["optics"]["crystal"] = {
            "class_name": "XicsrtOpticPlanarCrystal",
            "origin": [0.0, -3e-4, 0.80374151],
            "zaxis": [0.0, 0.59497864, -0.80374151],
            "xsize": 0.3, "ysize": 0.3,
            "crystal_spacing": 2.45676,
            "rocking_type": "gaussian", "rocking_fwhm": 1e-3,
        }
        base["optics"]["detector"] = det
    elif kind == "sphere_mirror_isotropic":
        src.update(angular_dist="isotropic", spread=np.radians(6.0),
                   xsize=0.01, ysize=0.01, zsize=0.005)
        base["optics"]["mirror"] = {
            "class_name": "XicsrtOpticSphericalMirror",
            "origin": [0.0, 0.0, 0.80374151],
            "zaxis": [0.0, 0.59497864, -0.80374151],
            "xsize": 0.3, "ysize": 0.3, "radius": 1.5,
        }
        base["optics"]["detector"] = dict(det, origin=[0.0, 0.9, 0.45],
                                          xsize=1.0, ysize=1.0,
                                          pixel_size=0.025)
    elif kind == "uniform_wavelength":
        src.update(angular_dist="isotropic_xy", spread=np.radians(10.0),
                   wavelength_dist="uniform",
                   wavelength_range=[3.9492 - 0.013, 3.9492 + 0.013])
        base["optics"]["crystal"] = {
            "class_name": "XicsrtOpticSphericalCrystal",
            "origin": [0.0, -3e-4, 0.80374151],
            "zaxis": [0.0, 0.59497864, -0.80374151],
            "xsize": 0.2, "ysize": 0.2, "radius": 1.0,
            "crystal_spacing": 2.45676,
            "rocking_type": "gaussian", "rocking_fwhm": 1e-3,
        }
        base["optics"]["detector"] = dict(det, pixel_size=0.02)
    elif kind == "cylinder_crystal":
        src.update(angular_dist="isotropic_xy",
                   spread=np.radians(10.0))
        base["optics"]["crystal"] = {
            "class_name": "XicsrtOpticCylindricalCrystal",
            "origin": [0.0, -3e-4, 0.80374151],
            "zaxis": [0.0, 0.59497864, -0.80374151],
            "xsize": 0.2, "ysize": 0.2, "radius": 1.0,
            "crystal_spacing": 2.45676,
            "rocking_type": "gaussian", "rocking_fwhm": 1e-3,
        }
        base["optics"]["detector"] = dict(det, xsize=1.0, ysize=0.5,
                                          pixel_size=0.025)
    elif kind == "convex_cylinder_mirror":
        src.update(angular_dist="isotropic", spread=np.radians(5.0))
        base["optics"]["mirror"] = {
            "class_name": "XicsrtOpticCylindricalMirror",
            "origin": [0.0, 0.0, 0.5],
            "zaxis": [0.0, 0.0, -1.0],
            "xsize": 0.3, "ysize": 0.3, "radius": 2.0, "convex": True,
        }
        base["optics"]["detector"] = dict(det, origin=[0.0, 0.0, -0.5],
                                          zaxis=[0.0, 0.0, 1.0],
                                          xsize=2.0, ysize=2.0,
                                          pixel_size=0.05)
    elif kind == "convex_sphere_flat_xy":
        src.update(angular_dist="flat_xy",
                   spread=[np.radians(5.0), np.radians(7.0)])
        base["optics"]["crystal"] = {
            "class_name": "XicsrtOpticSphericalCrystal",
            "origin": [0.0, -3e-4, 0.80374151],
            "zaxis": [0.0, 0.59497864, -0.80374151],
            "xsize": 0.2, "ysize": 0.2, "radius": 2.0, "convex": True,
            "crystal_spacing": 2.45676,
            "rocking_type": "gaussian", "rocking_fwhm": 2e-3,
        }
        base["optics"]["detector"] = dict(det, xsize=1.0, ysize=1.0,
                                          pixel_size=0.025)
    elif kind == "torus_crystal":
        src.update(angular_dist="isotropic_xy", spread=np.radians(10.0))
        base["optics"]["crystal"] = {
            "class_name": "XicsrtOpticToroidalCrystal",
            "origin": [0.0, -3e-4, 0.80374151],
            "zaxis": [0.0, 0.59497864, -0.80374151],
            "xsize": 0.2, "ysize": 0.2,
            "radius_major": 1.0, "radius_minor": 0.4,
            "crystal_spacing": 2.45676,
            "rocking_type": "gaussian", "rocking_fwhm": 1e-3,
        }
        base["optics"]["detector"] = dict(det, xsize=1.0, ysize=0.5,
                                          pixel_size=0.025)
    elif kind == "convex_torus_mirror":
        src.update(angular_dist="isotropic", spread=np.radians(5.0))
        base["optics"]["mirror"] = {
            "class_name": "XicsrtOpticToroidalMirror",
            "origin": [0.0, 0.0, 0.5],
            "zaxis": [0.0, 0.0, -1.0],
            "xsize": 0.2, "ysize": 0.2,
            "radius_major": 2.0, "radius_minor": 0.8,
            "convex": [True, False],
        }
        base["optics"]["detector"] = dict(det, origin=[0.0, 0.0, -0.5],
                                          zaxis=[0.0, 0.0, 1.0],
                                          xsize=2.0, ysize=2.0,
                                          pixel_size=0.05)
    elif kind == "file_rocking":
        import tempfile

        from tests.test_coverage_extra import _write_xop_file

        # This geometry's deviations sit at 0.4-11 mrad: give the table
        # a support and width that overlap them, so the interpolated
        # curve (and its slope) actually gates rays.
        xop = tempfile.mkdtemp() + "/diff_pat.dat"
        _write_xop_file(xop, fwhm=1.5e-3, span_urad=4000.0)
        src.update(angular_dist="isotropic_xy", spread=np.radians(10.0))
        base["optics"]["crystal"] = {
            "class_name": "XicsrtOpticSphericalCrystal",
            "origin": [0.0, -3e-4, 0.80374151],
            "zaxis": [0.0, 0.59497864, -0.80374151],
            "xsize": 0.2, "ysize": 0.2, "radius": 1.0,
            "crystal_spacing": 2.45676,
            "rocking_type": "file", "rocking_fwhm": None,
            "rocking_file": xop, "rocking_filetype": "xop",
        }
        base["optics"]["detector"] = dict(det, pixel_size=0.02)
    elif kind == "step_rocking":
        src.update(angular_dist="isotropic_xy", spread=np.radians(10.0))
        base["optics"]["crystal"] = {
            "class_name": "XicsrtOpticSphericalCrystal",
            "origin": [0.0, -3e-4, 0.80374151],
            "zaxis": [0.0, 0.59497864, -0.80374151],
            "xsize": 0.2, "ysize": 0.2, "radius": 1.0,
            "crystal_spacing": 2.45676,
            "rocking_type": "step", "rocking_fwhm": 8e-4,
        }
        base["optics"]["detector"] = dict(det, pixel_size=0.02)
    elif kind == "asym_xy_crystal":
        # Asymmetric isotropic_xy bounds: the sampler's Newton CDF
        # inversion.
        src.update(angular_dist="isotropic_xy",
                   spread=[-0.15, 0.15, -0.05, 0.12])
        base["optics"]["crystal"] = {
            "class_name": "XicsrtOpticSphericalCrystal",
            "origin": [0.0, -3e-4, 0.80374151],
            "zaxis": [0.0, 0.59497864, -0.80374151],
            "xsize": 0.2, "ysize": 0.2, "radius": 1.0,
            "crystal_spacing": 2.45676,
            "rocking_type": "gaussian", "rocking_fwhm": 1e-3,
        }
        base["optics"]["detector"] = dict(det, pixel_size=0.02)
    elif kind == "focused_gaussian_voigt":
        # Focused emission (per-ray basis), gaussian box, exact-Voigt
        # wavelengths, bulk-velocity Doppler.
        base["sources"]["source"] = {
            "class_name": "XicsrtSourceFocused",
            "intensity": 1536, "wavelength": 3.9492,
            "spatial_dist": "gaussian",
            "xsize": 0.004, "ysize": 0.004, "zsize": 0.002,
            "angular_dist": "isotropic", "spread": np.radians(9.0),
            "target": [0.0, -3e-4, 0.80374151],
            "wavelength_dist": "voigt",
            "linewidth": 1e12, "temperature": 1000.0,
            "mass_number": 40.0,
            "velocity": [0.0, 1e5, 0.0],
        }
        base["optics"]["crystal"] = {
            "class_name": "XicsrtOpticSphericalCrystal",
            "origin": [0.0, -3e-4, 0.80374151],
            "zaxis": [0.0, 0.59497864, -0.80374151],
            "xsize": 0.2, "ysize": 0.2, "radius": 1.0,
            "crystal_spacing": 2.45676,
            "rocking_type": "gaussian", "rocking_fwhm": 1e-3,
        }
        base["optics"]["detector"] = dict(det, pixel_size=0.02)
    elif kind == "mosaic_sphere":
        # HOPG mosaic crystal: per-layer crystallite normals and the
        # depth-aware survival weight estimator.
        src.update(angular_dist="isotropic_xy", spread=np.radians(10.0))
        base["optics"]["crystal"] = {
            "class_name": "XicsrtOpticSphericalMosaicCrystal",
            "origin": [0.0, -3e-4, 0.80374151],
            "zaxis": [0.0, 0.59497864, -0.80374151],
            "xsize": 0.2, "ysize": 0.2, "radius": 1.0,
            "crystal_spacing": 2.45676,
            "rocking_type": "gaussian", "rocking_fwhm": 5e-4,
            "mosaic_spread": np.radians(0.05),
            "mosaic_depth": 6,
            "mosaic_cutoff": 1e-4,  # hard prefilter: zero gradient
        }
        base["optics"]["detector"] = dict(det, pixel_size=0.02)
    elif kind == "plasma_cubic":
        # Cubic plasma -> Bragg crystal -> detector: emissivity enters
        # ray weights, temperature the Doppler width (source slots).
        # emissivity chosen for ~1536 expected photons:
        # E * dt * V * sin^2(spread/2) = E * 1e-3 * 1e-6 * 1.2e-3.
        base["sources"] = {"plasma": {
            "class_name": "XicsrtPlasmaCubic",
            "origin": [0.0, 0.0, 0.0],
            "xsize": 0.01, "ysize": 0.01, "zsize": 0.01,
            "target": [0.0, -3e-4, 0.80374151],
            "spread": np.radians(4.0),
            "emissivity": 1.26e15,
            "temperature": 1000.0,
            "mass_number": 40.0,
            "wavelength": 3.9492,
            "time_resolution": 1e-3,
            "bundle_volume": 1e-7,
            "use_poisson": False,
        }}
        base["optics"]["crystal"] = {
            "class_name": "XicsrtOpticSphericalCrystal",
            "origin": [0.0, -3e-4, 0.80374151],
            "zaxis": [0.0, 0.59497864, -0.80374151],
            "xsize": 0.2, "ysize": 0.2, "radius": 1.0,
            "crystal_spacing": 2.45676,
            "rocking_type": "gaussian", "rocking_fwhm": 1e-3,
        }
        base["optics"]["detector"] = dict(det, pixel_size=0.02)
    elif kind == "zsize_sphere_mirror":
        src.update(angular_dist="isotropic", spread=np.radians(6.0))
        base["optics"]["mirror"] = {
            "class_name": "XicsrtOpticSphericalMirror",
            "origin": [0.0, 0.0, 0.80374151],
            "zaxis": [0.0, 0.59497864, -0.80374151],
            "xsize": 0.3, "ysize": 0.3, "zsize": 0.01, "radius": 1.5,
        }
        base["optics"]["detector"] = dict(det, origin=[0.0, 0.9, 0.45],
                                          xsize=1.0, ysize=1.0,
                                          pixel_size=0.025)
    return base
