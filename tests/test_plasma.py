"""Plasma source tests: real-units photon accounting (the reference's
integrated_test_00 pattern) and profile/filter behavior."""

import numpy as np
import pytest

import xicsrt_tpu


def _plasma_config(**plasma_overrides):
    plasma = {
        "class_name": "XicsrtPlasmaCubic",
        "origin": [0.0, 0.0, 0.0],
        "zaxis": [0.0, 0.0, 1.0],
        "xsize": 0.1,
        "ysize": 0.1,
        "zsize": 0.1,
        "target": [0.0, 0.0, 1.0],
        "spread": np.pi / 3,
        "emissivity": 2e10,
        "temperature": 100.0,
        "wavelength": 3.9492,
        "time_resolution": 1e-3,
        "bundle_volume": 1e-6,
        "bundle_count": 1000,
        "use_poisson": True,
    }
    plasma.update(plasma_overrides)
    return {
        "general": {"number_of_iter": 1, "random_seed": 0, "print_results": False},
        "sources": {"plasma": plasma},
        "optics": {
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.0, 1.0],
                "zaxis": [0.0, 0.0, -1.0],
                "xsize": 4.0,
                "ysize": 4.0,
                "pixel_size": 0.04,
            }
        },
    }


class TestPlasmaPhotonAccounting:
    def test_expected_ray_count(self):
        """Real-units accounting: N = emissivity * dt * V * Omega/4pi.

        Canonical check from the reference's integrated_test_00: the number
        of generated rays equals the physical photon count within Poisson
        tolerance.
        """
        config = _plasma_config()
        results = xicsrt_tpu.raytrace(config)
        n_gen = results["total"]["meta"]["plasma"]["num_out"]
        volume = 0.1**3
        omega_frac = np.sin((np.pi / 3) / 2) ** 2  # 4 pi sin^2(t/2) / 4 pi
        expected = 2e10 * 1e-3 * volume * omega_frac
        assert expected > 1000  # the test must have statistics to mean much
        assert abs(n_gen - expected) < 5 * np.sqrt(expected)

    def test_bundle_gather_matches_repeat(self):
        """Each ray takes the attributes of its bundle: the generator's
        searchsorted gather equals ``np.repeat`` of the bundle table by
        the realized counts (the plain reference), with rays past the
        realized total masked off."""
        import jax

        from xicsrt_tpu.engine import Pipeline

        config = _plasma_config(temperature=300.0, velocity=[1e4, 0.0, 2e4])
        pipe = Pipeline(config)
        src = pipe.source
        params = pipe.params["sources"][src.name]
        keys = jax.random.split(jax.random.key(3), 7)
        cum, table, total = src.make_bundle_tables()(
            params, pipe.params["filters"], keys[0], keys[1], keys[2])
        cum, table = np.asarray(cum), np.asarray(table)
        counts = np.diff(np.concatenate([[0], cum]))
        ref = np.repeat(table, counts, axis=0)
        n = int(total)
        assert 0 < n == len(ref) <= src.num_rays

        ray_idx = np.arange(src.num_rays)
        bundle_id = np.clip(np.searchsorted(cum, ray_idx, side="right"),
                            0, len(cum) - 1)
        np.testing.assert_array_equal(table[bundle_id][:n], ref)

        rays = pipe.generate(params, pipe.params["filters"], jax.random.key(3))
        mask = np.asarray(rays.mask)
        assert mask[:n].all() and not mask[n:].any()

    def test_bundle_gather_option_removed(self):
        """The 'matmul' bundle gather is gone: an old config that still
        selects a gather mode is refused, not silently ignored."""
        with pytest.raises(ValueError, match="bundle_gather"):
            xicsrt_tpu.raytrace(_plasma_config(bundle_gather="matmul"))

    def test_all_rays_reach_big_detector(self):
        # Cone aimed at a 4x4 m detector 1 m away: tan(60 deg)*~1.06 < 2.
        results = xicsrt_tpu.raytrace(_plasma_config())
        meta = results["total"]["meta"]
        assert meta["detector"]["num_out"] == meta["plasma"]["num_out"]

    def test_poisson_count_varies_with_seed(self):
        counts = []
        for seed in range(3):
            config = _plasma_config()
            config["general"]["random_seed"] = seed
            counts.append(
                xicsrt_tpu.raytrace(config)["total"]["meta"]["plasma"]["num_out"]
            )
        assert len(set(counts)) > 1

    def test_doppler_broadening_scales_with_temperature(self):
        cold = _plasma_config(temperature=10.0)
        hot = _plasma_config(temperature=1000.0)
        w_cold = xicsrt_tpu.raytrace(cold)["found"]["history"]["plasma"]["wavelength"]
        w_hot = xicsrt_tpu.raytrace(hot)["found"]["history"]["plasma"]["wavelength"]
        assert w_hot.std() > 5 * w_cold.std()
        # sigma = lambda * sqrt(T / (m c^2))
        expected = 3.9492 * np.sqrt(1000.0 * 1.602176634e-19 /
                                    (1.66053906892e-27 * 299792458.0**2))
        np.testing.assert_allclose(w_hot.std(), expected, rtol=0.1)

    def test_spread_radius_spot_size(self):
        config = _plasma_config(spread=None, spread_radius=0.05)
        results = xicsrt_tpu.raytrace(config)
        hits = results["found"]["history"]["detector"]["origin"]
        r = np.sqrt(hits[:, 0] ** 2 + hits[:, 1] ** 2)
        # Spot at the target plane ~ spread_radius + source extent.
        assert np.percentile(r, 99) < 0.05 + 0.1 * np.sqrt(3) / 2 + 0.02

    def test_max_rays_guard(self):
        config = _plasma_config(emissivity=1e15, max_rays=int(1e6))
        with pytest.raises(ValueError, match="max_rays|too many"):
            xicsrt_tpu.raytrace(config)

    def test_point_bundle_type(self):
        config = _plasma_config(bundle_type="point")
        results = xicsrt_tpu.raytrace(config)
        assert results["total"]["meta"]["plasma"]["num_out"] > 0


class TestPlasmaProfiles:
    def test_toroidal_masks_outside_torus(self):
        config = _plasma_config()
        config["sources"]["plasma"].update(
            {
                "class_name": "XicsrtPlasmaToroidal",
                "major_radius": 1.0,
                "minor_radius": 0.02,  # thin torus through part of the box
                "torus_origin": [-1.0, 0.0, 0.0],
            }
        )
        results = xicsrt_tpu.raytrace(config)
        src = results["found"]["history"]["plasma"]["origin"]
        # All emitted rays originate within ~torus tube + voxel halo.
        r_cyl = np.sqrt((src[:, 0] + 1.0) ** 2 + src[:, 1] ** 2)
        d = np.sqrt((r_cyl - 1.0) ** 2 + src[:, 2] ** 2)
        assert np.all(d < 0.02 + 0.02)

    def test_toroidal_datafile(self, tmp_path):
        prof = tmp_path / "emiss.txt"
        rho = np.linspace(0, 1, 50)
        np.savetxt(prof, np.stack([rho, 1e10 * (1 - rho**2)], axis=-1))
        tfile = tmp_path / "temp.txt"
        np.savetxt(tfile, np.stack([rho, 100.0 * np.ones_like(rho)], axis=-1))
        config = _plasma_config()
        config["sources"]["plasma"].update(
            {
                "class_name": "XicsrtPlasmaToroidalDatafile",
                "major_radius": 1.0,
                "minor_radius": 0.05,
                "torus_origin": [-1.0, 0.0, 0.0],
                "emissivity_file": str(prof),
                "temperature_file": str(tfile),
            }
        )
        results = xicsrt_tpu.raytrace(config)
        assert results["total"]["meta"]["plasma"]["num_out"] > 0

    def test_cylindrical_runs(self):
        config = _plasma_config()
        config["sources"]["plasma"]["class_name"] = "XicsrtPlasmaCylindrical"
        results = xicsrt_tpu.raytrace(config)
        assert results["total"]["meta"]["plasma"]["num_out"] > 0


class TestPlasmaBundleFilter:
    def test_sightline_filter_restricts_bundles(self):
        config = _plasma_config()
        config["sources"]["plasma"]["filters"] = ["sight"]
        config["filters"] = {
            "sight": {
                "class_name": "XicsrtBundleFilterSightline",
                "origin": [0.0, 0.0, 0.0],
                "zaxis": [0.0, 0.0, 1.0],
                "radius": 0.02,
            }
        }
        results = xicsrt_tpu.raytrace(config)
        src = results["found"]["history"]["plasma"]["origin"]
        r = np.sqrt(src[:, 0] ** 2 + src[:, 1] ** 2)
        # Bundle centers within 0.02; rays spread at most voxel/2 further.
        assert np.all(r < 0.02 + 0.01)
        unfiltered = xicsrt_tpu.raytrace(_plasma_config())
        assert (
            results["total"]["meta"]["plasma"]["num_out"]
            < 0.5 * unfiltered["total"]["meta"]["plasma"]["num_out"]
        )
