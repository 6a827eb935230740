"""Additional physics and engine-semantics tests: mosaic crystals,
f32-vs-f64 tolerance, lost-history truncation, plugins, examples."""

import os
import subprocess
import sys

import numpy as np
import pytest

import xicsrt_tpu


def _mosaic_config(depth, spread=np.radians(0.5), num_iter=1, **general):
    g = {"number_of_iter": num_iter, "random_seed": 0, "print_results": False}
    g.update(general)
    return {
        "general": g,
        "sources": {
            "source": {
                "class_name": "XicsrtSourceDirected",
                "intensity": 30000,
                "wavelength": 3.9492,
                "spread": np.radians(2.0),
            }
        },
        "optics": {
            "crystal": {
                "class_name": "XicsrtOpticSphericalMosaicCrystal",
                "origin": [0.0, 0.0, 0.80374151],
                "zaxis": [0.0, 0.59497864, -0.80374151],
                "xsize": 0.3,
                "ysize": 0.3,
                "radius": 1.0,
                "crystal_spacing": 2.45676,
                "rocking_type": "gaussian",
                "rocking_fwhm": 48.070e-6,
                "mosaic_spread": spread,
                "mosaic_depth": depth,
            },
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084],
                "xsize": 0.6,
                "ysize": 0.6,
            },
        },
    }


class TestMosaicCrystal:
    def test_depth_increases_throughput(self):
        """More crystallite layers -> more rays find a reflecting
        crystallite (HOPG integrated-reflectivity behavior,
        cf. _InteractMosaicCrystal.py:53-107)."""
        shallow = xicsrt_tpu.raytrace(_mosaic_config(depth=1))
        deep = xicsrt_tpu.raytrace(_mosaic_config(depth=15))
        n1 = shallow["total"]["meta"]["crystal"]["num_out"]
        n15 = deep["total"]["meta"]["crystal"]["num_out"]
        assert n15 > 2 * n1
        assert n15 > 0

    def test_mosaic_widens_angular_acceptance(self):
        """A mosaic crystal reflects rays from a much wider region of the
        crystal face than a perfect crystal (whose acceptance is a narrow
        Bragg stripe), even though its peak acceptance is lower — the HOPG
        trade-off the multi-layer model reproduces."""
        mosaic = xicsrt_tpu.raytrace(_mosaic_config(depth=15))
        config = _mosaic_config(depth=15)
        config["optics"]["crystal"]["class_name"] = "XicsrtOpticSphericalCrystal"
        for key in ("mosaic_spread", "mosaic_depth"):
            del config["optics"]["crystal"][key]
        perfect = xicsrt_tpu.raytrace(config)

        def crystal_stripe_width(results):
            # Spread (std) of accepted-ray hit positions on the crystal in
            # the dispersion direction (local y).
            from xicsrt_tpu.public import get_element

            hits = results["found"]["history"]["crystal"]["origin"]
            element = get_element(results["config"], "crystal")
            local = np.asarray(element.frame.point_to_local(hits))
            return local[:, 1].std()

        assert crystal_stripe_width(mosaic) > 3 * crystal_stripe_width(perfect)

    def test_mosaic_cutoff_prefilter(self):
        with_cut = _mosaic_config(depth=15)
        with_cut["optics"]["crystal"]["mosaic_cutoff"] = 1e-8
        r_cut = xicsrt_tpu.raytrace(with_cut)
        r_full = xicsrt_tpu.raytrace(_mosaic_config(depth=15))
        n_cut = r_cut["total"]["meta"]["crystal"]["num_out"]
        n_full = r_full["total"]["meta"]["crystal"]["num_out"]
        # 6-sigma cutoff keeps essentially all reflections.
        assert abs(n_cut - n_full) < 5 * np.sqrt(max(n_full, 1)) + 20

    def test_weight_mode_matches_mc_depth_aware(self):
        """Weight-mode mosaic (depth-aware survival weighting) reproduces the mc-mode image: total reflected intensity
        within Poisson tolerance at full depth, and a matching line profile.
        """
        mc = xicsrt_tpu.raytrace(_mosaic_config(depth=15, num_iter=2))
        cfg = _mosaic_config(depth=15, num_iter=2, interact_mode="weight")
        wt = xicsrt_tpu.raytrace(cfg)

        n_mc = mc["total"]["meta"]["detector"]["num_out"]
        w_img = wt["total"]["image"]["detector"]
        w_total = float(w_img.sum())
        # Weight mode sums reflection probabilities: the mc count is a
        # Poisson draw around the same expectation.
        assert abs(w_total - n_mc) < 6 * np.sqrt(max(n_mc, 1)), (w_total, n_mc)

        def profile_moments(img):
            p = np.asarray(img, float).sum(axis=0)
            p = p / p.sum()
            ys = np.arange(len(p))
            mu = (p * ys).sum()
            sd = np.sqrt((p * (ys - mu) ** 2).sum())
            return mu, sd

        mu_mc, sd_mc = profile_moments(mc["total"]["image"]["detector"])
        mu_wt, sd_wt = profile_moments(w_img)
        assert abs(mu_wt - mu_mc) < 1.0
        assert abs(sd_wt - sd_mc) < 0.25 * sd_mc

    def test_weight_mode_depth_increases_throughput(self):
        """Depth-aware weighting: deeper mosaics reflect more total weight
        (1 - prod(1-p) grows with layers), unlike the round-1 single-layer
        approximation which was depth-independent."""
        shallow = xicsrt_tpu.raytrace(
            _mosaic_config(depth=1, interact_mode="weight"))
        deep = xicsrt_tpu.raytrace(
            _mosaic_config(depth=15, interact_mode="weight"))
        w1 = float(shallow["total"]["image"]["detector"].sum())
        w15 = float(deep["total"]["image"]["detector"].sum())
        assert w15 > 2 * w1 > 0

    def test_mosaic_focusing_preserves_line(self):
        """Mosaic focusing: a 20x wider crystallite distribution must NOT
        broaden the detected spectral line — crystallite tilt moves the
        reflection point on the crystal, not the exit angle relative to the
        Bragg condition. This is the defining HOPG property the multi-layer
        model reproduces (cf. _InteractMosaicCrystal.py docstring)."""
        tight = xicsrt_tpu.raytrace(_mosaic_config(depth=15, spread=np.radians(0.05)))
        wide = xicsrt_tpu.raytrace(_mosaic_config(depth=15, spread=np.radians(1.0)))

        def spot_sd(results):
            img = results["total"]["image"]["detector"]
            ys = np.arange(img.shape[1])
            p = img.sum(axis=0)
            p = p / p.sum()
            mu = (p * ys).sum()
            return np.sqrt((p * (ys - mu) ** 2).sum())

        assert spot_sd(wide) < 2.0 * spot_sd(tight)


class TestPrecisionModes:
    def test_f32_matches_f64_statistically(self):
        """f32 production mode reproduces f64 results within MC tolerance
        (SURVEY.md 7.2 item 9: f32-vs-f64 tolerance sweep)."""
        base = {
            "general": {"number_of_iter": 2, "random_seed": 3,
                        "print_results": False},
            "sources": {
                "source": {
                    "class_name": "XicsrtSourceDirected",
                    "intensity": 50000,
                    "wavelength": 3.9492,
                    "spread": np.radians(10.0),
                }
            },
            "optics": {
                "crystal": {
                    "class_name": "XicsrtOpticToroidalCrystal",
                    "origin": [0.0, 0.0, 0.80374151],
                    "zaxis": [0.0, 0.59497864, -0.80374151],
                    "xsize": 0.2,
                    "ysize": 0.2,
                    "radius_major": 1.0,
                    "radius_minor": 0.64,
                    "crystal_spacing": 2.45676,
                    "rocking_type": "gaussian",
                    "rocking_fwhm": 48.070e-6,
                },
                "detector": {
                    "class_name": "XicsrtOpticDetector",
                    "origin": [0.0, 0.76871290, 0.56904832],
                    "zaxis": [0.0, -0.95641806, 0.29200084],
                    "xsize": 0.4,
                    "ysize": 0.2,
                },
            },
        }
        import copy

        c32 = copy.deepcopy(base)
        c32["general"]["dtype"] = "float32"
        c64 = copy.deepcopy(base)
        c64["general"]["dtype"] = "float64"
        r32 = xicsrt_tpu.raytrace(c32)
        r64 = xicsrt_tpu.raytrace(c64)
        n32 = r32["total"]["meta"]["detector"]["num_out"]
        n64 = r64["total"]["meta"]["detector"]["num_out"]
        # Same seed but different dtype => different rounding; compare
        # statistically. The toroidal quartic is the precision-critical path.
        assert abs(n32 - n64) < 6 * np.sqrt(max(n64, 1))

        img32 = r32["total"]["image"]["detector"].sum(axis=0)
        img64 = r64["total"]["image"]["detector"].sum(axis=0)
        ys = np.arange(len(img32))

        def centroid(p):
            p = p / p.sum()
            return (p * ys).sum()

        assert abs(centroid(img32) - centroid(img64)) < 0.5  # pixels


class TestHistoryTruncation:
    def test_history_max_lost(self):
        config = {
            "general": {"number_of_iter": 1, "random_seed": 0,
                        "print_results": False, "history_max_lost": 100},
            "sources": {
                "source": {
                    "class_name": "XicsrtSourceDirected",
                    "intensity": 20000,
                    "wavelength": 3.9492,
                    "spread": np.radians(20.0),
                }
            },
            "optics": {
                "detector": {
                    "class_name": "XicsrtOpticDetector",
                    "origin": [0.0, 0.0, 1.0],
                    "zaxis": [0.0, 0.0, -1.0],
                    "xsize": 0.02,
                    "ysize": 0.02,
                }
            },
        }
        results = xicsrt_tpu.raytrace(config)
        lost = results["lost"]["history"]["detector"]
        assert lost["mask"].shape[0] == 100  # truncated to history_max_lost
        found = results["found"]["history"]["detector"]
        n_found = results["total"]["meta"]["detector"]["num_out"]
        assert found["mask"].shape[0] == n_found  # found kept in full


class TestPlugins:
    def test_pathlist_plugin(self, tmp_path):
        plugin = tmp_path / "_XicsrtSourceCustomTest.py"
        plugin.write_text(
            "from xicsrt_tpu.sources.generic import SourceGeneric\n"
            "class XicsrtSourceCustomTest(SourceGeneric):\n"
            "    def default_config(self):\n"
            "        config = super().default_config()\n"
            "        config['custom_knob'] = 0\n"
            "        return config\n"
        )
        config = {
            "general": {"number_of_iter": 1, "random_seed": 0,
                        "print_results": False, "pathlist": [str(tmp_path)]},
            "sources": {
                "src": {
                    "class_name": "XicsrtSourceCustomTest",
                    "intensity": 100,
                    "wavelength": 1.0,
                    "spread": 0.1,
                    "custom_knob": 5,
                }
            },
            "optics": {
                "det": {
                    "class_name": "XicsrtOpticDetector",
                    "origin": [0.0, 0.0, 1.0],
                    "zaxis": [0.0, 0.0, -1.0],
                    "xsize": 1.0,
                    "ysize": 1.0,
                }
            },
        }
        results = xicsrt_tpu.raytrace(config)
        assert results["total"]["meta"]["src"]["num_out"] == 100


@pytest.mark.parametrize(
    "example",
    [
        "example_00_point_source.py",
        "example_01_spherical_crystal.py",
        "example_02_aperture.py",
        "example_05_multichip.py",
        "example_08_plasma_fitting.py",
    ],
)
def test_example_runs(example):
    """Every bundled example executes cleanly (subprocess, CPU)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "examples", example)
    env = dict(os.environ)
    code = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        + open(script).read().replace('if __name__ == "__main__":', "if False:")
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=root, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
