"""Coverage for remaining reference features: tabulated rocking curves,
convex shapes, spatial distributions, CLI, file-based combine workflow."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import xicsrt_tpu
from xicsrt_tpu import io as xio


def _base_config(**general):
    g = {"number_of_iter": 1, "random_seed": 0, "print_results": False}
    g.update(general)
    return {
        "general": g,
        "sources": {
            "source": {
                "class_name": "XicsrtSourceDirected",
                "intensity": 5000,
                "wavelength": 3.9492,
                "spread": np.radians(10.0),
            }
        },
        "optics": {
            "crystal": {
                "class_name": "XicsrtOpticSphericalCrystal",
                "origin": [0.0, 0.0, 0.80374151],
                "zaxis": [0.0, 0.59497864, -0.80374151],
                "xsize": 0.2,
                "ysize": 0.2,
                "radius": 1.0,
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


def _write_xop_file(path, fwhm=48.070e-6, span_urad=300.0):
    """Synthetic XOP diff_pat.dat whose sigma curve is the same gaussian as
    the built-in rocking model (pi curve at half reflectivity)."""
    dtheta_urad = np.linspace(-span_urad, span_urad, 1201)
    sigma_fwhm_urad = fwhm * 1e6
    s = np.exp(-0.5 * (dtheta_urad / (sigma_fwhm_urad / 2.3548200450309493)) ** 2)
    p = 0.5 * s
    cols = np.stack(
        [dtheta_urad, dtheta_urad, np.zeros_like(s), np.zeros_like(s),
         np.zeros_like(s), p, s],
        axis=-1,
    )
    header = "#F diff_pat.dat\n#S 1 synthetic rocking curve\n#N 7\n"
    with open(path, "w") as fh:
        fh.write(header)
        np.savetxt(fh, cols)


class TestRockingFile:
    def test_xop_file_matches_gaussian(self, tmp_path):
        """rocking_type='file' (XOP table, sigma polarization) reproduces the
        analytic gaussian acceptance within MC tolerance."""
        xop = tmp_path / "diff_pat.dat"
        _write_xop_file(str(xop))

        gauss = xicsrt_tpu.raytrace(_base_config())
        config = _base_config()
        config["optics"]["crystal"].update(
            {
                "rocking_type": "file",
                "rocking_fwhm": None,
                "rocking_file": str(xop),
                "rocking_filetype": "xop",
                "rocking_mix": 1.0,  # pure sigma
            }
        )
        filed = xicsrt_tpu.raytrace(config)
        n_g = gauss["total"]["meta"]["detector"]["num_out"]
        n_f = filed["total"]["meta"]["detector"]["num_out"]
        assert abs(n_g - n_f) < 6 * np.sqrt(max(n_g, 1))

    def test_rocking_mix_interpolates(self, tmp_path):
        """rocking_mix blends sigma and pi curves: mix=0 (pure pi, half
        reflectivity) accepts about half of mix=1 (pure sigma)."""
        xop = tmp_path / "diff_pat.dat"
        _write_xop_file(str(xop))
        counts = {}
        for mix in (0.0, 1.0):
            config = _base_config()
            config["optics"]["crystal"].update(
                {
                    "rocking_type": "file",
                    "rocking_fwhm": None,
                    "rocking_file": str(xop),
                    "rocking_filetype": "xop",
                    "rocking_mix": mix,
                }
            )
            r = xicsrt_tpu.raytrace(config)
            counts[mix] = r["total"]["meta"]["detector"]["num_out"]
        ratio = counts[0.0] / max(counts[1.0], 1)
        assert 0.35 < ratio < 0.65

    def test_filetype_guess_from_name(self, tmp_path):
        xop = tmp_path / "diff_pat.dat"
        _write_xop_file(str(xop))
        from xicsrt_tpu.utils import bragg_files

        data = bragg_files.read(str(xop))  # no filetype given
        assert data["dtheta"].min() < 0 < data["dtheta"].max()
        assert data["reflect_s"].max() == pytest.approx(1.0, abs=1e-6)

    def test_simple_format(self, tmp_path):
        f = tmp_path / "curve.txt"
        dtheta = np.linspace(-1e-4, 1e-4, 101)
        np.savetxt(f, np.stack([dtheta, np.exp(-(dtheta / 3e-5) ** 2),
                                np.zeros_like(dtheta)], axis=-1))
        from xicsrt_tpu.utils import bragg_files

        data = bragg_files.read(str(f), "simple")
        assert len(data["dtheta"]) == 101


class TestConvexShapes:
    @pytest.mark.parametrize(
        "class_name,extra",
        [
            ("XicsrtOpticSphericalMirror", {"radius": 2.0, "convex": True}),
            ("XicsrtOpticCylindricalMirror", {"radius": 2.0, "convex": True}),
            (
                "XicsrtOpticToroidalMirror",
                {"radius_major": 2.0, "radius_minor": 0.5, "convex": [True, True]},
            ),
            (
                "XicsrtOpticToroidalMirror",
                {"radius_major": 2.0, "radius_minor": 0.5, "convex": [False, True]},
            ),
            (
                "XicsrtOpticToroidalMirror",
                {"radius_major": 2.0, "radius_minor": 0.5, "convex": [True, False]},
            ),
        ],
    )
    def test_convex_surface_diverges_beam(self, class_name, extra):
        """Convex mirrors at normal incidence reflect and diverge the beam;
        every ray that hits must reflect exactly once (mask conserved)."""
        config = {
            "general": {"number_of_iter": 1, "random_seed": 0,
                        "print_results": False},
            "sources": {
                "source": {
                    "class_name": "XicsrtSourceDirected",
                    "intensity": 2000,
                    "wavelength": 1.0,
                    "spread": np.radians(1.0),
                }
            },
            "optics": {
                "mirror": {
                    "class_name": class_name,
                    "origin": [0.0, 0.0, 1.0],
                    "zaxis": [0.0, 0.0, -1.0],
                    "xsize": 0.2,
                    "ysize": 0.2,
                    **extra,
                },
            },
        }
        results = xicsrt_tpu.raytrace(config)
        assert results["total"]["meta"]["mirror"]["num_out"] > 1900
        # Reflected rays travel back towards -z.
        hist = results["found"]["history"]["mirror"]
        assert np.all(hist["direction"][:, 2] < 0)


class TestSpatialDistributions:
    def test_gaussian_spatial_dist(self):
        config = _base_config()
        config["sources"]["source"].update(
            {"spatial_dist": "gaussian", "xsize": 0.02, "ysize": 0.04,
             "zsize": 0.0, "spread": 0.001}
        )
        config["optics"] = {
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.0, 1.0],
                "zaxis": [0.0, 0.0, -1.0],
                "xsize": 1.0,
                "ysize": 1.0,
            }
        }
        results = xicsrt_tpu.raytrace(config)
        src = results["found"]["history"]["source"]["origin"]
        # sizes are FWHM: sigma = fwhm / 2.355.
        np.testing.assert_allclose(src[:, 0].std(), 0.02 / 2.3548, rtol=0.1)
        np.testing.assert_allclose(src[:, 1].std(), 0.04 / 2.3548, rtol=0.1)

    def test_velocity_doppler_shift(self):
        config = _base_config()
        config["sources"]["source"]["velocity"] = [0.0, 0.0, -3e5]  # towards optic
        config["sources"]["source"]["wavelength_dist"] = "monochrome"
        config["optics"] = {
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.0, 1.0],
                "zaxis": [0.0, 0.0, -1.0],
                "xsize": 2.0,
                "ysize": 2.0,
            }
        }
        results = xicsrt_tpu.raytrace(config)
        w = results["found"]["history"]["source"]["wavelength"]
        # Moving against the emission direction -> blueshift ~ v/c = 1e-3.
        assert w.mean() > 3.9492 * (1 + 0.5e-3)


class TestCombineWorkflow:
    def test_offline_combine_of_saved_results(self, tmp_path):
        """The reference's cluster workflow: save runs separately, reload,
        combine (multiple_processors.rst)."""
        paths = []
        for seed in (0, 1):
            config = _base_config(random_seed=seed)
            r = xicsrt_tpu.raytrace(config)
            p = str(tmp_path / f"run{seed}.hdf5")
            xio.save_results(r, p)
            paths.append(p)
        loaded = [xio.load_results(p) for p in paths]
        combined = xicsrt_tpu.combine_raytrace(loaded)
        assert combined["total"]["meta"]["source"]["num_out"] == 10000
        total = sum(
            r["total"]["meta"]["detector"]["num_out"] for r in loaded
        )
        assert combined["total"]["meta"]["detector"]["num_out"] == total


class TestCLI:
    def test_cli_end_to_end(self, tmp_path):
        config_path = tmp_path / "config.json"
        config = {
            "general": {"number_of_iter": 2},
            "sources": {
                "source": {
                    "class_name": "XicsrtSourceDirected",
                    "intensity": 500,
                    "wavelength": 3.9492,
                    "spread": 0.0873,
                }
            },
            "optics": {
                "detector": {
                    "class_name": "XicsrtOpticDetector",
                    "origin": [0.0, 0.0, 1.0],
                    "zaxis": [0.0, 0.0, -1.0],
                    "xsize": 0.2,
                    "ysize": 0.2,
                }
            },
        }
        config_path.write_text(json.dumps(config))
        out_dir = tmp_path / "out"
        code = (
            "import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "from xicsrt_tpu.__main__ import run\n"
            f"run([{str(config_path)!r}, '--numiter', '1', '--seed', '3',"
            f" '--images', '--path', {str(out_dir)!r}])\n"
        )
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        # make_directories not set -> expect failure message about path.
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=300,
                              cwd=root)
        assert proc.returncode != 0
        assert "make_directories" in (proc.stderr + proc.stdout)

        out_dir.mkdir()
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=300,
                              cwd=root)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "Rays Generated" in proc.stdout
        assert any(f.endswith(".tif") for f in os.listdir(out_dir))

    def test_cli_version(self):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run(
            [sys.executable, "-c",
             "from xicsrt_tpu.__main__ import run; run(['--version'])"],
            capture_output=True, text=True, timeout=120, cwd=root,
        )
        assert proc.returncode == 0
        assert proc.stdout.strip()


class TestProfiler:
    def test_profiler_report(self):
        from xicsrt_tpu.utils.profiler import profiler

        profiler.enable()
        profiler.reset()
        xicsrt_tpu.raytrace(_base_config())
        text = profiler.report()
        assert "pipeline_build" in text
        assert "raytrace_run" in text
        # Engine-path spans.
        assert "build_runner" in text
        assert "sort_history" in text
        assert "combine_raytrace" in text
        profiler.disable()

    def test_device_trace_writes_profile(self, tmp_path):
        """general.profile_dir captures a jax profiler trace of the run."""
        logdir = tmp_path / "jaxprof"
        config = _base_config()
        config["general"]["profile_dir"] = str(logdir)
        xicsrt_tpu.raytrace(config)
        files = list(logdir.rglob("*"))
        assert any(f.is_file() for f in files), files

    def test_device_trace_noop_without_dir(self):
        from xicsrt_tpu.utils.profiler import profiler

        with profiler.device_trace(None):
            pass
