"""The platform policy and what replaced the removed engines.

- ``binning_route``: one function maps the platform to the image binning
  implementation; the wrapper's padding, big-image split and precision.
- The options of the removed Pallas engines are refused with ValueError.
- The persistent compile cache directory rule.
- The benchmark's table of published peaks.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from xicsrt_tpu.ops import binning
from tests.configs import spectrometer


def _random_hits(n, nx, ny, pixel_size, seed=0):
    k1, k2, k3, k4 = jax.random.split(jax.random.key(seed), 4)
    half = np.array([nx, ny]) * pixel_size * 0.6
    xy = jax.random.uniform(k1, (n, 2), jnp.float64, -1.0, 1.0) * half
    x_local = jnp.concatenate([xy, jnp.zeros((n, 1))], axis=1)
    mask = jax.random.uniform(k2, (n,)) > 0.2
    weight = jax.random.uniform(k3, (n,), jnp.float64, 0.1, 2.0)
    return x_local, mask, weight


class TestBinningRoute:
    @pytest.mark.parametrize("platform,route", [("cpu", "scatter"),
                                                ("gpu", "matmul")])
    def test_known_platforms(self, platform, route):
        assert binning.binning_route(platform) == route

    @pytest.mark.parametrize("platform", ["rocm", "METAL", "interpreter", ""])
    def test_other_platforms_raise(self, platform):
        with pytest.raises(ValueError, match="No image binning route"):
            binning.binning_route(platform)

    @pytest.mark.parametrize("mode,platform,name", [
        ("nearest", "cpu", "bin_image"),
        ("nearest", "gpu", "bin_image_matmul"),
        ("bilinear", "cpu", "bin_image_bilinear"),
        ("bilinear", "gpu", "bin_image_bilinear_matmul"),
    ])
    def test_select_bin_fn(self, mode, platform, name):
        assert binning.select_bin_fn(mode, platform).__name__ == name

    def test_default_platform_is_the_backend(self):
        from xicsrt_tpu.engine import Pipeline

        assert Pipeline(spectrometer(64)).platform == jax.default_backend()
        fn = binning.select_bin_fn("nearest")
        assert fn is binning.bin_image  # this suite pins the CPU

    def test_unsupported_platform_fails_at_trace(self):
        from xicsrt_tpu.engine import Pipeline

        pipeline = Pipeline(spectrometer(64), platform="rocm")
        with pytest.raises(ValueError, match="'rocm'"):
            pipeline.make_iteration()(pipeline.params, jax.random.key(0))

    @pytest.mark.parametrize("mode", ["nearest", "bilinear"])
    @pytest.mark.parametrize("n,chunk", [(2500, 1000), (1000, 1 << 17),
                                         (4096, 512)])
    def test_matmul_padding_matches_scatter(self, mode, n, chunk):
        """Ray counts that do not fill the last chunk pad with rays that
        land nowhere; two images share the chunked pass."""
        items = [_random_hits(n, 37, 23, 0.01) + (37, 23, 0.01),
                 _random_hits(n, 11, 40, 0.02, seed=1) + (11, 40, 0.02)]
        out = binning.bin_images_fused(items, mode, chunk=chunk,
                                       platform="gpu")
        ref = binning.bin_images_fused(items, mode, platform="cpu")
        for a, b in zip(out, ref):
            assert a.shape == b.shape
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-12, atol=1e-12)

    def test_big_image_takes_scatter_on_gpu(self):
        """Images above 2^18 bins leave the matrix product; the small ones
        keep it, and the output order is the input order."""
        big = _random_hits(3000, 1024, 300, 0.001) + (1024, 300, 0.001)
        small = _random_hits(3000, 30, 20, 0.01, seed=2) + (30, 20, 0.01)
        out = binning.bin_images_fused([small, big, small], "nearest",
                                       platform="gpu")
        assert [o.shape for o in out] == [(30, 20), (1024, 300), (30, 20)]
        np.testing.assert_array_equal(np.asarray(out[1]),
                                      np.asarray(binning.bin_image(*big)))
        np.testing.assert_allclose(np.asarray(out[0]),
                                   np.asarray(binning.bin_image(*small)),
                                   rtol=1e-12)

    @pytest.mark.parametrize("mode,grad", [("nearest", False),
                                           ("bilinear", False),
                                           ("bilinear", True)])
    def test_products_ask_for_highest_precision(self, mode, grad):
        """Every float32 contraction of the GPU route states
        Precision.HIGHEST (an f32 product would otherwise run in TF32)."""
        x, m, w = (a.astype(jnp.float32) if a.dtype != bool else a
                   for a in _random_hits(300, 12, 9, 0.01))

        def total(x, w):
            (img,) = binning.bin_images_fused([(x, m, w, 12, 9, 0.01)], mode,
                                              chunk=128, platform="gpu")
            return jnp.sum(img * jnp.arange(img.size).reshape(img.shape))

        fn = jax.grad(total, argnums=(0, 1)) if grad else total
        jaxpr = jax.make_jaxpr(fn)(x, w)
        dots = []

        def visit(jpr):
            for eqn in jpr.eqns:
                if eqn.primitive.name == "dot_general":
                    dots.append(eqn.params["precision"])
                for sub in jax.core.jaxprs_in_params(eqn.params):
                    visit(sub)

        visit(jaxpr.jaxpr)
        assert len(dots) == (3 if grad else 1), dots
        for precision in dots:
            assert precision is not None
            assert all(p == jax.lax.Precision.HIGHEST for p in precision)

    def test_trace_hits_bin_to_iteration_images(self):
        """``make_trace`` exposes the binning inputs: binning them gives the
        iteration's images."""
        from xicsrt_tpu.engine import Pipeline

        pipeline = Pipeline(spectrometer(4096))
        key = jax.random.key(2)
        meta, _, hits = pipeline.make_trace()(pipeline.params, key)
        out = pipeline.make_iteration()(pipeline.params, key)
        specs = pipeline.image_specs()
        assert set(hits) == set(specs) == set(out["image"])
        for name, ((nx, ny), ps) in specs.items():
            img = binning.bin_image(*hits[name], nx, ny, ps)
            np.testing.assert_array_equal(np.asarray(img),
                                          np.asarray(out["image"][name]))
            assert int(meta[name]) == int(out["meta"][name])


class TestRemovedOptions:
    @pytest.mark.parametrize("key,value,match", [
        ("engine", "fused", "general.engine"),
        ("engine", "xla", "general.engine"),
        ("binning", "pallas", "general.binning"),
        ("history_found_slots", 8, "history_found_slots"),
        ("keep_history", "found", "keep_history='found'"),
        ("keep_history", "sampled", "keep_history='sampled'"),
    ])
    def test_general_option_raises(self, key, value, match):
        import xicsrt_tpu

        config = spectrometer(64, **{key: value})
        with pytest.raises(ValueError, match=match):
            xicsrt_tpu.raytrace(config)

    def test_sharded_and_differentiable_paths_raise(self):
        from xicsrt_tpu.gradients import make_differentiable
        from xicsrt_tpu.parallel import make_sharded_run

        with pytest.raises(ValueError, match="general.engine"):
            make_sharded_run(spectrometer(64, engine="fused"), n_devices=2)
        with pytest.raises(ValueError, match="general.binning"):
            make_differentiable(spectrometer(64, binning="pallas"))

    def test_boolean_history_still_accepted(self):
        from xicsrt_tpu.config import check_removed_options

        for value in (True, False):
            check_removed_options(spectrometer(64, keep_history=value))


class TestCompileCache:
    def test_environment_variable_wins(self, monkeypatch, tmp_path):
        import xicsrt_tpu

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert xicsrt_tpu.compile_cache_dir() == str(tmp_path)

    def test_fixed_directory_in_checkout(self, monkeypatch):
        import xicsrt_tpu

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            xicsrt_tpu.__file__)))
        assert xicsrt_tpu.compile_cache_dir() == os.path.join(root,
                                                              ".jax_cache")
        with open(os.path.join(root, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


class TestBenchPeaks:
    def test_h100_entry(self):
        import bench

        assert bench.peak_flops("NVIDIA H100 80GB HBM3", "float32") == 67e12
        assert bench.peak_flops("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
        assert bench.PEAKS["NVIDIA H100 80GB HBM3"]["hbm_bytes_per_s"] == 3.35e12

    def test_unknown_device_raises(self):
        import bench

        with pytest.raises(KeyError, match="No published peaks"):
            bench.peak_flops("Unknown Accelerator 9000", "bfloat16")

    def test_unknown_dtype_raises(self):
        import bench

        with pytest.raises(KeyError, match="float16"):
            bench.peak_flops("NVIDIA H100 80GB HBM3", "float16")

    def test_no_gpu_is_an_error(self):
        import bench

        with pytest.raises(RuntimeError, match="No GPU"):
            bench.gpu_device()


class TestGraftEntry:
    def test_dryrun_on_the_test_mesh(self, capsys):
        from __graft_entry__ import dryrun_multichip

        dryrun_multichip(4)
        out = capsys.readouterr().out
        assert "dryrun_multichip OK: 4 devices" in out
        assert "gradient OK" in out

    def test_too_few_devices_raises(self):
        from __graft_entry__ import dryrun_multichip

        with pytest.raises(RuntimeError, match="cpu_mesh=True"):
            dryrun_multichip(len(jax.devices()) + 1)
