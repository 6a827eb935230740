"""Differentiable-raytracing tests: finite-difference gradient checks and an
end-to-end alignment recovery (the BASELINE.md differentiable-alignment
configuration)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from xicsrt_tpu.gradients import align, make_differentiable


def _bragg_config(num_iter=1, intensity=20000):
    return {
        "general": {
            "number_of_iter": num_iter,
            "random_seed": 0,
            "print_results": False,
            "dtype": "float64",
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
            "crystal": {
                "class_name": "XicsrtOpticSphericalCrystal",
                "origin": [0.0, 0.0, 0.80374151],
                "zaxis": [0.0, 0.59497864, -0.80374151],
                "xsize": 0.2,
                "ysize": 0.2,
                "radius": 1.0,
                "crystal_spacing": 2.45676,
                "rocking_type": "gaussian",
                "rocking_fwhm": 2e-4,
            },
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084],
                "xsize": 0.4,
                "ysize": 0.2,
                "pixel_size": 0.01,
            },
        },
    }


def _total_weight_fn():
    """Differentiable scalar: total detected weight vs crystal params."""
    image_fn, pipeline = make_differentiable(_bragg_config())
    key = jax.random.key(42)

    def total(params):
        return jnp.sum(image_fn(params, key)["detector"])

    return total, pipeline.params


class TestGradientCorrectness:
    @pytest.mark.parametrize(
        "path,eps",
        [
            (("optics", "crystal", "crystal_spacing"), 1e-6),
            (("optics", "crystal", "rocking_fwhm"), 1e-8),
        ],
    )
    def test_grad_matches_finite_difference_scalar(self, path, eps):
        total, params = _total_weight_fn()

        def get(params, path):
            node = params
            for p in path:
                node = node[p]
            return node

        def set_(params, path, value):
            import copy

            out = copy.deepcopy(
                jax.tree_util.tree_map(lambda x: x, params)
            )
            node = out
            for p in path[:-1]:
                node = node[p]
            node[path[-1]] = value
            return out

        g = jax.grad(lambda p: total(p))(params)
        g_val = float(get(g, path))

        v0 = get(params, path)
        f_plus = float(total(set_(params, path, v0 + eps)))
        f_minus = float(total(set_(params, path, v0 - eps)))
        fd = (f_plus - f_minus) / (2 * eps)
        assert g_val != 0.0
        np.testing.assert_allclose(g_val, fd, rtol=2e-3)

    def test_grad_wrt_crystal_origin_nonzero(self):
        total, params = _total_weight_fn()
        g = jax.grad(total)(params)
        g_origin = np.asarray(g["optics"]["crystal"]["frame"].origin)
        assert np.any(np.abs(g_origin) > 0)
        g_basis = np.asarray(g["optics"]["crystal"]["frame"].basis)
        assert np.any(np.abs(g_basis) > 0)

    def test_image_pixel_gradients_flow(self):
        """Pixel-level gradients w.r.t. detector position via bilinear splat."""
        image_fn, pipeline = make_differentiable(_bragg_config())
        key = jax.random.key(1)

        def pixel_moment(params):
            img = image_fn(params, key)["detector"]
            # First moment of the image along x: moves when optics move.
            nx = img.shape[0]
            xs = jnp.arange(nx, dtype=img.dtype)
            return jnp.sum(img * xs[:, None]) / (jnp.sum(img) + 1e-9)

        g = jax.grad(pixel_moment)(pipeline.params)
        det_origin_grad = np.asarray(g["optics"]["detector"]["frame"].origin)
        assert np.any(np.abs(det_origin_grad) > 1e-3)


class TestAlignment:
    def test_recover_crystal_spacing(self):
        """Differentiable alignment: recover a perturbed d-spacing from the
        target detector image (BASELINE.md target)."""
        true_config = _bragg_config(num_iter=1, intensity=50000)
        image_fn, pipeline = make_differentiable(true_config)
        key = jax.random.key(7)
        target = np.asarray(image_fn(pipeline.params, key)["detector"])

        perturbed = _bragg_config(num_iter=1, intensity=50000)
        perturbed["optics"]["crystal"]["crystal_spacing"] = 2.45676 * (1 + 2e-4)

        final, losses = align(
            perturbed,
            {"detector": target},
            optimize_paths=[("optics", "crystal", "crystal_spacing")],
            steps=60,
            learning_rate=2e-5,
            seed=7,
            resample=False,
        )
        recovered = float(final["optics"]["crystal"]["crystal_spacing"])
        # Bragg-line position is exquisitely sensitive to d: recovery to ~1e-5
        # relative is easy for gradient descent once the line overlaps.
        assert losses[-1] < 0.25 * losses[0]
        assert abs(recovered - 2.45676) < abs(2.45676 * 2e-4 - 0.0) * 0.5
