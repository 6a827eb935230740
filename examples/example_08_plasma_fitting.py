# -*- coding: utf-8 -*-
"""
Example 08: fitting plasma parameters from a measured spectrum.

The scientific payoff of a differentiable XICS code: recover the plasma
ION TEMPERATURE (Doppler line width) and EMISSIVITY (absolute brightness)
from a detector image. The reference computes these images forward-only
(``_XicsrtPlasmaGeneric.py:269-320`` real-units semantics); fitting there
means scanning or external finite differences.

Temperature sets the Doppler width of every sampled wavelength, so
``jax.grad`` of a pixel loss reaches it through the rays (reparameterized
sampling). The fit matches the line width along the dispersion axis, which
does not depend on the brightness. Emissivity sets the integer photon count, which carries no
gradient; the expected image is linear in it, so it is fit in closed form
from the image totals.
"""

import numpy as np

import jax
import jax.numpy as jnp

from xicsrt_tpu.gradients import align, make_differentiable


def _config(emissivity, temperature):
    return {
        "general": {"number_of_iter": 4, "random_seed": 0,
                    "print_results": False},
        "sources": {"plasma": {
            "class_name": "XicsrtPlasmaCubic",
            "origin": [0.0, 0.0, 0.0],
            "xsize": 2e-4, "ysize": 2e-4, "zsize": 2e-4,
            "target": [0.0, -3e-4, 0.80374151],
            "spread": np.radians(4.0),
            "emissivity": emissivity,
            "temperature": temperature,
            "mass_number": 40.0,
            "wavelength": 3.9492,
            "time_resolution": 1e-3,
            "bundle_volume": 8e-12,
            "use_poisson": False,
        }},
        "optics": {
            "crystal": {
                "class_name": "XicsrtOpticSphericalCrystal",
                "origin": [0.0, -3e-4, 0.80374151],
                "zaxis": [0.0, 0.59497864, -0.80374151],
                "xsize": 0.2, "ysize": 0.2, "radius": 1.0,
                "crystal_spacing": 2.45676,
                "rocking_type": "gaussian", "rocking_fwhm": 1e-3,
                "pixel_size": 0.02},
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084],
                "xsize": 0.4, "ysize": 0.2, "pixel_size": 0.002},
        },
    }


def line_width(image):
    """RMS width [pixels] of the line profile along the dispersion axis."""
    profile = jnp.sum(image, axis=1) / jnp.sum(image)
    x = jnp.arange(profile.shape[0], dtype=profile.dtype)
    mean = jnp.sum(profile * x)
    return jnp.sqrt(jnp.sum(profile * (x - mean) ** 2))


def width_loss(image, target):
    """Relative squared mismatch of the line widths (brightness-free)."""
    return (line_width(image) / line_width(target) - 1.0) ** 2


def main():
    E_true, T_true = 8.3e20, 2.0e4  # [ph/m^3/s], [eV]
    E_guess, T_guess = 0.6 * E_true, 0.5 * T_true

    # "Measured" spectrum: the image at the true parameters.
    image_fn, truth = make_differentiable(_config(E_true, T_true))
    target = np.asarray(image_fn(truth.params, jax.random.key(3))["detector"])
    print(f"target spectrum: {target.sum():.0f} detected weight")
    print(f"true      E {E_true:.3e}  T {T_true:.0f}")
    print(f"initial   E {E_guess:.3e}  T {T_guess:.0f}")

    # Temperature: Adam on the line-width loss, fresh rays every step.
    def report(step, loss, trainable):
        if step % 25 == 0:
            T = float(trainable["sources"]["plasma"]["temperature"])
            print(f"step {step:3d}: loss {loss:.3e}  T {T:.0f}")

    final, _ = align(
        _config(E_guess, T_guess), {"detector": target},
        optimize_paths=[("sources", "plasma", "temperature")],
        steps=150, learning_rate=400.0, seed=11, loss_fn=width_loss,
        callback=report,
    )
    T_fit = float(final["sources"]["plasma"]["temperature"])

    # Emissivity: the expected image is linear in it. Average the model's
    # total over a few ray sets so that the target's own noise dominates.
    image_fn, guess = make_differentiable(_config(E_guess, T_fit))
    total = np.mean([
        float(jnp.sum(image_fn(guess.params, jax.random.key(k))["detector"]))
        for k in range(5, 13)
    ])
    E_fit = E_guess * target.sum() / total

    print(f"recovered E {E_fit:.3e} ({abs(E_fit / E_true - 1) * 100:.1f}% "
          f"err)  T {T_fit:.0f} ({abs(T_fit / T_true - 1) * 100:.1f}% err)")
    # The emissivity inherits part of the temperature's error: the Bragg
    # acceptance, and so the detected total, depends on the line width.
    assert abs(E_fit / E_true - 1) < 0.08
    assert abs(T_fit / T_true - 1) < 0.1


if __name__ == "__main__":
    main()
