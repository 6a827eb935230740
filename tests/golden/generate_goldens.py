"""Generate golden parity data by RUNNING the CPU reference implementation.

Runs PrincetonUniversity/xicsrt v0.8.13 (read-only at /root/reference) on
several spectrometer geometries and stores detector images + per-element ray
counts as .npz files under tests/golden/. The two codes use different RNGs,
so the parity tests compare distributions (Poisson/chi-square tolerances),
not bitwise images.

Usage:  python tests/golden/generate_goldens.py [scenario ...]
Scenarios: torus, mesh_sphere, mosaic (default: all missing ones).

This script only *executes* the reference as a black box; no reference code
is copied into this repository.
"""

import os
import sys

import numpy as np

sys.path.insert(0, "/root/reference")

HERE = os.path.dirname(os.path.abspath(__file__))

BASE = {
    "general": {
        "number_of_iter": 5,
        "number_of_runs": 2,
        "random_seed": 7,
        "save_images": False,
        "save_results": False,
        "save_config": False,
        "print_results": False,
    },
    "sources": {
        "source": {
            "class_name": "XicsrtSourceDirected",
            "intensity": 1e5,
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
            "pixel_size": 0.004,
        },
    },
}


def _with_crystal(_drop=(), _intensity=None, **crystal_overrides):
    import copy

    config = copy.deepcopy(BASE)
    for key in _drop:
        config["optics"]["crystal"].pop(key, None)
    config["optics"]["crystal"].update(crystal_overrides)
    if _intensity is not None:
        config["sources"]["source"]["intensity"] = _intensity
    return config


SCENARIOS = {
    # Exercises the quartic torus solver (reference _ShapeTorus.py:110-183).
    # Wider rocking curve + 4x rays: the stock 48-urad width accepts only
    # ~16 of 1e6 rays, leaving the image comparison statistically vacuous;
    # same solver path, ~5000 counts.
    "torus": _with_crystal(
        _drop=("radius",),
        class_name="XicsrtOpticToroidalCrystal",
        radius_major=1.0,
        radius_minor=0.2,
        rocking_fwhm=1e-3,
        _intensity=4e5,
    ),
    # Exercises Möller–Trumbore + KD-tree refinement (_ShapeMesh.py:289-426).
    "mesh_sphere": _with_crystal(
        class_name="XicsrtOpticMeshSphericalCrystal",
        mesh_size=(21, 21),
        mesh_coarse_size=(7, 7),
    ),
    # Exercises the mosaic multi-layer loop (_InteractMosaicCrystal.py:53-107).
    "mosaic": _with_crystal(
        class_name="XicsrtOpticSphericalMosaicCrystal",
        mosaic_spread=np.radians(0.05),
        mosaic_depth=15,
        rocking_fwhm=150e-6,
    ),
}


# Gradient-golden operating point. The BASE geometry is an exact Rowland
# configuration (source on the Rowland sphere), so at the stock 48-urad
# rocking width the reflected intensity is a resonance ~4e-5 m wide in
# crystal-y — no usable finite-difference exists there. The golden widens
# the rocking curve (same physics path, broader resonance: response to y
# measured smooth over +-1e-3 m) and detunes the crystal to the steep flank
# of the acceptance curve, where d(efficiency)/dy is large and locally
# linear (scanned with the reference: counts 80020 -> 253604 -> 382431 at
# y = -5e-4, -2e-4, 0 for 2e6 rays).
GRAD_FWHM = 1e-3
GRAD_Y0 = -3e-4
GRAD_DELTA = 1e-4


def generate_gradient_golden():
    """Finite-difference the CPU reference w.r.t. crystal origin y.

    BASELINE.md's second clause demands gradient parity vs the CPU
    reference: this golden central-differences the DETECTED EFFICIENCY
    (detector image integral / rays generated) w.r.t. a global-y shift of
    the crystal origin, at the operating point above. Three seeds quantify
    the MC noise of the FD estimate; the parity test compares ``jax.grad``
    of the weight-mode image integral against the seed-mean within the
    seed spread.
    """
    import copy

    import xicsrt

    intensity = 1e6
    num_iter = 10  # 1e7 rays per evaluation

    def run(origin_y_shift, seed):
        config = copy.deepcopy(BASE)
        g = config["general"]
        g["number_of_iter"] = num_iter
        g["number_of_runs"] = 1
        g["random_seed"] = seed
        g["keep_history"] = False
        config["sources"]["source"]["intensity"] = intensity
        crystal = config["optics"]["crystal"]
        crystal["rocking_fwhm"] = GRAD_FWHM
        origin = list(crystal["origin"])
        origin[1] += origin_y_shift
        crystal["origin"] = origin
        result = xicsrt.raytrace(config)
        image = np.asarray(result["total"]["image"]["detector"], dtype=float)
        n_gen = float(result["total"]["meta"]["source"]["num_out"])
        return float(image.sum()) / n_gen

    out = {
        "delta": GRAD_DELTA, "y0": GRAD_Y0, "rocking_fwhm": GRAD_FWHM,
        "n_rays": intensity * num_iter,
    }
    fds = []
    for seed in (101, 202, 303):
        eff_p = run(GRAD_Y0 + GRAD_DELTA, seed)
        eff_m = run(GRAD_Y0 - GRAD_DELTA, seed)
        fd = (eff_p - eff_m) / (2 * GRAD_DELTA)
        out[f"fd_efficiency_seed{seed}"] = fd
        fds.append(fd)
        print(f"seed {seed}: d(eff)/dy = {fd:.4f} (eff {eff_m:.5f}/{eff_p:.5f})")
    out["fd_efficiency_mean"] = np.mean(fds)
    out["fd_efficiency_std"] = np.std(fds, ddof=1)
    path = os.path.join(HERE, "gradient_reference.npz")
    np.savez_compressed(path, **out)
    print(f"gradient golden -> {path} "
          f"(mean {out['fd_efficiency_mean']:.4f} "
          f"+- {out['fd_efficiency_std']:.4f})")


def generate_gradient_params_golden():
    """Finite-difference the CPU reference w.r.t. crystal_spacing and
    rocking_fwhm (round-2 verdict #5: gradient parity beyond pose).

    Same operating point as the y-shift golden (flank of the widened
    acceptance curve). Deltas are chosen so the induced Bragg-angle/width
    change is ~10% of the rocking width — inside the locally-linear regime:
    d(theta_B)/d(spacing) = -tan(theta_B)/spacing with theta_B = 53.5 deg
    here, so delta_spacing = 2e-4 A shifts theta_B by ~1.1e-4 rad.
    Per-seed runs reuse the SAME seed for +/- evaluations (common random
    numbers), which cancels most MC noise out of the difference.
    """
    import copy

    import xicsrt

    intensity = 1e6
    num_iter = 10  # 1e7 rays per evaluation

    def run(seed, **crystal_overrides):
        config = copy.deepcopy(BASE)
        g = config["general"]
        g["number_of_iter"] = num_iter
        g["number_of_runs"] = 1
        g["random_seed"] = seed
        g["keep_history"] = False
        config["sources"]["source"]["intensity"] = intensity
        crystal = config["optics"]["crystal"]
        crystal["rocking_fwhm"] = GRAD_FWHM
        origin = list(crystal["origin"])
        origin[1] += GRAD_Y0
        crystal["origin"] = origin
        crystal.update(crystal_overrides)
        result = xicsrt.raytrace(config)
        image = np.asarray(result["total"]["image"]["detector"], dtype=float)
        n_gen = float(result["total"]["meta"]["source"]["num_out"])
        return float(image.sum()) / n_gen

    spacing0 = BASE["optics"]["crystal"]["crystal_spacing"]
    params = {
        "crystal_spacing": (spacing0, 2e-4),
        "rocking_fwhm": (GRAD_FWHM, 5e-5),
    }
    out = {"y0": GRAD_Y0, "rocking_fwhm0": GRAD_FWHM,
           "crystal_spacing0": spacing0, "n_rays": intensity * num_iter}
    for pname, (p0, delta) in params.items():
        fds = []
        for seed in (404, 505, 606):
            eff_p = run(seed, **{pname: p0 + delta})
            eff_m = run(seed, **{pname: p0 - delta})
            fds.append((eff_p - eff_m) / (2 * delta))
            print(f"{pname} seed {seed}: d(eff)/d{pname} = {fds[-1]:.6g} "
                  f"(eff {eff_m:.5f}/{eff_p:.5f})")
        out[f"fd_{pname}_delta"] = delta
        out[f"fd_{pname}_mean"] = np.mean(fds)
        out[f"fd_{pname}_std"] = np.std(fds, ddof=1)
    path = os.path.join(HERE, "gradient_params_reference.npz")
    np.savez_compressed(path, **out)
    print(f"gradient-params golden -> {path}")
    for pname in params:
        print(f"  d(eff)/d({pname}) = {out[f'fd_{pname}_mean']:.6g} "
              f"+- {out[f'fd_{pname}_std']:.3g}")


def generate_gradient_pixel_golden():
    """Finite-difference the reference's DETECTOR IMAGE (superpixel level).

    BASELINE.md's metric is "detector image + pixel-grad allclose": the
    scalar-efficiency goldens above constrain gradient magnitude only. This
    golden central-differences the [100, 50] reference image coarsened to
    [10, 10] superpixels (the same coarsening as the image-parity tests)
    w.r.t. crystal origin-y and crystal_spacing, per generated ray, with
    common random numbers per seed pair. The parity test compares the
    SPATIAL STRUCTURE of d(image)/d(param) from jax against these fields.
    """
    import copy

    import xicsrt

    intensity = 1e6
    num_iter = 10  # 1e7 rays per evaluation

    def run(seed, origin_y_shift=0.0, **crystal_overrides):
        config = copy.deepcopy(BASE)
        g = config["general"]
        g["number_of_iter"] = num_iter
        g["number_of_runs"] = 1
        g["random_seed"] = seed
        g["keep_history"] = False
        config["sources"]["source"]["intensity"] = intensity
        # Pixel-RESOLVED operating point. At the stock geometry the line
        # is sub-pixel in y (sagittal focus, ~0.3 px sigma): pixel
        # gradients there only probe the binning kernel's derivative, not
        # physics. Two changes give the field pixel-scale structure both
        # codes must reproduce: a uniform wavelength band spreads the
        # dispersion (x) axis, and the detector sits 8 cm BEFORE the
        # sagittal focus so the y footprint defocuses over ~6 pixels.
        config["sources"]["source"]["wavelength_dist"] = "uniform"
        config["sources"]["source"]["wavelength_range"] = [
            3.9492 - 0.013, 3.9492 + 0.013
        ]
        det = config["optics"]["detector"]
        det["origin"] = list(
            np.asarray(det["origin"]) + 0.08 * np.asarray(det["zaxis"])
        )
        crystal = config["optics"]["crystal"]
        crystal["rocking_fwhm"] = GRAD_FWHM
        origin = list(crystal["origin"])
        origin[1] += GRAD_Y0 + origin_y_shift
        crystal["origin"] = origin
        crystal.update(crystal_overrides)
        result = xicsrt.raytrace(config)
        image = np.asarray(result["total"]["image"]["detector"], dtype=float)
        n_gen = float(result["total"]["meta"]["source"]["num_out"])
        return image / n_gen

    spacing0 = BASE["optics"]["crystal"]["crystal_spacing"]
    cases = {
        "origin_y": ("origin_y_shift", 0.0, GRAD_DELTA),
        "crystal_spacing": ("crystal_spacing", spacing0, 2e-4),
    }
    # Per-seed FULL-RESOLUTION [100, 50] FD fields: the parity test
    # compares after applying the SAME smoothing to the jax side, which
    # cancels the hard-binning (box) vs bilinear-splat (tent) kernel
    # difference that superpixel sums alone cannot.
    out = {"y0": GRAD_Y0, "rocking_fwhm": GRAD_FWHM,
           "crystal_spacing0": spacing0, "n_rays": intensity * num_iter}
    for cname, (kw, p0, delta) in cases.items():
        fields = []
        for seed in (707, 808, 909):
            img_p = run(seed, **{kw: p0 + delta})
            img_m = run(seed, **{kw: p0 - delta})
            fields.append((img_p - img_m) / (2 * delta))
            print(f"{cname} seed {seed}: |FD field| max "
                  f"{np.abs(fields[-1]).max():.4g}")
        out[f"fd_pixel_{cname}_delta"] = delta
        out[f"fd_pixel_{cname}_fields"] = np.stack(fields)
    path = os.path.join(HERE, "gradient_pixel_reference.npz")
    np.savez_compressed(path, **out)
    print(f"gradient-pixel golden -> {path}")


def run_reference(name, config):
    import xicsrt

    result = xicsrt.raytrace(config)
    meta = result["total"]["meta"]
    image = result["total"]["image"]["detector"]
    out = {
        "image": np.asarray(image),
        "n_generated": np.asarray(meta["source"]["num_out"]),
        "meta_crystal": np.asarray(meta["crystal"]["num_out"]),
        "meta_detector": np.asarray(meta["detector"]["num_out"]),
    }
    path = os.path.join(HERE, f"{name}_reference_image.npz")
    np.savez_compressed(path, **out)
    print(
        f"{name}: generated={out['n_generated']} crystal={out['meta_crystal']} "
        f"detector={out['meta_detector']} -> {path}"
    )


def main():
    requested = sys.argv[1:] or [
        n
        for n in list(SCENARIOS)
        + ["gradient", "gradient_params", "gradient_pixel"]
        if not os.path.exists(
            os.path.join(
                HERE,
                f"{n}_reference_image.npz" if n in SCENARIOS
                else f"{n}_reference.npz",
            )
        )
    ]
    for name in requested:
        if name == "gradient":
            generate_gradient_golden()
        elif name == "gradient_params":
            generate_gradient_params_golden()
        elif name == "gradient_pixel":
            generate_gradient_pixel_golden()
        else:
            run_reference(name, SCENARIOS[name])


if __name__ == "__main__":
    main()
