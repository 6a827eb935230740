"""Per-scenario throughput of the XLA engine on one GPU.

Measures each scenario with the same serialized-dispatch harness as
bench.py. One JSON line per scenario, naming the device. Fails without a
GPU.

Usage: timeout 590 python tools/bench_scenarios.py [scenario ...]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _crystal(**kw):
    crystal = {
        "origin": [0.0, 0.0, 0.80374151],
        "zaxis": [0.0, 0.59497864, -0.80374151],
        "xsize": 0.2,
        "ysize": 0.2,
        "crystal_spacing": 2.45676,
        "rocking_type": "gaussian",
        "rocking_fwhm": 48.070e-6,
    }
    crystal.update(kw)
    return crystal


def _config(crystal, intensity, num_iter, **general):
    g = {"number_of_iter": num_iter, "random_seed": 0,
         "keep_history": False, "print_results": False}
    g.update(general)
    return {
        "general": g,
        "sources": {
            "source": {
                "class_name": "XicsrtSourceDirected",
                "intensity": intensity,
                "wavelength": 3.9492,
                "angular_dist": "isotropic_xy",
                "spread": np.radians(10.0),
            }
        },
        "optics": {
            "crystal": crystal,
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084],
                "xsize": 0.4,
                "ysize": 0.2,
            },
        },
    }


def _plasma_config(intensity, num_iter, bundle_count=1000):
    # time_resolution chosen so the EXPECTED photon count equals
    # `intensity`: N = emissivity * t * volume * sin^2(spread/2)
    # (cf. sources/plasma.py intensity formula and tests/test_plasma.py).
    emissivity = 1e16
    volume = 0.02**3
    omega_frac = np.sin(np.radians(10.0) / 2.0) ** 2
    t_res = intensity / (emissivity * volume * omega_frac)
    return {
        "general": {"number_of_iter": num_iter, "random_seed": 0,
                    "keep_history": False, "print_results": False},
        "sources": {
            "plasma": {
                "class_name": "XicsrtPlasmaCubic",
                "origin": [0.0, 0.0, 0.0],
                "xsize": 0.02, "ysize": 0.02, "zsize": 0.02,
                "target": [0.0, 0.0, 0.80374151],
                "spread": np.radians(10.0),
                "emissivity": emissivity,
                "temperature": 1000.0,
                "mass_number": 40.0,
                "wavelength": 3.9492,
                "time_resolution": t_res,
                "bundle_volume": 1e-6,
                "bundle_count": bundle_count,
                "max_bundles": max(bundle_count * 2, 10000),
                "use_poisson": True,
                # The static budget carries headroom above the expectation
                # (sources/plasma.py _estimate_budget); 1.5x covers it.
                "max_rays": int(intensity * 1.5 + 1e5),
            }
        },
        "optics": {
            "crystal": _crystal(
                class_name="XicsrtOpticToroidalCrystal",
                radius_major=1.0, radius_minor=0.64,
                rocking_fwhm=100e-6,
            ),
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084],
                "xsize": 0.4, "ysize": 0.2,
            },
        },
    }


SCENARIOS = {
    "toroidal": lambda n, it: _config(
        _crystal(class_name="XicsrtOpticToroidalCrystal",
                 radius_major=1.0, radius_minor=0.2), n, it),
    "mosaic15": lambda n, it: _config(
        _crystal(class_name="XicsrtOpticSphericalMosaicCrystal",
                 radius=1.0, mosaic_spread=np.radians(0.05),
                 mosaic_depth=15, rocking_fwhm=150e-6), n, it),
    "mesh41": lambda n, it: _config(
        _crystal(class_name="XicsrtOpticMeshSphericalCrystal",
                 radius=1.0, mesh_size=(41, 41),
                 mesh_coarse_size=(11, 11)), n, it),
    "plasma_torus": _plasma_config,
    # Reference-scale plasma (1e5 bundles; _XicsrtPlasmaGeneric.py:155
    # defaults max_bundles=1e7): the bundle table and per-ray gather.
    "plasma_100k": lambda n, it: _plasma_config(n, it, bundle_count=100000),
    "diff_fwd_bwd": lambda n, it: _config(
        _crystal(class_name="XicsrtOpticSphericalCrystal", radius=1.0),
        n, it),
}


def _binning_flops_per_ray(pipeline):
    """FLOPs per ray of the binning matrix product: 2 * nx * ny per image."""
    mpr = sum(nx * ny for (nx, ny), _ in pipeline.image_specs().values())
    return 2.0 * mpr, mpr


def time_chained(step, params, n_rays, reps=2, blocks=2):
    import jax
    import jax.numpy as jnp

    jitted = jax.jit(step)
    key = jax.random.key(0)
    dep = jnp.uint32(0)
    for w in range(2):
        dep = jitted(params, jax.random.fold_in(key, 900 + w), dep)
    jax.block_until_ready(dep)
    best = float("inf")
    for b in range(blocks):
        d = dep
        t0 = time.perf_counter()
        for r in range(reps):
            d = jitted(params, jax.random.fold_in(key, b * reps + r), d)
        jax.block_until_ready(d)
        best = min(best, time.perf_counter() - t0)
    return n_rays * reps / best


def run_scenario(name, log2=None, num_iter=None):
    if log2 is None:
        log2 = int(os.environ.get("XICSRT_BENCH_LOG2", "22"))
    if num_iter is None:
        num_iter = int(os.environ.get("XICSRT_BENCH_ITER", "4"))
    import jax
    import jax.numpy as jnp

    from bench import gpu_device, peak_flops
    from xicsrt_tpu.engine import Pipeline

    dev = gpu_device()
    intensity = 1 << log2
    config = SCENARIOS[name](intensity, num_iter)

    if name == "diff_fwd_bwd":
        from xicsrt_tpu.gradients import make_differentiable

        remat_env = os.environ.get("XICSRT_BENCH_REMAT")
        image_fn, pipeline = make_differentiable(
            config, num_iter=num_iter,
            remat=None if remat_env is None else remat_env == "1",
        )

        # Pixel-weighted loss: a plain sum(image) lets XLA dead-code
        # -eliminate most of the trace (the bilinear splat's in-bounds sum
        # barely depends on positions), inflating the measurement ~100x.
        # Random fixed pixel weights force every per-pixel value (and its
        # adjoint) to be computed — the shape of a real alignment loss.
        nx, ny = pipeline.optics[-1].image_shape
        pixel_w = jax.random.uniform(jax.random.key(42), (int(nx), int(ny)))

        def loss(params, key):
            return jnp.sum(image_fn(params, key)["detector"] * pixel_w)

        grad_fn = jax.grad(loss)

        def step(params, key, dep):
            g = grad_fn(params, jax.random.fold_in(key, dep))
            leaf = g["optics"]["crystal"]["frame"].origin
            return (jnp.abs(leaf[0]) * 1e6).astype(jnp.uint32)

        n_rays = intensity * num_iter
        # The tent product runs three times per ray: forward and the two
        # products of its transpose.
        passes = 3.0
    else:
        pipeline = Pipeline(config)
        run = pipeline.make_run(num_iter, keep_history=False,
                                keep_images=True)
        last = pipeline.element_names[-1]

        def step(params, key, dep):
            out = run(params, jax.random.fold_in(key, dep))
            return out["meta"][last].astype(jnp.uint32)

        n_rays = pipeline.num_rays * num_iter
        passes = 1.0
    rps = time_chained(step, pipeline.params, n_rays)
    fpr, mpr = _binning_flops_per_ray(pipeline)
    op_dtype = jnp.dtype(pipeline.source.dtype).name
    share = passes * fpr * rps / peak_flops(dev.device_kind, op_dtype)
    return {"scenario": name,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "rays_per_s": rps,
            "rays_per_dispatch": n_rays,
            "binning_peak_share": share,
            "binning_macs_per_ray": int(mpr)}


def main():
    names = sys.argv[1:] or list(SCENARIOS)
    for name in names:
        try:
            res = run_scenario(name)
        except Exception as err:
            res = {"scenario": name, "error": f"{type(err).__name__}: {err}"}
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
