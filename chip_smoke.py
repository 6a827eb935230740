"""Smoke test of the raytracer on one NVIDIA GPU, through its normal entry
points, at real sizes.

Run from the repository root:

    python chip_smoke.py          # six phases on one card
    python chip_smoke.py --four   # the ray-sharded path on four cards only

Each phase prints one line: what it compared, with which tolerance, its
set-up (trace + compile) seconds, its run seconds and the device's
``peak_bytes_in_use`` so far. A line before the last gives the card's name
and power limit from ``nvidia-smi``. The last line is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``. Without a GPU,
or when any phase fails, the script exits non-zero and prints no result.

Phases (one card):

1. example_01 Bragg spectrometer, 1e6 rays, ``raytrace`` with its default
   full ray history, against the CPU reference's golden image.
2. The flagship chain (source -> boolean aperture -> spherical crystal ->
   detector) at 2^22 rays x 16 iterations: exact ray accounting, and the
   GPU's matmul binning against the scatter route on one iteration's rays.
3. Toroidal, mosaic (depth 15) and 21x21 mesh-sphere crystals against the
   CPU reference's golden images.
4. A toroidal-crystal plasma at 1e5 bundles and ~1.7e7 expected photons:
   the photon count against its Poisson expectation.
5. ``jax.grad`` through ``make_differentiable`` against the CPU
   reference's finite difference; the same gradient through the matmul
   and the scatter binning routes; one ``align`` step.
6. The flagship in float64 against float32.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")


# ---------------------------------------------------------------------------
# Configurations
# ---------------------------------------------------------------------------

def example01_config(intensity, num_iter, **crystal):
    """The example_01 spectrometer of the golden images (pixel 4 mm);
    ``crystal`` overrides the spherical crystal's class and shape."""
    crystal = crystal or {"class_name": "XicsrtOpticSphericalCrystal",
                          "radius": 1.0}
    crystal_config = {
        "origin": [0.0, 0.0, 0.80374151],
        "zaxis": [0.0, 0.59497864, -0.80374151],
        "xsize": 0.2, "ysize": 0.2,
        "crystal_spacing": 2.45676,
        "rocking_type": "gaussian", "rocking_fwhm": 48.070e-6,
    }
    crystal_config.update(crystal)
    return {
        "general": {"number_of_iter": num_iter, "random_seed": 7,
                    "print_results": False},
        "sources": {"source": {
            "class_name": "XicsrtSourceDirected",
            "intensity": intensity, "wavelength": 3.9492,
            "spread": np.radians(10.0),
        }},
        "optics": {
            "crystal": crystal_config,
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084],
                "xsize": 0.4, "ysize": 0.2, "pixel_size": 0.004,
            },
        },
    }


# Crystal families of tests/test_reference_parity_families.py, with the
# meshes the golden images were made from: a 41x41 mesh is another surface
# (its acceptance is ~8% lower than the 21x21 golden's). WIDTH_RTOL is that
# test's.
FAMILIES = {
    "torus": dict(class_name="XicsrtOpticToroidalCrystal",
                  radius_major=1.0, radius_minor=0.2, rocking_fwhm=1e-3),
    "mosaic": dict(class_name="XicsrtOpticSphericalMosaicCrystal",
                   radius=1.0, mosaic_spread=np.radians(0.05),
                   mosaic_depth=15, rocking_fwhm=150e-6),
    "mesh_sphere": dict(class_name="XicsrtOpticMeshSphericalCrystal",
                        radius=1.0, mesh_size=(21, 21),
                        mesh_coarse_size=(7, 7)),
}
WIDTH_RTOL = {"example01": 0.05, "torus": 0.05, "mesh_sphere": 0.08,
              "mosaic": 0.15}


def gradient_config(y0, rocking_fwhm, intensity, dtype):
    """The operating point of tests/test_gradient_parity.py."""
    config = example01_config(intensity, 1,
                              class_name="XicsrtOpticSphericalCrystal",
                              radius=1.0, rocking_fwhm=rocking_fwhm)
    config["optics"]["crystal"]["origin"] = [0.0, y0, 0.80374151]
    config["general"].update(random_seed=0, dtype=dtype)
    return config


# ---------------------------------------------------------------------------
# Criteria
# ---------------------------------------------------------------------------

def _ratio_sigma(k_ours, n_ours, k_ref, n_ref):
    p = (k_ours + k_ref) / (n_ours + n_ref)
    return np.sqrt(p / n_ours + p / n_ref)


def compare_with_golden(name, result, golden):
    """The criteria of tests/test_reference_parity*.py: acceptance and
    efficiency within 5 combined sigma, 10x10-superpixel chi2/ndof < 3,
    line centroid and width along the dispersion axis. Returns a summary
    string; raises AssertionError on a failure."""
    meta = result["total"]["meta"]
    n_gen = meta["source"]["num_out"]
    n_ref = float(golden["n_generated"])
    for element in ("crystal", "detector"):
        k = meta[element]["num_out"]
        k_ref = float(golden[f"meta_{element}"])
        sigma = _ratio_sigma(k, n_gen, k_ref, n_ref)
        assert abs(k / n_gen - k_ref / n_ref) < 5 * sigma, (
            f"{name}: {element} fraction {k / n_gen:.5f} vs reference "
            f"{k_ref / n_ref:.5f} (5 sigma = {5 * sigma:.2g})")
    eff = meta["detector"]["num_out"] / n_gen
    eff_ref = float(golden["meta_detector"]) / n_ref

    ref = golden["image"].astype(np.float64)
    img = np.asarray(result["total"]["image"]["detector"], np.float64)
    assert img.shape == ref.shape, (img.shape, ref.shape)
    sp = lambda a: a.reshape(10, 10, 5, 10).sum(axis=(1, 3))  # noqa: E731
    R, O = sp(ref), sp(img)
    scale = R.sum() / O.sum()
    O = O * scale
    keep = (R + O) > 50
    assert keep.sum() > 0, f"{name}: no superpixel has enough counts"
    chi2 = ((O[keep] - R[keep]) ** 2 / (R[keep] + scale * O[keep])).sum()
    chi2_ndof = chi2 / int(keep.sum())
    assert chi2_ndof < 3.0, f"{name}: chi2/ndof = {chi2_ndof:.2f}"

    ys = np.arange(ref.shape[1])

    def moments(p):
        p = p / p.sum()
        mu = (p * ys).sum()
        return mu, np.sqrt((p * (ys - mu) ** 2).sum())

    mu_r, sd_r = moments(ref.sum(axis=0))
    mu_o, sd_o = moments(img.sum(axis=0))
    centroid_tol = 0.5 if name == "example01" else 0.75
    assert abs(mu_o - mu_r) < centroid_tol, (
        f"{name}: centroid {mu_o:.2f} vs {mu_r:.2f} px")
    if sd_r < 1.0 and name != "example01":
        assert sd_o < 1.0, f"{name}: width {sd_o:.2f} px vs reference <1 px"
    else:
        assert abs(sd_o - sd_r) < WIDTH_RTOL[name] * sd_r, (
            f"{name}: width {sd_o:.2f} vs {sd_r:.2f} px")
    return (f"{name}: efficiency {eff:.5f} vs reference {eff_ref:.5f}, "
            f"chi2/ndof {chi2_ndof:.2f}, centroid {mu_o:.2f}/{mu_r:.2f} px, "
            f"width {sd_o:.2f}/{sd_r:.2f} px")


def _golden(name):
    data = np.load(os.path.join(GOLDEN, f"{name}_reference_image.npz"))
    return {k: data[k] for k in data.files}


def _assert_exact_accounting(result, n_expected=None):
    """Generated count (if given) and image integrals equal the counters
    exactly: mc mode, unit weights, every ray alive at an optic in bounds."""
    meta = result["total"]["meta"]
    if n_expected is not None:
        assert meta["source"]["num_out"] == n_expected, (
            meta["source"]["num_out"], n_expected)
    for name, img in result["total"]["image"].items():
        total = float(np.asarray(img, np.float64).sum())
        assert total == meta[name]["num_out"], (name, total,
                                                meta[name]["num_out"])


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_reference(intensity=100_000, num_iter=10):
    """example_01 through ``raytrace`` with the default keep_history=True."""
    import xicsrt_tpu

    result = xicsrt_tpu.raytrace(example01_config(intensity, num_iter))
    n_found = result["found"]["history"]["detector"]["origin"].shape[0]
    assert n_found == result["total"]["meta"]["detector"]["num_out"]
    summary = compare_with_golden("example01", result,
                                  _golden("example01"))
    return (f"{intensity * num_iter:.3g} rays, full history ({n_found} "
            f"found rays); {summary}")


def _hits_of_one_iteration(pipeline, key):
    """(x_local, mask, weight, nx, ny, pixel_size) per imaging optic for
    one iteration's rays, computed once on the device."""
    import jax

    specs = pipeline.image_specs()
    _, _, hits = jax.jit(pipeline.make_trace(keep_history=False,
                                             keep_images=True))(
        pipeline.params, key)
    return [hits[n] + (*specs[n][0], specs[n][1]) for n in specs]


def _time(fn, *args, reps=3):
    """Best wall seconds of ``fn(*args)`` after one warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def binning_routes(items):
    """Bin the same rays through the matmul route (``platform='gpu'``) and
    the scatter route (``platform='cpu'``). Nearest images must agree
    exactly; bilinear images, weighted nearest images and the bilinear VJP
    to rtol 1e-5 of their largest value. Returns each route's seconds:
    forward, and forward+VJP for bilinear (information for choosing the
    route, not a claim)."""
    import jax
    import jax.numpy as jnp

    from xicsrt_tpu.ops.binning import bin_images_fused

    statics = [it[3:] for it in items]
    xs = [it[0] for it in items]
    masks = [it[1] for it in items]
    ws = [it[2] for it in items]
    # Non-unit weights for the weighted comparison.
    ws_varied = [w * (0.5 + 0.5 * jnp.cos(x[:, 0] * 97.0))
                 for x, w in zip(xs, ws)]

    def images(platform, mode, xs, ws):
        full = [(x, m, w) + st for x, m, w, st in zip(xs, masks, ws, statics)]
        return bin_images_fused(full, mode, platform=platform)

    def loss(platform, xs, ws):
        out = images(platform, "bilinear", xs, ws)
        return sum(jnp.sum(i * jnp.sin(jnp.arange(i.size, dtype=i.dtype))
                           .reshape(i.shape)) for i in out)

    # Rays exactly on a pixel centre or edge sit on a kink of the splat,
    # where the two routes take different one-sided derivatives.
    smooth = []
    for x, (nx, ny, ps) in zip(xs, statics):
        p = np.stack([np.asarray(x[:, 0]) / ps + (nx - 1) / 2.0,
                      np.asarray(x[:, 1]) / ps + (ny - 1) / 2.0])
        smooth.append(np.all(np.abs(p - np.round(p)) > 1e-3, axis=0))

    out, times = {}, {}
    for platform in ("gpu", "cpu"):
        for mode in ("nearest", "bilinear"):
            fn = jax.jit(lambda xs, ws, mode=mode, platform=platform:
                         images(platform, mode, xs, ws))
            out[platform, mode] = [np.asarray(i) for i in fn(xs, ws)]
            times[f"{platform}_{mode}_fwd"] = _time(fn, xs, ws)
        out[platform, "weighted"] = [np.asarray(i) for i in jax.jit(
            lambda xs, ws, platform=platform:
            images(platform, "nearest", xs, ws))(xs, ws_varied)]
        grad_fn = jax.jit(jax.value_and_grad(
            lambda xs, ws, platform=platform: loss(platform, xs, ws),
            argnums=(0, 1)))
        _, (gx, gw) = grad_fn(xs, ws)
        out[platform, "vjp"] = (
            [np.asarray(g)[s] for g, s in zip(gx, smooth)]
            + [np.asarray(g) for g in gw])
        times[f"{platform}_bilinear_fwd_vjp"] = _time(grad_fn, xs, ws)
    for a, b in zip(out["gpu", "nearest"], out["cpu", "nearest"]):
        np.testing.assert_array_equal(a, b)
    for mode in ("bilinear", "weighted", "vjp"):
        for a, b in zip(out["gpu", mode], out["cpu", mode]):
            scale = np.abs(b).max()
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale)
    return {k.replace("gpu_", "matmul_").replace("cpu_", "scatter_"): v
            for k, v in times.items()}


def phase_flagship(intensity=1 << 22, num_iter=16):
    """The flagship chain through ``raytrace`` at throughput size; the two
    binning routes on one iteration's rays."""
    import jax

    import xicsrt_tpu
    from __graft_entry__ import _spectrometer_config
    from xicsrt_tpu.engine import Pipeline

    config = _spectrometer_config(intensity, num_iter=num_iter)
    t0 = time.perf_counter()
    result = xicsrt_tpu.raytrace(config)
    wall = time.perf_counter() - t0
    _assert_exact_accounting(result, intensity * num_iter)
    meta = result["total"]["meta"]
    assert meta["detector"]["num_out"] > 0

    items = _hits_of_one_iteration(Pipeline(config), jax.random.key(1))
    times = binning_routes(items)
    timing = ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in times.items())
    return (f"{intensity * num_iter} rays generated exactly; image sums == "
            f"counters; efficiency {meta['detector']['num_out'] / (intensity * num_iter):.5f}; "
            f"raytrace wall {wall:.2f} s (with compile). Binning on "
            f"{intensity} rays: matmul == scatter (nearest exact; "
            f"bilinear, weighted, VJP rtol 1e-5). Information, not a "
            f"claim: {timing}")


def phase_families(intensity=100_000, num_iter=10, names=tuple(FAMILIES)):
    import xicsrt_tpu

    lines = []
    for name in names:
        config = example01_config(intensity, num_iter, **FAMILIES[name])
        config["general"].update(random_seed=11, keep_history=False)
        result = xicsrt_tpu.raytrace(config)
        lines.append(compare_with_golden(name, result, _golden(name)))
    return f"{intensity * num_iter:.3g} rays each; " + "; ".join(lines)


def phase_plasma(intensity=1 << 22, num_iter=4, bundle_count=100_000):
    """A plasma -> toroidal crystal -> detector run whose expected photon
    count is ``intensity * num_iter``."""
    import xicsrt_tpu
    from tools.bench_scenarios import _plasma_config

    config = _plasma_config(intensity, num_iter, bundle_count=bundle_count)
    result = xicsrt_tpu.raytrace(config)
    _assert_exact_accounting(result)
    n_gen = result["total"]["meta"]["plasma"]["num_out"]
    expected = float(intensity * num_iter)
    assert abs(n_gen - expected) < 6 * np.sqrt(expected), (n_gen, expected)
    assert result["total"]["meta"]["detector"]["num_out"] > 0
    return (f"{bundle_count} bundles, {n_gen} photons generated vs "
            f"{expected:.0f} expected (6 sigma = {6 * np.sqrt(expected):.0f})"
            f"; image sums == counters")


def _efficiency_grad(config, intensity, keys, platform=None):
    """Per-key d(efficiency)/d(crystal origin y) and central differences
    through ``make_differentiable``."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from xicsrt_tpu.gradients import make_differentiable

    image_fn, pipeline = make_differentiable(config, platform=platform)
    params = pipeline.params
    frame0 = params["optics"]["crystal"]["frame"]
    e_y = jnp.asarray([0.0, 1.0, 0.0], dtype=frame0.origin.dtype)

    def efficiency(t, key):
        frame = dataclasses.replace(frame0, origin=frame0.origin + t * e_y)
        p = dict(params)
        p["optics"] = dict(params["optics"])
        p["optics"]["crystal"] = dict(params["optics"]["crystal"])
        p["optics"]["crystal"]["frame"] = frame
        return jnp.sum(image_fn(p, key)["detector"]) / intensity

    zero = jnp.zeros((), frame0.origin.dtype)
    grad_fn = jax.jit(jax.grad(efficiency))
    eff_fn = jax.jit(efficiency)
    grads = np.asarray([float(grad_fn(zero, jax.random.key(k)))
                        for k in keys])
    return grads, eff_fn


def phase_gradients(intensity=1 << 18, n_keys=6):
    """Gradient parity vs the reference's finite difference (f64), route
    agreement (f32, Precision.HIGHEST) and one alignment step."""
    import jax

    from xicsrt_tpu.gradients import align, make_differentiable

    golden = np.load(os.path.join(GOLDEN, "gradient_reference.npz"))
    y0 = float(golden["y0"])
    fwhm = float(golden["rocking_fwhm"])
    delta = float(golden["delta"])
    fd_ref = float(golden["fd_efficiency_mean"])
    fd_ref_std = float(golden["fd_efficiency_std"])

    # (1) matmul route == scatter route on the card, f32, same rays.
    config32 = gradient_config(y0, fwhm, intensity, "float32")
    g_mm, _ = _efficiency_grad(config32, intensity, [0, 1], platform="gpu")
    g_sc, _ = _efficiency_grad(config32, intensity, [0, 1], platform="cpu")
    np.testing.assert_allclose(g_mm, g_sc, rtol=1e-4)

    # (2) one align step returns finite parameters.
    image_fn, pipeline = make_differentiable(config32)
    target = image_fn(pipeline.params, jax.random.key(3))
    final, losses = align(
        config32, {"detector": np.asarray(target["detector"])},
        optimize_paths=[("optics", "crystal", "crystal_spacing")],
        steps=1, learning_rate=1e-5, seed=4)
    spacing = float(final["optics"]["crystal"]["crystal_spacing"])
    assert np.isfinite(spacing) and np.all(np.isfinite(losses)), (
        spacing, losses)

    # (3) f64 parity with the reference's central difference (the criteria
    # of tests/test_gradient_parity.py).
    config64 = gradient_config(y0, fwhm, intensity, "float64")
    keys = list(range(n_keys))
    grads, eff_fn = _efficiency_grad(config64, intensity, keys)
    fds = np.asarray([
        float((eff_fn(delta, jax.random.key(k))
               - eff_fn(-delta, jax.random.key(k))) / (2 * delta))
        for k in keys])
    g, g_sigma = grads.mean(), grads.std(ddof=1) / np.sqrt(len(grads))
    fd, fd_sigma = fds.mean(), fds.std(ddof=1) / np.sqrt(len(fds))
    assert abs(g) > 10 * g_sigma, (g, g_sigma)
    combined = np.sqrt(fd_sigma**2 + fd_ref_std**2)
    assert abs(fd - fd_ref) < 5 * combined, (fd, fd_sigma, fd_ref, fd_ref_std)
    assert abs(g - fd) < 0.03 * abs(fd) + 5 * np.sqrt(
        g_sigma**2 + fd_sigma**2), (g, fd)
    return (f"f32 d(eff)/dy matmul {g_mm[0]:.6g} vs scatter {g_sc[0]:.6g} "
            f"(rtol 1e-4); align step spacing {spacing:.6f}; f64 jax.grad "
            f"{g:.2f}+-{g_sigma:.2f}, jax FD {fd:.2f}+-{fd_sigma:.2f}, "
            f"reference FD {fd_ref:.2f}+-{fd_ref_std:.2f} (5 combined "
            f"sigma; grad vs FD 3% + 5 sigma)")


def phase_float64(intensity=1 << 20):
    """The flagship in float64 vs float32: efficiencies within 5 sigma."""
    import xicsrt_tpu
    from __graft_entry__ import _spectrometer_config

    effs = {}
    for seed, dtype in ((21, "float32"), (22, "float64")):
        config = _spectrometer_config(intensity, random_seed=seed,
                                      dtype=dtype)
        result = xicsrt_tpu.raytrace(config)
        _assert_exact_accounting(result, intensity)
        effs[dtype] = result["total"]["meta"]["detector"]["num_out"] / intensity
    p = 0.5 * (effs["float32"] + effs["float64"])
    sigma = np.sqrt(2 * p * (1 - p) / intensity)
    assert abs(effs["float64"] - effs["float32"]) < 5 * sigma, (effs, sigma)
    return (f"{intensity} rays each: efficiency f64 {effs['float64']:.5f} vs "
            f"f32 {effs['float32']:.5f} (5 sigma = {5 * sigma:.2g})")


def phase_four_cards(intensity=1 << 22, num_iter=4, grad_intensity=1 << 20,
                     n_keys=8, n_devices=4):
    """The ray-sharded flagship and gradient over ``n_devices`` cards
    against the same photon budget on one card."""
    import jax
    import jax.numpy as jnp

    import xicsrt_tpu
    from __graft_entry__ import _spectrometer_config
    from xicsrt_tpu.gradients import make_differentiable
    from xicsrt_tpu.parallel import make_sharded_run

    assert len(jax.devices()) >= n_devices, jax.devices()

    # One shard per card: the history rows split evenly over the devices.
    small = _spectrometer_config(64 * n_devices, keep_history=True)
    fn, pipeline, mesh = make_sharded_run(small, n_devices=n_devices)
    hist = fn(pipeline.params, jax.random.key(0))["history"]["detector"]
    shards = hist.origin.addressable_shards
    assert len({s.device for s in shards}) == n_devices, shards
    assert all(s.data.shape[0] == 64 for s in shards), shards

    effs, n_gens = {}, {}
    for n, sharded in ((n_devices, True), (1, False)):
        config = _spectrometer_config(intensity, num_iter=num_iter,
                                      shard_rays=sharded, devices=n,
                                      random_seed=30 + n)
        result = xicsrt_tpu.raytrace(config)
        _assert_exact_accounting(result, intensity * num_iter)
        n_gens[n] = result["total"]["meta"]["source"]["num_out"]
        effs[n] = result["total"]["meta"]["detector"]["num_out"] / n_gens[n]
    p = 0.5 * (effs[1] + effs[n_devices])
    sigma = np.sqrt(p * (1 - p) * (1 / n_gens[1] + 1 / n_gens[n_devices]))
    assert abs(effs[n_devices] - effs[1]) < 5 * sigma, (effs, sigma)

    golden = np.load(os.path.join(GOLDEN, "gradient_reference.npz"))
    config = gradient_config(float(golden["y0"]),
                             float(golden["rocking_fwhm"]),
                             grad_intensity, "float32")
    stats = {}
    for n in (1, n_devices):
        image_fn, pipe = make_differentiable(config, n_devices=n)
        pixel_w = jnp.linspace(0.5, 1.5, int(np.prod(
            pipe.optics[-1].image_shape))).reshape(pipe.optics[-1].image_shape)

        def loss(spacing, key, image_fn=image_fn, pipe=pipe, pixel_w=pixel_w):
            p = dict(pipe.params)
            p["optics"] = dict(p["optics"])
            p["optics"]["crystal"] = dict(p["optics"]["crystal"],
                                          crystal_spacing=spacing)
            return jnp.sum(image_fn(p, key)["detector"] * pixel_w)

        grad_fn = jax.jit(jax.grad(loss))
        d0 = pipe.params["optics"]["crystal"]["crystal_spacing"]
        g = np.asarray([float(grad_fn(d0, jax.random.key(100 + k)))
                        for k in range(n_keys)])
        stats[n] = (g.mean(), g.std(ddof=1) / np.sqrt(n_keys))
    (m1, s1), (m4, s4) = stats[1], stats[n_devices]
    assert abs(m1) > 5 * s1, (m1, s1)
    assert abs(m4 - m1) < 5 * np.sqrt(s1**2 + s4**2), (stats,)
    return (f"one shard per card ({n_devices} devices); {intensity * num_iter} "
            f"rays: efficiency {n_devices} cards {effs[n_devices]:.5f} vs 1 "
            f"card {effs[1]:.5f} (5 sigma = {5 * sigma:.2g}), image sums "
            f"== counters; d(loss)/d(spacing) {n_devices} cards "
            f"{m4:.5g}+-{s4:.2g} vs 1 card {m1:.5g}+-{s1:.2g} "
            f"({n_keys} keys each, 5 combined sigma)")


PHASES = [
    ("1 reference example_01", phase_reference),
    ("2 flagship 2^22 x 16", phase_flagship),
    ("3 surface families", phase_families),
    ("4 plasma 1e5 bundles", phase_plasma),
    ("5 gradients", phase_gradients),
    ("6 float64", phase_float64),
]
FOUR_PHASES = [("four cards", phase_four_cards)]


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

class CompileClock:
    """Sums JAX's tracing, lowering and compile durations (set-up time)."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.seconds = 0.0

    def __call__(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration


def run_phase(name, fn, device, clock):
    """Run one phase and print its line; a failing phase raises."""
    clock.seconds = 0.0
    t0 = time.perf_counter()
    summary = fn()
    wall = time.perf_counter() - t0
    stats = device.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    print(f"[phase {name}] ok: {summary} | set-up {clock.seconds:.1f} s, "
          f"wall {wall:.1f} s, peak_bytes_in_use {peak}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the ray-sharded path on four cards")
    args = parser.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax

    import xicsrt_tpu
    from bench import card_info

    if os.path.dirname(os.path.dirname(
            os.path.abspath(xicsrt_tpu.__file__))) != ROOT:
        raise SystemExit(f"xicsrt_tpu is not this checkout's: "
                         f"{xicsrt_tpu.__file__}")
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"No GPU: JAX found {devices[0].platform!r} "
                         f"devices; this smoke test runs on a GPU only.")
    if args.four and len(devices) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(devices)}.")
    print(f"card (nvidia-smi name, power.limit): {card_info()}", flush=True)
    print(f"jax {jax.__version__}: {len(devices)} x "
          f"{devices[0].device_kind}", flush=True)

    clock = CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock)
    try:
        for name, fn in (FOUR_PHASES if args.four else PHASES):
            run_phase(name, fn, devices[0], clock)
    finally:
        jax.monitoring.unregister_event_duration_listener(clock)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))


if __name__ == "__main__":
    main()
