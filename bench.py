"""Benchmark: rays/s of the XLA engine on the example_02-class spectrometer,
one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...}. The line names the platform, device kind and device count as JAX
reports them, and the card's name and power limit as ``nvidia-smi`` reports
them. Without a GPU the benchmark fails; it never falls back to the CPU.

Baseline: the CPU reference (PrincetonUniversity/xicsrt v0.8.13) measured at
7.7e5 rays/s on the example_02 aperture+detector scenario (BASELINE.md); the
richer spectrometer benched here (source -> aperture -> Bragg crystal ->
detector) is strictly more work per ray, so vs_baseline is conservative.

Self-verification:

1. every timed dispatch consumes a scalar produced by the previous dispatch
   (folded into its RNG key), so execution is serialized by a true data
   dependency — wall time is the sum of execution times;
2. outputs are verified inside the benchmark: generated counts must equal
   the static ray budget exactly, detector image sums must equal the meta
   counters exactly (mc mode, unit weights), and per-dispatch detected
   counts must agree within a Poisson band;
3. the FLOP/s that the binning matrix product alone implies (2 * nx * ny
   multiply-adds per ray and image) is ASSERTED below the card's published
   peak for the operand precision the binning runs at; the reported
   ``binning_peak_share`` makes the plausibility auditable.

Environment: XICSRT_BENCH_LOG2 (rays per iteration, default 22),
XICSRT_BENCH_ITER (iterations per dispatch, default 16), XICSRT_BENCH_REPS,
XICSRT_BENCH_BLOCKS, XICSRT_BENCH_BINNING_DTYPE ('float32'/'bfloat16').
"""

import json
import os
import subprocess
import time

import numpy as np

BASELINE_RAYS_PER_S = 7.7e5  # CPU reference example_02 (BASELINE.md)

# Published dense peaks, keyed by JAX's device_kind. Source: NVIDIA H100 SXM
# data sheet, rates without sparsity, at the full 700 W power limit. float32
# is the rate outside the tensor cores: the binning product runs there under
# Precision.HIGHEST.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bfloat16": 989e12,
        "tf32": 495e12,
        "float32": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak_flops(device_kind: str, op_dtype: str) -> float:
    """Published peak FLOP/s of ``device_kind`` for operands of
    ``op_dtype``. A device or dtype missing from ``PEAKS`` is an error."""
    if device_kind not in PEAKS:
        raise KeyError(
            f"No published peaks for device {device_kind!r}; add it to "
            f"bench.PEAKS with its source."
        )
    peaks = PEAKS[device_kind]
    if op_dtype not in peaks:
        raise KeyError(f"No {op_dtype} peak for {device_kind!r}.")
    return peaks[op_dtype]


def card_info() -> str:
    """``name, power.limit`` of the first card, from ``nvidia-smi`` run in a
    child process (which stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def gpu_device():
    """The first JAX device; raises when it is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"No GPU: JAX found {dev.platform!r} devices. This measurement "
            f"runs on a GPU only."
        )
    return dev


def build(intensity, num_iter, **general):
    from __graft_entry__ import _spectrometer_config
    from xicsrt_tpu.engine import Pipeline

    config = _spectrometer_config(
        intensity=intensity, num_iter=num_iter, keep_images=True, **general
    )
    pipeline = Pipeline(config)
    run = pipeline.make_run(num_iter, keep_history=False, keep_images=True)
    mpr = sum(nx * ny for (nx, ny), _ in pipeline.image_specs().values())
    return pipeline, run, mpr


def main():
    import jax
    import jax.numpy as jnp

    dev = gpu_device()
    card = card_info()
    intensity = 1 << int(os.environ.get("XICSRT_BENCH_LOG2", "22"))
    num_iter = int(os.environ.get("XICSRT_BENCH_ITER", "16"))
    reps = int(os.environ.get("XICSRT_BENCH_REPS", "3"))
    blocks = int(os.environ.get("XICSRT_BENCH_BLOCKS", "3"))
    general = {}
    if os.environ.get("XICSRT_BENCH_BINNING_DTYPE"):
        general["binning_dtype"] = os.environ["XICSRT_BENCH_BINNING_DTYPE"]

    pipeline, run, mpr = build(intensity, num_iter, **general)
    op_dtype = jnp.dtype(
        general.get("binning_dtype") or pipeline.source.dtype
    ).name
    peak = peak_flops(dev.device_kind, op_dtype)
    rays_per_dispatch = intensity * num_iter

    def step(params, key, dep):
        # Fold the previous dispatch's detector count into this dispatch's
        # key: a true data dependency, so dispatches cannot overlap.
        out = run(params, jax.random.fold_in(key, dep))
        return out["image"], out["meta"], out["meta"]["detector"].astype(jnp.uint32)

    jitted = jax.jit(step)
    key = jax.random.key(0)
    dep0 = jnp.uint32(0)

    # Warmup: compile and absorb first-execution costs outside the timed
    # region. Verify the static ray budget while we're at it.
    params = pipeline.params
    for w in range(3):
        images, meta, dep0 = jitted(
            params, jax.random.fold_in(key, 1000 + w), dep0
        )
    n_gen = np.asarray(meta["source"]).item()
    assert n_gen == rays_per_dispatch, (n_gen, rays_per_dispatch)

    # Timed blocks: each block chains `reps` dispatches through the data
    # dependency and blocks once at the end. Best of blocks.
    block_results = []
    for block in range(blocks):
        dep = dep0
        t0 = time.perf_counter()
        for r in range(reps):
            images, meta, dep = jitted(
                params, jax.random.fold_in(key, block * reps + r), dep
            )
        jax.block_until_ready(dep)
        dt = time.perf_counter() - t0
        block_results.append((dt, images, meta))

    # ---- verification (after timing; transfers are off-clock) ----------
    detected = []
    for dt, images, meta in block_results:
        meta_h = {k: np.asarray(v).item() for k, v in meta.items()}
        assert meta_h["source"] == rays_per_dispatch, meta_h
        det_sum = float(np.asarray(images["detector"]).sum())
        crys_sum = float(np.asarray(images["crystal"]).sum())
        # mc mode, unit weights: every ray alive at an optic is in-bounds,
        # so the image integral equals the meta counter exactly.
        assert abs(det_sum - meta_h["detector"]) <= 1e-6 * max(det_sum, 1), (
            det_sum, meta_h["detector"])
        assert abs(crys_sum - meta_h["crystal"]) <= 1e-6 * max(crys_sum, 1), (
            crys_sum, meta_h["crystal"])
        assert meta_h["detector"] > 0, "no rays reached the detector"
        detected.append(meta_h["detector"])
    # Independent dispatches of the same physics: detected counts must sit
    # in a Poisson band around their mean.
    mean_det = float(np.mean(detected))
    for d in detected:
        assert abs(d - mean_det) < 8.0 * np.sqrt(mean_det) + 1.0, (
            detected, "detected counts inconsistent across blocks")

    best_dt = min(dt for dt, _, _ in block_results)
    total_rays = rays_per_dispatch * reps
    rays_per_s = total_rays / best_dt

    # ---- plausibility: implied binning FLOP/s must fit on the card -------
    implied_flops = 2.0 * mpr * rays_per_s
    share = implied_flops / peak
    assert share <= 1.0, (
        f"Implied {implied_flops:.3e} FLOP/s exceeds the {peak:.3e} "
        f"{op_dtype} peak of {dev.device_kind} — the measurement is not "
        f"physical."
    )

    result = {
        "metric": "rays_per_second_example02_spectrometer",
        "value": rays_per_s,
        "unit": "rays/s",
        "vs_baseline": rays_per_s / BASELINE_RAYS_PER_S,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
            "card": card,
        },
        "rays_per_dispatch": rays_per_dispatch,
        "binning_op_dtype": op_dtype,
        "binning_macs_per_ray": mpr,
        "binning_peak_share": share,
        "detector_efficiency": mean_det / rays_per_dispatch,
        "verified": True,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
