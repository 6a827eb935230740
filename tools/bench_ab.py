"""A/B benchmark of execution variants of the XLA engine on one GPU.

Times the full example_02 spectrometer run (same harness as bench.py:
data-dependency-serialized dispatches, verified outputs) across binning
operand dtypes and with images off, and prints one JSON line per variant
naming the device. Fails without a GPU.

Usage: timeout 590 python tools/bench_ab.py [log2_intensity] [num_iter]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


VARIANTS = {
    "xla_f32": {},
    "xla_bf16": {"binning_dtype": "bfloat16"},
    "no_images": {"keep_images": False},
}


def time_variant(name, general, intensity, num_iter, reps=3, blocks=2):
    import jax
    import jax.numpy as jnp

    from bench import build, gpu_device

    dev = gpu_device()
    keep_images = general.pop("keep_images", True)
    pipeline, run, _ = build(intensity, num_iter, **general)
    if not keep_images:
        run = pipeline.make_run(num_iter, keep_history=False,
                                keep_images=False)

    def step(params, key, dep):
        out = run(params, jax.random.fold_in(key, dep))
        return out["meta"], out["meta"]["detector"].astype(jnp.uint32)

    jitted = jax.jit(step)
    key = jax.random.key(0)
    dep = jnp.uint32(0)
    params = pipeline.params
    for w in range(3):
        meta, dep = jitted(params, jax.random.fold_in(key, 1000 + w), dep)
    n_gen = np.asarray(meta["source"]).item()
    assert n_gen == intensity * num_iter

    best = float("inf")
    for block in range(blocks):
        d = dep
        t0 = time.perf_counter()
        for r in range(reps):
            meta, d = jitted(params, jax.random.fold_in(key, block * reps + r), d)
        jax.block_until_ready(d)
        best = min(best, time.perf_counter() - t0)
    rays_per_s = intensity * num_iter * reps / best
    n_det = np.asarray(meta["detector"]).item()
    return {
        "variant": name,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "rays_per_s": rays_per_s,
        "detected": n_det,
        "eff": float(f"{n_det / (intensity * num_iter):.4g}"),
    }


def main():
    log2 = int(sys.argv[1]) if len(sys.argv) > 1 else 25
    num_iter = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    intensity = 1 << log2
    for name, general in VARIANTS.items():
        try:
            res = time_variant(name, dict(general), intensity, num_iter)
        except Exception as err:  # keep going: one broken variant != no data
            res = {"variant": name, "error": f"{type(err).__name__}: {err}"}
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
