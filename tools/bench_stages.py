"""Stage-bisection benchmark: which part of the pipeline costs the time?

Times source-only, +aperture, +crystal, and the full chain, plus PRNG
implementation variants, on one GPU. One JSON line per variant, naming the
device. Fails without a GPU.

Usage: timeout 590 python tools/bench_stages.py [log2_intensity] [num_iter]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def time_run(pipeline, run, intensity, num_iter, reps=3, blocks=2):
    import jax
    import jax.numpy as jnp

    last = pipeline.element_names[-1]

    def step(params, key, dep):
        out = run(params, jax.random.fold_in(key, dep))
        return out["meta"], out["meta"][last].astype(jnp.uint32)

    jitted = jax.jit(step)
    key = jax.random.key(0)
    dep = jnp.uint32(0)
    params = pipeline.params
    for w in range(3):
        meta, dep = jitted(params, jax.random.fold_in(key, 1000 + w), dep)
    assert np.asarray(meta["source"]).item() == intensity * num_iter

    best = float("inf")
    for block in range(blocks):
        d = dep
        t0 = time.perf_counter()
        for r in range(reps):
            meta, d = jitted(params, jax.random.fold_in(key, block * reps + r), d)
        jax.block_until_ready(d)
        best = min(best, time.perf_counter() - t0)
    return intensity * num_iter * reps / best


def main():
    import jax

    from __graft_entry__ import _spectrometer_config
    from bench import gpu_device
    from xicsrt_tpu.engine import Pipeline

    dev = gpu_device()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log2 = int(sys.argv[1]) if len(sys.argv) > 1 else 25
    num_iter = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    intensity = 1 << log2

    def build(drop=(), **general):
        config = _spectrometer_config(intensity=intensity, num_iter=num_iter,
                                      keep_images=True, **general)
        for name in drop:
            del config["optics"][name]
        pipeline = Pipeline(config)
        run = pipeline.make_run(num_iter, keep_history=False, keep_images=True)
        return pipeline, run

    variants = {
        "source_only": {"drop": ("aperture", "crystal", "detector")},
        "plus_aperture": {"drop": ("crystal", "detector")},
        "plus_crystal": {"drop": ("detector",)},
        "full": {},
    }
    for name, kw in variants.items():
        pipeline, run = build(**kw)
        rps = time_run(pipeline, run, intensity, num_iter)
        print(json.dumps({"variant": name, "device": device,
                          "rays_per_s": rps}), flush=True)

    # PRNG implementation: threefry (default, splittable, slow) vs rbg
    # (hardware RngBitGenerator).
    jax.config.update("jax_default_prng_impl", "rbg")
    pipeline, run = build()
    rps = time_run(pipeline, run, intensity, num_iter)
    print(json.dumps({"variant": "full_rbg_prng", "device": device,
                      "rays_per_s": rps}), flush=True)


if __name__ == "__main__":
    main()
