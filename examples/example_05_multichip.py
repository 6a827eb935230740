# -*- coding: utf-8 -*-
"""
Example 05: sharding rays over a device mesh.

One flag shards the ray batch across every local device; detector images
and counters psum-reduce over the interconnect. With a single device the
same config runs unsharded. To try the mesh on a CPU, start Python with
``XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu``.
"""

import jax
import numpy as np

import xicsrt_tpu

config = {
    "general": {
        "number_of_iter": 2,
        "random_seed": 0,
        "shard_rays": True,       # <- the only change vs a one-device run
    },
    "sources": {
        "source": {
            "class_name": "XicsrtSourceDirected",
            "intensity": 80000,
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

results = xicsrt_tpu.raytrace(config)
print(f"devices used: {len(jax.devices())}")
