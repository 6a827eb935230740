"""Test configuration: run on a virtual 8-device CPU mesh.

The tests run on the CPU (``JAX_PLATFORMS=cpu``, the default here);
multi-device sharding logic is validated on eight virtual CPU devices.
Tests that need a GPU carry the ``gpu`` marker and skip on the CPU; on a
machine with a card, ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``
runs them there.
"""

import os

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
# Persistent compile cache: repeated identical pipelines across tests and
# test sessions skip XLA compilation. The directory is
# $JAX_COMPILATION_CACHE_DIR when set, else the checkout's .jax_cache
# (xicsrt_tpu.compile_cache_dir, applied when the package is imported).
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
