"""xicsrt_tpu: a differentiable Monte-Carlo x-ray raytracing framework on
JAX/XLA.

Provides the capabilities of PrincetonUniversity/xicsrt — photon-accurate
plasma sources, Bragg-crystal optics, aperture/filter chains, detector
images — redesigned for accelerators: rays are fixed-shape sharded arrays,
the optic chain compiles to one fused XLA program, randomness is stateless
key folding, and multi-device scaling uses `jax.sharding` collectives
instead of multiprocessing.
"""

from xicsrt_tpu._version import __version__  # noqa: F401

import os as _os

import jax as _jax


def compile_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives.

    ``$JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself), else the
    fixed directory ``.jax_cache`` beside the package in the checkout. The
    path is part of the cache's key, so it never depends on a temp name,
    the process or the time.
    """
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )


# Persistent XLA compilation cache: identical pipelines across processes skip
# compilation entirely. A directory the caller configured in code stays.
if (not _os.environ.get("JAX_COMPILATION_CACHE_DIR")
        and _jax.config.jax_compilation_cache_dir is None):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)

# Importing the element packages populates the class registry.
import xicsrt_tpu.filters  # noqa: E402,F401
import xicsrt_tpu.optics  # noqa: E402,F401
import xicsrt_tpu.sources  # noqa: E402,F401
from xicsrt_tpu.engine import combine_raytrace, raytrace, raytrace_single  # noqa: F401
from xicsrt_tpu.gradients import align, make_differentiable  # noqa: F401
from xicsrt_tpu.public import get_element  # noqa: F401
from xicsrt_tpu.utils.version import warn_version  # noqa: F401

# The reference exposes a separate multiprocessing entry point
# (``xicsrt.raytrace_mp(config, processes=None)``,
# ``xicsrt_multiprocessing.py:12``). Here one entry point covers 1..N devices:
# ``processes`` maps to the device count of the ray-sharded mesh.
def raytrace_mp(config, processes=None):
    """Drop-in equivalent of the reference's multiprocess raytrace.

    Runs the ray-sharded engine over ``processes`` devices (default: all).
    With one device this is identical to :func:`raytrace`.
    """
    import copy

    n = processes if processes is not None else len(_jax.devices())
    n = min(int(n), len(_jax.devices()))
    if n > 1:
        config = copy.deepcopy(config)
        general = config.setdefault("general", {})
        general["shard_rays"] = True
        general["devices"] = n
    return raytrace(config)
