"""Config system: defaults, recursive merge, strict checking.

The nested-dict config *is* the public API contract of the reference
(``xicsrt/xicsrt_config.py``), so the semantics are preserved: sections
``general/sources/optics/filters/scenario``, elements keyed by user-chosen
name with a ``class_name``, recursive merge with strict unknown-key
detection, and class-defined defaults chained through inheritance.

Execution options added under ``general``:

- ``dtype``: 'float32' (default) or 'float64' for validation runs;
- ``interact_mode``: 'mc' (reference Monte-Carlo acceptance semantics) or
  'weight' (probability-weighted, lower variance, differentiable);
- ``devices``: number of devices to shard the ray axis over (None = all
  local devices when sharding is enabled);
- ``shard_rays``: shard the ray batch over the device mesh (replaces the
  reference's multiprocessing-over-runs, ``xicsrt_multiprocessing.py:37-62``).
"""

from __future__ import annotations

import copy

import numpy as np

from xicsrt_tpu._version import __version__


def default_config() -> dict:
    """Top-level defaults. Mirrors ``xicsrt_config.default_config`` (:29-205)
    minus host-multiprocessing options, plus the execution options."""
    config: dict = {}
    g: dict = {}
    config["general"] = g

    g["version"] = __version__
    g["number_of_iter"] = 1
    g["number_of_runs"] = 1
    g["random_seed"] = None
    g["pathlist"] = []
    g["strict_config_check"] = True

    g["output_path"] = None
    g["output_prefix"] = "xicsrt"
    g["output_suffix"] = None
    g["output_run_suffix"] = None
    g["image_ext"] = ".tif"
    g["results_ext"] = ".hdf5"
    g["config_ext"] = ".json"
    g["make_directories"] = False

    g["keep_meta"] = True
    g["keep_images"] = True
    g["keep_history"] = True
    g["history_max_lost"] = 10000

    g["save_config"] = False
    g["save_images"] = False
    g["save_results"] = False
    g["print_results"] = True

    # --- execution options (new in xicsrt_tpu) ---
    g["dtype"] = "float32"
    g["interact_mode"] = "mc"
    g["image_mode"] = "nearest"
    # Operand dtype of the binning matrix product ('float32'/'bfloat16'/
    # None = ray dtype); bfloat16 is exact for unit ray weights.
    g["binning_dtype"] = None
    g["devices"] = None
    g["shard_rays"] = False
    # Directory for a jax.profiler device trace of the run loop (None = off).
    g["profile_dir"] = None
    g["block_iterations"] = True  # run all iterations inside one jit via scan

    config["sources"] = {}
    config["optics"] = {}
    config["filters"] = {}
    config["scenario"] = {}
    return config


# Options of the removed Pallas engines. A config that still sets one is
# rejected rather than silently run on another engine.
_REMOVED_GENERAL = {
    "engine": "the 'fused'/'auto' Pallas engine",
    "binning": "the 'pallas' binning kernel",
    "history_found_slots": "the fused engine's 'found' history reservoir",
}
_REMOVED_SOURCE = {"bundle_gather": "the 'matmul' plasma bundle gather"}


def check_removed_options(config_user: dict | None) -> None:
    """Raise ``ValueError`` for options whose implementation was removed.

    The XLA engine is the only engine: every config runs on it, with the
    binning and the plasma bundle gather chosen from the platform.
    """
    if not config_user:
        return
    general = config_user.get("general") or {}
    for key, what in _REMOVED_GENERAL.items():
        if key in general:
            raise ValueError(
                f"general.{key} selected {what}, which was removed; the XLA "
                f"engine runs every config. Delete the option."
            )
    if isinstance(general.get("keep_history"), str):
        raise ValueError(
            f"keep_history={general['keep_history']!r} selected a bounded "
            f"history reservoir of the removed fused engine; use True (full "
            f"per-ray history) or False."
        )
    for name, source in (config_user.get("sources") or {}).items():
        for key, what in _REMOVED_SOURCE.items():
            if key in source:
                raise ValueError(
                    f'Source "{name}": {key} selected {what}, which was '
                    f"removed; bundle attributes are always gathered by "
                    f"index. Delete the option."
                )


def get_config(config_user: dict | None = None) -> dict:
    check_removed_options(config_user)
    config = default_config()
    update_config(config, config_user, strict=False, update=True)
    return config


def refresh_config(config_new: dict) -> dict:
    """Re-default machine-specific entries of a config loaded from another
    system (mirrors ``xicsrt_config.refresh_config`` :215-245)."""
    config_new = copy.deepcopy(config_new)
    # Drop any stale host-specific path lists from reference-era configs.
    config_new.get("general", {}).pop("pathlist_default", None)
    config = default_config()
    update_config(config, config_new, strict=False, update=True, ignore_none=True)
    return config


def update_config(config, config_new, strict=None, update=None, ignore_none=None):
    """Recursive merge of ``config_new`` into ``config``.

    Semantics identical to the reference (``xicsrt_config.py:294-364``):

    - ``strict`` (True): raise on unknown keys;
    - ``update`` (False): retain unknown keys when not strict;
    - ``ignore_none`` (False): skip None values in ``config_new``.
    """
    _update_config_dict(config, config_new, strict, update, ignore_none)
    return config


def _update_config_dict(config, config_new, strict, update, ignore_none):
    if strict is None:
        strict = True
    if update is None:
        update = False
    if ignore_none is None:
        ignore_none = False
    if config_new is None:
        return
    for key in config_new:
        if key not in config:
            if strict:
                raise KeyError(f"User option not recognized: {key}")
            if update:
                config[key] = config_new[key]
        else:
            if isinstance(config[key], dict) and isinstance(config_new[key], dict):
                _update_config_dict(
                    config[key], config_new[key], strict, update, ignore_none
                )
            else:
                if ignore_none and config_new[key] is None:
                    continue
                config[key] = config_new[key]


def config_to_numpy(obj):
    """Recursively convert lists of numbers to numpy arrays, in place."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if isinstance(v, (dict,)):
                config_to_numpy(v)
            elif isinstance(v, (list, tuple)) and _is_numeric_seq(v):
                obj[k] = np.asarray(v)
    return obj


def config_from_numpy(obj):
    """Recursively convert numpy types to plain python, in place (for json)."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if isinstance(v, dict):
                config_from_numpy(v)
            elif isinstance(v, np.ndarray):
                obj[k] = v.tolist()
            elif isinstance(v, np.generic):
                obj[k] = v.item()
            elif isinstance(v, (list, tuple)):
                obj[k] = [
                    config_from_numpy(i)
                    if isinstance(i, dict)
                    else (i.tolist() if isinstance(i, np.ndarray) else i)
                    for i in v
                ]
    return obj


def _is_numeric_seq(v) -> bool:
    try:
        arr = np.asarray(v)
    except Exception:
        return False
    return arr.dtype.kind in "fiub"
