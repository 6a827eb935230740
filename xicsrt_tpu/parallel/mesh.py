"""Sharded raytracing over a JAX device mesh.

Replaces the reference's process-pool data parallelism
(``xicsrt/xicsrt_multiprocessing.py:37-62``: fork per run, pickle results
back) and its slurm-array multi-node recipe with one in-program mechanism:

- the ray batch axis is sharded over a 1-D ``rays`` mesh via ``shard_map``;
- every device folds its mesh position into the RNG key, so the sharded run
  draws *different* rays per device while remaining reproducible;
- detector images and meta counters are ``psum``-reduced across the mesh
  (NCCL over NVLink between the cards of one host) — the in-program
  equivalent of ``combine_raytrace``'s image/meta sums
  (``xicsrt_raytrace.py:327-354``);
- ray history (the only gather-shaped output) stays device-sharded on axis 0
  and materializes as a global array only if the host reads it.

Multi-host: initialize ``jax.distributed`` before building the mesh and pass
the global device list; the same code then spans hosts.
"""

from __future__ import annotations

import logging

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from xicsrt_tpu.engine import Pipeline

log = logging.getLogger("xicsrt_tpu")


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> dict:
    """Initialize the multi-host distributed runtime (idempotent).

    Thin wrapper over ``jax.distributed.initialize``. Pass the coordinator
    address (``host:port``), the process count and this process's id; only
    cluster managers that JAX recognises supply them from the environment.
    After this, ``ray_mesh()`` spans all *global* devices and the engine's
    psum reductions run as NCCL collectives: over NVLink between the cards
    of one host, over the network between hosts — replacing the
    reference's slurm-array + offline-merge recipe
    (``doc_source/userguide/multiple_processors.rst:27-78``).

    Returns ``{"process_index", "process_count", "num_devices",
    "is_primary"}`` for rank-gated work (e.g., saving results).
    """
    explicit = coordinator_address is not None or num_processes is not None
    # NB: probing via jax.process_count() would itself initialize the XLA
    # backend, after which jax.distributed.initialize refuses to run.
    if not jax.distributed.is_initialized():
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        except (ValueError, RuntimeError):
            if explicit:
                # The caller asked for a specific multi-host topology; a
                # silent fallback would run N independent single-process
                # jobs that all believe they are primary (every host would
                # save results). Fail loudly instead.
                raise
            # Auto-detect path: single-process / already-initialized
            # environments are fine; the mesh covers local devices only.
            pass
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "num_devices": len(jax.devices()),
        "is_primary": jax.process_index() == 0,
    }


def ray_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the ray axis, one shard per device.

    The cards of one host are joined all to all, so the mesh follows the
    ray split alone and needs no topology-shaped device order."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("rays",))


def _shard_intensity(config: dict, n_devices: int) -> dict:
    """Divide the photon load across devices, preserving totals.

    Sets ``intensity_scale = 1/n_devices`` on every source; each source
    class applies it to its own rate (generic: Poisson rate or ray count;
    plasma: per-bundle expected photon count lambda — see
    ``sources/plasma.py``). Poisson rates split into independent Poissons,
    so the psum-reduced totals have exactly the single-device photon
    statistics — the equivalent of the reference dividing runs across
    processes (``xicsrt_multiprocessing.py:48-56``).

    Non-Poisson counted sources additionally pre-divide ``intensity`` to an
    integer per-device count (remainder dropped with a warning), so exact
    generated totals stay a multiple of the mesh size.
    """
    import copy

    config = copy.deepcopy(config)
    for name, source_config in config.get("sources", {}).items():
        prior = float(source_config.get("intensity_scale", 1.0))
        intensity = source_config.get("intensity")
        use_poisson = source_config.get("use_poisson")
        if use_poisson is None:
            # Plasma sources default use_poisson=True and derive counts from
            # physics, not `intensity`; only explicit non-Poisson counted
            # sources need the integer pre-division below.
            use_poisson = "Plasma" in str(source_config.get("class_name", ""))
        if not use_poisson and intensity is not None:
            intensity = float(intensity)
            per_device = int(intensity * prior) // n_devices
            if per_device < 1:
                raise ValueError(
                    f'Source "{name}": non-Poisson intensity {intensity:g} '
                    f"is below the {n_devices}-device mesh size; raise the "
                    f"intensity or set use_poisson=True."
                )
            if per_device * n_devices != int(intensity * prior):
                log.warning(
                    'Source "%s": intensity %g is not a multiple of the '
                    "%d-device mesh; sharded total is %d rays.",
                    name, intensity, n_devices, per_device * n_devices,
                )
            source_config["intensity"] = per_device
            source_config["intensity_scale"] = 1.0
        else:
            source_config["intensity_scale"] = prior / n_devices
    return config


def make_sharded_run(config: dict, num_iter: int | None = None,
                     mesh: Mesh | None = None, n_devices: int | None = None,
                     keep_history: bool | None = None,
                     keep_images: bool | None = None):
    """Compile a full multi-iteration run sharded over the ray axis.

    Returns ``(jitted_fn, pipeline, mesh)`` where ``jitted_fn(params, key)``
    produces the same output pytree as ``Pipeline.make_run`` but with rays
    split across devices: meta/image are globally reduced, history arrays are
    sharded on axis 0.
    """
    if mesh is None:
        mesh = ray_mesh(n_devices)
    ndev = mesh.devices.size

    sharded_config = _shard_intensity(config, ndev)
    pipeline = Pipeline(sharded_config)
    g = pipeline.general
    if num_iter is None:
        num_iter = int(g["number_of_iter"])
    if keep_history is None:
        keep_history = bool(g["keep_history"])

    run_fn = pipeline.make_run(num_iter, keep_history=keep_history,
                               keep_images=keep_images)

    def device_run(params, key):
        idx = jax.lax.axis_index("rays")
        out = run_fn(params, jax.random.fold_in(key, idx))
        meta = {k: jax.lax.psum(v, "rays") for k, v in out["meta"].items()}
        image = {k: jax.lax.psum(v, "rays") for k, v in out["image"].items()}
        return {"meta": meta, "image": image, "history": out["history"]}

    # Output specs: reductions are replicated; history shards on the ray axis.
    meta_spec = (
        {k: P() for k in pipeline.element_names}
        if g.get("keep_meta", True) else {}
    )
    image_names = list(pipeline.image_specs().keys())
    use_images = g["keep_images"] if keep_images is None else keep_images
    image_spec = {k: P() for k in image_names} if use_images else {}
    if keep_history:
        history_spec = {
            k: pipeline_history_struct() for k in pipeline.element_names
        }
    else:
        history_spec = {}
    out_specs = {"meta": meta_spec, "image": image_spec, "history": history_spec}

    fn = shard_map(
        device_run,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn), pipeline, mesh


def pipeline_history_struct():
    """PartitionSpec template for a Rays pytree (5 leaves, axis-0 sharded)."""
    from xicsrt_tpu.rays import Rays

    return Rays(
        origin=P("rays"),
        direction=P("rays"),
        wavelength=P("rays"),
        weight=P("rays"),
        mask=P("rays"),
    )


def scaling_efficiency(throughputs: dict) -> dict:
    """Helper: compute scaling efficiency vs the 1-device throughput."""
    base = throughputs.get(1)
    if base is None or base <= 0:
        return {}
    return {n: (tp / (n * base)) for n, tp in throughputs.items()}
