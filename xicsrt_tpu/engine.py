"""Raytracing engine: config -> compiled pipeline -> results dict.

Replaces the reference engine stack (``xicsrt/xicsrt_raytrace.py`` +
``xicsrt/objects/_Dispatcher.py`` + ``xicsrt/xicsrt_multiprocessing.py``)
with one mechanism:

- the element chain is *compiled once* into a pure, differentiable function
  ``iteration(params, key) -> {meta, image, history}`` (the reference
  re-imports and re-instantiates every element per run,
  ``_Dispatcher.py:97-113``);
- iterations run inside a single jit (``lax.scan`` over per-iteration keys)
  when history is off, so images/meta accumulate on device;
- randomness is a stateless key tree: ``fold_in(root, run) -> fold_in(iter)
  -> split per element`` — supersedes the reference's global
  ``np.random.seed(seed + run)`` scheme (``xicsrt_raytrace.py:60-63,111``);
- multi-run/multi-process scale-out collapses into the sharded engine
  (``xicsrt_tpu.parallel``): rays shard over chips, images/meta psum.

The results dict keeps the reference layout: ``config``, ``total`` (meta +
image), ``found``/``lost`` (per-element ray history).
"""

from __future__ import annotations

import logging
import time

import numpy as np

import jax
import jax.numpy as jnp

from xicsrt_tpu import dispatch
from xicsrt_tpu.config import get_config
from xicsrt_tpu.ops.binning import bin_images_fused
from xicsrt_tpu.rays import Rays
from xicsrt_tpu.utils.profiler import profiler

log = logging.getLogger("xicsrt_tpu")


class Pipeline:
    """A config compiled into pure generate/trace functions + params pytree."""

    def __init__(self, config: dict, platform: str | None = None):
        """``platform``: the JAX platform whose image binning route the
        compiled functions use (``ops.binning.binning_route``); default
        JAX's default backend."""
        self.config = get_config(config)
        self.platform = platform or jax.default_backend()
        general = self.config["general"]
        self.general = general
        if str(general.get("dtype", "float32")).lower() in ("float64", "f64"):
            # Validation mode: f64 requires the global x64 switch.
            jax.config.update("jax_enable_x64", True)

        profiler.start("pipeline_build")
        dispatch.load_plugin_paths(general.get("pathlist"))
        self.filters = dispatch.build_section(self.config, "filters")
        self.sources = dispatch.build_section(self.config, "sources")
        self.optics = dispatch.build_section(self.config, "optics")
        if len(self.sources) != 1:
            # Same restriction as the reference dispatcher
            # (_Dispatcher.py:142-164).
            raise NotImplementedError(
                f"Exactly one source is required ({len(self.sources)} given)."
            )
        self.source = self.sources[0]

        filter_map = {f.name: f for f in self.filters}
        filter_fns = []
        source_filters = self.source.param.get("filters")
        source_filters = [] if source_filters is None else list(source_filters)
        for fname in source_filters:
            if fname not in filter_map:
                raise KeyError(f'Source filter "{fname}" is not defined.')
            filter_fns.append((fname, filter_map[fname].make_filter()))

        self.generate = self.source.make_generate(filter_fns)
        self.optic_traces = [(o.name, o.make_trace()) for o in self.optics]

        self.params = {
            "sources": {self.source.name: self.source.build_params()},
            "optics": {o.name: o.build_params() for o in self.optics},
            "filters": {f.name: f.build_params() for f in self.filters},
        }
        # Element order as configured (jit pytree outputs come back with
        # dict keys sorted, so order must be tracked explicitly).
        self.element_names = [self.source.name] + [o.name for o in self.optics]
        profiler.stop("pipeline_build")

    # ------------------------------------------------------------------
    @property
    def num_rays(self) -> int:
        return self.source.num_rays

    def image_specs(self) -> dict:
        out = {}
        for o in self.optics:
            if o.enable_image:
                out[o.name] = (o.image_shape, float(o.pixel_size))
        return out

    # ------------------------------------------------------------------
    def make_trace(self, keep_history: bool | None = None,
                   keep_images: bool | None = None):
        """Build ``trace(params, key) -> (meta, history, hits)``: one pass
        of source sampling and the optic chain, without image binning.

        ``hits`` maps each imaging optic to ``(x_local, mask, weight)``, the
        inputs of its detector image (see ``image_specs`` for the shape and
        pixel size); it is empty when ``keep_images`` is off.
        """
        g = self.general
        if keep_history is None:
            keep_history = bool(g["keep_history"])
        if keep_images is None:
            keep_images = bool(g["keep_images"])
        source_name = self.source.name
        generate = self.generate
        optic_traces = self.optic_traces
        image_specs = self.image_specs()
        # keep_meta=False drops the per-element counters from the outputs,
        # matching the reference's keep_meta gate (xicsrt_raytrace.py:187-201).
        keep_meta = bool(g.get("keep_meta", True))

        def trace(params, key):
            k_source, k_optics = jax.random.split(key)
            rays = generate(
                params["sources"][source_name], params["filters"], k_source
            )
            meta = {source_name: rays.num_alive()} if keep_meta else {}
            history = {source_name: rays} if keep_history else {}
            hits = {}
            for idx, (name, optic_trace) in enumerate(optic_traces):
                rays, x_local = optic_trace(
                    params["optics"][name], rays, jax.random.fold_in(k_optics, idx)
                )
                if keep_meta:
                    meta[name] = rays.num_alive()
                if keep_history:
                    history[name] = rays
                if keep_images and name in image_specs:
                    hits[name] = (x_local, rays.mask, rays.weight)
            return meta, history, hits

        return trace

    def make_iteration(self, keep_history: bool | None = None,
                       keep_images: bool | None = None):
        """Build ``iteration(params, key) -> dict`` for one trace pass."""
        trace = self.make_trace(keep_history, keep_images)
        image_specs = self.image_specs()
        # 'nearest' reproduces the reference's hard pixel assignment
        # (_TraceObject.py:257-291); 'bilinear' is the differentiable splat.
        # All images accumulate in ONE fused pass over the ray axis
        # (separate chunked scans defeat XLA fusion of the trace pipeline).
        image_mode = str(self.general.get("image_mode", "nearest")).lower()
        binning_dtype = self.general.get("binning_dtype")
        platform = self.platform

        def iteration(params, key):
            meta, history, hits = trace(params, key)
            names = [n for n in image_specs if n in hits]
            items = [
                hits[n] + (*image_specs[n][0], image_specs[n][1])
                for n in names
            ]
            images = dict(zip(names, bin_images_fused(
                items, image_mode, op_dtype=binning_dtype, platform=platform,
            )))
            return {"meta": meta, "image": images, "history": history}

        return iteration

    def make_run(self, num_iter: int, keep_history: bool | None = None,
                 keep_images: bool | None = None, remat: bool = False):
        """Build ``run(params, key) -> dict`` executing ``num_iter``
        iterations inside one jitted scan.

        Without history: images/meta accumulate on device (sum over
        iterations, exactly the reference's image-sum semantics,
        ``xicsrt_raytrace.py:327-354``). With history: per-iteration ray
        states are stacked on the leading axis.

        ``remat=True`` checkpoints each iteration: the backward pass
        recomputes the trace instead of storing per-ray residuals — required
        to differentiate large batches without exhausting HBM.
        """
        iteration = self.make_iteration(keep_history, keep_images)
        if remat:
            iteration = jax.checkpoint(iteration)
        g = self.general
        if keep_history is None:
            keep_history = bool(g["keep_history"])

        def run(params, key):
            keys = jax.random.split(key, num_iter)

            if not keep_history:
                def body(carry, k):
                    out = iteration(params, k)
                    acc = {
                        "meta": {
                            n: carry["meta"][n] + out["meta"][n]
                            for n in out["meta"]
                        },
                        "image": {
                            n: carry["image"][n] + out["image"][n]
                            for n in out["image"]
                        },
                        "history": {},
                    }
                    return acc, None

                first = iteration(params, keys[0])
                if num_iter == 1:
                    return first
                acc, _ = jax.lax.scan(body, first, keys[1:])
                return acc

            # History mode: stack per-iteration outputs.
            outs = [iteration(params, k) for k in keys]
            meta = {
                n: jnp.sum(jnp.stack([o["meta"][n] for o in outs]))
                for n in outs[0]["meta"]
            }
            image = {
                n: sum(o["image"][n] for o in outs) for n in outs[0]["image"]
            }
            history = {
                n: _concat_rays([o["history"][n] for o in outs])
                for n in outs[0]["history"]
            }
            return {"meta": meta, "image": image, "history": history}

        return run


def _concat_rays(bundles):
    return Rays(
        origin=jnp.concatenate([b.origin for b in bundles]),
        direction=jnp.concatenate([b.direction for b in bundles]),
        wavelength=jnp.concatenate([b.wavelength for b in bundles]),
        weight=jnp.concatenate([b.weight for b in bundles]),
        mask=jnp.concatenate([b.mask for b in bundles]),
    )


def _concat_rays_np(bundles):
    """Host-side bundle concatenation (numpy arrays from device_get)."""
    return Rays(
        origin=np.concatenate([np.asarray(b.origin) for b in bundles]),
        direction=np.concatenate([np.asarray(b.direction) for b in bundles]),
        wavelength=np.concatenate([np.asarray(b.wavelength) for b in bundles]),
        weight=np.concatenate([np.asarray(b.weight) for b in bundles]),
        mask=np.concatenate([np.asarray(b.mask) for b in bundles]),
    )


# ---------------------------------------------------------------------------
# Host-side orchestration.
# ---------------------------------------------------------------------------

def _root_key(general: dict):
    seed = general.get("random_seed")
    if seed is None:
        seed = np.random.SeedSequence().entropy % (2**63)
        if jax.process_count() > 1:
            # Seedless multi-host: every process must pass IDENTICAL
            # replicated arguments to the jitted shard_map, but each
            # process drew its own entropy — broadcast process-0's so the
            # global run is consistent (the multi-host analog of the
            # reference's per-run seeding, xicsrt_multiprocessing.py:48-50).
            from jax.experimental import multihost_utils

            words = np.asarray(
                [(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32
            )
            words = np.asarray(multihost_utils.broadcast_one_to_all(words))
            seed = (int(words[0]) << 32) | int(words[1])
    return jax.random.key(int(seed))


def _to_host(arr) -> np.ndarray:
    """Device array -> host numpy, multi-host safe.

    A history array from a multi-host sharded run is a global ``jax.Array``
    whose shards live on other processes' devices; ``np.asarray`` on it
    raises (non-addressable). Materialize the process-LOCAL shards instead,
    concatenated in global axis-0 order — each host then compacts the rays
    it owns (the cross-host merge is ``combine_raytrace`` on saved results,
    as in the reference slurm recipe,
    ``doc_source/userguide/multiple_processors.rst:56-78``).
    """
    if isinstance(arr, jax.Array) and not arr.is_fully_addressable:
        shards = sorted(
            arr.addressable_shards, key=lambda s: s.index[0].start or 0
        )
        return np.concatenate([np.asarray(s.data) for s in shards], axis=0)
    return np.asarray(arr)


def _sort_history(history_dev: dict, names: list, max_lost: int,
                  rng: np.random.Generator) -> tuple:
    """Split device history into found/lost, truncating lost rays.

    Equivalent of ``_sort_raytrace`` (``xicsrt_raytrace.py:229-278``), with
    the additional rule that rays dead at the source (Poisson budget padding)
    are dropped entirely rather than counted as lost.

    ``names`` is the element order as configured (source first, final optic
    last); jit outputs have key-sorted dicts, so order is passed explicitly.

    Multi-host: each process sorts the rays whose shards it owns (see
    ``_to_host``); found/lost histories are per-process, while meta/image
    stay globally reduced.
    """
    if not history_dev:
        return {}, {}
    source_name = names[0]
    last = names[-1]
    final_mask = _to_host(history_dev[last].mask)
    born_mask = _to_host(history_dev[source_name].mask)
    w_found = np.flatnonzero(final_mask)
    w_lost = np.flatnonzero(born_mask & ~final_mask)
    if len(w_lost) > max_lost:
        w_lost = rng.choice(w_lost, size=max_lost, replace=False)

    found, lost = {}, {}
    for name in names:
        r = history_dev[name]
        arrays = {
            "origin": _to_host(r.origin),
            "direction": _to_host(r.direction),
            "wavelength": _to_host(r.wavelength),
            "weight": _to_host(r.weight),
            "mask": _to_host(r.mask),
        }
        found[name] = {k: v[w_found] for k, v in arrays.items()}
        lost[name] = {k: v[w_lost] for k, v in arrays.items()}
    return found, lost


def build_runner(config: dict, pipeline: Pipeline | None = None):
    """Compile the per-run executor: plain jit, or ray-sharded over devices
    when ``general.shard_rays`` is set and more than one device is present.

    Returns (runner, pipeline).
    """
    g = get_config(config)["general"] if pipeline is None else None
    if pipeline is not None:
        g = pipeline.general
    shard = bool(g.get("shard_rays"))
    n_dev = g.get("devices") or len(jax.devices())
    if shard and n_dev > 1:
        from xicsrt_tpu.parallel import make_sharded_run

        runner, pipeline, _ = make_sharded_run(
            config if pipeline is None else pipeline.config, n_devices=n_dev
        )
        return runner, pipeline
    pipeline = pipeline or Pipeline(config)
    num_iter = int(pipeline.general["number_of_iter"])
    if bool(g["keep_history"]) and num_iter > 1:
        # History mode: compile ONE iteration and loop on the host —
        # unrolling every iteration into a single XLA program multiplies
        # compile time with no runtime benefit when history (whose arrays
        # must come back to the host anyway) is kept.
        iteration = jax.jit(pipeline.make_iteration())

        def runner(params, key):
            # Combine per-iteration outputs on the host: history arrays are
            # host-bound anyway, and host numpy avoids a shower of tiny
            # un-jitted device ops (each a separate XLA compilation).
            keys = jax.random.split(key, num_iter)
            outs = [jax.device_get(iteration(params, k)) for k in keys]
            meta = {
                n: sum(np.asarray(o["meta"][n]).item() for o in outs)
                for n in outs[0]["meta"]
            }
            image = {
                n: sum(np.asarray(o["image"][n]) for o in outs)
                for n in outs[0]["image"]
            }
            history = {
                n: _concat_rays_np([o["history"][n] for o in outs])
                for n in outs[0]["history"]
            }
            return {"meta": meta, "image": image, "history": history}

        return runner, pipeline
    if not bool(g.get("block_iterations", True)) and num_iter > 1:
        # Unblocked mode: compile ONE iteration and loop on the host,
        # accumulating images/meta on device between dispatches. Trades
        # per-iteration dispatch overhead for a num_iter-times smaller XLA
        # program — useful when iterating on configs interactively.
        iteration = jax.jit(pipeline.make_iteration())

        def runner(params, key):
            keys = jax.random.split(key, num_iter)
            acc = iteration(params, keys[0])
            for k in keys[1:]:
                out = iteration(params, k)
                acc = {
                    "meta": {
                        n: acc["meta"][n] + out["meta"][n]
                        for n in out["meta"]
                    },
                    "image": {
                        n: acc["image"][n] + out["image"][n]
                        for n in out["image"]
                    },
                    "history": {},
                }
            return acc

        return runner, pipeline
    run_fn = pipeline.make_run(num_iter)
    return jax.jit(run_fn), pipeline


def raytrace_single(config: dict, _pipeline: Pipeline | None = None,
                    _run_index: int = 0, _runner=None) -> dict:
    """One raytracing run (all iterations), returning a results dict.

    Equivalent of ``xicsrt_raytrace.raytrace_single`` (:87-175).
    """
    if _runner is None:
        _runner, _pipeline = build_runner(config, _pipeline)
    pipeline = _pipeline
    config = pipeline.config
    g = config["general"]
    jitted = _runner

    root = _root_key(g)
    run_key = jax.random.fold_in(root, _run_index)

    profiler.start("raytrace_run")
    out = jitted(pipeline.params, run_key)
    out = jax.block_until_ready(out)
    profiler.stop("raytrace_run")

    rng = np.random.default_rng(
        None if g["random_seed"] is None else int(g["random_seed"]) + _run_index
    )
    with profiler.span("sort_history"):
        found, lost = _sort_history(
            out["history"], pipeline.element_names,
            int(g["history_max_lost"]), rng,
        )

    def _section_meta(history):
        # Per-element alive counts within the compacted section (extends the
        # reference, which leaves found/lost meta empty,
        # xicsrt_raytrace.py:245,249; lost counts reflect the truncated set).
        return {
            name: {"num_out": int(rays["mask"].sum())}
            for name, rays in history.items()
        }

    result = {
        "config": config,
        "total": {
            "meta": {
                name: {"num_out": int(np.asarray(out["meta"][name]))}
                for name in pipeline.element_names
                if name in out["meta"]
            },
            "image": {name: np.asarray(img) for name, img in out["image"].items()},
        },
        "found": {"meta": _section_meta(found), "history": found},
        "lost": {"meta": _section_meta(lost), "history": lost},
    }
    return result


def raytrace(config: dict) -> dict:
    """Top-level entry: multiple runs, combined results, optional saving.

    Equivalent of ``xicsrt_raytrace.raytrace`` (:28-84). Runs execute
    sequentially on the available devices (each run re-folds the RNG key);
    for multi-chip execution of a *single* run see ``xicsrt_tpu.parallel``.
    """
    from xicsrt_tpu import io as xio

    t_start = time.time()
    with profiler.span("build_runner"):
        runner, pipeline = build_runner(config)
    config = pipeline.config
    g = config["general"]
    num_runs = int(g["number_of_runs"])

    # In multi-host runs every process computes identical reduced results;
    # only rank 0 writes/prints (single-process: process_index() == 0).
    primary = jax.process_index() == 0

    outputs = []
    # general.profile_dir: capture a device-level jax profiler trace of the
    # whole run loop (device-side counterpart of the reference's profiler
    # spans through the engine, xicsrt_raytrace.py:43,103,183).
    with profiler.device_trace(g.get("profile_dir")):
        for run in range(num_runs):
            g["output_run_suffix"] = f"{run:04d}"
            result = raytrace_single(
                config, _pipeline=pipeline, _run_index=run, _runner=runner
            )
            if g["save_images"] and primary:
                with profiler.span("save_images"):
                    xio.save_images(result)
            outputs.append(result)

    with profiler.span("combine_raytrace"):
        result = combine_raytrace(outputs)
    g["output_run_suffix"] = None

    if g["save_config"] and primary:
        xio.save_config(config)
    if g["save_images"] and primary:
        xio.save_images(result)
    if g["save_results"] and primary:
        with profiler.span("save_results"):
            xio.save_results(result)
    if g["print_results"] and primary:
        print_raytrace(result)
    log.info("raytrace completed in %0.2f s", time.time() - t_start)
    return result


def combine_raytrace(input_list: list) -> dict:
    """Combine results dicts from multiple runs.

    Equivalent of ``xicsrt_raytrace.combine_raytrace`` (:281-393): meta
    counters sum, images sum (with shape checks), histories concatenate.
    """
    if len(input_list) == 1:
        return input_list[0]
    output = {
        "config": input_list[0]["config"],
        "total": {"meta": {}, "image": {}},
        "found": {"meta": {}, "history": {}},
        "lost": {"meta": {}, "history": {}},
    }
    for name in input_list[0]["total"]["meta"]:
        output["total"]["meta"][name] = {
            "num_out": int(
                sum(r["total"]["meta"][name]["num_out"] for r in input_list)
            )
        }
    for name, img in input_list[0]["total"]["image"].items():
        for r in input_list[1:]:
            if r["total"]["image"][name].shape != img.shape:
                raise ValueError(f"Image shapes for {name} do not match across runs.")
        output["total"]["image"][name] = sum(
            r["total"]["image"][name] for r in input_list
        )
    for section in ("found", "lost"):
        names = input_list[0][section]["history"].keys()
        for name in names:
            keys = input_list[0][section]["history"][name].keys()
            output[section]["history"][name] = {
                k: np.concatenate(
                    [r[section]["history"][name][k] for r in input_list]
                )
                for k in keys
            }
        for name in input_list[0][section]["meta"]:
            output[section]["meta"][name] = {
                "num_out": int(
                    sum(r[section]["meta"][name]["num_out"] for r in input_list)
                )
            }
    return output


def print_raytrace(results: dict) -> None:
    """Human summary: generated/detected counts and Poisson-error efficiency
    (cf. ``xicsrt_raytrace.print_raytrace`` :414-431)."""
    meta = results["total"]["meta"]
    names = list(meta.keys())
    if not names:
        return
    num_generated = meta[names[0]]["num_out"]
    num_detected = meta[names[-1]]["num_out"]
    efficiency = num_detected / max(num_generated, 1)
    error = np.sqrt(max(num_detected, 1)) / max(num_generated, 1)
    print("")
    print("Rays Generated: {:0.4e}".format(num_generated))
    for name in names[1:]:
        print("Rays on {:12s}: {:0.4e}".format(name, meta[name]["num_out"]))
    print("Efficiency: {:0.4e} +/- {:0.2e} ({:0.2f}%)".format(
        efficiency, error, efficiency * 100))
    print("")
