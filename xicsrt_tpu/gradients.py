"""Differentiable raytracing: gradients of detector images w.r.t. optics.

This module delivers the differentiable-alignment capability from the
project north star: pixel gradients with respect to optic positions,
orientations, crystal d-spacing and rocking-curve width, used to optimize an
instrument layout against a target detector image.

How gradients flow (``interact_mode='weight'`` + ``image_mode='bilinear'``):

- source sampling is independent of optic parameters (reparameterized MC);
- intersection points and reflected directions are smooth functions of the
  optic frame and shape parameters;
- Bragg acceptance contributes through the ray weight
  ``w *= p(theta_inc(pose), theta_bragg(lambda, d); fwhm)`` — exactly the
  path the reference leaves unused (its ``weight`` field,
  ``_XicsrtSourceGeneric.py:383-387``);
- the bilinear image splat is piecewise-linear in the hit position.

Bounds/aperture masks remain hard steps (their gradient contribution — edge
terms — is ignored, the standard approximation in differentiable MC
renderers).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from xicsrt_tpu.engine import Pipeline


def make_differentiable(config: dict, num_iter: int | None = None,
                        remat: bool | None = None, mesh=None,
                        n_devices: int | None = None,
                        platform: str | None = None):
    """Build a differentiable forward: ``images(params, key) -> dict``.

    Forces weight-mode interactions and bilinear imaging. Returns
    ``(image_fn, pipeline)``; differentiate with ``jax.grad`` over any leaf
    of ``pipeline.params``.

    ``remat`` (default True) checkpoints each iteration so the backward
    pass recomputes the trace instead of storing residuals. The bilinear
    binning itself needs no rematerialization either way — its custom
    tent-transpose VJP (``ops/binning.py``) keeps only O(N) residuals.
    Pass ``remat=False`` for runs whose per-iteration trace intermediates
    fit in device memory (the backward then skips the ~1x trace
    recompute).

    ``platform`` selects the image binning route as for ``Pipeline``
    (default: JAX's default backend).

    Multi-chip gradients: pass ``mesh`` (a 1-D ``jax.sharding.Mesh``) or
    ``n_devices`` to shard the ray axis. Each device folds its mesh
    position into the RNG key and traces its share of the photon load
    (``parallel.mesh._shard_intensity`` divides source rates, preserving
    totals); the per-device images are ``psum``-reduced inside the
    ``shard_map``. Because the params enter replicated, the transpose of
    that program IS the cross-device gradient all-reduce: ``jax.grad`` of
    any loss of these images returns globally-summed parameter gradients,
    with the collective overlapped into the backward pass by XLA. This is
    the differentiable analog of the reference's only parallel mechanism
    (per-run process pool, ``xicsrt_multiprocessing.py:37-62``), which
    cannot propagate gradients at all.
    """
    import copy

    config = copy.deepcopy(config)
    general = config.setdefault("general", {})
    general["interact_mode"] = "weight"
    general["image_mode"] = "bilinear"
    general["keep_history"] = False

    if mesh is None and n_devices is not None and n_devices > 1:
        from xicsrt_tpu.parallel.mesh import ray_mesh

        mesh = ray_mesh(n_devices)
    if mesh is not None:
        from xicsrt_tpu.parallel.mesh import _shard_intensity

        config = _shard_intensity(config, int(mesh.devices.size))

    pipeline = Pipeline(config, platform=platform)
    n_iter = num_iter or int(pipeline.general["number_of_iter"])
    if remat is None:
        remat = True
    run = pipeline.make_run(
        n_iter, keep_history=False, keep_images=True, remat=remat
    )

    if mesh is None:
        def image_fn(params, key):
            return run(params, key)["image"]

        return image_fn, pipeline

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    image_names = list(pipeline.image_specs().keys())

    def device_images(params, key):
        idx = jax.lax.axis_index(axis)
        out = run(params, jax.random.fold_in(key, idx))
        return {k: jax.lax.psum(out["image"][k], axis) for k in image_names}

    image_fn = shard_map(
        device_images,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs={k: P() for k in image_names},
        check_vma=False,
    )
    return image_fn, pipeline


def l2_image_loss(image, target):
    return jnp.mean((image - target) ** 2)


def align(
    config: dict,
    target_images: dict,
    optimize_paths: list,
    steps: int = 100,
    learning_rate: float = 1e-3,
    num_iter: int | None = None,
    seed: int = 0,
    resample: bool = True,
    loss_fn=l2_image_loss,
    callback=None,
    mesh=None,
    n_devices: int | None = None,
):
    """Gradient-descent alignment of optic parameters to target images.

    Parameters
    ----------
    config : raytracing config (will run in weight/bilinear mode).
    target_images : {optic_name: [nx, ny] array} target detector images.
    optimize_paths : list of tuples addressing leaves of the params pytree,
      e.g. ``("optics", "crystal", "crystal_spacing")`` or
      ``("optics", "crystal", "frame")`` (optimizes origin + basis).
    steps, learning_rate : Adam settings.
    resample : fresh MC rays each step (True) or frozen rays (False —
      deterministic loss, useful for convergence tests).
    callback : optional fn(step, loss, params).
    mesh, n_devices : shard each step's rays over a device mesh; parameter
      gradients are psum-reduced across devices inside the backward pass
      (see ``make_differentiable``).

    Returns (optimized_params, losses).
    """
    import optax

    image_fn, pipeline = make_differentiable(
        config, num_iter=num_iter, mesh=mesh, n_devices=n_devices
    )
    params = pipeline.params
    targets = {k: jnp.asarray(v) for k, v in target_images.items()}

    def split_params(params):
        """Partition into (trainable, frozen) by optimize_paths."""
        trainable = {}
        for path in optimize_paths:
            node = params
            for p in path[:-1]:
                node = node[p]
            sub = trainable
            for p in path[:-1]:
                sub = sub.setdefault(p, {})
            sub[path[-1]] = node[path[-1]]
        return trainable

    def merge_params(params, trainable):
        out = dict(params)

        def _merge(dst, src):
            merged = dict(dst)
            for k, v in src.items():
                if isinstance(v, dict):
                    merged[k] = _merge(dst[k], v)
                else:
                    merged[k] = v
            return merged

        return _merge(out, trainable)

    trainable = split_params(params)
    opt = optax.adam(learning_rate)
    opt_state = opt.init(trainable)
    root_key = jax.random.key(seed)

    @jax.jit
    def step_fn(trainable, opt_state, key):
        def loss_of(trainable):
            full = merge_params(params, trainable)
            images = image_fn(full, key)
            losses = [loss_fn(images[k], targets[k]) for k in targets]
            return jnp.sum(jnp.stack(losses))

        loss, grads = jax.value_and_grad(loss_of)(trainable)
        updates, opt_state = opt.update(grads, opt_state)
        trainable = optax.apply_updates(trainable, updates)
        return trainable, opt_state, loss

    losses = []
    for i in range(steps):
        key = jax.random.fold_in(root_key, i if resample else 0)
        trainable, opt_state, loss = step_fn(trainable, opt_state, key)
        losses.append(float(loss))
        if callback is not None:
            callback(i, losses[-1], trainable)

    final = merge_params(params, trainable)
    return final, np.asarray(losses)
