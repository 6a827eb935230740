"""Ray bundles as fixed-shape JAX pytrees.

The reference stores rays as a dict-of-arrays (``xicsrt/objects/_RayArray.py:82-87``
holds ``origin[N,3], direction[N,3], wavelength[N], mask[N]`` plus a ``weight[N]``
added by sources). Here the same structure-of-arrays layout becomes a frozen
dataclass pytree with a *static* leading dimension ``N``: dead rays are masked,
never compacted, so every kernel sees fixed shapes and XLA can fuse the whole
optic chain.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["origin", "direction", "wavelength", "weight", "mask"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class Rays:
    """A bundle of N rays (structure of arrays).

    Attributes
    ----------
    origin : [N, 3] float
        Ray origin in the current reference frame (usually global).
    direction : [N, 3] float
        Unit direction vectors.
    wavelength : [N] float
        Wavelength in Angstroms.
    weight : [N] float
        Statistical weight carried by each ray. 1.0 for plain Monte-Carlo
        transport; multiplied by reflection probabilities in the
        differentiable ``weight`` interaction mode.
    mask : [N] bool
        True while the ray is alive. A ray that misses an optic keeps its
        storage slot but is masked out.
    """

    origin: jax.Array
    direction: jax.Array
    wavelength: jax.Array
    weight: jax.Array
    mask: jax.Array

    @property
    def n(self) -> int:
        return self.origin.shape[0]

    @property
    def dtype(self):
        return self.origin.dtype

    def replace(self, **kwargs) -> "Rays":
        return dataclasses.replace(self, **kwargs)

    def num_alive(self) -> jax.Array:
        return jnp.sum(self.mask)

    def weighted_alive(self) -> jax.Array:
        return jnp.sum(jnp.where(self.mask, self.weight, 0.0))

    def to_dict(self) -> dict:
        """Export to the reference dict-of-arrays layout (host side)."""
        return {
            "origin": self.origin,
            "direction": self.direction,
            "wavelength": self.wavelength,
            "weight": self.weight,
            "mask": self.mask,
        }


def zero_rays(n: int, dtype=jnp.float32) -> Rays:
    """Allocate an all-dead bundle of ``n`` rays.

    Mirrors ``RayArray.zeros`` (``_RayArray.py:82-87``) with the weight field
    always present.
    """
    return Rays(
        origin=jnp.zeros((n, 3), dtype=dtype),
        direction=jnp.zeros((n, 3), dtype=dtype),
        wavelength=jnp.zeros((n,), dtype=dtype),
        weight=jnp.ones((n,), dtype=dtype),
        mask=jnp.zeros((n,), dtype=bool),
    )


def concatenate(bundles: list) -> Rays:
    """Concatenate bundles along the ray axis (host-side combine)."""
    return Rays(
        origin=jnp.concatenate([b.origin for b in bundles], axis=0),
        direction=jnp.concatenate([b.direction for b in bundles], axis=0),
        wavelength=jnp.concatenate([b.wavelength for b in bundles], axis=0),
        weight=jnp.concatenate([b.weight for b in bundles], axis=0),
        mask=jnp.concatenate([b.mask for b in bundles], axis=0),
    )
