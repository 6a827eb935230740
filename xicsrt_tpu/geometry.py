"""Coordinate frames for optical elements.

Replaces the reference ``GeometryObject`` (``xicsrt/objects/_GeometryObject.py:19-200``)
with a differentiable pytree: an element pose is ``origin`` plus a row-matrix
``basis`` whose rows are the local x/y/z axes expressed in global coordinates.

Transforms are deliberately written as broadcast multiplies + adds rather
than ``v @ basis``: an accelerator may run a float32 dot_general at reduced
input precision by default (TF32 on a GPU), which is catastrophic for
Bragg-scale angles (rocking widths are ~5e-5 rad), while a K=3 contraction
gains nothing from a matrix unit. The elementwise form runs in full
f32/f64.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["origin", "basis"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class Frame:
    """Pose of an element: origin [3] and basis [3,3] (rows = x,y,z axes)."""

    origin: jax.Array
    basis: jax.Array

    @property
    def xaxis(self) -> jax.Array:
        return self.basis[0]

    @property
    def yaxis(self) -> jax.Array:
        return self.basis[1]

    @property
    def zaxis(self) -> jax.Array:
        return self.basis[2]

    # --- vectors ---------------------------------------------------------
    def vector_to_external(self, v: jax.Array) -> jax.Array:
        """Local components -> global vector. v: [..., 3]."""
        return (
            v[..., 0:1] * self.basis[0]
            + v[..., 1:2] * self.basis[1]
            + v[..., 2:3] * self.basis[2]
        )

    def vector_to_local(self, v: jax.Array) -> jax.Array:
        """Global vector -> local components. v: [..., 3]."""
        return jnp.stack(
            [
                jnp.sum(v * self.basis[0], axis=-1),
                jnp.sum(v * self.basis[1], axis=-1),
                jnp.sum(v * self.basis[2], axis=-1),
            ],
            axis=-1,
        )

    # --- points ----------------------------------------------------------
    def point_to_external(self, p: jax.Array) -> jax.Array:
        return self.vector_to_external(p) + self.origin

    def point_to_local(self, p: jax.Array) -> jax.Array:
        return self.vector_to_local(p - self.origin)


def default_xaxis(zaxis: np.ndarray) -> np.ndarray:
    """Default x-axis when the user provides none.

    Matches the reference convention (``_GeometryObject.py:96-111``):
    ``cross([0,0,1], zaxis)`` normalized, falling back to [1,0,0] when the
    z-axis is vertical.
    """
    zaxis = np.asarray(zaxis, dtype=np.float64)
    xaxis = np.cross(np.array([0.0, 0.0, 1.0]), zaxis)
    norm = np.linalg.norm(xaxis)
    if norm < 1e-12:
        return np.array([1.0, 0.0, 0.0])
    return xaxis / norm


def frame_from_config(
    origin,
    zaxis,
    xaxis=None,
    dtype=jnp.float32,
) -> Frame:
    """Build a Frame from config entries, validating orthogonality.

    Mirrors the setup in ``_GeometryObject.py:76-94``: the y-axis is always
    ``cross(zaxis, xaxis)``.
    """
    origin = np.asarray(origin, dtype=np.float64)
    zaxis = np.asarray(zaxis, dtype=np.float64)
    zn = np.linalg.norm(zaxis)
    if zn == 0:
        raise ValueError("zaxis must be a non-zero vector.")
    zaxis = zaxis / zn
    if xaxis is None:
        xaxis = default_xaxis(zaxis)
    else:
        xaxis = np.asarray(xaxis, dtype=np.float64)
        if not np.isclose(np.dot(zaxis, xaxis), 0.0, atol=1e-8):
            raise ValueError("zaxis and xaxis are not orthogonal.")
        xaxis = xaxis / np.linalg.norm(xaxis)
    yaxis = np.cross(zaxis, xaxis)
    basis = np.stack([xaxis, yaxis, zaxis], axis=0)
    return Frame(
        origin=jnp.asarray(origin, dtype=dtype),
        basis=jnp.asarray(basis, dtype=dtype),
    )


def aim_zaxis(origin, aim_point) -> np.ndarray:
    """Z-axis unit vector pointing from origin towards aim_point
    (host-side helper mirroring ``_GeometryObject.aim_to_point``)."""
    origin = np.asarray(origin, dtype=np.float64)
    aim_point = np.asarray(aim_point, dtype=np.float64)
    z = aim_point - origin
    return z / np.linalg.norm(z)
