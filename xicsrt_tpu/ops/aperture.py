"""Aperture masking with boolean composition.

Vectorized equivalent of ``xicsrt/tools/xicsrt_aperture.py``: a static list of
aperture specs compiles to a branch-free chain of vectorized mask updates.
The logic-op semantics match the reference exactly, including the (slightly
surprising) behavior that nand/nor/xnor can *revive* rays outside the current
mask-restricted domain only within already-live lanes — the reference applies
every update under the incoming mask ``m`` (``xicsrt_aperture.py:24-49``),
which we reproduce with a final ``& m``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from xicsrt_tpu.ops import vector as vec

_VALID_SHAPES = ("none", "circle", "square", "rectangle", "ellipse", "triangle")
_VALID_LOGIC = ("and", "not", "or", "nand", "nor", "xor", "xnor")


def normalize_aperture_spec(aperture_info):
    """Validate and normalize aperture config (host side, static).

    Accepts a single dict or a list of dicts with keys
    ``shape, size, origin, vertices, logic``.
    """
    if aperture_info is None:
        return []
    if isinstance(aperture_info, dict):
        aperture_info = [aperture_info]
    out = []
    for ap in aperture_info:
        spec = {
            "shape": (ap.get("shape") or "none").lower(),
            "logic": (ap.get("logic") or "and").lower(),
            "origin": np.asarray(
                ap.get("origin") if ap.get("origin") is not None else [0.0, 0.0],
                dtype=np.float64,
            ),
        }
        if spec["shape"] not in _VALID_SHAPES:
            raise ValueError(f'Aperture shape "{spec["shape"]}" is not implemented.')
        if spec["logic"] not in _VALID_LOGIC:
            raise ValueError(f'Aperture logic "{spec["logic"]}" is not known.')
        if "size" in ap and ap["size"] is not None:
            spec["size"] = np.atleast_1d(np.asarray(ap["size"], dtype=np.float64))
        if "vertices" in ap and ap["vertices"] is not None:
            spec["vertices"] = np.asarray(ap["vertices"], dtype=np.float64)
        out.append(spec)
    return out


def _shape_test(x_local, spec, dtype):
    """Inside-test for one aperture shape. x_local: [N, >=2] local coords."""
    shape = spec["shape"]
    ox, oy = float(spec["origin"][0]), float(spec["origin"][1])
    x = x_local[:, 0] - ox
    y = x_local[:, 1] - oy
    if shape == "none":
        return jnp.ones(x_local.shape[0], dtype=bool)
    if shape == "circle":
        r = float(spec["size"][0])
        return x * x + y * y < r * r
    if shape == "square":
        s = float(spec["size"][0])
        return (jnp.abs(x) < s / 2) & (jnp.abs(y) < s / 2)
    if shape == "rectangle":
        sx, sy = float(spec["size"][0]), float(spec["size"][1])
        return (jnp.abs(x) < sx / 2) & (jnp.abs(y) < sy / 2)
    if shape == "ellipse":
        sx, sy = float(spec["size"][0]), float(spec["size"][1])
        return (x / sx) ** 2 + (y / sy) ** 2 < 1.0
    if shape == "triangle":
        verts = spec["vertices"][:, 0:2] + spec["origin"][None, 0:2]
        p = jnp.stack([x_local[:, 0], x_local[:, 1]], axis=-1)
        return vec.point_in_triangle_2d(
            p,
            jnp.asarray(verts[0], dtype=dtype),
            jnp.asarray(verts[1], dtype=dtype),
            jnp.asarray(verts[2], dtype=dtype),
        )
    raise ValueError(shape)


def aperture_mask(x_local, mask, aperture_spec):
    """Apply a normalized aperture spec list to local intersection coords.

    ``x_local``: [N, 2 or 3]; ``mask``: [N] bool. Returns the updated mask.
    """
    if not aperture_spec:
        return mask
    dtype = x_local.dtype
    m_out = mask
    for spec in aperture_spec:
        m_test = _shape_test(x_local, spec, dtype) & mask
        logic = spec["logic"]
        if logic == "and":
            new = m_out & m_test
        elif logic == "not":
            new = m_out & ~m_test
        elif logic == "or":
            new = m_out | m_test
        elif logic == "nand":
            new = ~(m_out & m_test)
        elif logic == "nor":
            new = ~(m_out | m_test)
        elif logic == "xor":
            new = m_out ^ m_test
        elif logic == "xnor":
            new = ~(m_out ^ m_test)
        else:
            raise ValueError(logic)
        # Updates only apply inside the incoming mask (reference semantics).
        m_out = jnp.where(mask, new, m_out)
    return m_out & mask
