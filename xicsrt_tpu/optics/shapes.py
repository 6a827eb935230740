"""Analytic shape mixins: plane, sphere, cylinder, torus.

Each mixin provides ``make_intersect`` returning a pure, batched function
``(params, rays) -> (dist, normal, mask)`` in *global* coordinates. The
geometry math matches the reference shapes:

- plane: ``optics/_ShapePlane.py:32-62``
- sphere: ``optics/_ShapeSphere.py:52-106`` (concave picks the far root,
  convex the near root; center displaced along +-zaxis by the radius)
- cylinder: ``optics/_ShapeCylinder.py:52-133`` (axis along the local xaxis)
- torus: ``optics/_ShapeTorus.py:54-216`` (quartic in torus-centered
  coordinates with the torus axis along the local yaxis; the ``convex`` pair
  selects which of the four ascending intersections is used)

but are derived independently for dense masked arrays: no boolean fancy
indexing, no NaN seeding, and centers/axes are recomputed from the
differentiable frame params inside the function so pose gradients flow.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from xicsrt_tpu.ops import polynomials as poly
from xicsrt_tpu.ops import vector as vec
from xicsrt_tpu.optics.base import TraceElement


class ShapePlane(TraceElement):
    """Infinite plane through the frame origin, normal = zaxis."""

    def make_intersect(self):
        def intersect(params, rays):
            frame = params["frame"]
            normal = frame.zaxis
            denom = vec.dot(rays.direction, normal)
            numer = vec.dot(frame.origin[None, :] - rays.origin, normal)
            safe = jnp.where(jnp.abs(denom) > 1e-30, denom, 1e-30)
            dist = numer / safe
            m = rays.mask & (dist >= 0.0) & (jnp.abs(denom) > 1e-30)
            norm = jnp.broadcast_to(normal, rays.origin.shape)
            return dist, norm, m

        return intersect


class _ShapeCurvedMixin(TraceElement):
    """Shared config for single-radius curved shapes (sphere/cylinder)."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["radius"] = 1.0
        config["convex"] = False
        return config

    def build_params(self) -> dict:
        params = super().build_params()
        params["radius"] = self.as_array(self.param["radius"])
        return params


class ShapeSphere(_ShapeCurvedMixin):
    """Spherical cap; center at origin + sign * radius * zaxis."""

    def make_intersect(self):
        sign = -1.0 if self.param["convex"] else 1.0
        convex = bool(self.param["convex"])

        def intersect(params, rays):
            frame = params["frame"]
            radius = params["radius"]
            center = frame.origin + sign * radius * frame.zaxis
            L = center[None, :] - rays.origin
            t_ca = vec.dot(L, rays.direction)
            d2 = vec.dot(L, L) - t_ca * t_ca
            r2 = radius * radius
            hit = d2 <= r2
            t_hc = jnp.sqrt(jnp.maximum(r2 - d2, 0.0))
            # Convex surface: near intersection; concave: far intersection.
            dist = t_ca + (-t_hc if convex else t_hc)
            m = rays.mask & hit
            xloc = rays.origin + rays.direction * dist[:, None]
            norm = vec.safe_normalize(center[None, :] - xloc)
            return dist, norm, m

        return intersect


class ShapeCylinder(_ShapeCurvedMixin):
    """Cylindrical surface; axis along the local xaxis, center displaced
    along +-zaxis by the radius."""

    def make_intersect(self):
        sign = -1.0 if self.param["convex"] else 1.0
        convex = bool(self.param["convex"])

        def intersect(params, rays):
            frame = params["frame"]
            radius = params["radius"]
            center = frame.origin + sign * radius * frame.zaxis
            axis = frame.xaxis
            dp = rays.origin - center[None, :]
            d_ax = vec.dot(rays.direction, axis)
            p_ax = vec.dot(dp, axis)
            A1 = rays.direction - d_ax[:, None] * axis[None, :]
            B1 = dp - p_ax[:, None] * axis[None, :]
            a = vec.dot(A1, A1)
            b = 2.0 * vec.dot(A1, B1)
            c = vec.dot(B1, B1) - radius * radius
            t0, t1, valid = poly.solve_quadratic(a, b, c)
            dist = jnp.minimum(t0, t1) if convex else jnp.maximum(t0, t1)
            m = rays.mask & valid
            dist = jnp.where(m, dist, 0.0)
            xloc = rays.origin + rays.direction * dist[:, None]
            # Normal points from the surface towards the axis.
            to_center = center[None, :] - xloc
            along = vec.dot(to_center, axis)
            norm = vec.safe_normalize(to_center - along[:, None] * axis[None, :])
            return dist, norm, m

        return intersect


class ShapeTorus(TraceElement):
    """Toroidal surface.

    ``radius_major`` is the surface radius of curvature in the local x
    direction; ``radius_minor`` the curvature in y. The geometric torus (axis
    along the local yaxis, centered at origin + sign * radius_major * zaxis)
    is derived from the ``convex`` flag pair exactly as the reference does
    (``_ShapeTorus.py:54-91``); root index k selects the (k+1)-th
    intersection along the ray.
    """

    def default_config(self) -> dict:
        config = super().default_config()
        config["radius_major"] = 1.0
        config["radius_minor"] = 0.2
        config["convex"] = [False, False]
        return config

    def check_config(self):
        super().check_config()
        if self.config["radius_minor"] >= self.config["radius_major"]:
            raise ValueError("Cannot construct torus with radius_major <= radius_minor.")

    def initialize(self):
        super().initialize()
        convex = [bool(v) for v in np.atleast_1d(self.param["convex"])]
        if len(convex) == 1:
            convex = [convex[0], convex[0]]
        table = {
            (False, False): (-1.0, +1.0),
            (False, True): (+1.0, +1.0),
            (True, False): (+1.0, -1.0),
            (True, True): (-1.0, -1.0),
        }
        major_adjust, center_sign = table[tuple(convex)]
        self.param["major_adjust"] = major_adjust  # torus_major = R + adj * r
        self.param["center_sign"] = center_sign

    def build_params(self) -> dict:
        params = super().build_params()
        params["radius_major"] = self.as_array(self.param["radius_major"])
        params["radius_minor"] = self.as_array(self.param["radius_minor"])
        return params

    def make_intersect(self):
        major_adjust = float(self.param["major_adjust"])
        center_sign = float(self.param["center_sign"])

        def intersect(params, rays):
            frame = params["frame"]
            r_min = params["radius_minor"]
            r_maj = params["radius_major"] + major_adjust * r_min
            center = frame.origin + center_sign * params["radius_major"] * frame.zaxis

            # Torus-centered local coordinates (torus axis = local y).
            O = frame.vector_to_local(rays.origin - center[None, :])
            D = frame.vector_to_local(rays.direction)

            # Shift each ray origin to the point of closest approach to the
            # torus center: |coefficients| stay O(r^2) instead of O(|O|^2),
            # which keeps the float32 quartic well conditioned.
            t_shift = -vec.dot(O, D)
            Os = O + t_shift[:, None] * D

            o2 = vec.dot(Os, Os)
            od = vec.dot(Os, D)
            r2 = r_maj * r_maj + r_min * r_min
            dy = D[:, 1]
            oy = Os[:, 1]

            c0 = jnp.ones_like(o2)
            c1 = 4.0 * od
            c2 = 4.0 * od * od + 2.0 * o2 - 2.0 * r2 + 4.0 * r_maj**2 * dy * dy
            c3 = 4.0 * od * (o2 - r2) + 8.0 * r_maj**2 * dy * oy
            c4 = (
                o2 * o2
                - 2.0 * r2 * o2
                + 4.0 * r_maj**2 * oy * oy
                + (r_maj**2 - r_min**2) ** 2
            )

            # The solver's branches (sqrt/cbrt/arccos at their singular
            # points) have no usable derivative; gradients of the root come
            # from the implicit function theorem below instead.
            roots = jax.lax.stop_gradient(
                poly.solve_quartic(c0, c1, c2, c3, c4))
            cand = roots + t_shift[:, None]  # distances along the ray

            # Root selection: of the positive real intersections, take the
            # one on the optic patch — the surface containing the frame
            # origin, i.e. minimal |local z| of the hit. This generalizes
            # the reference's solver-order-dependent root_idx table
            # (``_ShapeTorus.py:72-89,175-181``) and also handles rays
            # originating inside the torus hole. z_local is linear in t.
            z0 = vec.dot(rays.origin - frame.origin[None, :], frame.zaxis)
            zd = vec.dot(rays.direction, frame.zaxis)
            z_local = z0[:, None] + cand * zd[:, None]
            valid = jnp.isfinite(cand) & (cand > 1e-6)
            score = jnp.where(valid, jnp.abs(z_local), jnp.inf)
            k = jnp.argmin(score, axis=-1)
            rows = jnp.arange(cand.shape[0])
            m = rays.mask & valid[rows, k]
            # dy/dc = -(df/dc) / f'(y) at the root y of f: a Newton step
            # whose value is exactly zero carries that derivative.
            y = jnp.where(m, roots[rows, k], 0.0)
            f = (((c0 * y + c1) * y + c2) * y + c3) * y + c4
            df = ((4.0 * c0 * y + 3.0 * c1) * y + 2.0 * c2) * y + c3
            df = jnp.where(jnp.abs(df) > 1e-30, df, 1.0)
            y = y - (f - jax.lax.stop_gradient(f)) / df
            dist = jnp.where(m, y + t_shift, 0.0)

            # Normal (global frame): project the hit onto the torus axis
            # circle and point from the tube center to the hit.
            xloc = rays.origin + rays.direction * dist[:, None]
            yaxis = frame.yaxis
            pt = xloc - center[None, :]
            pt_planar = pt - vec.dot(pt, yaxis)[:, None] * yaxis[None, :]
            q = center[None, :] + r_maj * vec.safe_normalize(pt_planar)
            norm = vec.safe_normalize(xloc - q)
            return dist, norm, m

        return intersect
