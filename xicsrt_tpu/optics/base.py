"""Optic base: frame + bounds + aperture + image grid.

Functional analog of ``xicsrt/optics/_TraceObject.py``. A concrete optic is a
Shape mixin x Interact mixin (same composition pattern as the reference,
``optics/_TraceObject.py:157-172``), but the composition is *compiled*: an
optic exports a pure function ``trace(params, rays, key) -> (rays, x_local)``
closed over all static structure, so the whole optic chain fuses into one XLA
program. All geometry math runs in global coordinates on dense ``[N, 3]``
arrays; ``trace_local`` is accepted for config compatibility but is a no-op
(the compiled pipeline has no per-optic transform cost to avoid).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from xicsrt_tpu.dispatch import GeometryElement
from xicsrt_tpu.ops.aperture import aperture_mask, normalize_aperture_spec
from xicsrt_tpu.rays import Rays


class TraceElement(GeometryElement):
    """Base optic: bounds, apertures, pixel-image grid."""

    def default_config(self) -> dict:
        """
        Config options (mirroring ``_TraceObject.default_config`` :29-99):
        xsize/ysize/zsize (bounds half-extent tests), pixel_size (image
        binning), aperture (spec list), trace_local (compat no-op),
        check_size, check_aperture, filters.
        """
        config = super().default_config()
        config["xsize"] = None
        config["ysize"] = None
        config["zsize"] = None
        config["pixel_size"] = None
        config["trace_local"] = False
        config["check_size"] = True
        config["check_aperture"] = True
        config["aperture"] = None
        config["filters"] = []
        return config

    def initialize(self):
        super().initialize()
        xsize = self.param.get("xsize")
        ysize = self.param.get("ysize")
        if xsize and ysize:
            pixel_size = self.param.get("pixel_size")
            if pixel_size is None:
                pixel_size = xsize / 100.0
                self.param["pixel_size"] = pixel_size
            nx = xsize / pixel_size
            ny = ysize / pixel_size
            if not (
                np.isclose(nx, np.round(nx), atol=1e-6)
                and np.isclose(ny, np.round(ny), atol=1e-6)
            ):
                self.log.warning(
                    "Optic size (%0.4f x %0.4f) is not a multiple of pixel_size "
                    "(%0.4f); output image may be truncated.",
                    xsize, ysize, pixel_size,
                )
            self.param["pixel_xsize"] = int(np.round(nx))
            self.param["pixel_ysize"] = int(np.round(ny))
            self.param["enable_image"] = True
        else:
            self.param["enable_image"] = False
        self.aperture_spec = normalize_aperture_spec(self.param.get("aperture"))

    # ------------------------------------------------------------------
    @property
    def enable_image(self) -> bool:
        return bool(self.param.get("enable_image"))

    @property
    def image_shape(self):
        if not self.enable_image:
            return None
        return (self.param["pixel_xsize"], self.param["pixel_ysize"])

    @property
    def pixel_size(self):
        return self.param.get("pixel_size")

    # ------------------------------------------------------------------
    def make_check_bounds(self):
        """Returns fn(x_local, mask) -> mask applying size + aperture tests.

        Equivalent of ``_TraceObject.check_bounds/check_size/check_aperture``
        (:180-232)."""
        check_size = bool(self.param.get("check_size", True))
        check_aperture = bool(self.param.get("check_aperture", True))
        xsize = self.param.get("xsize")
        ysize = self.param.get("ysize")
        zsize = self.param.get("zsize")
        ap_spec = self.aperture_spec

        def check_bounds(x_local, mask):
            m = mask
            if check_size:
                if xsize is not None:
                    m = m & (jnp.abs(x_local[:, 0]) < xsize / 2.0)
                if ysize is not None:
                    m = m & (jnp.abs(x_local[:, 1]) < ysize / 2.0)
                if zsize is not None:
                    m = m & (jnp.abs(x_local[:, 2]) < zsize / 2.0)
            if check_aperture and ap_spec:
                m = aperture_mask(x_local, m, ap_spec)
            return m

        return check_bounds

    # --- shape/interact contracts (provided by mixins) -------------------
    def make_intersect(self):
        """Returns fn(params, rays) -> (dist, normal, m_int).

        ``dist``: [N] distance along the ray to the surface; ``normal``:
        [N, 3] surface normal at the hit; ``m_int``: alive & geometrically
        intersecting.
        """
        raise NotImplementedError

    def make_interact(self):
        """Returns fn(params, rays, xloc, norm, mask, key) -> rays."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    def make_trace(self):
        """Compose intersect -> bounds -> interact into one pure function."""
        intersect = self.make_intersect()
        check_bounds = self.make_check_bounds()
        interact = self.make_interact()

        def trace(params, rays: Rays, key):
            frame = params["frame"]
            dist, norm, m_int = intersect(params, rays)
            xloc = jnp.where(
                m_int[:, None],
                rays.origin + rays.direction * dist[:, None],
                rays.origin,
            )
            x_local = frame.point_to_local(xloc)
            mask = check_bounds(x_local, m_int)
            rays = interact(params, rays, xloc, norm, mask, key)
            # Advance every intersecting ray to the surface (the reference
            # moves lost rays too, _InteractObject.py:26-40, with NaN for
            # non-intersections; we keep the previous origin instead so the
            # arrays stay finite for gradients).
            rays = rays.replace(origin=xloc)
            return rays, x_local

        return trace
