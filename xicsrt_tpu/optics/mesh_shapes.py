"""Triangle-mesh optics.

Vectorized replacement for ``xicsrt/optics/_ShapeMesh.py`` and the
sphere/cylinder/torus mesh generators. Two intersection paths:

- **Refine path** (default when a coarse mesh is available, mirroring the
  reference's refinement semantics ``_ShapeMesh.py:350-475``): the
  reference prunes candidate faces with a cKDTree around a coarse-mesh
  hit; pointer-chasing trees do not map to fixed-shape array code, so the pruning structure
  here is a *uniform 2D grid* over the mesh's local x-y footprint, built
  on the host at setup. On device: rays are transformed to the mesh local
  frame, intersected densely against the (tiny) coarse mesh, the hit's
  local x-y selects a grid cell (rays that miss the coarse mesh fall back
  to a mid-plane projection instead of being dropped — the reference
  loses those rays and warns, ``_ShapeMesh.py:158-162``), and the exact
  Möller–Trumbore test runs only on that cell's K candidate faces. Work
  is O(rays x K) instead of O(rays x faces).
- **Dense path** (fallback, and ``mesh_refine=False``): every ray against
  every face, scanned over fixed-size face chunks. Exact for meshes that
  are not x-y height fields.

Both paths process rays in fixed-size blocks (``mesh_ray_block``) via
``lax.map`` so peak memory is bounded regardless of batch size.

- Smooth-surface mode (``mesh_interpolate``) interpolates vertex normals
  barycentrically on the hit face (the reference fits CloughTocher2D splines
  in the local x-y plane; barycentric interpolation is mesh-intrinsic,
  fixed-shape, and exact at the vertices).
- Mesh data is differentiable: points/normals live in the params pytree.

Mesh data convention follows the reference: with ``trace_local=True``
(default for generated meshes) points/normals are given in the optic local
frame and are transformed through the (differentiable) frame at trace time;
otherwise they are taken as global.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from xicsrt_tpu.ops import vector as vec
from xicsrt_tpu.optics.base import TraceElement

_MT_EPS = 1e-12


def _moller_trumbore(O, D, v0, v1, v2):
    """Vectorized Möller–Trumbore ray/triangle test.

    ``O``/``D``: [N, 3] ray origins/directions. ``v0/v1/v2``: triangle
    vertices, either [C, 3] (shared face set) or [N, C, 3] (per-ray
    candidates). Returns ``(t, u, v, hit)`` each [N, C]. Same predicate as
    the reference's ``mesh_intersect_1`` (``_ShapeMesh.py:289-348``) but
    batched over a static candidate axis.
    """
    if v0.ndim == 2:
        v0, v1, v2 = v0[None], v1[None], v2[None]
    e1 = v1 - v0
    e2 = v2 - v0
    Ob = O[:, None, :]
    Db = D[:, None, :]
    h = jnp.cross(Db, e2)
    a = jnp.sum(e1 * h, axis=-1)
    inv_a = 1.0 / jnp.where(jnp.abs(a) > _MT_EPS, a, _MT_EPS)
    s = Ob - v0
    u = jnp.sum(s * h, axis=-1) * inv_a
    q = jnp.cross(s, e1)
    v = jnp.sum(Db * q, axis=-1) * inv_a
    t = jnp.sum(e2 * q, axis=-1) * inv_a
    hit = (
        (jnp.abs(a) > _MT_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > 1e-7)
    )
    return t, u, v, hit


class ShapeMesh(TraceElement):
    """Arbitrary triangle-mesh surface."""

    def default_config(self) -> dict:
        """
        mesh_points: [P,3] vertex positions.
        mesh_normals: [P,3] vertex normals (enables smooth interpolation).
        mesh_faces: [F,3] vertex indices.
        mesh_coarse_points/normals/faces: coarse proxy mesh used by the
            refine path to localize hits (``_ShapeMesh.py:350-426``).
        mesh_interpolate: barycentric smooth position/normal interpolation.
        mesh_refine: grid-pruned candidate intersection (default: on when a
            coarse mesh is available and the data is local-frame).
        mesh_chunk: faces per scanned chunk on the dense path (memory knob).
        mesh_ray_block: rays per processed block (memory knob).
        mesh_grid_size: (ncx, ncy) pruning-grid resolution (default: auto,
            ~2 faces per cell before margin expansion).
        mesh_grid_margin: cell halo each face is registered into (covers the
            x-y error of the coarse hit estimate).
        """
        config = super().default_config()
        config["mesh_points"] = None
        config["mesh_normals"] = None
        config["mesh_faces"] = None
        config["mesh_coarse_points"] = None
        config["mesh_coarse_normals"] = None
        config["mesh_coarse_faces"] = None
        config["mesh_interpolate"] = None
        config["mesh_refine"] = None
        config["mesh_chunk"] = 512
        config["mesh_ray_block"] = 131072
        config["mesh_grid_size"] = None
        config["mesh_grid_margin"] = 1.0
        return config

    def check_param(self):
        super().check_param()
        if self.param["mesh_points"] is None or self.param["mesh_faces"] is None:
            raise ValueError(
                f'Optic "{self.name}": mesh_points and mesh_faces are required.'
            )
        if self.param["mesh_interpolate"] is None:
            self.param["mesh_interpolate"] = self.param["mesh_normals"] is not None
        elif self.param["mesh_interpolate"] and self.param["mesh_normals"] is None:
            raise ValueError(
                "mesh_normals must be provided to use mesh interpolation."
            )
        local_data = bool(self.param.get("trace_local", False))
        has_coarse = (
            self.param["mesh_coarse_points"] is not None
            and self.param["mesh_coarse_faces"] is not None
        )
        refine = self.param["mesh_refine"]
        if refine is None:
            refine = has_coarse and local_data
        refine = bool(refine)
        if refine and not has_coarse:
            raise ValueError(
                f'Optic "{self.name}": mesh_refine requires mesh_coarse_points '
                "and mesh_coarse_faces."
            )
        if refine and not local_data:
            raise ValueError(
                f'Optic "{self.name}": mesh_refine requires local-frame mesh '
                "data (trace_local=True); the pruning grid lives in the "
                "mesh local x-y plane."
            )
        self.param["mesh_refine"] = refine

    def initialize(self):
        super().initialize()
        pts = np.asarray(self.param["mesh_points"], dtype=np.float64)
        spread = pts.max(axis=0) - pts.min(axis=0)
        if self.param.get("trace_local", False) and (
            spread[2] > spread[0] or spread[2] > spread[1]
        ):
            self.log.warning(
                "Mesh is not oriented with surface normals near local z; "
                "results may be unexpected."
            )

    def build_params(self) -> dict:
        params = super().build_params()
        params["mesh_points"] = self.as_array(self.param["mesh_points"])
        if self.param["mesh_normals"] is not None:
            params["mesh_normals"] = self.as_array(self.param["mesh_normals"])
        return params

    def _generate_coarse(self):
        """Generate the coarse proxy mesh for the refine path (generators).

        Mirrors the reference generators, which build both a fine and a
        coarse mesh (e.g. ``_ShapeMeshSphere.py:60-98``).
        """
        size = self.param.get("mesh_coarse_size")
        if size is None or self.param["mesh_coarse_points"] is not None:
            return
        points, normals, faces = self.generate_mesh(size)
        self.param["mesh_coarse_points"] = points
        self.param["mesh_coarse_normals"] = normals
        self.param["mesh_coarse_faces"] = faces

    def make_intersect(self):
        if self.param["mesh_refine"]:
            return self._make_intersect_refine()
        return self._make_intersect_dense()

    # -- shared pieces -----------------------------------------------------

    def _normal_fn(self, interpolate):
        """Returns fn(pts, normals, fverts, u, v) -> [N,3] hit normals
        (in the same frame as ``pts``)."""

        def normal_at(pts, normals, fverts, u, v):
            if interpolate and normals is not None:
                n0 = normals[fverts[:, 0]]
                n1 = normals[fverts[:, 1]]
                n2 = normals[fverts[:, 2]]
                w0 = (1.0 - u - v)[:, None]
                return vec.safe_normalize(
                    w0 * n0 + u[:, None] * n1 + v[:, None] * n2
                )
            p0 = pts[fverts[:, 0]]
            e1 = pts[fverts[:, 1]] - p0
            e2 = pts[fverts[:, 2]] - p0
            return vec.safe_normalize(jnp.cross(e1, e2))

        return normal_at

    @staticmethod
    def _block_map(fn, n, args, block):
        """Apply ``fn`` over fixed-size ray blocks (bounds peak memory).

        ``args``: tuple of arrays with leading dim n; returns fn outputs
        (a tuple of arrays with leading dim = block) re-assembled to n.
        """
        b = max(1, min(int(block), n))
        n_blocks = -(-n // b)
        pad = n_blocks * b - n
        if n_blocks == 1:
            return fn(args)
        padded = tuple(
            jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1), constant_values=1.0)
            for a in args
        )
        blocked = tuple(a.reshape((n_blocks, b) + a.shape[1:]) for a in padded)
        out = jax.lax.map(fn, blocked)
        return tuple(o.reshape((n_blocks * b,) + o.shape[2:])[:n] for o in out)

    # -- dense path ----------------------------------------------------------

    def _make_intersect_dense(self):
        faces = np.asarray(self.param["mesh_faces"], dtype=np.int32)
        n_faces = faces.shape[0]
        chunk = int(self.param["mesh_chunk"])
        n_chunks = max(1, -(-n_faces // chunk))
        # Pad the face list to a whole number of chunks with degenerate
        # (never-hit) faces referencing vertex 0.
        pad = n_chunks * chunk - n_faces
        faces_padded = np.concatenate(
            [faces, np.zeros((pad, 3), dtype=np.int32)], axis=0
        ).reshape(n_chunks, chunk, 3)
        interpolate = bool(self.param["mesh_interpolate"])
        local_data = bool(self.param.get("trace_local", False))
        ray_block = int(self.param["mesh_ray_block"])
        normal_at = self._normal_fn(interpolate)

        def intersect(params, rays):
            frame = params["frame"]
            pts = params["mesh_points"]
            if local_data:
                pts = frame.point_to_external(pts)
            normals = params.get("mesh_normals")
            if normals is not None and local_data:
                normals = frame.vector_to_external(normals)

            n = rays.origin.shape[0]
            dtype = rays.origin.dtype
            inf = jnp.asarray(jnp.inf, dtype=dtype)
            face_chunks = jnp.asarray(faces_padded)  # [n_chunks, chunk, 3]

            def block(args):
                O, D = args
                nb = O.shape[0]
                rows = jnp.arange(nb)

                def body(ci, carry):
                    best_t, best_face, best_u, best_v = carry
                    face_chunk = face_chunks[ci]  # [chunk, 3]
                    tri = pts[face_chunk]
                    t, u, v, hit = _moller_trumbore(
                        O, D, tri[:, 0], tri[:, 1], tri[:, 2]
                    )
                    t_masked = jnp.where(hit, t, inf)
                    j = jnp.argmin(t_masked, axis=-1)
                    t_new = t_masked[rows, j]
                    better = t_new < best_t
                    gface = ci * chunk + j
                    return (
                        jnp.where(better, t_new, best_t),
                        jnp.where(better, gface.astype(jnp.int32), best_face),
                        jnp.where(better, u[rows, j], best_u),
                        jnp.where(better, v[rows, j], best_v),
                    )

                init = (
                    jnp.full((nb,), jnp.inf, dtype=dtype),
                    jnp.zeros((nb,), dtype=jnp.int32),
                    jnp.zeros((nb,), dtype=dtype),
                    jnp.zeros((nb,), dtype=dtype),
                )
                return jax.lax.fori_loop(0, n_chunks, body, init)

            best_t, best_face, best_u, best_v = self._block_map(
                block, n, (rays.origin, rays.direction), ray_block
            )

            m = rays.mask & jnp.isfinite(best_t)
            dist = jnp.where(m, best_t, 0.0)
            all_faces = jnp.asarray(faces_padded.reshape(-1, 3))
            fverts = all_faces[best_face]  # [n, 3]
            norm = normal_at(pts, normals, fverts, best_u, best_v)
            return dist, norm, m

        return intersect

    # -- refine (grid-pruned) path -------------------------------------------

    def _build_grid(self):
        """Host-side uniform grid over the local x-y mesh footprint.

        Fixed-shape stand-in for the reference's cKDTree candidate lookup
        (``_ShapeMesh.py:464-475``): each cell stores the indices of every
        face whose x-y bounding box overlaps the cell expanded by
        ``mesh_grid_margin`` cells, padded to the max count with a sentinel
        degenerate face that can never be hit.
        """
        pts = np.asarray(self.param["mesh_points"], dtype=np.float64)
        faces = np.asarray(self.param["mesh_faces"], dtype=np.int32)
        n_faces = faces.shape[0]
        xy = pts[:, :2]
        fxy = xy[faces]  # [F, 3, 2]
        fmin = fxy.min(axis=1)
        fmax = fxy.max(axis=1)
        lo = xy.min(axis=0)
        hi = xy.max(axis=0)
        span = np.maximum(hi - lo, 1e-300)

        grid_size = self.param["mesh_grid_size"]
        if grid_size is None:
            nc = int(np.clip(np.ceil(np.sqrt(n_faces / 2.0)), 1, 512))
            ncx = ncy = nc
        else:
            ncx, ncy = (int(v) for v in grid_size)
        cell = span / np.array([ncx, ncy])
        margin = float(self.param["mesh_grid_margin"]) * cell

        i0 = np.clip(
            np.floor((fmin - margin - lo) / cell).astype(np.int64), 0, [ncx - 1, ncy - 1]
        )
        i1 = np.clip(
            np.floor((fmax + margin - lo) / cell).astype(np.int64), 0, [ncx - 1, ncy - 1]
        )
        cell_lists = [[] for _ in range(ncx * ncy)]
        for f in range(n_faces):
            for ix in range(i0[f, 0], i1[f, 0] + 1):
                for iy in range(i0[f, 1], i1[f, 1] + 1):
                    cell_lists[ix * ncy + iy].append(f)
        k_max = max(1, max(len(c) for c in cell_lists))
        # Sentinel: face index n_faces -> degenerate triangle (vertex 0 x3).
        cell_faces = np.full((ncx * ncy, k_max), n_faces, dtype=np.int32)
        for ci, lst in enumerate(cell_lists):
            cell_faces[ci, : len(lst)] = lst
        faces_sentinel = np.concatenate(
            [faces, np.zeros((1, 3), dtype=np.int32)], axis=0
        )
        zmid = float(pts[:, 2].min() + pts[:, 2].max()) / 2.0
        return {
            "cell_faces": cell_faces,
            "faces_sentinel": faces_sentinel,
            "lo": lo,
            "cell": cell,
            "ncx": ncx,
            "ncy": ncy,
            "k_max": k_max,
            "zmid": zmid,
        }

    def _make_intersect_refine(self):
        grid = self._build_grid()
        coarse_pts = np.asarray(self.param["mesh_coarse_points"], dtype=np.float64)
        coarse_faces = np.asarray(self.param["mesh_coarse_faces"], dtype=np.int32)
        interpolate = bool(self.param["mesh_interpolate"])
        ray_block = int(self.param["mesh_ray_block"])
        normal_at = self._normal_fn(interpolate)
        ncy = grid["ncy"]
        ncx = grid["ncx"]
        zmid = grid["zmid"]
        lo_x, lo_y = (float(v) for v in grid["lo"])
        cw_x, cw_y = (float(v) for v in grid["cell"])
        c_tri = coarse_pts[coarse_faces]  # [Fc, 3, 3] static host data

        def intersect(params, rays):
            frame = params["frame"]
            pts = params["mesh_points"]  # local-frame, differentiable
            normals = params.get("mesh_normals")
            n = rays.origin.shape[0]
            dtype = rays.origin.dtype
            inf = jnp.asarray(jnp.inf, dtype=dtype)
            cell_faces = jnp.asarray(grid["cell_faces"])  # [ncells, K]
            faces_sentinel = jnp.asarray(grid["faces_sentinel"])  # [F+1, 3]
            tri_c = jnp.asarray(c_tri, dtype=dtype)

            O_l = frame.point_to_local(rays.origin)
            D_l = frame.vector_to_local(rays.direction)

            def block(args):
                O, D = args
                nb = O.shape[0]
                rows = jnp.arange(nb)
                # 1. Coarse hit estimate (dense MT over the tiny coarse mesh).
                tc, _, _, hitc = _moller_trumbore(
                    O, D, tri_c[:, 0], tri_c[:, 1], tri_c[:, 2]
                )
                tc_masked = jnp.where(hitc, tc, inf)
                t_c = jnp.min(tc_masked, axis=-1)
                hit_any = jnp.isfinite(t_c)
                # Fallback for coarse misses: project onto the mid-z plane
                # (keeps edge rays the reference's refinement would lose).
                dz = D[:, 2]
                safe_dz = jnp.where(jnp.abs(dz) > 1e-12, dz, 1e-12)
                t_plane = (zmid - O[:, 2]) / safe_dz
                t_est = jnp.where(hit_any, t_c, t_plane)
                p = O + t_est[:, None] * D
                # 2. Grid cell -> K candidate faces.
                ix = jnp.clip(
                    jnp.floor((p[:, 0] - lo_x) / cw_x).astype(jnp.int32), 0, ncx - 1
                )
                iy = jnp.clip(
                    jnp.floor((p[:, 1] - lo_y) / cw_y).astype(jnp.int32), 0, ncy - 1
                )
                cand = cell_faces[ix * ncy + iy]  # [nb, K]
                fidx = faces_sentinel[cand]  # [nb, K, 3]
                v0 = pts[fidx[..., 0]]
                v1 = pts[fidx[..., 1]]
                v2 = pts[fidx[..., 2]]
                # 3. Exact MT on candidates only.
                t, u, v, hit = _moller_trumbore(O, D, v0, v1, v2)
                t_masked = jnp.where(hit, t, inf)
                j = jnp.argmin(t_masked, axis=-1)
                return (
                    t_masked[rows, j],
                    cand[rows, j],
                    u[rows, j],
                    v[rows, j],
                )

            best_t, best_face, best_u, best_v = self._block_map(
                block, n, (O_l, D_l), ray_block
            )

            m = rays.mask & jnp.isfinite(best_t)
            dist = jnp.where(m, best_t, 0.0)
            fverts = jnp.asarray(grid["faces_sentinel"])[best_face]
            norm_local = normal_at(pts, normals, fverts, best_u, best_v)
            norm = frame.vector_to_external(norm_local)
            return dist, norm, m

        return intersect


def grid_faces(nx: int, ny: int) -> np.ndarray:
    """Triangulate a regular (nx, ny) point grid: 2 triangles per cell.

    Points are indexed row-major as i * ny + j.
    """
    faces = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a = i * ny + j
            b = (i + 1) * ny + j
            c = (i + 1) * ny + (j + 1)
            d = i * ny + (j + 1)
            faces.append((a, b, c))
            faces.append((a, c, d))
    return np.asarray(faces, dtype=np.int32)


class ShapeMeshSphere(ShapeMesh):
    """Spherical surface patch as a mesh grid (verification optic).

    Generates the same local-coordinate spherical patch as the reference
    (``_ShapeMeshSphere.py:60-98``) on a regular grid triangulation.
    """

    def default_config(self) -> dict:
        config = super().default_config()
        config["radius"] = 1.0
        config["mesh_size"] = (11, 11)
        config["mesh_coarse_size"] = (5, 5)
        config["trace_local"] = True
        return config

    def setup(self):
        super().setup()
        points, normals, faces = self.generate_mesh(self.param["mesh_size"])
        self.param["mesh_points"] = points
        self.param["mesh_normals"] = normals
        self.param["mesh_faces"] = faces
        self._generate_coarse()

    def generate_mesh(self, mesh_size):
        radius = float(self.param["radius"])
        xsize = float(self.param["xsize"])
        ysize = float(self.param["ysize"])
        x = np.linspace(-xsize / 2, xsize / 2, int(mesh_size[0]))
        y = np.linspace(-ysize / 2, ysize / 2, int(mesh_size[1]))
        xx, yy = np.meshgrid(x, y, indexing="ij")
        zz = radius - np.sqrt(radius**2 - xx**2 - yy**2)
        points = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=-1)
        center = np.array([0.0, 0.0, radius])
        normals = center[None, :] - points
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        faces = grid_faces(len(x), len(y))
        return points, normals, faces


class ShapeMeshCylinder(ShapeMesh):
    """Cylindrical surface patch as a mesh grid; axis along local x."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["radius"] = 1.0
        config["mesh_size"] = (11, 11)
        config["mesh_coarse_size"] = (5, 5)
        config["trace_local"] = True
        return config

    def setup(self):
        super().setup()
        points, normals, faces = self.generate_mesh(self.param["mesh_size"])
        self.param["mesh_points"] = points
        self.param["mesh_normals"] = normals
        self.param["mesh_faces"] = faces
        self._generate_coarse()

    def generate_mesh(self, mesh_size):
        radius = float(self.param["radius"])
        xsize = float(self.param["xsize"])
        ysize = float(self.param["ysize"])
        x = np.linspace(-xsize / 2, xsize / 2, int(mesh_size[0]))
        half_angle = np.arcsin(ysize / 2 / radius)
        psi = np.linspace(-half_angle, half_angle, int(mesh_size[1]))
        xx, pp = np.meshgrid(x, psi, indexing="ij")
        yy = radius * np.sin(pp)
        zz = radius - radius * np.cos(pp)
        points = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=-1)
        # Normal points from the surface towards the axis line (0, y?, R).
        normals = np.stack(
            [np.zeros_like(pp.ravel()), -np.sin(pp.ravel()), np.cos(pp.ravel())],
            axis=-1,
        )
        faces = grid_faces(len(x), len(psi))
        return points, normals, faces


class ShapeMeshTorus(ShapeMesh):
    """Toroidal surface patch as a mesh grid (cf. ``_ShapeMeshTorus.py``)."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["radius_major"] = 1.0
        config["radius_minor"] = 0.2
        config["convex"] = [False, False]
        config["normal_method"] = "analytic"
        config["mesh_size"] = (11, 11)
        config["mesh_coarse_size"] = (5, 5)
        config["mesh_xsize"] = None
        config["mesh_ysize"] = None
        config["trace_local"] = True
        return config

    def setup(self):
        super().setup()
        convex = [bool(v) for v in np.atleast_1d(self.param["convex"])]
        if len(convex) == 1:
            convex = [convex[0], convex[0]]
        # Same (root, torus_major, center) geometry table as the analytic
        # ShapeTorus (``_ShapeTorus.py:72-89``).
        table = {
            (False, False): (-1.0, +1.0),
            (False, True): (+1.0, +1.0),
            (True, False): (+1.0, -1.0),
            (True, True): (-1.0, -1.0),
        }
        self._major_adjust, self._center_sign = table[tuple(convex)]
        points, normals, faces = self.generate_mesh(self.param["mesh_size"])
        self.param["mesh_points"] = points
        if str(self.param["normal_method"]).lower() == "fd":
            normals = self._normals_fd(points)
        self.param["mesh_normals"] = normals
        self.param["mesh_faces"] = faces
        self._generate_coarse()

    def _surface(self, phi, psi):
        R = float(self.param["radius_major"])
        r = float(self.param["radius_minor"])
        adj = self._major_adjust
        s_m = self._center_sign
        T = R + adj * r
        # u(phi): unit vector in the local xz-plane from the torus center
        # towards the surface; C = s_m * R * zhat.
        ux = np.sin(phi)
        uz = -s_m * np.cos(phi)
        qx = T * ux
        qz = s_m * R + T * uz
        px = qx - adj * r * np.cos(psi) * ux
        py = r * np.sin(psi)
        pz = qz - adj * r * np.cos(psi) * uz
        nx = -adj * np.cos(psi) * ux
        ny = np.sin(psi)
        nz = -adj * np.cos(psi) * uz
        points = np.stack([px, py, pz], axis=-1)
        normals = np.stack([nx, ny, nz], axis=-1)
        normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
        return points, normals

    def generate_mesh(self, mesh_size):
        R = float(self.param["radius_major"])
        r = float(self.param["radius_minor"])
        xsize = self.param["mesh_xsize"] or self.param["xsize"]
        ysize = self.param["mesh_ysize"] or self.param["ysize"]
        half_major = np.arcsin(float(xsize) / 2 / R)
        half_minor = np.arcsin(float(ysize) / 2 / r)
        phi = np.linspace(-half_major, half_major, int(mesh_size[0]))
        psi = np.linspace(-half_minor, half_minor, int(mesh_size[1]))
        pp, ss = np.meshgrid(phi, psi, indexing="ij")
        points, normals = self._surface(pp.ravel(), ss.ravel())
        faces = grid_faces(len(phi), len(psi))
        return points, normals, faces

    def _normals_fd(self, points, delta=1e-6):
        """Finite-difference normals (parity with normal_method='fd')."""
        # Reconstruct the (phi, psi) grid parameterization numerically is
        # unnecessary: use neighboring-point cross products per grid cell.
        nx, ny = (int(v) for v in self.param["mesh_size"])
        pts = points.reshape(nx, ny, 3)
        gx = np.gradient(pts, axis=0)
        gy = np.gradient(pts, axis=1)
        n = np.cross(gx, gy)
        sign = -1.0 if self._major_adjust > 0 else 1.0
        n = sign * n
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        return n.reshape(-1, 3)
