"""Exact curved surfaces as structured point grids (reference CURVEDS).

A CurvedSurface stores an (ni, nj) structured grid of points lying exactly on
the true geometry (circle, tooth flank, ...).  Its one non-obvious operation
is REFINE_SEARCH (CURVEDS.h:37-56): given the corner points of a mesh entity
(edge/face) whose nodes all lie on the surface, average their *grid indices*
and return the stored point there — so bisection nodes land ON the exact
surface instead of at the chord midpoint.  ``plan_surf`` packages this for
:meth:`HexMesh.refine`.

All point->index lookups are vectorized (sorted quantized-key arrays +
searchsorted) — the reference's std::map<COOR,...> per-point lookups do not
scale to the DEHW mesh sizes in Python.

:class:`SparseSurface` is the growing dict-grid variant used for the DEHW
domain-decomposition auxiliary surfaces (wodeAucu/whdeAucu, DEHW.h:41-44),
which are populated incrementally during refinement (UPDA_WODE/UPDA_WHDE,
DEHW.h:1435-1503).
"""

from __future__ import annotations

import numpy as np

from ..utils.quadrature import HEX_EDGES, HEX_FACES
from .hexmesh import HexMesh, _rows_view, coord_keys


class _KeyIndex:
    """Sorted quantized-coordinate key table -> (i, j) grid indices."""

    def __init__(self, coords: np.ndarray, ij: np.ndarray):
        """coords (N,3) float, ij (N,2) int.  First occurrence of a
        duplicate key wins (std::map::emplace semantics, CURVEDS.h:33)."""
        keys = _rows_view(coord_keys(coords))
        uniq, first = np.unique(keys, return_index=True)
        self._keys = uniq
        self._ij = np.asarray(ij, dtype=np.int64)[first]

    def lookup(self, coords: np.ndarray):
        """(found (N,), ij (N,2)) for a flat (N,3) coordinate batch."""
        keys = _rows_view(coord_keys(np.ascontiguousarray(coords)))
        pos = np.searchsorted(self._keys, keys)
        pos_c = np.minimum(pos, self._keys.size - 1)
        found = (self._keys.size > 0) & (self._keys[pos_c] == keys)
        ij = np.where(found[:, None], self._ij[pos_c], 0)
        return found, ij


class CurvedSurface:
    def __init__(self, grid: np.ndarray):
        """grid: (ni, nj, 3) exact surface points."""
        self.grid = np.asarray(grid, dtype=np.float64)
        self._rebuild_map()

    def _rebuild_map(self) -> None:
        ni, nj, _ = self.grid.shape
        ii, jj = np.meshgrid(np.arange(ni), np.arange(nj), indexing="ij")
        self._index = _KeyIndex(
            self.grid.reshape(-1, 3),
            np.stack([ii.ravel(), jj.ravel()], axis=-1),
        )

    # ------------------------------------------------------------------ query
    def contains(self, coords: np.ndarray) -> np.ndarray:
        """Boolean mask: are these points stored surface points?"""
        coords = np.asarray(coords, dtype=np.float64)
        found, _ = self._index.lookup(coords.reshape(-1, 3))
        return found.reshape(coords.shape[:-1])

    def indices(self, coords: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(found mask, (.,2) indices) for a batch of points."""
        coords = np.asarray(coords, dtype=np.float64)
        found, ij = self._index.lookup(coords.reshape(-1, 3))
        return found.reshape(coords.shape[:-1]), ij.reshape(
            coords.shape[:-1] + (2,)
        )

    def refine_search(self, corner_coords: np.ndarray):
        """CURVEDS::REFINE_SEARCH: all corners on surface -> grid point at
        the integer-average index; else None."""
        found, idx = self.indices(corner_coords)
        if not found.all():
            return None
        mean = idx.sum(axis=0) // idx.shape[0]
        return self.grid[int(mean[0]), int(mean[1])]

    # ------------------------------------------------------------- refinement
    def plan_surf(
        self, mesh: HexMesh, elems: np.ndarray, plan: dict | None = None
    ) -> dict:
        """CURVEDS::REFINE (CURVEDS.h:58-101): for each marked element,
        harvest exact-surface midpoints for all 12 edges and 6 faces whose
        nodes all lie on this surface.  Accumulates into/returns ``plan``
        (existing keys are kept — the reference's map::insert semantics)."""
        plan = {} if plan is None else plan
        elems = np.asarray(elems, dtype=np.int64)
        corn = mesh.elem_corn[elems]
        for table in (HEX_EDGES, HEX_FACES):
            nodes = corn[:, table]                     # (E, n_ent, k)
            k = table.shape[1]
            flat_nodes = nodes.reshape(-1, k)
            coords = mesh.coords[flat_nodes]           # (E*n_ent, k, 3)
            found, idx = self.indices(coords)
            all_on = found.all(axis=1)
            for r in np.nonzero(all_on)[0]:
                mean = idx[r].sum(axis=0) // k
                key = tuple(int(v) for v in np.sort(flat_nodes[r]))
                plan.setdefault(key, self.grid[int(mean[0]), int(mean[1])])
        return plan

    def rigid_transform(self, rot: np.ndarray, trans: np.ndarray) -> None:
        """CURVEDS::RIGI_ROTR (CURVEDS.h:103-119)."""
        self.grid = self.grid @ np.asarray(rot, dtype=np.float64).T + np.asarray(
            trans, dtype=np.float64
        )
        self._rebuild_map()

    def copy(self) -> "CurvedSurface":
        return CurvedSurface(self.grid.copy())


class SparseSurface:
    """Growing dict-backed CURVEDS for domain-interface auxiliary surfaces.

    Reference counterpart: the pre-allocated-but-sparsely-filled
    ``wodeAucu``/``whdeAucu`` grids (DEHW.h:41-44,448-453), extended during
    each refinement round by inserting new nodes at the integer-average of
    their defining corners' indices (UPDA_WODE, DEHW.h:1435-1457)."""

    def __init__(self):
        self._pts: dict[tuple[int, int], np.ndarray] = {}
        self._dirty = True
        self._index: _KeyIndex | None = None
        self._by_key: dict[tuple[int, int, int], tuple[int, int]] = {}

    def insert(self, i: int, j: int, coord: np.ndarray) -> None:
        self._pts[(int(i), int(j))] = np.asarray(coord, dtype=np.float64)
        self._dirty = True

    def insert_grid(self, i0: int, di: int, j0: int, dj: int,
                    pts: np.ndarray) -> None:
        """Bulk insert pts (ni, nj, 3) at indices (i0 + a*di, j0 + b*dj)."""
        pts = np.asarray(pts, dtype=np.float64)
        for a in range(pts.shape[0]):
            for b in range(pts.shape[1]):
                self._pts[(i0 + a * di, j0 + b * dj)] = pts[a, b]
        self._dirty = True

    def _rebuild(self) -> None:
        if not self._dirty:
            return
        items = list(self._pts.items())
        coords = np.array([c for _, c in items], dtype=np.float64).reshape(-1, 3)
        ij = np.array([k for k, _ in items], dtype=np.int64).reshape(-1, 2)
        self._index = _KeyIndex(coords, ij)
        keys = coord_keys(coords)
        self._by_key = {}
        for r in range(keys.shape[0]):
            self._by_key.setdefault(
                tuple(int(v) for v in keys[r]), (int(ij[r, 0]), int(ij[r, 1]))
            )
        self._dirty = False

    def contains(self, coords: np.ndarray) -> np.ndarray:
        self._rebuild()
        coords = np.asarray(coords, dtype=np.float64)
        if not self._pts:
            return np.zeros(coords.shape[:-1], dtype=bool)
        found, _ = self._index.lookup(coords.reshape(-1, 3))
        return found.reshape(coords.shape[:-1])

    def update_from_refine(self, mesh: HexMesh, new_nodes) -> None:
        """UPDA_* semantics: for every node created by the last refine whose
        defining corners all lie on this surface, insert it at the
        integer-average index.  ``new_nodes`` = mesh.last_new_nodes."""
        if not self._pts:
            return
        self._rebuild()
        for defs, ids in new_nodes:
            if defs.size == 0:
                continue
            coords = mesh.coords[defs]                 # (E, m, 3)
            E, m, _ = coords.shape
            found, ij = self._index.lookup(coords.reshape(-1, 3))
            found = found.reshape(E, m)
            ij = ij.reshape(E, m, 2)
            ok = found.all(axis=1)
            if not ok.any():
                continue
            mean = ij[ok].sum(axis=1) // m             # (n, 2)
            for row, nid in zip(mean, ids[ok]):
                self._pts[(int(row[0]), int(row[1]))] = mesh.coords[int(nid)]
        self._dirty = True

    def rigid_transform(self, rot: np.ndarray, trans: np.ndarray) -> None:
        rot = np.asarray(rot, dtype=np.float64)
        trans = np.asarray(trans, dtype=np.float64)
        for k in self._pts:
            self._pts[k] = rot @ self._pts[k] + trans
        self._dirty = True

    def copy(self) -> "SparseSurface":
        out = SparseSurface()
        out._pts = {k: v.copy() for k, v in self._pts.items()}
        return out
