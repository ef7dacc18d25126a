"""Octree hexahedral mesh with adaptive refinement and multigrid transfer.

Host-side (NumPy/SciPy, float64) re-design of the reference mesh core
(MULTIGRID.h:10-948): node dedup by coordinate, octree refinement with the 7
bisection patterns, 2:1 gradual-level enforcement, hanging-node patching, and
per-level scalar prolongation operators.  Unlike the reference (std::map-driven,
element-at-a-time), all operations here are batched over elements with NumPy;
entity (edge/face) adjacency is rebuilt on demand by sorting instead of being
maintained incrementally.

The output of :meth:`HexMesh.transfer` is the level structure + scipy CSR
prolongations consumed by the FEM/solver layers; nothing here touches JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

from ..utils.constants import COOR_TOL
from ..utils.quadrature import HEX_EDGES, HEX_FACES
from .templates import LEAF_PATT, PATTERN_ARRAYS, TEMPLATES

_KEY_SCALE = 1.0 / COOR_TOL


def coord_keys(coords: np.ndarray) -> np.ndarray:
    """Quantized integer keys for coordinate dedup (COOR tolerance 1e-10,
    PREP.h:180-185)."""
    return np.round(np.asarray(coords, dtype=np.float64) * _KEY_SCALE).astype(
        np.int64
    )


def _rows_view(a: np.ndarray) -> np.ndarray:
    """View (n,k) int64 rows as a 1-D structured array for unique/searchsorted."""
    a = np.ascontiguousarray(a, dtype=np.int64)
    return a.view([("", a.dtype)] * a.shape[1]).ravel()


class HexMesh:
    """Per-body octree hex mesh (reference class MULTIGRID, mesh part)."""

    def __init__(self) -> None:
        self._coords = np.zeros((0, 3), dtype=np.float64)
        self._coord_map: dict[tuple[int, int, int], int] = {}
        # element columnar storage
        self.elem_corn = np.zeros((0, 8), dtype=np.int64)
        self.elem_level = np.zeros(0, dtype=np.int64)
        self.elem_patt = np.zeros(0, dtype=np.int64)
        self.elem_parent = np.zeros(0, dtype=np.int64)
        self.elem_child0 = np.zeros(0, dtype=np.int64)   # -1 if leaf
        self.elem_nchild = np.zeros(0, dtype=np.int64)
        self.max_level = -1
        # transfer products (filled by .transfer())
        self.level_nodes: list[np.ndarray] = []
        self.node_level: np.ndarray | None = None
        self.node_pos: np.ndarray | None = None     # node -> reordered position
        self.pos_node: np.ndarray | None = None     # position -> node
        self.scal_prol: list[sp.csr_matrix] = []
        self.fino_cono: dict[int, tuple[int, ...]] = {}  # hanging -> parents
        self.cono_fino: dict[tuple[int, ...], int] = {}
        # rigid-coupling mechanism (MULTIGRID.h:53-54; disabled in all
        # reference examples, kept for parity)
        self.coup_nodes: set[int] = set()
        self.coup_reps: int = -1
        # (defs, ids) pairs recorded by the most recent refine() call
        self.last_new_nodes: list[tuple[np.ndarray, np.ndarray]] = []

    # ------------------------------------------------------------------ nodes
    @property
    def n_nodes(self) -> int:
        return self._coords.shape[0]

    @property
    def coords(self) -> np.ndarray:
        return self._coords

    def add_nodes(self, coords: np.ndarray) -> np.ndarray:
        """Vectorized TRY_ADD_NODE (MULTIGRID.h:322-333): dedup by coordinate,
        returning node ids for each input row."""
        coords = np.atleast_2d(np.asarray(coords, dtype=np.float64))
        keys = coord_keys(coords)
        kview = _rows_view(keys)
        uniq, first_idx, inv = np.unique(kview, return_index=True, return_inverse=True)
        uniq_ids = np.empty(uniq.shape[0], dtype=np.int64)
        fresh_u = []
        fresh_keys = []
        get = self._coord_map.get
        for u, key in enumerate(map(tuple, keys[first_idx].tolist())):
            hit = get(key)
            if hit is None:
                fresh_u.append(u)
                fresh_keys.append(key)
            else:
                uniq_ids[u] = hit
        if fresh_u:
            fresh_u = np.array(fresh_u, dtype=np.int64)
            base = self._coords.shape[0]
            self._coords = np.concatenate(
                [self._coords, coords[first_idx[fresh_u]]], axis=0
            )
            ids = base + np.arange(fresh_u.size, dtype=np.int64)
            self._coord_map.update(zip(fresh_keys, ids.tolist()))
            uniq_ids[fresh_u] = ids
        return uniq_ids[inv]

    def set_coords(self, node_ids: np.ndarray, coords: np.ndarray) -> None:
        """Move nodes (hanging-node PATCH); keeps the dedup map consistent."""
        node_ids = np.asarray(node_ids, dtype=np.int64)
        old_keys = coord_keys(self._coords[node_ids])
        for row in old_keys:
            self._coord_map.pop(tuple(int(v) for v in row), None)
        self._coords[node_ids] = coords
        new_keys = coord_keys(coords)
        for nid, row in zip(node_ids, new_keys):
            self._coord_map[tuple(int(v) for v in row)] = int(nid)

    def rigid_transform(self, rot: np.ndarray, trans: np.ndarray) -> None:
        """RIGI_ROTR (MULTIGRID.h:710-720): rotate+translate all nodes."""
        self.transform(
            lambda c: c @ np.asarray(rot, dtype=np.float64).T
            + np.asarray(trans, dtype=np.float64)
        )

    def transform(self, fn) -> None:
        """Apply an arbitrary coordinate map to all nodes (COOR_ADJU-style,
        e.g. the BEAM pre-twist, examples/BEAM.h:89-99)."""
        self._coords = np.asarray(fn(self._coords), dtype=np.float64)
        self._coord_map = {
            tuple(int(v) for v in row): i
            for i, row in enumerate(coord_keys(self._coords))
        }

    # --------------------------------------------------------------- elements
    @property
    def n_elems(self) -> int:
        return self.elem_corn.shape[0]

    def add_elements(
        self,
        corn: np.ndarray,
        level: np.ndarray | int,
        parent: np.ndarray | int = -1,
    ) -> np.ndarray:
        corn = np.atleast_2d(np.asarray(corn, dtype=np.int64))
        n = corn.shape[0]
        level = np.broadcast_to(np.asarray(level, dtype=np.int64), (n,))
        parent = np.broadcast_to(np.asarray(parent, dtype=np.int64), (n,))
        base = self.n_elems
        self.elem_corn = np.concatenate([self.elem_corn, corn])
        self.elem_level = np.concatenate([self.elem_level, level])
        self.elem_patt = np.concatenate(
            [self.elem_patt, np.full(n, LEAF_PATT, dtype=np.int64)]
        )
        self.elem_parent = np.concatenate([self.elem_parent, parent])
        self.elem_child0 = np.concatenate(
            [self.elem_child0, np.full(n, -1, dtype=np.int64)]
        )
        self.elem_nchild = np.concatenate(
            [self.elem_nchild, np.zeros(n, dtype=np.int64)]
        )
        if n:
            self.max_level = max(self.max_level, int(level.max()))
        return np.arange(base, base + n, dtype=np.int64)

    def leaf_mask(self) -> np.ndarray:
        return self.elem_nchild == 0

    def leaf_elems(self) -> np.ndarray:
        return np.nonzero(self.leaf_mask())[0]

    def add_box_grid(
        self,
        origin: np.ndarray,
        spacing: np.ndarray,
        divisions: tuple[int, int, int],
        coords_fn=None,
    ) -> np.ndarray:
        """Structured (nx,ny,nz)-cell grid of level-0 hexes.

        ``coords_fn(ijk_float_coords) -> coords`` may map the regular lattice
        onto a curved geometry (e.g. cylinder shells).  Returns element ids.
        """
        nx, ny, nz = divisions
        ii, jj, kk = np.meshgrid(
            np.arange(nx + 1), np.arange(ny + 1), np.arange(nz + 1), indexing="ij"
        )
        lattice = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3).astype(np.float64)
        coords = np.asarray(origin, dtype=np.float64) + lattice * np.asarray(
            spacing, dtype=np.float64
        )
        if coords_fn is not None:
            coords = coords_fn(lattice)
        ids = self.add_nodes(coords).reshape(nx + 1, ny + 1, nz + 1)
        ci, cj, ck = np.meshgrid(
            np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
        )
        ci, cj, ck = ci.ravel(), cj.ravel(), ck.ravel()
        corn = np.stack(
            [
                ids[ci, cj, ck],
                ids[ci + 1, cj, ck],
                ids[ci + 1, cj + 1, ck],
                ids[ci, cj + 1, ck],
                ids[ci, cj, ck + 1],
                ids[ci + 1, cj, ck + 1],
                ids[ci + 1, cj + 1, ck + 1],
                ids[ci, cj + 1, ck + 1],
            ],
            axis=-1,
        )
        return self.add_elements(corn, level=0)

    # ------------------------------------------------------- entity adjacency
    def _entity_adjacency(self, kind: str):
        """Sorted-entity -> element incidence over ALL elements.

        Returns (unique_keys_view, group_starts, elem_of_entity) such that
        entities equal to unique key u belong to elements
        ``elem_of_entity[group_starts[u]:group_starts[u+1]]``.
        """
        table = HEX_EDGES if kind == "edge" else HEX_FACES
        k = table.shape[1]
        ent = self.elem_corn[:, table]           # (E, n_ent, k)
        ent = np.sort(ent.reshape(-1, k), axis=1)
        owners = np.repeat(np.arange(self.n_elems), table.shape[0])
        view = _rows_view(ent)
        # the stable lexicographic order of the rows (argsort of ``view``)
        order = np.lexsort(ent.T[::-1])
        sview = view[order]
        sowners = owners[order]
        uniq_mask = np.ones(sview.shape[0], dtype=bool)
        uniq_mask[1:] = sview[1:] != sview[:-1]
        starts = np.nonzero(uniq_mask)[0]
        uniq = sview[starts]
        starts = np.append(starts, sview.shape[0])
        return uniq, starts, sowners

    # ------------------------------------------------------------- refinement
    def grle_check(self, spli: set[int]) -> set[int]:
        """2:1 gradual-level rule (MULTIGRID.h:547-678): transitively add leaf
        neighbors that share a to-be-hanging parent edge/face; forced elements
        get full pattern 0."""
        if not spli:
            return spli
        adjacency = {
            "edge": (HEX_EDGES, *self._entity_adjacency("edge")),
            "face": (HEX_FACES, *self._entity_adjacency("face")),
        }
        leaf = self.leaf_mask()
        spli = set(int(x) for x in spli)
        marked = np.zeros(self.n_elems, dtype=bool)
        marked[list(spli)] = True
        frontier = np.array(sorted(spli), dtype=np.int64)
        while frontier.size:
            # every element sharing a parent edge/face that one of the
            # frontier's elements touches, per (parent pattern, ordinal)
            fr = frontier[self.elem_parent[frontier] >= 0]
            pids = self.elem_parent[fr]
            ords = fr - self.elem_child0[pids]
            patts = self.elem_patt[pids]
            found = [np.zeros(0, dtype=np.int64)]
            for p, o in set(zip(patts.tolist(), ords.tolist())):
                t = TEMPLATES[p]
                pcorn = self.elem_corn[pids[(patts == p) & (ords == o)]]
                for kind, touched in (("edge", t.touched_edges[o]),
                                      ("face", t.touched_faces[o])):
                    if not touched:
                        continue
                    table, uniq, starts, elems = adjacency[kind]
                    keys = np.sort(pcorn[:, table[np.array(touched)]], axis=2)
                    pos = np.searchsorted(
                        uniq, _rows_view(keys.reshape(-1, keys.shape[2])))
                    lo, n = starts[pos], starts[pos + 1] - starts[pos]
                    first = np.cumsum(n) - n
                    found.append(elems[np.repeat(lo - first, n)
                                       + np.arange(n.sum())])
            nb = np.unique(np.concatenate(found))
            added = nb[leaf[nb] & ~marked[nb]]
            self.elem_patt[added] = 0
            marked[added] = True
            spli |= set(added.tolist())
            frontier = added
        return spli

    def refine(
        self,
        spli: set[int] | np.ndarray,
        spli_flag: dict[int, set[int]] | None = None,
        plan_surf: dict[tuple[int, ...], np.ndarray] | None = None,
        mid_fn=None,
    ) -> set[int]:
        """REFINE (MULTIGRID.h:375-545): split marked elements per their
        ``elem_patt`` pattern; bisection nodes land on ``plan_surf`` (exact
        curved surface) when their defining-corner key is present, else at
        ``mid_fn(corner_coords (E,m,3)) -> (E,3)`` (the reference's
        COOR_AVER hooks — e.g. DEHW's cylindrical/toroidal averaging,
        DEHW.h:62-138), defaulting to the plain corner average.  Returns the
        children selected by ``spli_flag``; records every created node in
        ``self.last_new_nodes`` as (sorted defining-corner ids (E,m),
        node ids (E,)) for interface-surface bookkeeping (UPDA_*)."""
        spli_flag = spli_flag or {}
        plan_surf = plan_surf or {}
        spli = self.grle_check(set(int(x) for x in np.asarray(list(spli))))
        result: set[int] = set()
        self.last_new_nodes: list[tuple[np.ndarray, np.ndarray]] = []
        if not spli:
            return result
        spli_arr = np.array(sorted(spli), dtype=np.int64)
        patts = self.elem_patt[spli_arr]
        for s in np.unique(patts):
            s = int(s)
            if s == LEAF_PATT:
                raise ValueError("element marked for refinement has leaf pattern")
            els = spli_arr[patts == s]
            pa = PATTERN_ARRAYS[s]
            corn = self.elem_corn[els]                     # (E,8)
            n_new = len(pa.new_corners_list)
            new_ids = np.zeros((els.size, n_new), dtype=np.int64)
            for j, defin in enumerate(pa.new_corners_list):
                defs = np.sort(corn[:, defin], axis=1)     # (E,m) sorted ids
                if mid_fn is not None:
                    coords = np.asarray(mid_fn(self._coords[defs]))
                else:
                    coords = self._coords[defs].mean(axis=1)
                if plan_surf:
                    for r in range(els.size):
                        hit = plan_surf.get(tuple(int(v) for v in defs[r]))
                        if hit is not None:
                            coords[r] = hit
                new_ids[:, j] = self.add_nodes(coords)
                self.last_new_nodes.append((defs, new_ids[:, j].copy()))
            # children
            nc = pa.n_children
            ccorn = np.zeros((els.size, nc, 8), dtype=np.int64)
            for ci in range(nc):
                for k in range(8):
                    src = pa.child_src_index[ci, k]
                    if pa.child_src_is_corner[ci, k]:
                        ccorn[:, ci, k] = corn[:, src]
                    else:
                        ccorn[:, ci, k] = new_ids[:, src]
            child_ids = self.add_elements(
                ccorn.reshape(-1, 8),
                level=np.repeat(self.elem_level[els] + 1, nc),
                parent=np.repeat(els, nc),
            )
            self.elem_child0[els] = child_ids[::nc]
            self.elem_nchild[els] = nc
            for row, eid in enumerate(els if spli_flag else ()):
                flagged = spli_flag.get(int(eid))
                if flagged:
                    for ordinal in flagged:
                        result.add(int(child_ids[row * nc + ordinal]))
        return result

    def refine_uniform(self, rounds: int, pattern: int = 0) -> None:
        """Refine every leaf ``rounds`` times with the given pattern."""
        for _ in range(rounds):
            leaves = self.leaf_elems()
            self.elem_patt[leaves] = pattern
            self.refine(set(int(x) for x in leaves))

    # --------------------------------------------------------------- transfer
    def transfer(self) -> None:
        """TRANSFER + PATCH (MULTIGRID.h:722-948): classify bisection nodes by
        level (hanging nodes pinned to artificial level max_level+1), snap
        hanging nodes onto their parent average, and build per-level scalar
        prolongations ``scal_prol[l]: cum_n(l) -> cum_n(l+1)`` with structure
        [I; averaging rows]."""
        L = self.max_level
        # entity -> has-leaf-sharer, over all elements
        e_uniq, e_starts, e_elems = self._entity_adjacency("edge")
        f_uniq, f_starts, f_elems = self._entity_adjacency("face")
        leaf = self.leaf_mask()

        def _has_leaf_sharer(uniq, starts, elems):
            out = np.zeros(uniq.shape[0], dtype=bool)
            leaf_flags = leaf[elems]
            # segment any() via cumulative sums
            cs = np.concatenate([[0], np.cumsum(leaf_flags)])
            out = cs[starts[1:]] - cs[starts[:-1]] > 0
            return out

        e_hasleaf = _has_leaf_sharer(e_uniq, e_starts, e_elems)
        f_hasleaf = _has_leaf_sharer(f_uniq, f_starts, f_elems)

        # node -> level classification (ininTran[l]), one template node of
        # every refined element at a time, in element order: a node met again
        # through a shared edge or face keeps the parents of its last visit
        n_max = 8
        occ_eid, occ_j, occ_node, occ_target, occ_par, occ_k = (
            [], [], [], [], [], [])
        refined = np.nonzero(~leaf)[0]
        patts = self.elem_patt[refined]
        for s in np.unique(patts):
            els = refined[patts == s]
            t = TEMPLATES[int(s)]
            lvl = self.elem_level[els]
            corn = self.elem_corn[els]
            child0 = self.elem_child0[els]
            for j, nn in enumerate(t.new_nodes):
                parents = np.sort(corn[:, list(nn.corners)], axis=1)
                if nn.kind == "center":
                    target = lvl
                else:
                    uniq, hasleaf = (
                        (e_uniq, e_hasleaf) if nn.kind == "edge"
                        else (f_uniq, f_hasleaf)
                    )
                    u = np.searchsorted(uniq, _rows_view(parents))
                    target = np.where(hasleaf[u], L, lvl)
                par = np.full((els.size, n_max), -1, dtype=np.int64)
                par[:, : parents.shape[1]] = parents
                occ_eid.append(els)
                occ_j.append(np.full(els.size, j, dtype=np.int64))
                occ_node.append(
                    self.elem_corn[child0 + nn.child, nn.child_corner])
                occ_target.append(target)
                occ_par.append(par)
                occ_k.append(np.full(els.size, parents.shape[1], np.int64))
        if occ_eid:
            order = np.lexsort(
                (np.concatenate(occ_j), np.concatenate(occ_eid)))
            occ_node = np.concatenate(occ_node)[order]
            occ_target = np.concatenate(occ_target)[order]
            occ_par = np.concatenate(occ_par)[order]
            occ_k = np.concatenate(occ_k)[order]
        else:
            occ_node = occ_target = occ_k = np.zeros(0, dtype=np.int64)
            occ_par = np.zeros((0, n_max), dtype=np.int64)

        # inin[l]: (nodes ascending, parents padded with -1, parent counts)
        inin = []
        for lv in range(L + 1):
            sel = np.nonzero(occ_target == lv)[0]
            rev = occ_node[sel][::-1]
            nodes, first = np.unique(rev, return_index=True)
            last = sel[::-1][first]
            inin.append((nodes, occ_par[last], occ_k[last]))
        node_level_set = [np.unique(self.elem_corn[self.elem_level == 0])]
        node_level_set += [inin[lv][0] for lv in range(L + 1)]

        # PATCH: snap hanging nodes to parent average (MULTIGRID.h:722-754)
        self.fino_cono = {}
        self.cono_fino = {}
        if L >= 0 and inin[L][0].size:
            nodes, par, k = inin[L]
            coords = np.empty((nodes.size, 3))
            for m in np.unique(k):
                sel = k == m
                coords[sel] = self._coords[par[sel, :m]].mean(axis=1)
            self.set_coords(nodes, coords)
            tuples = [tuple(p[:m]) for p, m in zip(par.tolist(), k.tolist())]
            self.fino_cono = dict(zip(nodes.tolist(), tuples))
            self.cono_fino = dict(zip(tuples, nodes.tolist()))

        # level ordering (coupling nodes -> artificial level; rep -> level 0)
        coup = np.array(sorted(self.coup_nodes), dtype=np.int64)
        self.level_nodes = []
        for lv in range(L + 2):
            sel = node_level_set[lv].astype(np.int64)
            drop = (sel == self.coup_reps) | np.isin(sel, coup)
            self.level_nodes.append(sel[~drop])
        if self.coup_reps >= 0:
            self.level_nodes[0] = np.sort(
                np.append(self.level_nodes[0], self.coup_reps)
            )
        if self.coup_nodes:
            self.level_nodes[L + 1] = np.sort(
                np.concatenate(
                    [self.level_nodes[L + 1], np.array(sorted(self.coup_nodes))]
                )
            )

        n_total = self.n_nodes
        self.node_level = np.zeros(n_total, dtype=np.int64)
        self.node_pos = np.zeros(n_total, dtype=np.int64)
        self.pos_node = np.zeros(n_total, dtype=np.int64)
        acc = 0
        for lv, nodes in enumerate(self.level_nodes):
            self.node_level[nodes] = lv
            self.node_pos[nodes] = acc + np.arange(nodes.size)
            self.pos_node[acc : acc + nodes.size] = nodes
            acc += nodes.size
        assert acc == n_total, "every node must be classified into one level"

        # scalar prolongations: [I; averaging rows], a parent in the coupling
        # set standing for its representative
        self.scal_prol = []
        cum = np.cumsum([0] + [nodes.size for nodes in self.level_nodes])
        for lv in range(L + 1):
            n_rows = int(cum[lv + 2])
            n_cols = int(cum[lv + 1])
            nodes, par, k = inin[lv]
            keep = ~np.isin(nodes, coup)
            nodes, par, k = nodes[keep], par[keep], k[keep]
            valid = np.arange(n_max)[None, :] < k[:, None]
            if coup.size:
                par = np.where(np.isin(par, coup), self.coup_reps, par)
            rows = [np.arange(n_cols), np.repeat(self.node_pos[nodes], k)]
            cols = [np.arange(n_cols), self.node_pos[par[valid]]]
            vals = [np.ones(n_cols), np.repeat(1.0 / k, k)]
            if lv == L:
                for n in self.coup_nodes:
                    rows.append(np.array([self.node_pos[n]]))
                    cols.append(np.array([self.node_pos[self.coup_reps]]))
                    vals.append(np.ones(1))
            P = sp.csr_matrix(
                (np.concatenate(vals),
                 (np.concatenate(rows), np.concatenate(cols))),
                shape=(n_rows, n_cols), dtype=np.float64,
            )
            self.scal_prol.append(P)

    # ----------------------------------------------------------------- output
    def leaf_volume(self) -> float:
        """GET_VOLUME (MULTIGRID.h:1041-1082): 27-pt Gauss volume of leaves."""
        from ..fem.elasticity import element_volumes

        leaves = self.leaf_elems()
        return float(element_volumes(self._coords[self.elem_corn[leaves]]).sum())
