"""Contact-zone adaptive mesh refinement (CSEARCH::ADAPTIVE_REFINE).

Re-design of CSEARCH.h:839-956: harvest candidate faces of both bodies on
their exact surfaces, bucket-sort in user curvilinear coordinates, clip every
candidate pair, and mark the nodes of pairs whose minimum initial gap is
within ``dist_crit``; elements of **both** bodies at level ``level`` touching
marked nodes are then fully refined (pattern 0) with bisection nodes snapped
onto the exact surfaces.  Returns whether anything was refined
(isnoRefi flag) so callers can run shrinking-criterion rounds
(DEHW.h:1505-1571: distCrit = {65,45,25} um).
"""

from __future__ import annotations

import numpy as np

from ..mesh.curveds import CurvedSurface
from ..mesh.hexmesh import HexMesh
from .search import (
    bucket_pairs,
    face_curvilinear_boxes,
    face_curvilinear_centroids,
    mortar_integrate,
    surface_faces,
)


def adaptive_refine(
    mast_mesh: HexMesh,
    slav_mesh: HexMesh,
    mast_surf: CurvedSurface,
    slav_surf: CurvedSurface,
    level: int,
    dist_crit: float,
    buck_divisions: tuple[int, int],
    cart_curv,
) -> bool:
    mast_faces = surface_faces(mast_mesh, mast_surf.contains)
    slav_faces = surface_faces(slav_mesh, slav_surf.contains)
    if mast_faces.size == 0 or slav_faces.size == 0:
        return False

    mast_uv = face_curvilinear_centroids(mast_mesh, mast_faces, cart_curv)
    slav_uv = face_curvilinear_centroids(slav_mesh, slav_faces, cart_curv)
    mast_box = face_curvilinear_boxes(mast_mesh, mast_faces, cart_curv)
    pm, ps = bucket_pairs(
        mast_uv, slav_uv, buck_divisions, mast_uv_box=mast_box
    )
    if pm.size == 0:
        return False

    pair_idx, _, _, _, _, gap = mortar_integrate(
        mast_mesh.coords[mast_faces[pm]], slav_mesh.coords[slav_faces[ps]]
    )
    if pair_idx.size == 0:
        return False
    n_pairs = pm.size
    pair_min = np.full(n_pairs, np.inf)
    np.minimum.at(pair_min, pair_idx, gap)
    close = pair_min <= dist_crit
    if not close.any():
        return False

    spli_nodes = (
        np.unique(mast_faces[pm[close]].ravel()),
        np.unique(slav_faces[ps[close]].ravel()),
    )

    refined = False
    for mesh, surf, nodes in (
        (mast_mesh, mast_surf, spli_nodes[0]),
        (slav_mesh, slav_surf, spli_nodes[1]),
    ):
        leaves = mesh.leaf_elems()
        lvl_ok = mesh.elem_level[leaves] == level
        cand = leaves[lvl_ok]
        if cand.size == 0:
            continue
        touch = np.isin(mesh.elem_corn[cand], nodes).any(axis=1)
        els = cand[touch]
        if els.size == 0:
            continue
        mesh.elem_patt[els] = 0
        spli = mesh.grle_check(set(int(x) for x in els))
        plan = surf.plan_surf(mesh, np.array(sorted(spli)))
        mesh.refine(spli, plan_surf=plan)
        refined = True
    return refined
