"""Mortar contact geometry: Newton projections and polygon clipping.

Host-side (NumPy float64, fully vectorized over face pairs) re-design of the
reference local search (CSEARCH.h:232-459) and mortar segmentation
(CSEARCH.h:461-775):

  * closest-point projection of a point onto a bilinear quad (PROJECT_STM);
  * projection of a master surface point onto the slave face along the master
    normal (PROJECT_MTS);
  * clipping the slave face (projected into the master's natural plane)
    against the master square, angular sort, fan triangulation about the
    polygon centroid, 4-pt Gauss per triangle (SI_SUB);
  * emission of mortar integration points with basis triad, gap, weight
    (SEGMENT_INTERSECT).

Robustness constants follow the reference epsilon conventions
(CSEARCH.h:12 miniArea=1e-12, 1e-10 dedup).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.quadrature import QUAD_CORNERS, TRI_QUAD

MINI_AREA = 1.0e-12
DEDUP_TOL = 1.0e-10
# how far outside the master square [-1, 1]^2 a clipping vertex may lie
CLIP_TOL = 1.0e-9
NEWTON_ITERS = 60

# bilinear coefficients: x(xi,eta) = c0 + c1 xi + c2 eta + c3 xi eta
_COEF = np.stack(
    [
        0.25 * np.ones(4),
        0.25 * QUAD_CORNERS[:, 0],
        0.25 * QUAD_CORNERS[:, 1],
        0.25 * QUAD_CORNERS[:, 0] * QUAD_CORNERS[:, 1],
    ]
)  # (4 coef, 4 corner)


def bilinear_coeffs(corners: np.ndarray) -> np.ndarray:
    """corners (...,4,3) -> coefficients (...,4,3): [c0,c1,c2,c3]."""
    return np.einsum("ca,...ad->...cd", _COEF, corners)


def quad4_eval(coef: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """Evaluate bilinear map: coef (...,4,3), xi (...,2) -> (...,3)."""
    c0, c1, c2, c3 = coef[..., 0, :], coef[..., 1, :], coef[..., 2, :], coef[..., 3, :]
    return (
        c0
        + c1 * xi[..., 0:1]
        + c2 * xi[..., 1:2]
        + c3 * (xi[..., 0:1] * xi[..., 1:2])
    )


def quad4_tangents(coef: np.ndarray, xi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    c1, c2, c3 = coef[..., 1, :], coef[..., 2, :], coef[..., 3, :]
    return c1 + c3 * xi[..., 1:2], c2 + c3 * xi[..., 0:1]


def _flat(a: np.ndarray, lead: tuple, tail: tuple) -> np.ndarray:
    return np.broadcast_to(a, lead + tail).reshape((-1,) + tail)


def project_points_to_quads(
    corners: np.ndarray, points: np.ndarray, xi0: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Closest-point (orthogonal) projection, batched Newton
    (PROJECT_STM_SUB, CSEARCH.h:309-398).

    corners (...,4,3), points (...,3) -> (xi (...,2), gap (...,)).
    gap = n . (p - x(xi)) with n = normalized t1 x t2.

    Each Newton step updates only the points not yet converged: a point
    that met the criterion keeps its xi, and would meet it again."""
    coef = bilinear_coeffs(corners)
    lead = np.broadcast_shapes(coef.shape[:-2], points.shape[:-1])
    coef = _flat(coef, lead, (4, 3))
    pts = _flat(points, lead, (3,))
    xi = (np.zeros((pts.shape[0], 2)) if xi0 is None
          else _flat(xi0, lead, (2,)).copy())
    act = np.arange(pts.shape[0])
    for _ in range(NEWTON_ITERS):
        cf, xa = coef[act], xi[act]
        x = quad4_eval(cf, xa)
        t1, t2 = quad4_tangents(cf, xa)
        dvec = x - pts[act]
        r1 = (dvec * t1).sum(-1)
        r2 = (dvec * t2).sum(-1)
        c3 = cf[..., 3, :]
        dc3 = (dvec * c3).sum(-1)
        J11 = (t1 * t1).sum(-1)
        J12 = (t1 * t2).sum(-1) + dc3
        J22 = (t2 * t2).sum(-1)
        det = J11 * J22 - J12 * J12
        det = np.where(np.abs(det) < 1e-300, 1.0, det)
        dxi = -np.stack(
            [(J22 * r1 - J12 * r2) / det, (J11 * r2 - J12 * r1) / det], axis=-1
        )
        done = (np.linalg.norm(dxi, axis=-1) < 1e-12) & (
            np.hypot(r1, r2) < 1e-15
        )
        xi[act] = np.where(done[..., None], xa, xa + dxi)
        act = act[~done]
        if act.size == 0:
            break
    x = quad4_eval(coef, xi)
    t1, t2 = quad4_tangents(coef, xi)
    n = np.cross(t1, t2)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    gap = ((pts - x) * n).sum(-1)
    return xi.reshape(lead + (2,)), gap.reshape(lead)


def project_normal_to_quads(
    tang1: np.ndarray,
    tang2: np.ndarray,
    points: np.ndarray,
    slav_corners: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Project master points onto slave faces along the master normal
    (PROJECT_MTS, CSEARCH.h:232-307): find slave (xi,eta) with
    (x_s - p) perpendicular to both master tangents.

    tang1/tang2/points (...,3); slav_corners (...,4,3) ->
    (slave xi (...,2), gap (...,) = n.(x_s - p)).  Newton steps update
    only the points not yet converged, as in ``project_points_to_quads``.
    """
    coef = bilinear_coeffs(slav_corners)
    lead = np.broadcast_shapes(tang1.shape[:-1], tang2.shape[:-1],
                               points.shape[:-1], coef.shape[:-2])
    coef = _flat(coef, lead, (4, 3))
    tang1, tang2, pts = (_flat(v, lead, (3,)) for v in (tang1, tang2, points))
    xi = np.zeros((pts.shape[0], 2))
    act = np.arange(pts.shape[0])
    for _ in range(NEWTON_ITERS):
        cf, xa, ta1, ta2 = coef[act], xi[act], tang1[act], tang2[act]
        c3 = cf[..., 3, :]
        x = quad4_eval(cf, xa)
        dvec = x - pts[act]
        r1 = (dvec * ta1).sum(-1)
        r2 = (dvec * ta2).sum(-1)
        xs1 = cf[..., 1, :] + c3 * xa[..., 1:2]   # dx_s/dxi
        xs2 = cf[..., 2, :] + c3 * xa[..., 0:1]   # dx_s/deta
        J11 = (xs1 * ta1).sum(-1)
        J12 = (xs2 * ta1).sum(-1)
        J21 = (xs1 * ta2).sum(-1)
        J22 = (xs2 * ta2).sum(-1)
        det = J11 * J22 - J12 * J21
        det = np.where(np.abs(det) < 1e-300, 1.0, det)
        dxi = -np.stack(
            [(J22 * r1 - J12 * r2) / det, (J11 * r2 - J21 * r1) / det], axis=-1
        )
        done = (np.linalg.norm(dxi, axis=-1) < 1e-14) & (
            np.hypot(r1, r2) < 1e-15
        )
        xi[act] = np.where(done[..., None], xa, xa + dxi)
        act = act[~done]
        if act.size == 0:
            break
    n = np.cross(tang1, tang2)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    x = quad4_eval(coef, xi)
    gap = ((x - pts) * n).sum(-1)
    return xi.reshape(lead + (2,)), gap.reshape(lead)


# ------------------------------------------------------------------- clipping
_SQUARE = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
MAX_CLIP_VERTS = 16          # intersection of two convex quads has <= 8; slack
MAX_TRIS = MAX_CLIP_VERTS


def _points_in_quad(pts: np.ndarray, quad: np.ndarray) -> np.ndarray:
    """IN_CQUAD_2D (CSEARCH.h:599-612): point inside (possibly non-convex
    traversal) quad via triangle-area sum.  pts (...,2), quad (...,4,2)."""
    total = _tri_area(quad[..., 0, :], quad[..., 1, :], quad[..., 2, :]) + _tri_area(
        quad[..., 2, :], quad[..., 3, :], quad[..., 0, :]
    )
    s = np.zeros(pts.shape[:-1])
    for i in range(4):
        s = s + _tri_area(pts, quad[..., i, :], quad[..., (i + 1) % 4, :])
    return s <= (1.0 + 1.0e-12) * total


def _tri_area(p0, p1, p2) -> np.ndarray:
    v0 = p1 - p0
    v1 = p2 - p0
    return np.abs(v0[..., 0] * v1[..., 1] - v0[..., 1] * v1[..., 0]) / 2.0


def _segment_intersections(a0, a1, b0, b1):
    """LINE_INTERSECT_2D (CSEARCH.h:518-597), batched.

    Segments a0-a1 vs b0-b1, all (...,2).  Returns (pts (...,2,2),
    valid (...,2)): up to two intersection points (two for collinear
    overlap).
    """
    shape = a0.shape[:-1]
    out = np.zeros(shape + (2, 2))
    valid = np.zeros(shape + (2,), dtype=bool)

    # bounding box + straddle test (IS_CROSS_2D)
    bb = ~(
        (np.maximum(a0[..., 0], a1[..., 0]) < np.minimum(b0[..., 0], b1[..., 0]))
        | (np.maximum(a0[..., 1], a1[..., 1]) < np.minimum(b0[..., 1], b1[..., 1]))
        | (np.minimum(a0[..., 0], a1[..., 0]) > np.maximum(b0[..., 0], b1[..., 0]))
        | (np.minimum(a0[..., 1], a1[..., 1]) > np.maximum(b0[..., 1], b1[..., 1]))
    )

    def cross2(u, v):
        return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]

    d1 = cross2(b0 - a0, b0 - b1) * cross2(b0 - a1, b0 - b1)
    d2 = cross2(a0 - b0, a0 - a1) * cross2(a0 - b1, a0 - a1)
    crossing = bb & (d1 <= 0) & (d2 <= 0)

    area2 = _tri_area(b0, a0, a1)
    area3 = _tri_area(b1, a0, a1)
    collinear = crossing & (area2 < MINI_AREA) & (area3 < MINI_AREA)
    endpoint0 = crossing & ~collinear & (area2 < MINI_AREA)
    endpoint1 = crossing & ~collinear & (area3 < MINI_AREA) & ~endpoint0
    generic = crossing & ~collinear & ~endpoint0 & ~endpoint1

    # generic: weighted point between b0, b1 with factor area2/area3
    with np.errstate(divide="ignore", invalid="ignore"):
        t = area2 / np.where(area3 == 0.0, 1.0, area3)
        pt = (b0 + t[..., None] * b1) / (1.0 + t[..., None])
    out[..., 0, :] = np.where(generic[..., None], pt, out[..., 0, :])
    valid[..., 0] |= generic

    # endpoint cases
    out[..., 0, :] = np.where(endpoint0[..., None], b0, out[..., 0, :])
    valid[..., 0] |= endpoint0
    out[..., 0, :] = np.where(endpoint1[..., None], b1, out[..., 0, :])
    valid[..., 0] |= endpoint1

    # collinear overlap: order along dominant axis, take [max(starts),
    # min(ends)]
    use_x = np.abs(a0[..., 0] - a1[..., 0]) > DEDUP_TOL
    axis = np.where(use_x, 0, 1)

    def sort_pair(p, q):
        key_p = np.take_along_axis(p, axis[..., None], -1)[..., 0]
        key_q = np.take_along_axis(q, axis[..., None], -1)[..., 0]
        swap = key_p > key_q
        lo = np.where(swap[..., None], q, p)
        hi = np.where(swap[..., None], p, q)
        return lo, hi

    alo, ahi = sort_pair(a0, a1)
    blo, bhi = sort_pair(b0, b1)
    klo_a = np.take_along_axis(alo, axis[..., None], -1)[..., 0]
    klo_b = np.take_along_axis(blo, axis[..., None], -1)[..., 0]
    khi_a = np.take_along_axis(ahi, axis[..., None], -1)[..., 0]
    khi_b = np.take_along_axis(bhi, axis[..., None], -1)[..., 0]
    start = np.where((klo_a < klo_b)[..., None], blo, alo)
    end = np.where((khi_a > khi_b)[..., None], bhi, ahi)
    same = (
        np.abs(
            np.take_along_axis(start, axis[..., None], -1)[..., 0]
            - np.take_along_axis(end, axis[..., None], -1)[..., 0]
        )
        < DEDUP_TOL
    )
    out[..., 0, :] = np.where(collinear[..., None], start, out[..., 0, :])
    valid[..., 0] |= collinear
    out[..., 1, :] = np.where((collinear & ~same)[..., None], end, out[..., 1, :])
    valid[..., 1] |= collinear & ~same
    return out, valid


def clip_pairs(slav_proj: np.ndarray):
    """SI_SUB clipping core, batched over P pairs.

    slav_proj (P,4,2): slave corners projected into the master natural plane.
    Returns (tri_xi (P, MAX_TRIS, 3, 2) triangle vertices incl. centroid,
    tri_valid (P, MAX_TRIS) bool, area (P,)).
    """
    P = slav_proj.shape[0]
    mast = np.broadcast_to(_SQUARE, (P, 4, 2))
    cand = np.zeros((P, 8 + 32, 2))
    cval = np.zeros((P, 8 + 32), dtype=bool)
    # vertices inside the other quad
    for i in range(4):
        cand[:, i] = slav_proj[:, i]
        cval[:, i] = _points_in_quad(slav_proj[:, i], mast)
        cand[:, 4 + i] = mast[:, i]
        cval[:, 4 + i] = _points_in_quad(mast[:, i], slav_proj)
    # 16 edge pairs x up to 2 points
    idx = 8
    for i in range(4):
        for j in range(4):
            pts, val = _segment_intersections(
                mast[:, i],
                mast[:, (i + 1) % 4],
                slav_proj[:, j],
                slav_proj[:, (j + 1) % 4],
            )
            cand[:, idx : idx + 2] = pts
            cval[:, idx : idx + 2] = val
            idx += 2

    # every vertex of the intersection lies in the master square; a point
    # outside it is an artefact of two nearly collinear edges, where the
    # far end of a long slave edge passes for an endpoint on the master's
    # (a slave quad ~100 faces long, whose projected corners carry
    # 1e-12 of rounding: BLOCK's ring load at glob_leve=4)
    cval &= (np.abs(cand) <= 1.0 + CLIP_TOL).all(axis=-1)

    # dedup on 1e-10 grid, compact valid to front
    keys = np.round(cand / DEDUP_TOL).astype(np.int64)
    keys[~cval] = np.iinfo(np.int64).max  # invalid sorts last
    order = np.lexsort((keys[..., 1], keys[..., 0]), axis=-1)
    skeys = np.take_along_axis(keys, order[..., None], axis=1)
    scand = np.take_along_axis(cand, order[..., None], axis=1)
    sval = np.take_along_axis(cval, order, axis=1)
    dup = np.zeros_like(sval)
    dup[:, 1:] = (skeys[:, 1:] == skeys[:, :-1]).all(-1)
    keep = sval & ~dup
    counts = keep.sum(axis=1)

    # compact kept vertices to the front
    comp_order = np.argsort(~keep, axis=1, kind="stable")
    verts = np.take_along_axis(scand, comp_order[..., None], axis=1)[
        :, : MAX_CLIP_VERTS
    ]
    nv = np.minimum(counts, MAX_CLIP_VERTS)

    # angular sort about vertex centroid
    with np.errstate(invalid="ignore", divide="ignore"):
        vmask = np.arange(MAX_CLIP_VERTS)[None, :] < nv[:, None]
        cent0 = (verts * vmask[..., None]).sum(1) / np.maximum(nv, 1)[:, None]
        ang = np.arctan2(
            verts[..., 1] - cent0[:, None, 1], verts[..., 0] - cent0[:, None, 0]
        )
    ang[~vmask] = np.inf
    aorder = np.argsort(ang, axis=1, kind="stable")
    verts = np.take_along_axis(verts, aorder[..., None], axis=1)

    # polygon area + centroid (Nurnberg/Bourke), cyclic over nv vertices
    i_idx = np.arange(MAX_CLIP_VERTS)[None, :]
    nxt = np.where(i_idx + 1 >= nv[:, None], 0, i_idx + 1)
    vx, vy = verts[..., 0], verts[..., 1]
    nx = np.take_along_axis(vx, nxt, 1)
    ny = np.take_along_axis(vy, nxt, 1)
    crossterm = np.where(vmask, vx * ny - nx * vy, 0.0)
    area2 = crossterm.sum(1)
    area = area2 / 2.0
    good = (np.abs(area) > MINI_AREA) & (nv >= 3)
    with np.errstate(invalid="ignore", divide="ignore"):
        cx = (np.where(vmask, (vx + nx) * crossterm, 0.0)).sum(1) / (6.0 * area)
        cy = (np.where(vmask, (vy + ny) * crossterm, 0.0)).sum(1) / (6.0 * area)
    cent = np.stack([cx, cy], axis=-1)
    cent = np.where(good[:, None], cent, 0.0)

    # fan triangles (centroid, v_i, v_{i+1})
    tri = np.zeros((P, MAX_TRIS, 3, 2))
    tri[:, :, 0] = cent[:, None]
    tri[:, :, 1] = verts
    tri[:, :, 2] = np.stack([nx, ny], axis=-1)
    tri_valid = vmask & good[:, None]
    return tri, tri_valid, np.abs(area)


def triangle_gauss(tri: np.ndarray):
    """4-pt Gauss per triangle (TRIANGLE_QUADRATURE, CSEARCH.h:468-483).

    tri (...,3,2) -> (xi (...,4,2), w (...,4)); weights = 2*area*w_ref.
    """
    bary = TRI_QUAD.bary           # (4,3)
    wref = TRI_QUAD.weights        # (4,)
    pts = np.einsum("gb,...bd->...gd", bary, tri)
    area = _tri_area(tri[..., 0, :], tri[..., 1, :], tri[..., 2, :])
    w = 2.0 * area[..., None] * wref
    return pts, w
