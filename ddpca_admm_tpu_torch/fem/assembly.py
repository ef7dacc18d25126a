"""Global sparse assembly of the elasticity stiffness on the leaf mesh.

Reference: MULTIGRID.h:950-1039 assembles triplets into a row-major Eigen
CSR over ALL nodes (including hanging nodes, which are eliminated later by
the finest prolongation).  Here: element matrices batched (NumPy or JAX),
triplets summed into scipy CSR on the host; the solve phase never touches
this matrix directly — it consumes the Galerkin-coarsened, constrained
hierarchy instead.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..mesh.hexmesh import HexMesh
from .elasticity import elastic_matrix, element_stiffness


def assemble_stiffness(
    mesh: HexMesh, e_mod: float, nu: float, chunk: int = 50_000
) -> sp.csr_matrix:
    """Assemble 3-DOF/node stiffness over leaf elements -> CSR (3N,3N)."""
    D = elastic_matrix(e_mod, nu)
    n = 3 * mesh.n_nodes
    leaves = mesh.leaf_elems()
    acc = sp.csr_matrix((n, n), dtype=np.float64)
    for start in range(0, leaves.size, chunk):
        els = leaves[start : start + chunk]
        corn = mesh.elem_corn[els]                     # (E,8)
        K = element_stiffness(mesh.coords[corn], D)    # (E,24,24)
        dofs = (3 * corn[:, :, None] + np.arange(3)).reshape(-1, 24)  # (E,24)
        rows = np.repeat(dofs, 24, axis=1).ravel()
        cols = np.tile(dofs, (1, 24)).ravel()
        acc = acc + sp.coo_matrix(
            (K.ravel(), (rows, cols)), shape=(n, n)
        ).tocsr()
    return acc


def distribute_face_load(
    mesh: HexMesh,
    face_nodes: np.ndarray,
    traction_fn,
    loads: dict[int, float],
) -> None:
    """Integrate a traction over quad4 faces into nodal loads.

    ``face_nodes`` (F,4) node ids per surface face; ``traction_fn(x) -> (3,)``
    evaluated at Gauss points (``x`` (...,3)); accumulates into ``loads``
    keyed by global DOF (reference LOAD_ACCU, MULTIGRID.h:1084-1100).
    """
    from ..utils.quadrature import QUAD_QUAD, surface_jacobian

    corners = mesh.coords[face_nodes]                   # (F,4,3)
    for g in range(QUAD_QUAD.n_gp):
        nat = QUAD_QUAD.points[g]
        N = QUAD_QUAD.shape[g]                          # (4,)
        w = QUAD_QUAD.weights[g]
        x = np.einsum("a,fac->fc", N, corners)          # (F,3)
        jac = surface_jacobian(np.broadcast_to(nat, (corners.shape[0], 2)), corners)
        trac = np.asarray(traction_fn(x), dtype=np.float64)  # (F,3) or (3,)
        trac = np.broadcast_to(trac, (corners.shape[0], 3))
        contrib = (w * jac)[:, None, None] * N[None, :, None] * trac[:, None, :]
        dofs = 3 * face_nodes[:, :, None] + np.arange(3)
        accumulate_loads(loads, dofs, contrib)


def accumulate_loads(loads: dict[int, float], dofs: np.ndarray,
                     vals: np.ndarray) -> None:
    """``loads[d] += v`` for each (d, v) of the flattened arrays, in their
    order: each DOF's sum is added up in the same sequence as one Python
    loop would, and a new DOF enters ``loads`` at its first appearance."""
    dofs = np.asarray(dofs, dtype=np.int64).ravel()
    vals = np.asarray(vals, dtype=np.float64).ravel()
    uniq, first, inv = np.unique(dofs, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    keys = uniq[order].tolist()
    acc = np.array([loads.get(k, 0.0) for k in keys], dtype=np.float64)
    np.add.at(acc, rank[inv], vals)
    loads.update(zip(keys, acc.tolist()))
