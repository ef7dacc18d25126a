"""Isotropic linear elasticity: material law and hex8 element kernels.

Reference semantics: MULTIGRID.h:950-1039 (STIF_MATR: 27-pt Gauss hex8
stiffness with engineering-strain B matrices), :1041-1082 (GET_VOLUME),
:1316-1433 (per-element L2 stress projection).  Defaults E=210 GPa, nu=0.3
(MULTIGRID.h:99-100).

The element kernels exist twice, as in the JAX package:
  * NumPy batched versions for the host setup/assembly path;
  * ``element_stiffness_torch``, batched einsums over the elements on a
    torch device (the JAX package's ``element_stiffness_jax``), for
    device-side assembly.  The host build does not call it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.quadrature import HEX_QUAD

DEFAULT_E = 210.0e9
DEFAULT_NU = 0.3


def elastic_matrix(e_mod: float = DEFAULT_E, nu: float = DEFAULT_NU) -> np.ndarray:
    """6x6 isotropic elasticity matrix in Voigt order (xx,yy,zz,xy,yz,zx)."""
    lam = e_mod * nu / (1.0 + nu) / (1.0 - 2.0 * nu)
    mu = e_mod / 2.0 / (1.0 + nu)
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[np.arange(3), np.arange(3)] = 2.0 * mu + lam
    D[np.arange(3, 6), np.arange(3, 6)] = mu
    return D


def _b_matrix_np(dndx: np.ndarray) -> np.ndarray:
    """Engineering-strain B (...,6,24) from shape gradients (...,3,8)."""
    shape = dndx.shape[:-2]
    B = np.zeros(shape + (6, 24))
    for a in range(8):
        gx, gy, gz = dndx[..., 0, a], dndx[..., 1, a], dndx[..., 2, a]
        B[..., 0, 3 * a + 0] = gx
        B[..., 1, 3 * a + 1] = gy
        B[..., 2, 3 * a + 2] = gz
        B[..., 3, 3 * a + 0] = gy
        B[..., 3, 3 * a + 1] = gx
        B[..., 4, 3 * a + 1] = gz
        B[..., 4, 3 * a + 2] = gy
        B[..., 5, 3 * a + 0] = gz
        B[..., 5, 3 * a + 2] = gx
    return B


# elements per block of element_stiffness: a block's (E,24,24) products stay
# in the CPU's cache across the Gauss-point loop; every element's arithmetic
# is the same at any block size
STIFFNESS_BLOCK = 1024


def element_stiffness(exyz: np.ndarray, D: np.ndarray) -> np.ndarray:
    """Batched hex8 stiffness: exyz (E,8,3) -> (E,24,24).  NumPy host path.

    Structured as a loop over Gauss points with batched matmuls (BLAS) —
    much faster than one mega-einsum for large element batches — over
    blocks of STIFFNESS_BLOCK elements."""
    exyz = np.asarray(exyz, dtype=np.float64)
    E = exyz.shape[0]
    if E > STIFFNESS_BLOCK:
        K = np.empty((E, 24, 24))
        for a in range(0, E, STIFFNESS_BLOCK):
            K[a : a + STIFFNESS_BLOCK] = element_stiffness(
                exyz[a : a + STIFFNESS_BLOCK], D)
        return K
    K = np.zeros((E, 24, 24))
    for g in range(HEX_QUAD.n_gp):
        dN = HEX_QUAD.shape_grad[g]                 # (3,8)
        w = HEX_QUAD.weights[g]
        J = np.einsum("di,eic->edc", dN, exyz)      # (E,3,3)
        detJ = np.linalg.det(J)
        dndx = np.linalg.solve(J, np.broadcast_to(dN, (E, 3, 8)))  # (E,3,8)
        B = _b_matrix_np(dndx)                      # (E,6,24)
        DB = np.matmul(D, B)                        # (E,6,24)
        BtDB = np.matmul(B.transpose(0, 2, 1), DB)  # (E,24,24)
        K += np.multiply(BtDB, (w * detJ)[:, None, None], out=BtDB)
    return K


def _inv3x3(J: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form 3x3 inverse and determinant (the JAX package's: its
    device path has no LU)."""
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    d, e, f = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    g, h, i = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    Dm = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * Dm + c * G
    adj = torch.stack([torch.stack([A, B, C], dim=-1),
                       torch.stack([Dm, E, F], dim=-1),
                       torch.stack([G, H, I], dim=-1)], dim=-2)
    return adj / det[..., None, None], det


def element_stiffness_torch(exyz, D, device="cuda") -> torch.Tensor:
    """Device hex8 stiffness (E,8,3) -> (E,24,24) in float64: the JAX
    package's ``element_stiffness_jax``, batched einsums over elements and
    Gauss points on ``device`` (default the card; raises without one unless
    the caller asks for the CPU).  Arrays or tensors in, a tensor on
    ``device`` out."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    exyz = torch.as_tensor(exyz, dtype=torch.float64, device=dev)
    D = torch.as_tensor(D, dtype=torch.float64, device=dev)
    dN = torch.as_tensor(HEX_QUAD.shape_grad, dtype=torch.float64,
                         device=dev)
    w = torch.as_tensor(HEX_QUAD.weights, dtype=torch.float64, device=dev)
    J = torch.einsum("gdi,eic->egdc", dN, exyz)
    Jinv, detJ = _inv3x3(J)
    dndx = torch.einsum("egdc,gci->egdi", Jinv, dN)

    gx, gy, gz = dndx[..., 0, :], dndx[..., 1, :], dndx[..., 2, :]
    zeros = torch.zeros_like(gx)
    # rows of B grouped per node a: (E,27,6,8) per dof component
    bx = torch.stack([gx, zeros, zeros, gy, zeros, gz], dim=-2)
    by = torch.stack([zeros, gy, zeros, gx, gz, zeros], dim=-2)
    bz = torch.stack([zeros, zeros, gz, zeros, gy, gx], dim=-2)
    B = torch.stack([bx, by, bz], dim=-1).reshape(*gx.shape[:-1], 6, 24)
    DB = torch.einsum("st,egtq->egsq", D, B)
    return torch.einsum("egsp,egsq,eg,g->epq", B, DB, detJ, w)


def element_volumes(exyz: np.ndarray) -> np.ndarray:
    """Batched 27-pt Gauss volumes: exyz (E,8,3) -> (E,)."""
    dN = HEX_QUAD.shape_grad
    J = np.einsum("gdi,eic->egdc", dN, exyz, optimize=True)
    return np.einsum("eg,g->e", np.linalg.det(J), HEX_QUAD.weights, optimize=True)


def element_stress_projection(
    exyz: np.ndarray, edisp: np.ndarray, D: np.ndarray
) -> np.ndarray:
    """Per-element L2 projection of Gauss stresses to the 8 nodes
    (MULTIGRID.h:1348-1372): solve (N^T N) S = N^T sigma_g per element.

    exyz (E,8,3), edisp (E,24) -> nodal stresses (E,8,6).
    """
    dN = HEX_QUAD.shape_grad
    Nsh = HEX_QUAD.shape                            # (27,8)
    w = HEX_QUAD.weights
    J = np.einsum("gdi,eic->egdc", dN, exyz, optimize=True)
    detJ = np.linalg.det(J)
    dndx = np.einsum("egdc,gci->egdi", np.linalg.inv(J), dN, optimize=True)
    B = _b_matrix_np(dndx)                          # (E,27,6,24)
    sig = np.einsum("st,egtq,eq->egs", D, B, edisp, optimize=True)  # (E,27,6)
    wd = w * detJ                                   # (E,27)
    rhs = np.einsum("ga,egs,eg->eas", Nsh, sig, wd, optimize=True)  # (E,8,6)
    M = np.einsum("ga,gb,eg->eab", Nsh, Nsh, wd, optimize=True)     # (E,8,8)
    return np.linalg.solve(M, rhs)


def von_mises(stress6: np.ndarray) -> np.ndarray:
    """Equivalent von Mises stress from Voigt components (...,6)."""
    s = stress6
    return np.sqrt(
        (
            (s[..., 0] - s[..., 1]) ** 2
            + (s[..., 1] - s[..., 2]) ** 2
            + (s[..., 0] - s[..., 2]) ** 2
            + 6.0 * (s[..., 3] ** 2 + s[..., 4] ** 2 + s[..., 5] ** 2)
        )
        / 2.0
    )
