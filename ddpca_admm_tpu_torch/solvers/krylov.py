"""Batched Krylov solvers: CG, BiCGSTAB and GMRES (the port of
``solvers/krylov.py``).

Reference: MGPIS.h:163-225 (PCG, Shewchuk formulation, tol 1e-14*||b||),
:350-432 (preconditioned BiCGSTAB, tol 1e-14*||b||), :227-348 (restarted
GMRES(10), tol 1e-12*||b||).  Every call solves a batch of systems at once;
converged lanes are frozen by masking, and the loop ends when no lane is
active: one host read of the active mask per iteration (per restart for
GMRES).  Preconditioners are callables (multigrid V-cycle or Jacobi).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.constants import (
    BICGSTAB_RTOL,
    CG_RTOL,
    GMRES_RESTART,
    GMRES_RTOL,
)

# stagnation exit (reference MGPIS stagnation monitors, MGPIS.h:141-155): a
# lane that has not improved its best residual by >0.1% for STALL_LIMIT
# iterations is frozen (preconditioner floor reached)
STALL_LIMIT = 25


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den where den != 0, else 0."""
    return torch.where(den != 0.0,
                       num / torch.where(den == 0.0, torch.ones_like(den),
                                         den),
                       torch.zeros_like(num))


class CgResult(NamedTuple):
    x: torch.Tensor
    iters: int
    res_norm: torch.Tensor


def pcg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    precond: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    rtol: float = CG_RTOL,
    maxiter: int = 1000,
) -> CgResult:
    """Preconditioned CG over a batch: b (..., n); batch lanes converge
    independently (per-lane tolerance rtol*||b||, MGPIS.h:175)."""
    x = torch.zeros_like(b) if x0 is None else x0
    tol = rtol * torch.sqrt(_dot(b, b))
    r = b - matvec(x)
    d = precond(r)
    delta = _dot(r, d)
    best = torch.sqrt(_dot(r, r))
    stall = torch.zeros(b.shape[:-1], dtype=torch.int64, device=b.device)
    it = 0
    while it < maxiter:
        active = (torch.sqrt(_dot(r, r)) > tol) & (stall < STALL_LIMIT)
        if not bool(active.any()):
            break
        act = active[..., None]
        q = matvec(d)
        alpha = _safe_div(delta, _dot(d, q))
        x = torch.where(act, x + alpha[..., None] * d, x)
        r_new = torch.where(act, r - alpha[..., None] * q, r)
        s = precond(r_new)
        delta_new = _dot(r_new, s)
        beta = _safe_div(delta_new, delta)
        d = torch.where(act, s + beta[..., None] * d, d)
        rn = torch.sqrt(_dot(r_new, r_new))
        improved = rn < 0.999 * best
        best = torch.minimum(best, rn)
        stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
        r, delta = r_new, delta_new
        it += 1
    return CgResult(x=x, iters=it, res_norm=torch.sqrt(_dot(r, r)))



def _nz(x: torch.Tensor) -> torch.Tensor:
    """x with its zeros replaced by ones (a safe divisor)."""
    return torch.where(x == 0.0, torch.ones_like(x), x)


def bicgstab(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    precond: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    rtol: float = BICGSTAB_RTOL,
    maxiter: int = 2000,
) -> CgResult:
    """Right-preconditioned BiCGSTAB (MGPIS.h:350-432 semantics), batched.
    x, r, p and v are masked per lane; rho, alpha and omega are updated in
    every lane, as the JAX package does."""
    x = torch.zeros_like(b) if x0 is None else x0
    tol = rtol * torch.sqrt(_dot(b, b))
    r = b - matvec(x)
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones(b.shape[:-1], dtype=b.dtype,
                                     device=b.device)
    it = 0
    while it < maxiter:
        active = torch.sqrt(_dot(r, r)) > tol
        if not bool(active.any()):
            break
        act = active[..., None]
        rho_new = _dot(rhat, r)
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        p = torch.where(act, r + beta[..., None] * (p - omega[..., None] * v),
                        p)
        phat = precond(p)
        v_new = matvec(phat)
        alpha = rho_new / _nz(_dot(rhat, v_new))
        s = r - alpha[..., None] * v_new
        shat = precond(s)
        t = matvec(shat)
        omega = _dot(t, s) / _nz(_dot(t, t))
        x = torch.where(
            act, x + alpha[..., None] * phat + omega[..., None] * shat, x)
        r = torch.where(act, s - omega[..., None] * t, r)
        v = torch.where(act, v_new, v)
        rho = rho_new
        it += 1
    return CgResult(x=x, iters=it, res_norm=torch.sqrt(_dot(r, r)))


def gmres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    precond: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    rtol: float = GMRES_RTOL,
    restart: int = GMRES_RESTART,
    max_restarts: int = 200,
) -> CgResult:
    """Left-preconditioned restarted GMRES(restart) (MGPIS::GMRES_SOLV,
    MGPIS.h:227-348: restart 10, tol 1e-12*||b||), batched over leading
    axes.

    Each restart cycle runs a fixed ``restart``-step Arnoldi factorization
    with modified Gram-Schmidt and solves the small least-squares problem
    by its normal equations (plus 1e-30*I), as the JAX package does.  The
    true residual is checked once per restart, so ``iters`` counts
    restarts."""
    x = torch.zeros_like(b) if x0 is None else x0
    tol = rtol * torch.sqrt(_dot(b, b))
    batch = tuple(b.shape[:-1])
    eye = torch.eye(restart, dtype=b.dtype, device=b.device)

    def cycle(x, r):
        z = precond(r)
        beta = torch.sqrt(_dot(z, z))
        V = [z / _nz(beta)[..., None]]
        H = torch.zeros(batch + (restart + 1, restart), dtype=b.dtype,
                        device=b.device)
        for j in range(restart):
            w = precond(matvec(V[j]))
            # columns past j are zero in the JAX package's masked sweep: it
            # subtracts 0 * 0 from w there, which leaves w as it is
            for i in range(j + 1):
                hij = _dot(V[i], w)
                w = w - hij[..., None] * V[i]
                H[..., i, j] = hij
            hnext = torch.sqrt(_dot(w, w))
            H[..., j + 1, j] = hnext
            V.append(w / _nz(hnext)[..., None])
        # least squares min || beta e1 - H y || by normal equations
        e1 = torch.zeros(batch + (restart + 1,), dtype=b.dtype,
                         device=b.device)
        e1[..., 0] = beta
        HtH = torch.einsum("...ij,...ik->...jk", H, H) + 1e-30 * eye
        Hte = torch.einsum("...ij,...i->...j", H, e1)
        y = torch.linalg.solve(HtH, Hte[..., None])[..., 0]
        dx = torch.einsum("...jn,...j->...n", torch.stack(V[:restart], -2), y)
        return x + dx

    it = 0
    r = b - matvec(x)
    while it < max_restarts and bool((torch.sqrt(_dot(r, r)) > tol).any()):
        x = cycle(x, r)
        r = b - matvec(x)
        it += 1
    return CgResult(x=x, iters=it, res_norm=torch.sqrt(_dot(r, r)))


def jacobi_preconditioner(
        diag: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    inv = torch.where(diag != 0.0, 1.0 / _nz(diag), torch.ones_like(diag))
    return lambda r: inv * r
