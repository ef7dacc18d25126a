"""The ADMM contact-analysis loop (MCONTACT::CONTACT_ANALYSIS), the port of
the JAX package's ``admm/loop.py`` as a host loop over torch tensors.

Reference semantics (MCONTACT.h:2493-2723), one iteration:

  1. x-update: every subdomain solves (K + rho B^T B) u = f + B_p^T z - B^T l
     — batched multigrid-preconditioned CG over the body axis.
  2. gamma: interface traction trial at integral points + projection
     (max(0,.) for contact, Coulomb cone clip for friction; none for perfect
     interfaces) (MCONTACT.h:2632-2668).
  3. z-update: per region side solve rho M z = B_p^T u + M l + E gamma
     — batched Jacobi-PCG on the interface Gram matrices.
  4. lambda-update: l += M^{-1} (B_p^T u - rho M z).
  5. MONITOR: per-body ||du||^2 <= 1e-12 ||u||^2 and per-side
     ||dz||^2 <= 1e-12 ||z||^2, full-space norms via the Gram trick
     (MCONTACT.h:2725-2845); oscillation bookkeeping for freezing the coarse
     correction.

The host reads the convergence flag after every iteration (loop.py:345-364
of the JAX package checks it on the host too).  The solver's phases are
``record_function`` ranges ("admm_step", "body pcg", "coarse pcg",
"interface pcg", "vcycle"), which ``torch.profiler`` reports by name.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..solvers.krylov import pcg
from ..solvers.mg import vcycle
from ..utils.constants import (
    ADMM_CRIT_DISP,
    ADMM_CRIT_OSCI,
    ADMM_MAX_ITER,
    ADMM_MONI_CYCLE,
    CG_RTOL,
)
from ..utils.device import resolve_device, to_device
from ..utils.precision import floor_crit, floor_rtol
from .multiscale import ComposedAccu, ComposedTranD
from .problem import AdmmProblem, RegionGroup


def _vcycle(mg, r):
    with record_function("vcycle"):
        return vcycle(mg, r)


class GroupState(NamedTuple):
    z: torch.Tensor       # (R,2,m)
    lam: torch.Tensor     # (R,2,m)
    gamma: torch.Tensor   # (R,i)


class AdmmState(NamedTuple):
    u: torch.Tensor                   # (B,n)
    groups: tuple[GroupState, ...]
    it: int
    converged: bool
    moni: torch.Tensor                # (cycle, n_monitors) rolling buffer
    mult_frozen: bool                 # coarse correction freeze
    inner_iters: int                  # total inner body-CG iterations
    coarse_x: tuple                   # per coarse correction: (Nc,) warm start
    moni_hist: torch.Tensor           # (hist_rows, n_monitors) per-iteration
    # monitor ratios, written in place (hist_rows=1 when recording is off:
    # the row is overwritten); ratios, not resuMoni's raw squared norms, as
    # in the JAX package (utils/io.py::write_moni)


def _project_gamma(g: RegionGroup, gamma: torch.Tensor,
                   mode: str) -> torch.Tensor:
    """Contact projection (MCONTACT.h:2637-2668)."""
    if mode == "scalar":
        # frictionless contact: gamma_n <- max(0, gamma_n)
        return torch.clamp(gamma, min=0.0) * g.i_mask
    # vector mode: fric<0 perfect (no projection); fric>0 Coulomb
    R, i_pad = gamma.shape
    gn = gamma[:, 0::3]
    gt1 = gamma[:, 1::3]
    gt2 = gamma[:, 2::3]
    is_contact = (g.fric >= 0.0)[:, None]
    is_fric = (g.fric > 0.0)[:, None]
    gn_p = torch.where(is_contact, torch.clamp(gn, min=0.0), gn)
    # Coulomb cone: ||gt|| <= mu * gn; open gap -> zero tangential
    tnorm = torch.sqrt(gt1**2 + gt2**2)
    slide = g.fric[:, None] * gn_p
    one = torch.ones_like(tnorm)
    scale = torch.where(tnorm >= torch.clamp(slide, min=0.0),
                        slide / torch.where(tnorm == 0.0, one, tnorm), one)
    scale = torch.where(gn_p > 0.0, scale, torch.zeros_like(scale))
    gt1_p = torch.where(is_fric, gt1 * scale, gt1)
    gt2_p = torch.where(is_fric, gt2 * scale, gt2)
    out = torch.stack([gn_p, gt1_p, gt2_p], dim=-1).reshape(R, i_pad)
    return out * g.i_mask


# iteration caps of the body PCG and of the interface mass PCGs
INNER_MAXITER = 500
MASS_MAXITER = 200


def make_admm_step(prob: AdmmProblem, modes: tuple[str, ...], shard=None,
                   inner_maxiter: int = INNER_MAXITER):
    """Build the single-iteration function ``step(state) -> state``.

    With a ``shard`` (``parallel/sharding.py::Shard``), ``prob`` and
    ``state.u`` hold the rank's bodies [shard.lo, shard.hi) and the rest is
    replicated: the body solve runs on the local bodies, and the step
    all-gathers u where the coarse correction, the region groups and the
    monitors read it.  Gathers, not sums over ranks, keep every sum in its
    single-device order.  The inner iteration count and the flags that end
    the loop (``converged``, the coarse freeze) are reduced over ranks, so
    every rank takes the same decisions.  Without one the step runs a
    one-device ``Shard``, whose collectives are the identity."""
    from ..parallel.sharding import Shard

    mg = prob.mg
    if shard is None:
        shard = Shard(prob.cons_forc.shape[0], prob.cons_forc.device)
    gather, rows = shard.gather, slice(shard.lo, shard.hi)
    dtype = prob.cons_forc.dtype
    tiny = float(torch.finfo(dtype).tiny)
    crit_disp = floor_crit(ADMM_CRIT_DISP, dtype)
    # reference tolerance (1e-14*||b||, MGPIS.h:175), floored at the solve
    # dtype's achievable residual (utils/precision.py policy)
    inner_rtol = floor_rtol(CG_RTOL, dtype)
    # the interface mass solves run to 4*eps (they gate the z/lambda
    # monitor noise floor); the body solve keeps the 40*eps floor
    mass_rtol = max(float(CG_RTOL), 4.0 * float(torch.finfo(dtype).eps))

    def body_solve(rhs, x0):
        # warm start from the previous ADMM iterate; matvec in the solve
        # dtype, V-cycle preconditioner in float32 (see solvers/mg.py)
        with record_function("body pcg"):
            res = pcg(mg.A_top.mv, lambda r: _vcycle(mg, r), rhs,
                      x0=x0, rtol=inner_rtol, maxiter=inner_maxiter)
        return res.x, res.iters

    def apply_coarse(co, state, u, x_prev):
        # tranL/tranZ are row-compacted (R,2,r_pad,k) with a scatter index
        # into the coarse vector (padded rows produce exact zeros and
        # scatter harmlessly to row 0)
        gf = co.forc0
        for gs, tl, ti in zip(state.groups, co.tranL, co.tranL_idx):
            gf = gf.index_add(0, ti.reshape(-1), tl.mv(gs.lam).reshape(-1))
        if co.tranZ is not None:
            for gs, tz, ti in zip(state.groups, co.tranZ, co.tranZ_idx):
                gf = gf.index_add(0, ti.reshape(-1), tz.mv(gs.z).reshape(-1))
        if isinstance(co.tranD, ComposedTranD):
            # F^T A u through the hierarchy (float64 A + Pt chain)
            gf = gf + co.tranD.apply(u, gather)
        else:
            gf = gf + co.tranD.mv(gather(u).reshape(-1))
        if co.mg is not None:
            # DOUBLE_M(_1): MG-preconditioned CG on the coarse operator's
            # own DD hierarchy (MCONTACT.h:1538-1670), warm-started from the
            # previous iteration's coarse solution
            with record_function("coarse pcg"):
                sol = pcg(
                    co.mg.A_top.mv,
                    lambda r: _vcycle(co.mg, r),
                    gf[None],
                    x0=x_prev[None],
                    rtol=inner_rtol,
                    maxiter=500,
                ).x[0]
        else:
            # inverse apply + one refinement step in the solve dtype
            sol = co.inv @ gf
            sol = sol + co.inv @ (gf - co.mat @ sol)
        if isinstance(co.accu, ComposedAccu):
            du = co.accu.apply(sol, rows)   # P chain from dole
        else:
            # a sharded accu holds the rank's rows only
            du = co.accu.mv(sol).reshape(u.shape)
        return u + du, sol

    def step(state: AdmmState) -> AdmmState:
        # once converged the step is a no-op
        if state.converged:
            return state
        # ---------------------------------------------------- x-update rhs
        # the replicated scatter over the group state runs on the full
        # (B, n) layout, with the rank's own rows of cons_forc in place
        # (the same sums as on one device); the rank keeps its rows
        rhs_flat = torch.nn.functional.pad(
            prob.cons_forc, (0, 0, shard.lo, shard.n_bodies - shard.hi)
        ).reshape(-1)
        for g, gs in zip(prob.groups, state.groups):
            # row-compacted TtP/Tt: scatter each (region, side)'s body-DOF
            # contributions into the stacked rhs (offsets baked into t_idx)
            contrib = g.TtP.mv(gs.z) - g.Tt.mv(gs.lam)       # (R,2,r)
            rhs_flat = rhs_flat.index_add(0, g.t_idx.reshape(-1),
                                          contrib.reshape(-1))
        rhs = rhs_flat.reshape((-1,) + tuple(prob.cons_forc.shape[1:]))
        rhs = rhs[rows] * prob.u_mask
        # the body PCG runs on the local bodies alone: its lanes are
        # independent, so a rank's loop ends when its own lanes end
        u, inner_it = body_solve(rhs, state.u)

        # ------------------ coarse-space corrections (MULTISCALE variants A
        # and/or B, MCONTACT.h:2540-2624); applied until the oscillation
        # monitor freezes them (MULT_MAXI semantics)
        new_coarse_x = list(state.coarse_x)
        if prob.coarse and not state.mult_frozen:
            for ci, co in enumerate(prob.coarse):
                u, new_coarse_x[ci] = apply_coarse(co, state, u,
                                                   state.coarse_x[ci])

        new_groups = []
        # body monitors: full-space ||du||^2 vs ||u||^2 via Gram, computed on
        # max-normalized vectors (the scale cancels in the ratio)
        du = u - state.u
        s_u = torch.clamp(u.abs().amax(dim=-1, keepdim=True), min=tiny)
        dus, us = du / s_u, u / s_u
        du2 = (dus * prob.gram.mv(dus)).sum(-1)
        u2 = (
            (us * prob.gram.mv(us)).sum(-1)
            + 2.0 * (prob.gram_lin * us).sum(-1) / s_u[..., 0]
            + prob.gram_const / s_u[..., 0] ** 2
        )
        both = gather(torch.stack([du2, u2], dim=-1))
        moni_vals = [both[:, 0]]
        moni_allow = [both[:, 1]]
        u_all = gather(u)

        for g, gs, mode in zip(prob.groups, state.groups, modes):
            u_rs = u_all[g.body_idx]                          # (R,2,n)
            bpu = g.Bp.mv(u_rs) + g.bp_const                  # (R,2,m)
            # ------------------------------------------------------ gamma
            lam_ip = g.L.mv(gs.lam)                           # (R,2,i)
            pd_u = g.Pd.mv(u_rs) + g.pd_const                 # (R,2,i)
            gamma = 0.5 * (
                lam_ip[:, 0] - lam_ip[:, 1] + pd_u[:, 0] - pd_u[:, 1] - g.rho_g
            )
            gamma = _project_gamma(g, gamma, mode)
            # ---------------------------------------------------- z-update
            gamma_b = gamma[:, None, :].expand(gamma.shape[0], 2,
                                               gamma.shape[1])
            e_gamma = g.E.tmv(gamma_b, g.m_mask.shape[-1])    # (R,2,m)
            z_rhs = (bpu + g.M.mv(gs.lam) + e_gamma) * g.m_mask
            with record_function("interface pcg"):
                z = pcg(
                    g.Mp.mv,
                    lambda r, g=g: r / g.Mp_diag,
                    z_rhs,
                    x0=gs.z,
                    rtol=mass_rtol,
                    maxiter=MASS_MAXITER,
                ).x
            # ----------------------------------------------- lambda-update
            l_rhs = (bpu - g.Mp.mv(z)) * g.m_mask
            with record_function("interface pcg"):
                dlam = pcg(
                    g.M.mv,
                    lambda r, g=g: r / g.M_diag,
                    l_rhs,
                    rtol=mass_rtol,
                    maxiter=MASS_MAXITER,
                ).x
            lam = gs.lam + dlam
            new_groups.append(GroupState(z=z, lam=lam, gamma=gamma))
            # ---------------------------------------------------- monitors
            s_z = torch.clamp(z.abs().amax(dim=-1, keepdim=True), min=tiny)
            dz2 = (((z - gs.z) / s_z) ** 2).sum(-1)           # (R,2)
            z2 = ((z / s_z) ** 2).sum(-1)
            moni_vals.append(dz2.reshape(-1))
            moni_allow.append(z2.reshape(-1))

        vals = torch.cat(moni_vals)
        allow = torch.cat(moni_allow)
        # the monitored quantity is the scale-invariant ratio (reference
        # semantics ||d.||^2 <= crit*||.||^2, MCONTACT.h:2760, rearranged)
        ratio = vals / torch.clamp(allow, min=tiny)
        moni = state.moni.clone()
        moni[state.it % ADMM_MONI_CYCLE] = ratio
        # out of place, like moni: a caller may keep the old state
        moni_hist = state.moni_hist.clone()
        moni_hist[state.it % moni_hist.shape[0]] = ratio

        # convergence: every monitor ratio below crit (MCONTACT.h:2760)
        converged = bool((ratio <= crit_disp).all())

        # oscillation freeze for the coarse correction (MCONTACT.h:2749-2758,
        # 2838-2840): all monitors' 10-sample oscillation < 0.1 * median
        mx, mn = moni.amax(dim=0), moni.amin(dim=0)
        medi = 0.5 * (mx + mn)
        osc_ok = bool(((mx - mn) <= ADMM_CRIT_OSCI * medi).all())
        # the replicated group state may differ in its last bits from rank
        # to rank (index_add is atomic on the card): a flag decided on one
        # rank alone would leave another waiting in a collective
        inner_it, not_conv, not_osc = shard.max_ints(
            [inner_it, int(not converged), int(not osc_ok)])
        converged, osc_ok = not not_conv, not not_osc
        mult_frozen = state.mult_frozen or (
            state.it >= ADMM_MONI_CYCLE and osc_ok
        )

        return AdmmState(
            u=u,
            groups=tuple(new_groups),
            it=state.it + 1,
            converged=converged,
            moni=moni,
            mult_frozen=mult_frozen,
            inner_iters=state.inner_iters + inner_it,
            coarse_x=tuple(new_coarse_x),
            moni_hist=moni_hist,
        )

    return step


def init_state(prob: AdmmProblem, hist_rows: int = 1) -> AdmmState:
    B, n = prob.cons_forc.shape
    dtype = prob.cons_forc.dtype
    dev = prob.cons_forc.device
    groups = []
    n_moni = B
    for g in prob.groups:
        R, _, m = g.bp_const.shape
        i = g.rho_g.shape[1]
        groups.append(
            GroupState(
                z=torch.zeros((R, 2, m), dtype=dtype, device=dev),
                lam=torch.zeros((R, 2, m), dtype=dtype, device=dev),
                gamma=torch.zeros((R, i), dtype=dtype, device=dev),
            )
        )
        n_moni += 2 * R
    return AdmmState(
        u=torch.zeros((B, n), dtype=dtype, device=dev),
        groups=tuple(groups),
        it=0,
        converged=False,
        moni=torch.full((ADMM_MONI_CYCLE, n_moni), torch.inf, dtype=dtype,
                        device=dev),
        mult_frozen=False,
        inner_iters=0,
        coarse_x=tuple(
            torch.zeros(co.forc0.shape, dtype=dtype, device=dev)
            for co in (prob.coarse or ())
        ),
        moni_hist=torch.full((hist_rows, n_moni), torch.inf, dtype=dtype,
                             device=dev),
    )


def admm_step(prob: AdmmProblem, state: AdmmState,
              modes: tuple[str, ...],
              inner_maxiter: int = INNER_MAXITER) -> AdmmState:
    """One ADMM iteration of ``prob`` from ``state`` (both on one device).
    A no-op once ``state.converged`` is set (see ``make_admm_step``)."""
    return make_admm_step(prob, modes, inner_maxiter=inner_maxiter)(state)


def contact_analysis(
    prob: AdmmProblem,
    modes: tuple[str, ...],
    max_iter: int = ADMM_MAX_ITER,
    record_moni: bool = False,
    device="cuda",
    callback=None,
    state0: AdmmState | None = None,
    inner_maxiter: int = INNER_MAXITER,
    shard=None,
) -> AdmmState:
    """Run the ADMM loop to convergence (or ``max_iter``) on ``device``
    (default the card; the problem is moved there if it lies elsewhere).

    ``record_moni=True`` sizes the history buffer to ``max_iter`` rows so
    every iteration's monitor ratios survive the loop (resuMoni.txt parity,
    MCONTACT.h:2742); rows past convergence stay +inf.  ``state0`` starts
    the loop from a given state (a rank's share of one, or one that
    ``utils/checkpoint.py::load_state`` read) instead of the zero state;
    ``inner_maxiter`` caps the body PCG.  ``shard`` runs the rank's share of
    a problem split by ``parallel/sharding.py`` (see ``make_admm_step``),
    from ``state0`` = the rank's share of a state (``shard_state``).
    ``callback(state)``, if given, runs after every iteration (monitor
    output, checkpoints).  The JAX package's
    ``chunk`` dispatch is not carried over: it works around a
    remote-attached TPU, and this loop already checks convergence on the
    host after every iteration."""
    dev = resolve_device(device)
    prob = to_device(prob, dev)
    if state0 is None:
        state = init_state(prob, hist_rows=max_iter if record_moni else 1)
    else:
        state = to_device(state0, dev)
    step = make_admm_step(prob, modes, shard=shard,
                          inner_maxiter=inner_maxiter)
    while state.it < max_iter and not state.converged:
        with record_function("admm_step"):
            state = step(state)
        if callback is not None:
            callback(state)
    return state


def contact_analysis_stepwise(
    prob: AdmmProblem,
    modes: tuple[str, ...],
    max_iter: int = ADMM_MAX_ITER,
    callback=None,
    device="cuda",
) -> AdmmState:
    """The JAX package's name for :func:`contact_analysis` with a
    per-iteration ``callback``."""
    return contact_analysis(prob, modes, max_iter, device=device,
                            callback=callback)
