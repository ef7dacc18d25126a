"""Device-side ADMM problem: padded/stacked tensors built from host operators.

This is the bridge between the host setup (meshes, ConstrainedSystem,
RegionOps) and the solve loop (the port of the JAX package's
``admm/problem.py``).  Key design decision: every
operator the hot loop applies against body displacements is pre-composed with
the body's reduced-space expansion X (u_full = X u + d0), so loop state is
only (u_reduced per body, z/lambda per region side) — no 3N-DOF vectors, no
host round-trips.

  x-update rhs contribution:  TtP @ z - Tt @ lam    (TtP = X^T systTran_pena)
  interface trace:            Bp @ u + bp_const     (Bp = systTran_pena^T X)
  gamma displacement part:    Pd @ u + pd_const     (Pd = pemaInpo inpoDisp X)

Convergence monitoring reproduces the reference's *full-space* norms via the
precomputed Gram matrix G = X^T X:  ||du_full||^2 = du^T G du
(MCONTACT.h:2737-2743 semantics without materializing full vectors).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..fem.constraints import ConstrainedSystem
from ..solvers.mg import MgHierarchy, build_hierarchy
from ..sparse.bell import (
    BlockEll,
    compact_device_sparse,
    device_sparse,
    round_up,
    tiles_on,
)
from ..sparse.ell import Ell
from ..utils.device import resolve_device, to_device
from ..utils.pool import thread_imap
from .operators import RegionOps


class RegionGroup(NamedTuple):
    """Stacked operators for all regions of one DOF mode ('scalar'/'vector').

    Leading axes: R regions x 2 sides.  m = interface DOFs, i = integral-point
    DOFs, n = body reduced DOFs (padded to group/batch maxima).
    """

    body_idx: torch.Tensor    # (R,2) int64
    TtP: Ell | BlockEll      # (R,2,r,kt): X^T systTran_pena, row-compacted
    Tt: Ell | BlockEll       # (R,2,r,kt): X^T systTran, row-compacted
    t_idx: torch.Tensor       # (R,2,r): scatter rows into stacked (B*n) rhs
    Bp: Ell | BlockEll       # (R,2,m,kb): systTran_pena^T X
    bp_const: torch.Tensor    # (R,2,m)
    M: Ell | BlockEll        # (R,2,m,km) inteMass
    Mp: Ell | BlockEll       # (R,2,m,km) inteMass_pena
    M_diag: torch.Tensor      # (R,2,m)
    Mp_diag: torch.Tensor
    L: Ell | BlockEll        # (R,2,i,kl) inpoLagr
    Pd: Ell | BlockEll       # (R,2,i,kp) pemaInpo inpoDisp X
    pd_const: torch.Tensor    # (R,2,i)
    E: Ell                   # (R,2,i,ke) inteInpo TRANSPOSED (apply via tmv)
    rho_g: torch.Tensor       # (R,i) pemaInpo @ inpoNgap
    fric: torch.Tensor        # (R,)
    m_mask: torch.Tensor      # (R,2,m) valid interface dof
    i_mask: torch.Tensor      # (R,i) valid integral-point dof

    @property
    def n_regions(self) -> int:
        return self.body_idx.shape[0]


class AdmmProblem(NamedTuple):
    mg: MgHierarchy            # batched body hierarchies
    cons_forc: torch.Tensor     # (B,n)
    gram: object               # (B,n,...) X^T X: Dia, Ell or BlockEll
    gram_lin: torch.Tensor      # (B,n)   X^T d0
    gram_const: torch.Tensor    # (B,)    ||d0||^2
    groups: tuple[RegionGroup, ...]   # scalar and/or vector groups
    u_mask: torch.Tensor        # (B,n) valid reduced dof
    coarse: "tuple | None"     # CoarseCorrection tuple (A and/or B), or None


@dataclass
class AdmmMeta:
    """Host-side metadata for unpacking results."""

    systems: list[ConstrainedSystem]
    regions: list[RegionOps]
    group_modes: list[str]
    group_region_idx: list[list[int]]   # global region index per group slot
    n_pad: int


def _compose(ops, X: sp.csr_matrix, d0: np.ndarray, side: int):
    """Pre-compose one region side with the body expansion."""
    s = ops.sides[side]
    TtP = (X.T @ s.syst_tran_pena).tocsr()   # (n x m)
    Tt = (X.T @ s.syst_tran).tocsr()
    Bp = (s.syst_tran_pena.T @ X).tocsr()    # (m x n)
    bp_const = s.syst_tran_pena.T @ d0
    pema = sp.diags(ops.pema)
    Pd = (pema @ s.inpo_disp @ X).tocsr()    # (i x n)
    pd_const = pema @ (s.inpo_disp @ d0)
    return TtP, Tt, Bp, bp_const, Pd, pd_const


def build_problem(
    systems: Sequence[ConstrainedSystem],
    regions: Sequence[RegionOps],
    dole: Sequence[int] | None = None,
    musc_sett: int = 2,
    meshes: Sequence | None = None,
    coarse_solver: str = "auto",
    structured: bool = True,
    device="cuda",
    dtype=None,
) -> tuple[AdmmProblem, AdmmMeta]:
    """Build the device problem on ``device`` (default the card; raises
    when there is none and the caller did not ask for the CPU).

    ``dole``: per-body coarse level for the coarse-space corrections
    (doleMcsc, MCONTACT.h:23); None disables them.  ``musc_sett`` is the
    reference's correction bitmask (MCONTACT.h:22): bit0 = MULTISCALE (A,
    LATIN macroscopic — requires ``meshes``), bit1 = MULTISCALE_1 (B,
    interface-eliminated).  ``dtype``: the solve dtype (default:
    ``DDPCA_SOLVE_DTYPE``, else float64; utils/precision.py).  The V-cycle
    runs in float32 either way; a float32 solve has every floating tensor
    in float32, cast on the host before the upload, so the card never
    holds the float64 problem.  Block-ELL tiles
    (``DDPCA_SPARSE_FORMAT=bell``) are built in the solve dtype straight
    on ``device``."""
    dev = resolve_device(device)
    with tiles_on(dev):
        return _build_problem(systems, regions, dole, musc_sett, meshes,
                              coarse_solver, structured, dev, dtype)


def _build_problem(systems, regions, dole, musc_sett, meshes, coarse_solver,
                   structured, dev, dtype):
    B = len(systems)
    from ..utils.precision import cast_problem
    from ..utils.precision import solve_dtype as _solve_dtype
    from ..utils.timing import phase as _phase

    sd = _solve_dtype(dtype)
    # Bodies untouched by contact AMR have fewer multigrid levels than the
    # refined ones (the reference's per-domain mgpi.maxiLeve varies freely,
    # MGPIS.h:10); the batched hierarchy needs a uniform count, so extend
    # shallow bodies at the finest end with identity prolongations (repeat
    # the finest operator — extra smoothing there is harmless).  Appending
    # at the top keeps coarse level indices (dole) stable.
    L_max = max(s.n_levels for s in systems)
    # extend local copies of the level lists — never mutate the caller's
    # ConstrainedSystem objects (they may be reused for run_apps or a second
    # build with different dole semantics)
    stif_lists, prol_lists = [], []
    for s in systems:
        stif = list(s.cons_stif)
        prol = list(s.real_prol)
        while len(stif) < L_max:
            stif.append(stif[-1])
            prol.append(sp.identity(stif[-1].shape[0], format="csr"))
        stif_lists.append(stif)
        prol_lists.append(prol)
    # structured-grid DIA fast path: only when EVERY body is a detected
    # uniform grid AND no body needed level extension (identity prolongations
    # are not nested-grid transfers).  ``structured=False`` opts out.
    grids = [getattr(s, "grid", None) for s in systems]
    if (
        not structured
        or any(g is None for g in grids)
        or any(len(s.cons_stif) != L_max for s in systems)
    ):
        grids = None
    # LARGE structured uniform-dole problems compute the F^T A / accuProl
    # actions of coarse correction B through the hierarchy (ComposedTranD /
    # ComposedAccu) instead of materializing them.  Small problems keep the
    # materialized (solve-dtype-exact) operators: the composed chain runs
    # in the f32 preconditioner dtype.
    import os as _os

    compose_min = int(
        _os.environ.get("DDPCA_COMPOSE_TRAND_MIN_DOFS", "2000000")
    )
    n_top = round_up(max(stif[-1].shape[0] for stif in stif_lists), 128)
    composed = (
        dole is not None
        and bool(musc_sett & 2)
        and grids is not None
        and len(set(dole)) == 1
        and B * n_top >= compose_min
    )
    with _phase("MGPIS::ESTABLISH (device hierarchy)"):
        # the composed F^T A u takes A in float64 in either solve dtype
        mg = build_hierarchy(
            stif_lists, prol_lists,
            dtype=torch.float32,
            a_top_dtype=torch.float64 if composed else sd,
            grids=grids,
        )
    compose_a = mg.A_top
    if mg.A_top.dtype != sd:
        # a float32 solve: the Krylov operator is the finest level's own
        mg = mg._replace(A_top=mg.levels[-1].A)
    n_pad = mg.levels[-1].A.n_rows
    cons_forc = np.zeros((B, n_pad))
    gram_mats, gram_lin, gram_const = [], np.zeros((B, n_pad)), np.zeros(B)
    u_mask = np.zeros((B, n_pad), dtype=bool)
    for b, s in enumerate(systems):
        nb = s.n_dof
        cons_forc[b, :nb] = s.cons_forc
        G = (s.expand.T @ s.expand).tocsr()
        gram_mats.append(G)
        gram_lin[b, :nb] = s.expand.T @ s.expand_const
        gram_const[b] = float(s.expand_const @ s.expand_const)
        u_mask[b, :nb] = True
    if all((G - sp.diags(G.diagonal())).nnz == 0 for G in gram_mats):
        # grid-mode expand is permutation x mask x prolongation-free, so
        # X^T X is exactly diagonal — store as a 1-offset Dia (no gather)
        from ..sparse.dia import Dia as _Dia

        gd = np.ones((B, n_pad))
        for b, G in enumerate(gram_mats):
            gd[b, : G.shape[0]] = G.diagonal()
        gram = _Dia(torch.from_numpy(gd[:, None, :]), (0,), n_pad)
    else:
        gram = device_sparse(gram_mats, n_pad, n_pad, dtype=sd)

    # Group regions by DOF mode, then split each mode into SIZE BUCKETS:
    # every group is padded to its largest member, so one group spanning a
    # heterogeneous region population (DEHW: ~4 large AMR contact zones among
    # ~90 small DD interfaces) would cost R x max instead of ~sum.  Sorting
    # by size and opening a new bucket whenever a region falls below half the
    # bucket leader bounds per-region padding waste to 2x at the price of
    # O(log(size range)) extra groups.
    modes_present = sorted({r.region.mode for r in regions})
    buckets: list[tuple[str, list[int]]] = []
    for mode in modes_present:
        idx = [i for i, r in enumerate(regions) if r.region.mode == mode]

        def _size(i):
            r = regions[i]
            m = max(r.sides[s].inte_mass.shape[0] for s in (0, 1))
            return m + r.pema.size

        idx.sort(key=_size, reverse=True)
        cur: list[int] = []
        for i in idx:
            if cur and _size(cur[0]) > 2 * _size(i):
                buckets.append((mode, cur))
                cur = []
            cur.append(i)
        if cur:
            buckets.append((mode, cur))

    modes = [m for m, _ in buckets]   # one entry PER GROUP (may repeat)
    groups = []
    group_region_idx = []
    for mode, idx in buckets:
        group_region_idx.append(idx)
        regs = [regions[i] for i in idx]
        R = len(regs)
        # pad interface/integral-point dims to the JAX package's 128 multiple
        # (the same shapes); vector mode additionally needs divisibility by 3
        # (gamma n/t1/t2 deinterleave in loop.py) -> lcm(128,3) = 384
        align = 384 if mode == "vector" else 128
        m_pad = round_up(
            max(r.sides[s].inte_mass.shape[0] for r in regs for s in (0, 1)),
            align,
        )
        i_pad = round_up(max(r.pema.size for r in regs), align)

        body_idx = np.array([r.region.bodies for r in regs], dtype=np.int32)
        fric = np.array([r.region.fric for r in regs])

        def stacked(mats, n_rows, n_cols):
            return device_sparse(mats, n_rows, n_cols, dtype=sd,
                                 batch_shape=(R, 2))

        sides2 = [(i, s) for i in range(R) for s in (0, 1)]

        def compose(side):
            i, s = side
            body = systems[regs[i].region.bodies[s]]
            return _compose(regs[i], body.expand, body.expand_const, s)

        comp = dict(zip(sides2, thread_imap(compose, sides2)))
        # TtP/Tt (X^T systTran(_pena)) are nonzero only on body DOFs near
        # the interface: store them row-compacted with a shared scatter
        # index into the stacked (B, n) rhs (body offset baked in) instead
        # of (R, 2, n_pad, k) stacks that scale with the BODY dimension.
        t_offsets = [
            regs[i].region.bodies[s] * n_pad for i, s in sides2
        ]
        (TtP, Tt), t_idx = compact_device_sparse(
            [[comp[k][0] for k in sides2], [comp[k][1] for k in sides2]],
            m_pad, (R, 2), row_offsets=t_offsets, dtype=sd,
        )
        Bp = stacked([comp[k][2] for k in sides2], m_pad, n_pad)
        Pd = stacked([comp[k][4] for k in sides2], i_pad, n_pad)
        M = stacked([regs[i].sides[s].inte_mass for i, s in sides2], m_pad, m_pad)
        Mp = stacked(
            [regs[i].sides[s].inte_mass_pena for i, s in sides2], m_pad, m_pad
        )
        L = stacked([regs[i].sides[s].inpo_lagr for i, s in sides2], i_pad, m_pad)
        # E (inteInpo) is stored TRANSPOSED: a contact-zone interface node
        # can touch thousands of integral points (ELL k explodes to the max
        # over all regions), but every integral point touches exactly 4
        # nodes, so E^T has bounded row degree; applied via Ell.tmv scatter
        # (ELL in either format: Block-ELL has no tmv).
        E = device_sparse(
            [regs[i].sides[s].inte_inpo.T.tocsr() for i, s in sides2],
            i_pad, m_pad, dtype=sd, batch_shape=(R, 2), force_ell=True,
        )

        bp_const = np.zeros((R, 2, m_pad))
        pd_const = np.zeros((R, 2, i_pad))
        M_diag = np.ones((R, 2, m_pad))
        Mp_diag = np.ones((R, 2, m_pad))
        m_mask = np.zeros((R, 2, m_pad), dtype=bool)
        i_mask = np.zeros((R, i_pad), dtype=bool)
        rho_g = np.zeros((R, i_pad))
        for i, r in enumerate(regs):
            i_mask[i, : r.pema.size] = True
            rho_g[i, : r.pema.size] = r.pema * r.ngap
            for s in (0, 1):
                mdof = r.sides[s].inte_mass.shape[0]
                m_mask[i, s, :mdof] = True
                bp_const[i, s, :mdof] = comp[(i, s)][3]
                pd_const[i, s, : r.pema.size] = comp[(i, s)][5]
                M_diag[i, s, :mdof] = r.sides[s].inte_mass.diagonal()
                Mp_diag[i, s, :mdof] = r.sides[s].inte_mass_pena.diagonal()

        groups.append(
            RegionGroup(
                body_idx=torch.from_numpy(body_idx.astype(np.int64)),
                TtP=TtP,
                Tt=Tt,
                t_idx=t_idx,
                Bp=Bp,
                bp_const=torch.from_numpy(bp_const),
                M=M,
                Mp=Mp,
                M_diag=torch.from_numpy(M_diag),
                Mp_diag=torch.from_numpy(Mp_diag),
                L=L,
                Pd=Pd,
                pd_const=torch.from_numpy(pd_const),
                E=E,
                rho_g=torch.from_numpy(rho_g),
                fric=torch.from_numpy(fric),
                m_mask=torch.from_numpy(m_mask),
                i_mask=torch.from_numpy(i_mask),
            )
        )

    coarse = None
    if dole is not None:
        from .multiscale import (
            build_coarse_correction,
            build_coarse_correction_a,
        )

        m_pads = [g.bp_const.shape[-1] for g in groups]
        parts = []
        if musc_sett & 1:
            with _phase("MCONTACT::MULTISCALE (coarse correction A)"):
                parts.append(
                    build_coarse_correction_a(
                        systems, regions, meshes or [], list(dole), n_pad,
                        group_region_idx, m_pads, coarse_solver=coarse_solver,
                        dtype=sd,
                    )
                )
        if musc_sett & 2:
            with _phase("MCONTACT::MULTISCALE_1 (coarse correction B)"):
                parts.append(
                    build_coarse_correction(
                        systems, regions, list(dole), n_pad, group_region_idx,
                        m_pads, coarse_solver=coarse_solver,
                        compose_mg=mg if composed else None, dtype=sd,
                        compose_a=compose_a,
                    )
                )
        coarse = tuple(parts) if parts else None

    prob = AdmmProblem(
        mg=mg,
        cons_forc=torch.from_numpy(cons_forc),
        gram=gram,
        gram_lin=torch.from_numpy(gram_lin),
        gram_const=torch.from_numpy(gram_const),
        groups=tuple(groups),
        u_mask=torch.from_numpy(u_mask),
        coarse=coarse,
    )
    if sd != torch.float64:
        # on the host: casting after the upload would hold the float64
        # problem on the card first (the JAX package's sparse/bell.py
        # records a tripled peak from that order)
        with _phase("cast to the solve dtype (host)"):
            prob = cast_problem(prob, sd,
                                keep=(compose_a,) if composed else ())
    prob = to_device(prob, dev)
    meta = AdmmMeta(
        systems=list(systems),
        regions=list(regions),
        group_modes=modes,
        group_region_idx=group_region_idx,
        n_pad=n_pad,
    )
    return prob, meta
