"""Dual-mortar monolithic solver with semi-smooth Newton active set.

Re-design of MCONTACT::LAGRANGE (MCONTACT.h:2847-3701) — the reference's
comparison baseline ("dual mortar + GMG-BiCGSTAB") and the cross-solver
oracle for the ADMM results:

  1. drop integration points touching hanging non-mortar nodes (:2871-2893);
  2. per non-mortar segment, dual basis A = D M^{-1} (:2915-2947);
  3. weight-averaged nodal normals + tangent frames (:2969-3037);
  4. mortar coupling B with the dual basis on the non-mortar side (the
     non-mortar block is diagonal by biorthogonality) and weighted gaps
     (:3040-3124);
  5. saddle system [K B^T; B 0] over all bodies' reduced DOFs + multipliers;
  6. active-set loop: states 0/1/2 = inactive/sliding/sticking per node;
     slip-direction rows, active-row selection, *condensation* of each
     multiplier against its dominant displacement DOF(s), then solve the
     condensed nonsymmetric system; states update by semi-smooth Newton
     residuals with scale 210e9 until no state changes (:3184-3699).

The port of the JAX package's ``admm/lagrange.py``.  All sparse
reorganization happens on the host (scipy: shapes change each active-set
iteration), copied as it is; the condensed solve runs as BiCGSTAB on
``device`` (f64 ELL matvec, torch ops; the V-cycle of ``prec_type=1`` in
f32).  ``prec_type`` selects the preconditioner, mirroring the reference:

  * 1 — restricted-GMG (MCONTACT.h:3419-3562): the per-body multigrid
    prolongations are stacked block-diagonally, the finest one row-restricted
    to the non-condensed DOFs, and the condensed operator Galerkin-coarsened
    down the hierarchy; one V-cycle on that hierarchy preconditions BiCGSTAB
    (reference: ``mgpi.BiCGSTAB_SOLV(1, ·)``).
  * 2 — Jacobi-preconditioned BiCGSTAB (reference: Eigen::BiCGSTAB,
    MCONTACT.h:3565-3578).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..fem.constraints import ConstrainedSystem
from ..solvers.krylov import bicgstab, jacobi_preconditioner
from ..solvers.mg import build_hierarchy, vcycle
from ..sparse.ell import Ell, ell_from_csr
from ..utils.device import resolve_device, to_device
from .operators import RegionOps

SENE_SCALE = 210.0e9   # semi-smooth Newton complementarity scale


def _tangent_frame(normals: np.ndarray) -> np.ndarray:
    """Right-handed orthonormal frames (n, t1, t2) per row; robust analogue
    of the reference's branchy construction (MCONTACT.h:2993-3036)."""
    n = normals / np.linalg.norm(normals, axis=-1, keepdims=True)
    helper = np.where(
        (np.abs(n[:, 0]) > 0.9)[:, None],
        np.array([0.0, 1.0, 0.0]),
        np.array([1.0, 0.0, 0.0]),
    )
    t1 = np.cross(helper, n)
    t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = np.cross(n, t1)
    return np.stack([n, t1, t2], axis=1)   # (m,3,3) rows n,t1,t2


@dataclass
class LagrangeResult:
    u: list[np.ndarray]            # per body reduced displacement
    lagr: list[np.ndarray]         # per region (3m,) multipliers (node frame)
    status: list[np.ndarray]       # per region (m,) final active states
    iters: int
    nm_nodes: list[np.ndarray] = None  # per region (m,) non-mortar node ids
    # per Newton pass: Khat rows, BiCGSTAB iterations (None where spsolve
    # ran), host seconds of assembly, condensation and Khat (``host_s``),
    # seconds of the preconditioner build (``prec_s``, None where spsolve
    # ran) and of the condensed solve (``solve_s``, ended by a device sync)
    passes: list[dict] = field(default_factory=list)


def solve_lagrange(
    systems: list[ConstrainedSystem],
    regions: list[RegionOps],
    meshes: list,
    fric: list[float] | None = None,
    max_newton: int = 30,
    use_device: bool = True,
    prec_type: int = 2,
    device="cuda",
) -> LagrangeResult:
    """The dual-mortar solve.  ``use_device=False``, or a condensed
    operator of 500 rows or fewer, solves each Newton pass with the host's
    ``spsolve``; otherwise the condensed system runs as BiCGSTAB on
    ``device`` (default the card; raises without one unless ``"cpu"``)."""
    dev = resolve_device(device)
    B = len(systems)
    nred = [s.n_dof for s in systems]
    base = np.concatenate([[0], np.cumsum(nred)])
    Nd = int(base[-1])

    # ---- step 1+2+3+4 per region ------------------------------------------
    moco = []          # per region: [side0, side1] (3m x n_red) couplings
    gapd = []          # per region: (3m,) weighted gaps
    nm_nodes = []      # per region: (m,) non-mortar node ids
    region_ips = []
    # per-body nodal normal accumulators (vectorized: scatter-add per corner
    # instead of a per-(ip, corner) Python dict walk — 10^4+ nodes at DEHW
    # scale)
    acc_n: dict[int, np.ndarray] = {}
    acc_w: dict[int, np.ndarray] = {}

    for r in regions:
        ip = r.region.ip
        b0 = r.region.bodies[0]
        mesh0 = meshes[b0]
        # drop ips touching hanging non-mortar nodes
        hang_level = mesh0.max_level + 1
        keep = ~(mesh0.node_level[ip.nodes[0]] == hang_level).any(axis=1)
        idx = np.nonzero(keep)[0]
        region_ips.append(idx)
        nodes0 = ip.nodes[0][idx]
        w = ip.weight[idx]
        if b0 not in acc_n:
            acc_n[b0] = np.zeros((meshes[b0].n_nodes, 3))
            acc_w[b0] = np.zeros(meshes[b0].n_nodes)
        contrib = w[:, None] * ip.basis[idx, 0]     # (I, 3)
        for k in range(4):
            np.add.at(acc_n[b0], nodes0[:, k], contrib)
            np.add.at(acc_w[b0], nodes0[:, k], w)

    # nodal frames per body (rows with zero weight never get looked up)
    frames_by_body: dict[int, np.ndarray] = {}
    for b0, an in acc_n.items():
        aw = np.maximum(acc_w[b0], 1.0e-300)[:, None]
        nrm = an / aw
        nz_rows = np.linalg.norm(nrm, axis=1) > 0
        fr = np.tile(np.eye(3), (an.shape[0], 1, 1))
        if nz_rows.any():
            fr[nz_rows] = _tangent_frame(nrm[nz_rows])
        frames_by_body[b0] = fr

    for ri, r in enumerate(regions):
        ip = r.region.ip
        idx = region_ips[ri]
        b0, b1 = r.region.bodies
        nodes0 = ip.nodes[0][idx]
        nodes1 = ip.nodes[1][idx]
        shape0 = ip.shape[0][idx]
        shape1 = ip.shape[1][idx]
        w = ip.weight[idx]
        gap = ip.gap[idx]

        # non-mortar node numbering (first appearance, MCONTACT.h:2954-2966)
        uniq, cidx = np.unique(nodes0.reshape(-1), return_inverse=True)
        cidx = cidx.reshape(-1, 4)
        m = uniq.size
        nm_nodes.append(uniq)

        # dual basis per segment: A = D M^-1 over the ips of each segment
        seg_key = nodes0  # segments identified by their node rows
        _, seg_id = np.unique(
            np.ascontiguousarray(seg_key).view(
                [("", seg_key.dtype)] * 4
            ).ravel(),
            return_inverse=True,
        )
        n_seg = seg_id.max() + 1 if seg_id.size else 0
        D = np.zeros((n_seg, 4, 4))
        M = np.zeros((n_seg, 4, 4))
        wdiag = np.zeros((idx.size, 4, 4))
        wdiag[:, np.arange(4), np.arange(4)] = w[:, None] * shape0
        np.add.at(D, seg_id, wdiag)
        np.add.at(M, seg_id, np.einsum("i,ia,ib->iab", w, shape0, shape0))
        A = np.linalg.solve(M.transpose(0, 2, 1), D.transpose(0, 2, 1)).transpose(0, 2, 1)
        dual = np.einsum("iab,ib->ia", A[seg_id], shape0)     # (I,4)

        # mortar coupling (notaMoco): rows = 3 per non-mortar node in frame
        Fr = frames_by_body[b0][uniq]                         # (m,3,3)
        sides = []
        for tv, (nds, shp, bb) in enumerate(
            ((nodes0, shape0, b0), (nodes1, shape1, b1))
        ):
            if tv == 0:
                # diagonal D-block by biorthogonality: each non-mortar node
                # couples only with itself (MCONTACT.h:3070-3072)
                vals = (w[:, None] * dual * shape0)           # (I,4)
                rows3 = 3 * cidx[:, :, None] + np.arange(3)
                cols3 = 3 * nds[:, :, None] + np.arange(3)
                mat = sp.coo_matrix(
                    (
                        np.repeat(vals.ravel(), 3),
                        (rows3.ravel(), cols3.ravel()),
                    ),
                    shape=(3 * m, 3 * meshes[bb].n_nodes),
                ).tocsr()
            else:
                # full: w dual_j shape_m -> (node j, node m) 3x3 identity blocks
                vals = np.einsum("i,ia,ib->iab", w, dual, shp)  # (I,4,4)
                rows3 = np.broadcast_to(
                    3 * cidx[:, :, None, None] + np.arange(3)[None, None, None, :],
                    (idx.size, 4, 4, 3),
                )
                cols3 = np.broadcast_to(
                    3 * nds[:, None, :, None] + np.arange(3)[None, None, None, :],
                    (idx.size, 4, 4, 3),
                )
                v3 = np.broadcast_to(vals[..., None], (idx.size, 4, 4, 3))
                mat = sp.coo_matrix(
                    (v3.ravel(), (rows3.ravel(), cols3.ravel())),
                    shape=(3 * m, 3 * meshes[bb].n_nodes),
                ).tocsr()
                mat = -mat
            # frame rotation rows: lambda expressed in (n,t1,t2)
            jj = np.arange(m)
            fr_blocks = sp.coo_matrix(
                (
                    Fr.ravel(),
                    (
                        (3 * jj[:, None, None]
                         + np.arange(3)[None, :, None]
                         + np.zeros((1, 1, 3), np.int64)).ravel(),
                        (3 * jj[:, None, None]
                         + np.arange(3)[None, None, :]
                         + np.zeros((1, 3, 1), np.int64)).ravel(),
                    ),
                ),
                shape=(3 * m, 3 * m),
            ).tocsr()
            mat = (fr_blocks @ mat @ systems[bb].expand).tocsr()
            sides.append(mat)
        moco.append(sides)

        g = np.zeros(3 * m)
        np.add.at(g, 3 * cidx.ravel(), (w[:, None] * dual * gap[:, None]).ravel())
        gapd.append(g)

    fric = [r.region.fric for r in regions] if fric is None else fric

    # ---- saddle structure --------------------------------------------------
    acin_reco = np.concatenate([[0], np.cumsum([n.size for n in nm_nodes])])
    Nl = 3 * int(acin_reco[-1])
    K_blocks = sp.block_diag(
        [systems[v].cons_stif[-1] for v in range(B)], format="csr"
    )
    br_r, br_c, br_v = [], [], []
    for ri, r in enumerate(regions):
        r0 = 3 * acin_reco[ri]
        for tv in (0, 1):
            bb = r.region.bodies[tv]
            co = moco[ri][tv].tocoo()
            br_r.append(co.row + r0)
            br_c.append(co.col + base[bb])
            br_v.append(co.data)
    B_rows = sp.coo_matrix(
        (np.concatenate(br_v) if br_v else np.zeros(0),
         (np.concatenate(br_r) if br_r else np.zeros(0, np.int64),
          np.concatenate(br_c) if br_c else np.zeros(0, np.int64))),
        shape=(Nl, Nd),
    ).tocsr()
    forc = np.concatenate(
        [np.concatenate([systems[v].cons_forc for v in range(B)]),
         np.concatenate(gapd) if gapd else np.zeros(0)]
    )

    # initial states (MCONTACT.h:2954-2966): fric==0 -> 1, else -> 2
    status = [
        np.full(nm_nodes[ri].size, 1 if regions[ri].region.fric == 0.0 else 2,
                dtype=np.int64)
        for ri in range(len(regions))
    ]
    hist = [s.copy() for s in status]
    rel_disp = [np.zeros(3 * n.size) for n in nm_nodes]
    lagr = [np.zeros(3 * n.size) for n in nm_nodes]

    u_out = None
    it = 0
    passes = []
    for it in range(max_newton):
        t_pass = time.perf_counter()
        # slip rows for sliding frictional nodes (MCONTACT.h:3188-3239):
        # one global slip operator assembled as COO (the per-node lil_matrix
        # loop was the host bottleneck above fixture scale)
        sl_r, sl_c, sl_v = [], [], []
        for ri, r in enumerate(regions):
            mu = regions[ri].region.fric
            if mu <= 0.0:
                continue
            r0 = 3 * acin_reco[ri]
            js = np.nonzero(status[ri] == 1)[0]
            if js.size == 0:
                continue
            use_rel = np.isin(hist[ri][js], (0, 1))
            t0 = np.where(use_rel, rel_disp[ri][3 * js + 1],
                          lagr[ri][3 * js + 1])
            t1 = np.where(use_rel, rel_disp[ri][3 * js + 2],
                          lagr[ri][3 * js + 2])
            tt = np.hypot(t0, t1)
            ok_t = tt > 0.0
            js, t0, t1, tt = js[ok_t], t0[ok_t], t1[ok_t], tt[ok_t]
            rows = r0 + 3 * js
            sl_r.append(np.repeat(rows, 2))
            sl_c.append(np.stack([rows + 1, rows + 2], axis=1).ravel())
            sl_v.append(
                (mu * np.stack([t0 / tt, t1 / tt], axis=1)).ravel()
            )
        if sl_r:
            slid = sp.coo_matrix(
                (np.concatenate(sl_v),
                 (np.concatenate(sl_r), np.concatenate(sl_c))),
                shape=(Nl, Nl),
            ).tocsr()
            extra = (slid @ B_rows).T.tocsr()
        else:
            extra = sp.csr_matrix((Nd, Nl))

        # active multiplier selection (realMatr, MCONTACT.h:3242-3279)
        keep_parts = []
        for ri in range(len(regions)):
            r0 = 3 * acin_reco[ri]
            st = status[ri]
            j1 = np.nonzero(st == 1)[0]
            j2 = np.nonzero(st == 2)[0]
            rows = np.concatenate(
                [r0 + 3 * j1,
                 (r0 + 3 * j2[:, None] + np.arange(3)).ravel()]
            )
            rows.sort()
            keep_parts.append(rows)
        keep_rows = (
            np.concatenate(keep_parts).astype(np.int64)
            if keep_parts else np.zeros(0, np.int64)
        )
        nl = keep_rows.size
        Bk = B_rows[keep_rows]                        # (nl, Nd)
        BkT = (B_rows.T + extra)[:, keep_rows]        # (Nd, nl) incl slip rows
        gk = forc[Nd:][keep_rows]

        # condensation: dominant displacement DOF(s) per multiplier
        # (MCONTACT.h:3283-3324): status1 -> argmax |Bk| within the
        # non-mortar body block; status2 -> the 3 coupled DOFs.  Works on the
        # CSR arrays directly — the previous per-row .toarray() materialized
        # an Nd-length dense vector per multiplier.
        cond_dofs = np.empty(nl, dtype=np.int64)
        indptr, indices, data = Bk.indptr, Bk.indices, Bk.data
        row = 0
        ok = True
        for ri, r in enumerate(regions):
            b0 = r.region.bodies[0]
            lo, hi = base[b0], base[b0 + 1]
            st = status[ri]
            for j in range(st.size):
                if st[j] == 1:
                    sl = slice(indptr[row], indptr[row + 1])
                    cols = indices[sl]
                    inb = (cols >= lo) & (cols < hi)
                    vals = np.abs(data[sl][inb])
                    if vals.size == 0:
                        ok = False
                    else:
                        cond_dofs[row] = cols[inb][int(vals.argmax())]
                    row += 1
                elif st[j] == 2:
                    sl = slice(indptr[row], indptr[row + 3])
                    cols = np.unique(indices[sl])
                    cols = cols[(cols >= lo) & (cols < hi)]
                    if cols.size != 3:
                        ok = False
                        cols = np.resize(cols, 3)
                    cond_dofs[row:row + 3] = cols
                    row += 3
        assert ok and row == nl, "condensation pivot failure"

        mask = np.zeros(Nd, dtype=bool)
        mask[cond_dofs] = True
        rest = np.nonzero(~mask)[0]
        # blocks
        K00 = K_blocks[cond_dofs][:, cond_dofs]
        K01 = K_blocks[cond_dofs][:, rest]
        K10 = K_blocks[rest][:, cond_dofs]
        K11 = K_blocks[rest][:, rest]
        T0 = Bk[:, cond_dofs]
        T1 = Bk[:, rest]
        T0f = BkT[cond_dofs]
        T1f = BkT[rest]
        F0 = forc[cond_dofs]
        F1 = forc[rest]

        # block inverses of T0 / T0f (diag or 3x3, MCONTACT.h:3372-3411)
        iT0 = _block_inverse(T0, status, regions)
        iT0f = _block_inverse(T0f.T, status, regions).T

        Khat = (K11 - K10 @ iT0 @ T1 - T1f @ iT0f @ K01
                + T1f @ iT0f @ K00 @ iT0 @ T1).tocsr()
        Fhat = (F1 - K10 @ (iT0 @ gk) - T1f @ (iT0f @ F0)
                + T1f @ (iT0f @ (K00 @ (iT0 @ gk))))

        if use_device and Khat.shape[0] > 500:
            vals, cols, n_cols = ell_from_csr(Khat)
            e = Ell(vals=torch.from_numpy(vals).to(dev, torch.float64),
                    cols=torch.from_numpy(cols).to(dev), n_cols=n_cols)
            rhs = torch.from_numpy(Fhat).to(dev, torch.float64)
            host_s = time.perf_counter() - t_pass
            t_prec = time.perf_counter()
            prec = _restricted_gmg_precond(Khat, systems, base, rest, dev) \
                if prec_type == 1 else None
            if prec is None:
                prec = jacobi_preconditioner(
                    torch.from_numpy(Khat.diagonal()).to(dev, torch.float64))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            prec_s = time.perf_counter() - t_prec
            t_solve = time.perf_counter()
            res = bicgstab(e.mv, prec, rhs, maxiter=Khat.shape[0])
            U1 = res.x.cpu().numpy()
            krylov_iters = res.iters
            # free this pass's device operators before the next pass
            # builds its own
            del e, prec, rhs, res
        else:
            host_s = time.perf_counter() - t_pass
            prec_s = None
            t_solve = time.perf_counter()
            U1 = spla.spsolve(Khat.tocsc(), Fhat)
            krylov_iters = None
        passes.append(dict(khat_rows=int(Khat.shape[0]),
                           krylov_iters=krylov_iters, host_s=host_s,
                           prec_s=prec_s,
                           solve_s=time.perf_counter() - t_solve))
        t_rest = time.perf_counter()

        U0 = iT0 @ gk - iT0 @ (T1 @ U1)
        lam_k = (iT0f @ F0 - iT0f @ (K00 @ (iT0 @ gk))
                 - iT0f @ (K01 @ U1) + iT0f @ (K00 @ (iT0 @ (T1 @ U1))))

        u_full = np.zeros(Nd)
        u_full[cond_dofs] = U0
        u_full[rest] = U1
        lam_full = np.zeros(Nl)
        lam_full[keep_rows] = lam_k

        # recover per-region relative displacement and multipliers
        hist = [s.copy() for s in status]
        changes = 0
        u_out = [u_full[base[v] : base[v + 1]] for v in range(B)]
        for ri, r in enumerate(regions):
            r0 = 3 * acin_reco[ri]
            n3 = 3 * nm_nodes[ri].size
            wd = -gapd[ri]
            for tv in (0, 1):
                bb = r.region.bodies[tv]
                wd = wd + moco[ri][tv] @ u_full[base[bb] : base[bb + 1]]
            rel_disp[ri] = wd
            lagr[ri] = lam_full[r0 : r0 + n3]
            mu = r.region.fric
            if mu < 0.0:
                continue
            lam3 = lagr[ri].reshape(-1, 3)
            wd3 = wd.reshape(-1, 3)
            old = status[ri]
            sene_n = lam3[:, 0] + SENE_SCALE * wd3[:, 0]
            if mu == 0.0:
                new = np.where(sene_n <= 0.0, 0, 1)
            else:
                sene_t = np.where(
                    old == 2,
                    np.hypot(lam3[:, 1], lam3[:, 2]),
                    mu * lam3[:, 0]
                    + SENE_SCALE * np.hypot(wd3[:, 1], wd3[:, 2]),
                )
                new = np.where(
                    sene_n <= 0.0, 0,
                    np.where(sene_t >= mu * sene_n, 1, 2),
                )
            changes += int((new != old).sum())
            status[ri] = new.astype(np.int64)
        passes[-1]["host_s"] += time.perf_counter() - t_rest
        if changes == 0:
            break
    return LagrangeResult(u=u_out, lagr=lagr, status=status, iters=it,
                          nm_nodes=nm_nodes, passes=passes)


def _restricted_gmg_precond(Khat, systems, base, rest, device):
    """precType=1 preconditioner (MCONTACT.h:3419-3562): a V-cycle on the
    condensed operator, using the bodies' own multigrid prolongations
    stacked block-diagonally with the finest-level rows restricted to the
    non-condensed DOF set ``rest``.  Coarser levels keep the full coarse
    bases (the condensed DOFs are a measure-zero interface set; Galerkin
    coarsening through the restricted top keeps the cycle consistent).
    Returns None when any body lacks a geometric hierarchy."""
    depth = min(len(s.real_prol) for s in systems)
    if depth == 0:
        return None
    B = len(systems)
    prols = []
    for l in range(depth):
        # align at the finest level: use each body's last `depth` prols
        blocks = [systems[v].real_prol[len(systems[v].real_prol) - depth + l]
                  for v in range(B)]
        prols.append(sp.block_diag(blocks, format="csr"))
    # row-restrict the finest prolongation to non-condensed DOFs
    Nd = int(base[-1])
    S = sp.csr_matrix(
        (np.ones(rest.size), (np.arange(rest.size), rest)),
        shape=(rest.size, Nd),
    )
    prols[-1] = (S @ prols[-1]).tocsr()
    # Galerkin chain down from Khat
    mats = [Khat.tocsr()]
    for P in reversed(prols):
        mats.append((P.T @ mats[-1] @ P).tocsr())
    mats.reverse()  # coarsest first
    # No size cap: build_hierarchy dense-inverts the coarsest level up to
    # DENSE_COARSE_MAXI and otherwise ends the V-cycle in an aggressive
    # Chebyshev sweep — still a fixed linear operator, so refined meshes keep
    # the restricted-GMG preconditioner instead of silently dropping to
    # Jacobi (reference behavior: MCONTACT.h:3419-3562 always builds it).
    # No ``grids``: every level is ELL (K1 serves structured levels only).
    # The V-cycle runs in f32; A_top, which the preconditioner never
    # applies, aliases the f32 finest level instead of an f64 copy.
    mg = build_hierarchy([mats], [prols], assume_sym=False,
                         a_top_dtype=torch.float32)
    mg = to_device(mg, device)
    n = Khat.shape[0]
    n_pad = mg.levels[-1].A.n_rows  # hierarchy pads to 128 rows

    def prec(r):
        rp = torch.nn.functional.pad(r, (0, n_pad - n)) if n_pad > n else r
        return vcycle(mg, rp[None])[0][:n]

    return prec


def _block_inverse(T0: sp.spmatrix, status, regions) -> sp.csr_matrix:
    """Invert the (1x1 / 3x3) diagonal blocks of T0 (MCONTACT.h:3372-3411).

    Vectorized: slot -> block-id map, one COO filter for the 3x3 block
    entries, batched np.linalg.inv (the per-multiplier csr indexing loop
    was quadratic-ish at DEHW scale)."""
    T0 = T0.tocsr()
    n = T0.shape[0]
    # slot layout: walk the active nodes once to mark 1x1 vs 3x3 slots
    starts1, starts3 = [], []
    k = 0
    for ri in range(len(regions)):
        st = status[ri]
        for j in range(st.size):
            if st[j] == 1:
                starts1.append(k)
                k += 1
            elif st[j] == 2:
                starts3.append(k)
                k += 3
    assert k == n
    starts1 = np.asarray(starts1, dtype=np.int64)
    starts3 = np.asarray(starts3, dtype=np.int64)

    rows_out, cols_out, vals_out = [], [], []
    if starts1.size:
        d = T0.diagonal()
        rows_out.append(starts1)
        cols_out.append(starts1)
        vals_out.append(1.0 / d[starts1])
    if starts3.size:
        # block id per slot (-1 for 1x1 slots)
        bid = np.full(n, -1, np.int64)
        off = np.full(n, 0, np.int64)
        for a in range(3):
            bid[starts3 + a] = np.arange(starts3.size)
            off[starts3 + a] = a
        coo = T0.tocoo()
        sel = (bid[coo.row] >= 0) & (bid[coo.row] == bid[coo.col])
        blocks = np.zeros((starts3.size, 3, 3))
        blocks[bid[coo.row[sel]], off[coo.row[sel]], off[coo.col[sel]]] = \
            coo.data[sel]
        inv = np.linalg.inv(blocks)
        a3 = np.arange(3)
        rows_out.append(
            (starts3[:, None, None] + a3[None, :, None]
             + np.zeros((1, 1, 3), np.int64)).ravel()
        )
        cols_out.append(
            (starts3[:, None, None] + a3[None, None, :]
             + np.zeros((1, 3, 1), np.int64)).ravel()
        )
        vals_out.append(inv.ravel())
    if not rows_out:
        return sp.csr_matrix((n, n))
    return sp.csr_matrix(
        (np.concatenate(vals_out),
         (np.concatenate(rows_out), np.concatenate(cols_out))),
        shape=T0.shape,
    )
