"""Batched geometric-multigrid V-cycle (the port of ``solvers/mg.py``).

Re-design of the reference MGPIS (MGPIS.h:40-128): the row-sequential
symmetric Gauss-Seidel smoother is replaced by a degree-``CHEB_DEGREE``
Chebyshev polynomial smoother on D^{-1}A, and the coarsest level applies an
explicit dense inverse (one batched matmul).  All level operators carry a
leading body axis: one V-cycle call smooths every subdomain at once.

The host half (``build_hierarchy``) picks each level's format exactly as the
JAX package does on the CPU; the V-cycle runs in the hierarchy's dtype
(float32) while ``A_top``, the Krylov matvec operator, is in the solve
dtype: a float64 copy of the finest level, or in float32 the finest
level's operator itself.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.linalg
import scipy.sparse as sp
import torch

from ..sparse import bell
from ..sparse.bell import device_sparse, round_up
from ..sparse.dia import (
    class_cap,
    dia_from_csr_list,
    plane_classes,
    plane_dia_from_csr_list,
)
from ..utils.constants import DENSE_COARSE_MAXI
from ..utils.pool import thread_imap
from ..utils.precision import solve_dtype


class BatchBlocks:
    """Block-diagonal over the leading batch axis: each contiguous body
    range gets its own operator (different structured-grid shapes need
    different DIA offset sets)."""

    def __init__(self, ops: tuple, bounds: tuple[tuple[int, int], ...]):
        self.ops = tuple(ops)
        self.bounds = tuple((int(a), int(b)) for a, b in bounds)

    @property
    def n_rows(self) -> int:
        return self.ops[0].n_rows

    @property
    def dtype(self):
        return self.ops[0].dtype

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        outs = [op.mv(x[a:b]) for op, (a, b) in zip(self.ops, self.bounds)]
        return torch.cat(outs, dim=0)


def _stuff_axis(x: torch.Tensor, axis: int, stride: int,
                n_f: int) -> torch.Tensor:
    """Zero-stuff one grid axis: coarse length n_c -> fine length n_f with
    coarse values at positions 0, stride, 2*stride, ... (layout ops only)."""
    n_c = x.shape[axis]
    if stride == 1:
        assert n_f == n_c
        return x
    y = torch.stack([x, torch.zeros_like(x)], dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * n_c
    return y.reshape(shape).narrow(axis, 0, n_f)


class StructuredProl:
    """Prolongation on nested grids: P e_c = S @ stuff(e_c), where stuff
    zero-fills the coarse values into their fine-grid slots and S is the
    interpolation stencil as a square fine-grid DIA."""

    def __init__(self, S, fshape, cshape, strides, n_c_pad: int):
        self.S = S
        self.fshape = tuple(fshape)    # (nz, ny, nx) fine node grid
        self.cshape = tuple(cshape)
        self.strides = tuple(strides)  # (sz, sy, sx)
        self.n_c_pad = int(n_c_pad)

    def _stuff(self, e_c: torch.Tensor) -> torch.Tensor:
        nzc, nyc, nxc = self.cshape
        nzf, nyf, nxf = self.fshape
        batch = tuple(e_c.shape[:-1])
        x = e_c[..., : 3 * nzc * nyc * nxc].reshape(
            batch + (nzc, nyc, nxc, 3)
        )
        nb = len(batch)
        for ax, (s, nf) in enumerate(zip(self.strides, (nzf, nyf, nxf))):
            x = _stuff_axis(x, nb + ax, s, nf)
        x = x.reshape(batch + (3 * nzf * nyf * nxf,))
        pad = self.S.n_rows - x.shape[-1]
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        return x.contiguous()

    def mv(self, e_c: torch.Tensor) -> torch.Tensor:
        return self.S.mv(self._stuff(e_c))


class StructuredRest:
    """Restriction = P^T: r_c = unstuff(S^T r), a strided slice of the
    transposed stencil's output."""

    def __init__(self, St, fshape, cshape, strides, n_c_pad: int):
        self.St = St
        self.fshape = tuple(fshape)
        self.cshape = tuple(cshape)
        self.strides = tuple(strides)
        self.n_c_pad = int(n_c_pad)

    def mv(self, r: torch.Tensor) -> torch.Tensor:
        nzc, nyc, nxc = self.cshape
        nzf, nyf, nxf = self.fshape
        batch = tuple(r.shape[:-1])
        y = self.St.mv(r)[..., : 3 * nzf * nyf * nxf]
        g = y.reshape(batch + (nzf, nyf, nxf, 3))
        sz, sy, sx = self.strides
        g = g[..., ::sz, ::sy, ::sx, :]
        out = g.reshape(batch + (3 * nzc * nyc * nxc,))
        pad = self.n_c_pad - out.shape[-1]
        if pad:
            out = torch.nn.functional.pad(out, (0, pad))
        return out


CHEB_DEGREE = 3

# Below this un-deduplicated DIA footprint, weakly-compressing groups (<4x
# plane dedup) take plain Dia: the JAX package's rule, kept so the port
# picks the same formats.  Tests set it to 0 to force the PlaneDia path on
# tiny fixtures.
DIA_LATENCY_BYTES = 64 << 20
CHEB_LOWER_FRACTION = 0.25   # smoothing interval [lmax/4, 1.02*lmax]
CHEB_UPPER_SAFETY = 1.02


class MgLevel(NamedTuple):
    A: object                 # (B, n_l) operator at this level
    inv_diag: torch.Tensor    # (B, n_l)
    lmax: torch.Tensor        # (B,) upper eigenvalue estimate of D^{-1}A
    P: object | None          # prolongation from level below, None at 0
    Pt: object | None         # restriction to level below


class MgHierarchy(NamedTuple):
    levels: tuple[MgLevel, ...]   # index 0 = coarsest (precond dtype)
    # (B, n0, n0) explicit coarse inverses, or None when the coarse space is
    # too large to dense-invert (DENSE_COARSE_MAXI): the V-cycle then ends
    # in a Chebyshev sweep at level 0
    coarse_inv: torch.Tensor | None
    A_top: object                 # finest-level operator in the solve dtype


COARSE_CHEB_DEGREE = 12  # level-0 sweep when coarse_inv is None


def _stencil_matrix(P: sp.spmatrix, zmap: np.ndarray) -> sp.csr_matrix:
    """Square fine-grid stencil S with S[r, embed(c)] = P[r, c], where
    embed maps each coarse node to its fine-grid slot (GridInfo.zmaps)."""
    P = P.tocoo()
    cn, ck = P.col // 3, P.col % 3
    cols = 3 * zmap[cn] + ck
    n_f = P.shape[0]
    return sp.csr_matrix((P.data, (P.row, cols)), shape=(n_f, n_f))


def _pad_identity(m: sp.csr_matrix, n: int) -> sp.csr_matrix:
    """``sp.block_diag([m, sp.identity(n - m.shape[0])], format="csr")``
    without its COO round trip: m's rows in canonical order (sorted, with
    duplicates summed, as that conversion leaves them), then unit rows."""
    extra = n - m.shape[0]
    m = m.copy()
    m.sum_duplicates()
    dt = np.result_type(m.dtype, np.float64)
    indptr = np.concatenate([
        m.indptr, m.indptr[-1] + np.arange(1, extra + 1,
                                           dtype=m.indptr.dtype)])
    indices = np.concatenate([
        m.indices, np.arange(m.shape[1], m.shape[1] + extra,
                             dtype=m.indices.dtype)])
    data = np.concatenate([m.data.astype(dt, copy=False), np.ones(extra, dt)])
    return sp.csr_matrix((data, indices, indptr),
                         shape=(n, m.shape[1] + extra))


def estimate_lmax(A: sp.spmatrix, iters: int = 20, seed: int = 0) -> float:
    """Power iteration upper bound for lambda_max(D^{-1}A) (host, setup)."""
    A = A.tocsr()
    d = A.diagonal()
    d = np.where(d > 0, d, 1.0)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(A.shape[0])
    x /= np.linalg.norm(x)
    lam = 1.0
    for _ in range(iters):
        y = (A @ x) / d
        lam = float(np.linalg.norm(y))
        if lam == 0.0:
            return 1.0
        x = y / lam
    return lam


_NP_OF = {torch.float32: np.dtype(np.float32),
          torch.float64: np.dtype(np.float64)}
_TORCH_OF = {v: k for k, v in _NP_OF.items()}


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return _NP_OF[dtype]


def _bell_fits(mats, n_rows, n_cols) -> bool:
    # the JAX package's Block-ELL byte budget: where it fits, the generic
    # sparse format (device_sparse: Block-ELL under DDPCA_SPARSE_FORMAT=bell,
    # else ELL) instead of Dia
    S = bell._max_slots(mats, round_up(n_cols, bell.CB))
    entries = len(mats) * (round_up(n_rows, bell.RB) // bell.RB) * S \
        * bell.RB * bell.CB
    return entries * 4 <= bell.BELL_MAX_BYTES


def _dia_auto(mats, shape, n_rows, dt, pad_identity=True, classes=None):
    """The JAX package's structured format policy (mg.py:329-347): PlaneDia
    when the plane dedup pays (>= 4x) or the un-deduplicated bytes pass
    DIA_LATENCY_BYTES, plain Dia for small weakly-compressing groups,
    ``device_sparse``'s format (Block-ELL or ELL, sparse/bell.py) where no
    plane table fits and the Block-ELL budget does.  ``classes``:
    the matrices' ``plane_classes``, where the caller has them."""
    pd = plane_dia_from_csr_list(mats, shape, n_rows, dt,
                                 pad_identity=pad_identity, classes=classes)
    if pd is not None:
        C, D, P = pd.vals.shape
        planes = pd.kz.numel()
        dia_bytes = planes * D * P * np.dtype(dt).itemsize
        if 4 * C <= planes or dia_bytes > DIA_LATENCY_BYTES:
            return pd
        return dia_from_csr_list(mats, n_rows, dt, pad_identity=pad_identity)
    if _bell_fits(mats, n_rows, n_rows) and pad_identity:
        return device_sparse(mats, n_rows, n_rows, _TORCH_OF[np.dtype(dt)])
    return dia_from_csr_list(mats, n_rows, dt, pad_identity=pad_identity)


def build_hierarchy(
    cons_stif: list[list[sp.spmatrix]],
    real_prol: list[list[sp.spmatrix]],
    dtype: torch.dtype = torch.float32,
    assume_sym: bool = True,
    a_top_dtype: torch.dtype | None = None,
    grids=None,
) -> MgHierarchy:
    """Build a batched hierarchy (CPU tensors) from per-subdomain scipy
    matrices.

    ``cons_stif[b][l]`` level-l constrained stiffness of subdomain b
    (l=0 coarsest); ``real_prol[b][l]`` maps level l -> l+1.  All subdomains
    must have the same number of levels; shapes are padded to the batch max.
    The V-cycle runs in ``dtype``; ``A_top`` holds the finest operator in
    ``a_top_dtype`` (default: the solve dtype, ``utils/precision.py``).
    Where the two dtypes agree, ``A_top`` is ``levels[-1].A``, the same
    object, and no second copy of its tables exists."""
    B = len(cons_stif)
    L = len(cons_stif[0])
    assert all(len(cs) == L for cs in cons_stif), "uniform level count required"

    levels = []
    for l in range(L):
        mats = [cons_stif[b][l] for b in range(B)]
        n_pad = round_up(max(m.shape[0] for m in mats), 128)
        # pad diagonal with 1.0 so padded rows stay decoupled identity
        def pad(m, n_pad=n_pad):
            m = m.tocsr()
            return _pad_identity(m, n_pad) if m.shape[0] < n_pad else m

        padded = list(thread_imap(pad, mats))
        diag = np.stack([np.asarray(m.diagonal()) for m in padded])
        inv_diag = np.where(diag != 0.0, 1.0 / np.where(diag == 0, 1, diag), 1.0)
        lmax = np.array(list(thread_imap(estimate_lmax, padded)))
        levels.append(
            dict(
                mats=padded, inv_diag=inv_diag, lmax=lmax, n_pad=n_pad,
                pmats=(
                    [real_prol[b][l - 1] for b in range(B)] if l > 0 else None
                ),
            )
        )

    # coarse dense inverses (host scipy f64 factorization, shipped in dtype)
    n0 = levels[0]["n_pad"]
    if n0 > DENSE_COARSE_MAXI:
        inv = None
    else:
        inv = np.zeros((B, n0, n0))
        for b in range(B):
            m = cons_stif[b][0].toarray()
            nb = m.shape[0]
            dense = np.eye(n0)
            dense[:nb, :nb] = m
            try:
                if not assume_sym:
                    raise scipy.linalg.LinAlgError  # go straight to LU
                cho = scipy.linalg.cho_factor(dense)
                inv[b] = scipy.linalg.cho_solve(cho, np.eye(n0))
            except scipy.linalg.LinAlgError:
                # semi-definite coarse matrix (weakly constrained body): LU
                # with a tiny Tikhonov shift keeps the V-cycle a valid
                # preconditioner
                shift = 1e-12 * np.abs(np.diag(dense)).max()
                lu = scipy.linalg.lu_factor(dense + shift * np.eye(n0))
                inv[b] = scipy.linalg.lu_solve(lu, np.eye(n0))

    structured = grids is not None and all(g is not None for g in grids)
    if structured:
        # group contiguous bodies with identical grid shapes (BatchBlocks)
        bounds = []
        start = 0
        for b in range(1, B + 1):
            if b == B or grids[b].shapes != grids[start].shapes:
                bounds.append((start, b))
                start = b

        def _grouped(build_one):
            return BatchBlocks(
                tuple(build_one(a, b) for a, b in bounds), tuple(bounds)
            )

    np_dtype = _np_dtype(dtype)
    sd = a_top_dtype if a_top_dtype is not None else solve_dtype()
    # the finest level's plane classes serve both its V-cycle operator and
    # A_top, whose dtypes differ: found once, under the larger class cap
    top_classes = {}
    if structured and sd != dtype:
        L_top = L - 1
        for a, b in bounds:
            shape = grids[a].shapes[L_top]
            plane = 3 * shape[1] * shape[2]
            cap = max(class_cap(plane, np_dtype),
                      class_cap(plane, _np_dtype(sd)))
            top_classes[a, b] = plane_classes(
                levels[L_top]["mats"][a:b], shape, levels[L_top]["n_pad"],
                cap)
    dev_levels = []
    for l, lv in enumerate(levels):
        if structured:
            A = _grouped(
                lambda a, b, lv=lv, l=l: _dia_auto(
                    lv["mats"][a:b], grids[a].shapes[l], lv["n_pad"], np_dtype,
                    classes=top_classes.get((a, b)) if l == L - 1 else None,
                )
            )
            if l > 0:
                n_f, n_c = lv["n_pad"], levels[l - 1]["n_pad"]

                def _prols(a, b, l=l, n_f=n_f, n_c=n_c, transpose=False):
                    g0 = grids[a]

                    def stencil(bb):
                        S = _stencil_matrix(
                            real_prol[bb][l - 1], grids[bb].zmaps[l - 1]
                        )
                        return S.T.tocsr() if transpose else S

                    mats = list(thread_imap(stencil, range(a, b)))
                    Sd = _dia_auto(
                        mats, g0.shapes[l], n_f, np_dtype, pad_identity=False
                    )
                    fshape = g0.shapes[l]
                    cshape = g0.shapes[l - 1]
                    strides = g0.strides[l - 1]
                    if transpose:
                        return StructuredRest(Sd, fshape, cshape, strides, n_c)
                    return StructuredProl(Sd, fshape, cshape, strides, n_c)

                P = _grouped(lambda a, b: _prols(a, b))
                Pt = _grouped(lambda a, b: _prols(a, b, transpose=True))
            else:
                P = Pt = None
        else:
            if l > 0:
                n_fine, n_coar = lv["n_pad"], levels[l - 1]["n_pad"]
                P = device_sparse(lv["pmats"], n_fine, n_coar, dtype)
                Pt = device_sparse(
                    [m.T.tocsr() for m in lv["pmats"]], n_coar, n_fine, dtype
                )
            else:
                P = Pt = None
            A = device_sparse(lv["mats"], lv["n_pad"], lv["n_pad"], dtype)
        dev_levels.append(
            MgLevel(
                A=A,
                inv_diag=torch.from_numpy(lv["inv_diag"]).to(dtype),
                lmax=torch.from_numpy(lv["lmax"]).to(dtype),
                P=P,
                Pt=Pt,
            )
        )
    # Krylov matvec operator in the solve dtype; it aliases the finest level
    # when the two dtypes agree
    if sd == dtype:
        A_top = dev_levels[-1].A
    elif structured:
        A_top = _grouped(
            lambda a, b: _dia_auto(
                levels[-1]["mats"][a:b], grids[a].shapes[-1],
                levels[-1]["n_pad"], _np_dtype(sd),
                classes=top_classes.get((a, b)),
            )
        )
    else:
        A_top = device_sparse(
            levels[-1]["mats"], levels[-1]["n_pad"], levels[-1]["n_pad"], sd
        )
    return MgHierarchy(
        levels=tuple(dev_levels),
        coarse_inv=None if inv is None else torch.from_numpy(inv).to(dtype),
        A_top=A_top,
    )


def chebyshev_smooth(A, inv_diag: torch.Tensor, lmax: torch.Tensor,
                     b: torch.Tensor, x: torch.Tensor,
                     degree: int = CHEB_DEGREE) -> torch.Tensor:
    """Chebyshev(degree) smoothing of A x = b on [lmax*frac, lmax*safety]
    (Saad, Iterative Methods for Sparse Linear Systems, Alg. 12.1, with
    Jacobi left preconditioning).  ``lmax`` carries b's batch axes."""
    lmax_s = (CHEB_UPPER_SAFETY * lmax)[..., None]
    lmin_s = (CHEB_LOWER_FRACTION * lmax)[..., None]
    theta = 0.5 * (lmax_s + lmin_s)
    delta = 0.5 * (lmax_s - lmin_s)
    r = b - A.mv(x)
    d = inv_diag * r / theta
    x = x + d
    rho = delta / theta
    for _ in range(degree - 1):
        r = r - A.mv(d)
        rho_new = 1.0 / (2.0 * theta / delta - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * (inv_diag * r)
        x = x + d
        rho = rho_new
    return x


def vcycle(mg: MgHierarchy, b: torch.Tensor,
           x: torch.Tensor | None = None) -> torch.Tensor:
    """One V(1,1) cycle on the finest level (MGPIS::MULT_VCYC semantics with
    the Chebyshev smoother).  b, x: (B, n_finest) in any float dtype; the
    cycle runs in the hierarchy's (float32) dtype and casts back."""
    L = len(mg.levels) - 1
    in_dtype = b.dtype
    dtype = mg.levels[-1].A.dtype

    def cycle(l: int, bl: torch.Tensor, xl: torch.Tensor) -> torch.Tensor:
        if l == 0:
            if mg.coarse_inv is None:
                lv0 = mg.levels[0]
                return chebyshev_smooth(
                    lv0.A, lv0.inv_diag, lv0.lmax, bl, xl,
                    degree=COARSE_CHEB_DEGREE,
                )
            return torch.matmul(mg.coarse_inv, bl[..., None])[..., 0]
        lv = mg.levels[l]
        xl = chebyshev_smooth(lv.A, lv.inv_diag, lv.lmax, bl, xl)
        r = bl - lv.A.mv(xl)
        rc = lv.Pt.mv(r)
        ec = cycle(l - 1, rc, torch.zeros_like(rc))
        xl = xl + lv.P.mv(ec)
        xl = chebyshev_smooth(lv.A, lv.inv_diag, lv.lmax, bl, xl)
        return xl

    # scale into a well-ranged float32 window (residual norms can be
    # ~1e-14*b)
    scale = torch.clamp(b.abs().amax(dim=-1, keepdim=True),
                        min=torch.finfo(b.dtype).tiny)
    b_s = (b / scale).to(dtype)
    x_s = torch.zeros_like(b_s) if x is None else (x / scale).to(dtype)
    out = cycle(L, b_s, x_s)
    return out.to(in_dtype) * scale
