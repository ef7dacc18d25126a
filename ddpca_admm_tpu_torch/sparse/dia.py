"""DIA (diagonal) sparse formats for structured grids (the port of
``sparse/dia.py``).

A hex8 stiffness on a uniform Cartesian grid in coordinate-lexicographic
node order (z, y, x major, 3 dof minor) is a pure stencil: every row's
couplings sit at a fixed set of ``col - row`` offsets.  Storing one value
vector per offset turns SpMV into ``y = sum_d vals[d] * shift(x, off_d)``.

``Dia`` stores every row's values; ``PlaneDia`` stores one (D, P) value slab
per class of equal z-planes plus a class id per (body, plane), and its SpMV
runs the hand-written CUDA kernel (``plane_dia_kernel.py``) on the card.
Rows beyond the active range act as identity (``tail_identity``, the
hierarchy's padding) or as zero (the transfer stencils).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..utils.pool import thread_imap
from .ell import broadcast_shapes

# The CUDA kernel's plan (csrc/plane_dia.cu, built once per operator): at
# most PLAN_CAP planes per work item and PLAN_WINDOW shifts per offset
# group (the kernel refuses a plan built for other numbers); a block takes
# PLAN_TILE_BYTES of plane columns.  A launch of fewer than PLAN_MIN_BLOCKS
# blocks (about three per SM of an H100) is bound by its chains of load
# latencies, so the plan of a small operator cuts its work items smaller
# (``plan_cap``).
PLAN_CAP = 8
PLAN_WINDOW = 12
PLAN_TILE_BYTES = 512
PLAN_MIN_BLOCKS = 384

# The class cap that decides between PlaneDia and the other formats: the
# JAX package's VALS_VMEM_MAX (sparse/pallas_dia.py), copied as a plain
# number so the port picks exactly the JAX package's CPU formats.  It says
# nothing about the CUDA kernel, which takes any class count.
PLANE_DIA_CLASS_BYTES = 48 * 1024 * 1024


def _window_starts(offsets: tuple[int, ...], device) -> torch.Tensor:
    """Start of each offset's window in x padded by (-min, max) offsets."""
    lo = min(offsets + (0,))
    return torch.tensor([o - lo for o in offsets], dtype=torch.int64,
                        device=device)


def _window_runs(offsets: tuple[int, ...]) -> tuple[tuple[int, ...], ...]:
    """Split the offsets (sorted, unique) into runs (d0, d1, s0, step) whose
    window starts in the padded x are s0, s0 + step, ...: a hex8 stencil
    has a few runs of consecutive or evenly spaced offsets."""
    lo = min(offsets + (0,))
    starts = [o - lo for o in offsets]
    runs = []
    d0 = 0
    while d0 < len(starts):
        d1 = d0 + 1
        step = starts[d1] - starts[d0] if d1 < len(starts) else 1
        if step > 0:
            while d1 < len(starts) and starts[d1] - starts[d1 - 1] == step:
                d1 += 1
        else:
            step = 1
        runs.append((d0, d1, starts[d0], step))
        d0 = d1
    return tuple(runs)


def _shifted_sum(op, vals_run, xs, na, plane=None):
    """sum_d vals_d[i] * xs[i + off_d] over the na active rows of ``op``
    (a Dia or PlaneDia), xs zero-padded outside its own range.
    ``vals_run(d0, d1)`` gives the values of offsets d0..d1-1, shaped
    (..., k, na), or (..., nz, k, P) when ``plane`` = P splits the rows into
    z-planes.  The windows are views of the padded x (``unfold``).  On the
    card, where the solve is bound by launches, one gather takes all D
    windows; on the CPU, where that gather over a strided view is slow at
    the slice's size, each run of evenly spaced offsets is a strided view
    multiplied in place, with no copy of the windows."""
    lo = min(op.offsets + (0,))
    hi = max(op.offsets + (0,))
    xw = F.pad(xs, (-lo, hi)).unfold(-1, na, 1)      # (..., L, na) view
    if xs.device.type == "cpu":
        parts = [(d0, d1, xw[..., s0:s0 + step * (d1 - d0):step, :])
                 for d0, d1, s0, step in op.runs]
    else:
        parts = [(0, len(op.offsets), xw.index_select(-2, op.starts))]
    y = None
    for d0, d1, w in parts:                          # w: (..., k, na)
        if plane is not None:
            w = w.reshape(w.shape[:-1] + (na // plane, plane))
            w = w.transpose(-3, -2)                  # (..., nz, k, P)
        part = (vals_run(d0, d1) * w).sum(dim=-2)
        y = part if y is None else y + part
    return y.reshape(y.shape[:-2] + (na,)) if plane is not None else y


def _with_tail(y, xb, n, tail_identity):
    na = y.shape[-1]
    if na == n:
        return y
    if tail_identity:
        tail = xb[..., na:].to(y.dtype)
    else:
        tail = torch.zeros(y.shape[:-1] + (n - na,), dtype=y.dtype,
                           device=y.device)
    return torch.cat([y, tail], dim=-1)


class Dia:
    """Batched DIA matrix; vals (..., D, n_active), offsets static tuple.
    Rows beyond ``n_active`` (the padded tail up to ``n_rows``) store no
    values: the tail acts as identity (``tail_identity``) or zero."""

    def __init__(self, vals: torch.Tensor, offsets: tuple[int, ...],
                 n_rows: int, tail_identity: bool = True):
        self.vals = vals
        self.offsets = tuple(int(o) for o in offsets)
        self._n_rows = int(n_rows)
        self.tail_identity = bool(tail_identity)
        self.starts = _window_starts(self.offsets, vals.device)
        self.runs = _window_runs(self.offsets)

    @property
    def n_rows(self) -> int:
        return self._n_rows

    @property
    def n_active(self) -> int:
        return self.vals.shape[-1]

    @property
    def dtype(self):
        return self.vals.dtype

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x; batch axes broadcast against the matrix's batch axes."""
        batch = broadcast_shapes(self.vals.shape[:-2], x.shape[:-1])
        n = self._n_rows
        na = self.n_active
        xb = x.expand(batch + (n,))
        out_dtype = torch.promote_types(self.dtype, x.dtype)
        # x is padded over its full length n (the JAX package's Dia reads
        # the tail through positive offsets, where PlaneDia reads zeros)
        vals = self.vals.to(out_dtype)
        y = _shifted_sum(self, lambda d0, d1: vals[..., d0:d1, :],
                         xb.to(out_dtype), na)
        return _with_tail(y.expand(batch + (na,)), xb, n, self.tail_identity)


def class_plan(kz: np.ndarray, n_classes: int,
               cap: int = PLAN_CAP) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's work list for a (B, nz) class map: ``pairs``, the
    (body, plane) pairs as b*nz + z sorted by class (stable), and ``items``
    (n_items, 3) = (class, first, count), each class's run of ``pairs`` cut
    into chunks of at most ``cap`` planes.  A class with no plane has no
    item."""
    flat = np.asarray(kz).reshape(-1)
    if flat.size and (flat.min() < 0 or flat.max() >= n_classes):
        raise ValueError(f"class_plan: class ids outside [0, {n_classes})")
    pairs = np.argsort(flat, kind="stable").astype(np.int32)
    counts = np.bincount(flat, minlength=n_classes)
    items = []
    first = 0
    for c, n in enumerate(counts.tolist()):
        items += [(c, first + s, min(cap, n - s)) for s in range(0, n, cap)]
        first += n
    return pairs, np.asarray(items, np.int32).reshape(-1, 3)


def plan_cap(kz: np.ndarray, n_classes: int, plane: int,
             itemsize: int) -> int:
    """Planes per work item for a (B, nz) class map: PLAN_CAP, halved
    while the launch would have fewer than PLAN_MIN_BLOCKS blocks (work
    items x column tiles), down to one plane."""
    counts = np.bincount(np.asarray(kz).reshape(-1), minlength=n_classes)
    tiles = -(-plane * itemsize // PLAN_TILE_BYTES)
    cap = PLAN_CAP
    while cap > 1 and int((-(-counts // cap)).sum()) * tiles < PLAN_MIN_BLOCKS:
        cap //= 2
    return cap


def offset_groups(offsets: Sequence[int],
                  window: int = PLAN_WINDOW) -> np.ndarray:
    """(G, 1 + window) int32: the offsets cut into groups of ``window``
    consecutive shifts.  Row g holds the group's first shift g0 and, in slot
    k, the index d of offset g0 + k, or -1 where the operator has none."""
    order = np.argsort(np.asarray(offsets, np.int64), kind="stable")
    rows: list[list[int]] = []
    for d in order.tolist():
        off = int(offsets[d])
        row = rows[-1] if rows else None
        if row is None or off >= row[0] + window or row[1 + off - row[0]] >= 0:
            row = [off] + [-1] * window
            rows.append(row)
        row[1 + off - row[0]] = d
    return np.asarray(rows, np.int32).reshape(-1, 1 + window)


class PlaneDia:
    """Per-z-plane-deduplicated batched DIA for uniform structured grids.

    vals: (C, D, P) unique value slabs, P = 3*ny*nx dofs per z-plane;
    kz: (B, nz) int32 class of every (body, plane).  The constructor also
    builds the CUDA kernel's plan as int32 tensors on kz's device
    (``class_plan`` with ``plan_cap`` planes per item, and
    ``offset_groups``): ``plan_pairs``, ``plan_items`` and
    ``plan_groups``.  A kz on the card is read to the host here, once;
    ``mv`` never reads it back."""

    def __init__(self, vals: torch.Tensor, kz: torch.Tensor,
                 offsets: tuple[int, ...], n_rows: int, plane: int,
                 tail_identity: bool = True):
        self.vals = vals          # (C, D, P)
        self.kz = kz              # (B, nz) int32
        self.offsets = tuple(int(o) for o in offsets)
        kz_host = kz.detach().cpu().numpy()
        pairs, items = class_plan(
            kz_host, vals.shape[0],
            plan_cap(kz_host, vals.shape[0], plane, vals.element_size()))
        self.plan_pairs = torch.from_numpy(pairs).to(kz.device)
        self.plan_items = torch.from_numpy(items).to(kz.device)
        self.plan_groups = torch.from_numpy(
            offset_groups(self.offsets)).to(kz.device)
        self.starts = _window_starts(self.offsets, vals.device)
        self.runs = _window_runs(self.offsets)
        self._n_rows = int(n_rows)
        self.plane = int(plane)
        self.tail_identity = bool(tail_identity)

    @property
    def n_rows(self) -> int:
        return self._n_rows

    @property
    def n_active(self) -> int:
        return self.kz.shape[-1] * self.plane

    @property
    def dtype(self):
        return self.vals.dtype

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x through K1's wrapper (``plane_dia_kernel.py``), which
        takes the plain version for CPU tensors."""
        from .plane_dia_kernel import plane_dia_mv

        return plane_dia_mv(self, x)


# plane-dedup merge radius (relative): translated copies of the same
# element pattern differ only by fp noise from the mesh subdivision
# arithmetic, so slabs within DEDUP_RTOL merge; genuinely different planes
# (Dirichlet mask, penalty faces) sit decades apart.  The stored
# representative is an exact slab from one member plane.
DEDUP_RTOL = 1.0e-8


class _SlabDedup:
    def __init__(self, amax: float):
        self.amax = max(float(amax), 1.0e-300)
        self.reps: list[np.ndarray] = []
        self.sigs: list[tuple[float, float]] = []

    def lookup(self, slab: np.ndarray) -> int | None:
        tol = DEDUP_RTOL * self.amax
        s1 = float(slab.sum())
        s2 = float(np.abs(slab).sum())
        n = slab.size
        for cid, (r1, r2) in enumerate(self.sigs):
            if abs(s1 - r1) > n * tol or abs(s2 - r2) > n * tol:
                continue
            if np.allclose(slab, self.reps[cid], rtol=0.0, atol=tol):
                return cid
        return None

    def add(self, slab: np.ndarray) -> int:
        self.reps.append(slab)
        self.sigs.append((float(slab.sum()), float(np.abs(slab).sum())))
        return len(self.reps) - 1


def class_cap(plane: int, dtype) -> int:
    """The JAX package's cap on a PlaneDia's classes: max(64,
    PLANE_DIA_CLASS_BYTES // (plane * itemsize))."""
    return max(64, PLANE_DIA_CLASS_BYTES
               // max(plane * np.dtype(dtype).itemsize, 1))


def plane_classes(
    mats: Sequence[sp.spmatrix],
    shape: tuple[int, int, int],
    n_rows: int,
    max_classes: int,
    offsets: np.ndarray | None = None,
    pad_identity: bool = True,
):
    """The plane classes of a batch of same-grid matrices: (reps, kz,
    offsets), ``reps`` the float64 (D, P) slab of each class in order of
    first appearance, or None when the matrices do not fit the grid or
    hold more than ``max_classes`` distinct slabs."""
    nz, ny, nx = (int(s) for s in shape)
    P = 3 * ny * nx
    n_act = nz * P
    if n_act > n_rows or n_act == 0:
        return None
    if offsets is None:
        offsets = dia_offsets(mats)
    if 0 not in offsets:
        offsets = np.sort(np.append(offsets, 0))
    offsets = np.asarray(offsets, np.int64)
    D = offsets.size
    B = len(mats)
    kz = np.zeros((B, nz), np.int32)
    amax = max(
        (float(np.abs(m.data).max()) if m.nnz else 0.0) for m in mats
    )
    dedup = _SlabDedup(amax)

    def diagonals(m):
        """m's (D, n_act) diagonals, or None where its padding is not a
        bare unit diagonal."""
        c = m.tocoo()
        if m.shape[0] > n_act:
            # hierarchy padding must be a bare unit diagonal
            tail = c.row >= n_act
            if not (
                (c.col[tail] == c.row[tail]).all()
                and (c.data[tail] == 1.0).all()
            ):
                return None
        keep = c.row < n_act
        row = c.row[keep].astype(np.int64)
        k = np.searchsorted(offsets, c.col[keep].astype(np.int64) - row)
        # the sums of np.add.at into zeros, entry by entry in COO order
        vals = np.bincount(k * n_act + row, weights=c.data[keep],
                           minlength=D * n_act).reshape(D, n_act)
        if pad_identity and m.shape[0] < n_act:
            zero_slot = int(np.searchsorted(offsets, 0))
            vals[zero_slot, m.shape[0]:] = 1.0
        return vals

    for b, vals in enumerate(thread_imap(diagonals, mats)):
        if vals is None:
            return None
        v3 = vals.reshape(D, nz, P)
        for z in range(nz):
            slab = np.ascontiguousarray(v3[:, z, :])
            cid = dedup.lookup(slab)
            if cid is None:
                cid = dedup.add(slab)
                if cid + 1 > max_classes:
                    return None
            kz[b, z] = cid
    return dedup.reps, kz, offsets


def plane_dia_from_csr_list(
    mats: Sequence[sp.spmatrix],
    shape: tuple[int, int, int],
    n_rows: int,
    dtype=np.float32,
    offsets: np.ndarray | None = None,
    pad_identity: bool = True,
    max_classes: int | None = None,
    classes=None,
) -> "PlaneDia | None":
    """Build a PlaneDia (CPU tensors) for a batch of same-grid matrices, or
    None when the class table has more than ``max_classes`` distinct slabs
    (the caller falls back to another format).  ``max_classes`` defaults to
    the JAX package's rule, ``class_cap``.
    ``shape`` = (nz, ny, nx) node grid; active rows are exactly 3*nz*ny*nx,
    anything beyond (hierarchy padding) follows the Dia tail convention.
    ``classes``: the ``plane_classes`` of the same matrices computed with a
    cap of at least ``max_classes`` (classes only grow, so a larger cap
    gives the same result where this one would not have stopped)."""
    nz, ny, nx = (int(s) for s in shape)
    P = 3 * ny * nx
    if max_classes is None:
        max_classes = class_cap(P, dtype)
    if classes is None:
        classes = plane_classes(mats, shape, n_rows, max_classes, offsets,
                                pad_identity)
    if classes is None or len(classes[0]) > max_classes:
        return None
    reps, kz, offsets = classes
    pvals = np.stack(
        [r.astype(dtype) for r in reps], axis=0
    )   # (C, D, P)
    return PlaneDia(
        torch.from_numpy(pvals), torch.from_numpy(kz.copy()),
        tuple(int(o) for o in offsets), n_rows, P,
        tail_identity=pad_identity,
    )


def dia_offsets(mats: Sequence[sp.spmatrix]) -> np.ndarray:
    """Union of col-row offsets over a batch of square matrices."""
    def distinct(m):
        c = m.tocoo()
        # the sorted distinct col - row, through a count over their range
        n = max(m.shape[0], 1)
        seen = np.bincount(c.col.astype(np.int64) - c.row + (n - 1),
                           minlength=n - 1 + max(m.shape[1], 1))
        return np.nonzero(seen)[0] - (n - 1)

    offs = [np.zeros(0, np.int64)] + list(thread_imap(distinct, mats))
    return np.unique(np.concatenate(offs))


def dia_from_csr_list(
    mats: Sequence[sp.spmatrix],
    n_rows: int | None = None,
    dtype=np.float32,
    offsets: np.ndarray | None = None,
    pad_identity: bool = True,
) -> Dia:
    """Stack square matrices as a batched Dia (CPU tensors) padded to
    ``n_rows``.  The padded tail (and any trailing identity block the caller
    already appended) is not stored: Dia.mv treats rows past ``n_active`` as
    identity (``pad_identity=True``, hierarchy convention) or zero."""
    n = n_rows or max(m.shape[0] for m in mats)
    coos = [m.tocoo() for m in mats]
    # active range: rows that are anything but a bare 1.0 diagonal
    n_act = 1
    for c in coos:
        nontrivial = (c.col != c.row) | (c.data != 1.0)
        if nontrivial.any():
            n_act = max(n_act, int(c.row[nontrivial].max()) + 1)
        if not pad_identity and c.row.size:
            n_act = max(n_act, int(c.row.max()) + 1)
    n_act = min(n, n_act)
    if offsets is None:
        offsets = dia_offsets(mats)
    if 0 not in offsets:
        offsets = np.sort(np.append(offsets, 0))
    offsets = np.asarray(offsets, np.int64)
    zero_slot = int(np.searchsorted(offsets, 0))
    B = len(mats)
    vals = np.zeros((B, offsets.size, n_act), dtype)
    for b, c in enumerate(coos):
        keep = c.row < n_act
        k = np.searchsorted(
            offsets, c.col[keep].astype(np.int64) - c.row[keep]
        )
        np.add.at(vals[b], (k, c.row[keep]), c.data[keep].astype(dtype))
        if pad_identity:
            # unit diagonal on stored-but-inactive rows of smaller batch
            # members (their tail within n_act must stay decoupled identity
            # unless the matrix itself provided it)
            m_n = mats[b].shape[0]
            if m_n < n_act:
                vals[b, zero_slot, m_n:] = 1.0
    return Dia(
        torch.from_numpy(vals), tuple(int(o) for o in offsets), n,
        tail_identity=pad_identity,
    )
