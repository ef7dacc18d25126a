"""Fixed-topology ELL sparse matrices (the port of ``sparse/ell.py``).

Every operator here has a static sparsity frozen after setup, stored as ELL:
per-row column indices padded to the largest row length.  SpMV is a gather,
a multiply and a row sum; a batch of same-shape operators carries leading
batch axes on ``vals``/``cols``.  Transposed products (``tmv``) scatter-add.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..utils.pool import thread_imap

# row degree up to which mv runs as per-slot gathers (no (..., n_rows, k)
# temporary); larger k gathers once and sums over k
ELL_UNROLL_MAX = 32


def broadcast_shapes(a: tuple, b: tuple) -> tuple:
    """numpy broadcasting of two shapes (``torch.broadcast_shapes`` costs
    more than the small SpMVs it would serve)."""
    n = max(len(a), len(b))
    a = (1,) * (n - len(a)) + tuple(a)
    b = (1,) * (n - len(b)) + tuple(b)
    out = []
    for p, q in zip(a, b):
        if p != q and p != 1 and q != 1:
            raise ValueError(f"shapes {a} and {b} do not broadcast")
        out.append(q if p == 1 else p)
    return tuple(out)


def _flat_batch(t: torch.Tensor, batch: tuple, tail: tuple) -> torch.Tensor:
    return t.expand(batch + tail).reshape((-1,) + tail)


class Ell(NamedTuple):
    """ELL matrix; also used batched with leading axes on vals/cols."""

    vals: torch.Tensor   # (..., n_rows, k)
    cols: torch.Tensor   # (..., n_rows, k) int64; padded entries point at 0
    n_cols: int          # logical column count

    @property
    def n_rows(self) -> int:
        return self.vals.shape[-2]

    @property
    def dtype(self):
        return self.vals.dtype

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x; x (..., n_cols) with batch axes broadcast against the
        matrix's batch axes, as per-slot gathers accumulated into y."""
        batch = broadcast_shapes(self.vals.shape[:-2], x.shape[:-1])
        n_rows, k = self.vals.shape[-2:]
        vals = _flat_batch(self.vals, batch, (n_rows, k))
        cols = _flat_batch(self.cols, batch, (n_rows, k))
        xb = _flat_batch(x, batch, (x.shape[-1],))
        if k <= ELL_UNROLL_MAX:
            acc = vals[..., 0] * torch.gather(xb, 1, cols[..., 0])
            for j in range(1, k):
                acc = acc + vals[..., j] * torch.gather(xb, 1, cols[..., j])
        else:
            g = torch.gather(xb, 1, cols.reshape(cols.shape[0], -1))
            acc = (vals * g.reshape(vals.shape)).sum(-1)
        return acc.reshape(batch + (n_rows,))

    def tmv(self, x: torch.Tensor, n_out: int | None = None) -> torch.Tensor:
        """y = A.T @ x by scatter-add: each stored entry (r, cols[r,k])
        adds vals[r,k]*x[r] into y[cols[r,k]] (per-slot ``index_add_``).
        Padded entries carry value 0 and scatter harmlessly into slot 0."""
        n_out = n_out or self.n_cols
        batch = broadcast_shapes(self.vals.shape[:-2], x.shape[:-1])
        n_rows, k = self.vals.shape[-2:]
        vals = _flat_batch(self.vals, batch, (n_rows, k))
        cols = _flat_batch(self.cols, batch, (n_rows, k))
        xb = _flat_batch(x, batch, (n_rows,))
        flat = vals.shape[0]
        dtype = torch.promote_types(self.dtype, x.dtype)
        base = (torch.arange(flat, device=cols.device) * n_out)[:, None]
        out = torch.zeros(flat * n_out, dtype=dtype, device=vals.device)
        for j in range(k):
            out.index_add_(0, (cols[..., j] + base).reshape(-1),
                           (vals[..., j] * xb).reshape(-1))
        return out.reshape(batch + (n_out,))


def ell_from_csr(A: sp.spmatrix, k: int | None = None,
                 n_rows: int | None = None):
    """Convert scipy sparse to ELL numpy arrays (vals, cols, n_cols).

    ``k`` pads the row length, ``n_rows`` pads the row count (for batching).
    Padded entries have value 0 and column 0."""
    A = A.tocsr()
    A.sum_duplicates()
    counts = np.diff(A.indptr)
    kmax = int(counts.max()) if counts.size else 1
    k = max(kmax, k or 1)
    n = A.shape[0] if n_rows is None else n_rows
    assert n >= A.shape[0]
    vals = np.zeros((n, k), dtype=A.dtype)
    cols = np.zeros((n, k), dtype=np.int64)
    if A.nnz:
        rows = np.repeat(np.arange(A.shape[0]), counts)
        offs = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
        vals[rows, offs] = A.data
        cols[rows, offs] = A.indices
    return vals, cols, int(A.shape[1])


def stack_ells(mats: Sequence[sp.spmatrix], n_rows: int | None = None,
               n_cols: int | None = None, k: int | None = None,
               dtype=torch.float64) -> Ell:
    """Pad a list of sparse matrices to common shape and stack on axis 0,
    as a CPU tensor Ell in ``dtype``."""
    kmax = max(
        (int(np.diff(m.tocsr().indptr).max()) if m.nnz else 1) for m in mats
    )
    k = max(kmax, k or 1)
    n = max(m.shape[0] for m in mats) if n_rows is None else n_rows
    nc = max(m.shape[1] for m in mats) if n_cols is None else n_cols
    # ell_from_csr sums a CSR's duplicates in place: a matrix listed twice
    # goes to one thread
    distinct = {id(m): m for m in mats}
    done = dict(zip(distinct, thread_imap(
        lambda m: ell_from_csr(m, k=k, n_rows=n), distinct.values())))
    parts = [done[id(m)] for m in mats]
    return Ell(
        vals=torch.from_numpy(np.stack([p[0] for p in parts])).to(dtype),
        cols=torch.from_numpy(np.stack([p[1] for p in parts])),
        n_cols=int(nc),
    )
