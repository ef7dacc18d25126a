"""Block-ELL sparse format (the port of the JAX package's ``sparse/bell.py``).

Block-ELL groups rows into blocks of RB=8 and columns into blocks of
CB=128; per row block it stores the S distinct column blocks it touches as
dense (8, 128) tiles and one int32 column-block index each.  Its product is
a gather of whole 128-wide blocks of x and a contraction over the tiles,
which the port runs as one launch of K2 (``sparse/block_ell_kernel.py``).
The JAX package takes it on every accelerator because a TPU runs an
arbitrary gather as a scalarized loop; the tiles are mostly zeros (a few
percent filled for hex8 operators), so the format moves several times the
bytes of ELL.

Which format ``device_sparse`` builds is read at build time from
``DDPCA_SPARSE_FORMAT`` (``bell`` or ``ell``, the JAX package's switch).
The port's default is ELL on every device: the TPU's reason for Block-ELL
does not hold on an H100, whose gathers run at memory speed.  Under
``bell`` the choice follows the JAX package exactly: Block-ELL wherever the
tiles fit ``BELL_MAX_BYTES`` at 4 bytes an entry (in either dtype, so both
packages pick the same format for the same matrices), ELL for operators
built with ``force_ell`` (those applied by transpose, ``Ell.tmv``) and past
the budget.  ``DDPCA_SPARSE_DEBUG`` prints each choice.

Row and column counts are always padded to (8, 128) multiples, so both
formats give vectors of the JAX package's shapes.
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..utils.pool import thread_imap
from ..utils.precision import solve_dtype
from .block_ell_kernel import block_ell_mv
from .ell import Ell, stack_ells

RB = 8     # row block
CB = 128   # column block
BELL_MAX_BYTES = int(
    os.environ.get("DDPCA_BELL_MAX_BYTES", str(2 << 30))
)

_NP_OF = {torch.float32: np.float32, torch.float64: np.float64}
# where _bell_from_layouts materialises tiles (tiles_on)
_TILES_DEVICE = [torch.device("cpu")]


def round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


@contextlib.contextmanager
def tiles_on(device):
    """Materialise the Block-ELL tiles built inside on ``device``: the
    problem builder passes its device, so that tiles a few percent full
    never exist densely in host memory (13.7 GB in float64 for BLOCK
    glob_leve=2).  Every other tensor is built on the host as before."""
    saved = _TILES_DEVICE[0]
    _TILES_DEVICE[0] = torch.device(device)
    try:
        yield
    finally:
        _TILES_DEVICE[0] = saved


def use_block_format() -> bool:
    """Whether ``device_sparse`` builds Block-ELL: ``DDPCA_SPARSE_FORMAT``
    is ``bell``.  Unset (or any other value) means ELL on every device."""
    env = os.environ.get("DDPCA_SPARSE_FORMAT")
    if env:
        return env == "bell"
    return False


class BlockEll(NamedTuple):
    """Block-ELL matrix; batched with leading axes on tiles/cblk.

    tiles: (..., n_rb, S, RB, CB) dense tiles (zero-padded slots)
    cblk:  (..., n_rb, S) int32 column-block indices (padded slots -> 0)
    n_cols: padded column count (multiple of CB)
    """

    tiles: torch.Tensor
    cblk: torch.Tensor
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.tiles.shape[-4] * RB

    @property
    def dtype(self):
        return self.tiles.dtype

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x; batch axes broadcast as ``Ell.mv``'s; x in the
        tiles' dtype (K2's wrapper)."""
        return block_ell_mv(self, x)


class _Layout(NamedTuple):
    """Where one matrix's entries go in its tiles (``_place``)."""

    urb: np.ndarray     # row block of each occupied slot
    slot: np.ndarray    # its slot within the row block
    ucb: np.ndarray     # its column block (int32)
    inv: np.ndarray     # (nnz,) the occupied slot of each entry
    within: np.ndarray  # (nnz,) the entry's place in its (RB, CB) tile
    data: np.ndarray    # (nnz,) values, duplicates summed
    need: int           # slots the matrix needs (its largest count)


def _layout(A: sp.spmatrix, n_cols: int) -> _Layout:
    """Slots of one matrix, numbered per row block in column-block order
    (the JAX package's ``_bell_arrays_single``).  Duplicate entries are
    summed first, so every tile entry is written once."""
    ncb = n_cols // CB
    A = A.tocsr()
    if not A.has_canonical_format:
        A = A.copy()
        A.sum_duplicates()
    empty = np.zeros(0, np.int64)
    if A.nnz == 0:
        return _Layout(empty, empty, np.zeros(0, np.int32), empty, empty,
                       np.zeros(0, A.dtype), 1)
    row = np.repeat(np.arange(A.shape[0], dtype=np.int64), np.diff(A.indptr))
    col = A.indices.astype(np.int64)
    key = (row // RB) * ncb + col // CB
    uk, inv = np.unique(key, return_inverse=True)
    urb = uk // ncb
    slot = np.arange(uk.size) - np.searchsorted(urb, urb, side="left")
    return _Layout(urb, slot, (uk % ncb).astype(np.int32), inv.reshape(-1),
                   (row % RB) * CB + col % CB, A.data, int(slot.max()) + 1)


def _place(lay: _Layout, cblk: np.ndarray, base: int) -> np.ndarray:
    """Write one matrix's column blocks into its (n_rb, S) slice of cblk
    and return the flat positions of its entries in the stacked tiles,
    its own tiles starting at ``base``."""
    S = cblk.shape[1]
    if lay.need > S:
        raise ValueError(f"slot overflow: need {lay.need} > S={S}")
    cblk[lay.urb, lay.slot] = lay.ucb
    tile = lay.urb * S + lay.slot
    return base + tile[lay.inv] * (RB * CB) + lay.within


def _layouts(mats: Sequence[sp.spmatrix], n_cols: int) -> list[_Layout]:
    """The layouts of ``mats`` in threads; a matrix listed twice is laid
    out once."""
    distinct = {id(m): m for m in mats}
    done = dict(zip(distinct, thread_imap(
        lambda m: _layout(m, n_cols), distinct.values())))
    return [done[id(m)] for m in mats]


def _bell_from_layouts(layouts, n_rows, n_cols, S, dtype, batch_shape,
                       single) -> BlockEll:
    """The stacked tiles, zeros in ``dtype`` on the tiles' device
    (``tiles_on``), with every entry scattered in once: the host holds the
    entries and their positions, never the mostly-zero tiles."""
    n_rb = n_rows // RB
    per = n_rb * S * RB * CB
    cblk = np.zeros((len(layouts), n_rb, S), np.int32)
    flat = np.concatenate(list(thread_imap(
        lambda i: _place(layouts[i], cblk[i], i * per),
        range(len(layouts)))) + [np.zeros(0, np.int64)])
    data = np.concatenate([lay.data for lay in layouts]
                          + [np.zeros(0)]).astype(_NP_OF[dtype])
    dev = _TILES_DEVICE[0]
    tiles = torch.zeros(len(layouts) * per, dtype=dtype, device=dev)
    tiles[torch.from_numpy(flat).to(dev)] = torch.from_numpy(data).to(dev)
    tiles = tiles.reshape((len(layouts), n_rb, S, RB, CB))
    cblk = torch.from_numpy(cblk).to(dev)
    if batch_shape is not None:
        tiles = tiles.reshape(tuple(batch_shape) + tiles.shape[1:])
        cblk = cblk.reshape(tuple(batch_shape) + cblk.shape[1:])
    elif single:
        tiles, cblk = tiles[0], cblk[0]
    return BlockEll(tiles=tiles, cblk=cblk, n_cols=int(n_cols))


def bell_from_csr_list(
    mats: Sequence[sp.spmatrix],
    n_rows: int | None = None,
    n_cols: int | None = None,
    dtype=torch.float32,
    batch_shape: tuple[int, ...] | None = None,
) -> BlockEll:
    """A (stacked) BlockEll from scipy matrices, its tensors on the tiles'
    device (``tiles_on``, default the CPU); sizes padded to (RB, CB)
    multiples and the batch's largest slot count.
    ``batch_shape`` reshapes the leading stack axis (e.g. (R, 2))."""
    n_rows = round_up(n_rows or max(m.shape[0] for m in mats), RB)
    n_cols = round_up(n_cols or max(m.shape[1] for m in mats), CB)
    layouts = _layouts(mats, n_cols)
    S = max(lay.need for lay in layouts)
    return _bell_from_layouts(layouts, n_rows, n_cols, S, dtype,
                              batch_shape, len(mats) == 1)


def _max_slots(mats: Sequence[sp.spmatrix], n_cols: int) -> int:
    """Max distinct column-blocks touched by any row-block, over the batch."""
    ncb = n_cols // CB
    S = 1
    for A in mats:
        A = A.tocoo()
        if A.nnz == 0:
            continue
        key = (A.row // RB).astype(np.int64) * ncb + A.col // CB
        uk = np.unique(key)
        counts = np.bincount(uk // ncb)
        S = max(S, int(counts.max()))
    return S


def device_sparse(
    mats: Sequence[sp.spmatrix],
    n_rows: int | None = None,
    n_cols: int | None = None,
    dtype: torch.dtype | None = None,
    batch_shape: tuple[int, ...] | None = None,
    force_ell: bool = False,
):
    """Stack scipy matrices as a BlockEll or an Ell: Block-ELL where
    ``use_block_format()`` and the tiles fit ``BELL_MAX_BYTES``, else ELL.
    An Ell holds CPU tensors (the problem builder moves the whole problem
    to its device); a BlockEll is built on the tiles' device
    (``tiles_on``).
    Row/column counts are padded to (8, 128) multiples; ``batch_shape``
    reshapes the leading stack axis; ``dtype`` defaults to the solve dtype.
    ``force_ell`` keeps ELL for operators applied by transpose
    (``Ell.tmv``), which Block-ELL does not have."""
    n_rows = round_up(n_rows or max(m.shape[0] for m in mats), RB)
    n_cols = round_up(n_cols or max(m.shape[1] for m in mats), CB)
    dtype = dtype or solve_dtype()
    if use_block_format() and not force_ell:
        layouts = _layouts(mats, n_cols)
        S = max(lay.need for lay in layouts)
        # the JAX package's budget, at 4 bytes an entry in either dtype
        tile_entries = len(mats) * (n_rows // RB) * S * RB * CB
        take = tile_entries * 4 <= BELL_MAX_BYTES
        if os.environ.get("DDPCA_SPARSE_DEBUG"):
            nnz = sum(m.nnz for m in mats)
            print(
                f"[sparse] {len(mats)}x({n_rows}x{n_cols}) S={S} "
                f"tiles={tile_entries * 4 / 1e6:.0f}MB "
                f"nnz={nnz / 1e6:.2f}M fill={nnz / max(tile_entries, 1):.3f}"
                f" -> {'bell' if take else 'ELL'}",
                flush=True,
            )
        if take:
            # tiles straight in the solve dtype, on the problem's device:
            # never a float64 stack cast later, nor dense tiles on the host
            return _bell_from_layouts(layouts, n_rows, n_cols, S, dtype,
                                      batch_shape, len(mats) == 1)
    e = stack_ells(mats, n_rows=n_rows, n_cols=n_cols, dtype=dtype)
    if batch_shape is not None:
        e = Ell(
            vals=e.vals.reshape(tuple(batch_shape) + e.vals.shape[1:]),
            cols=e.cols.reshape(tuple(batch_shape) + e.cols.shape[1:]),
            n_cols=e.n_cols,
        )
    elif len(mats) == 1:
        e = Ell(vals=e.vals[0], cols=e.cols[0], n_cols=e.n_cols)
    return e


def compact_device_sparse(
    mats_groups: "Sequence[Sequence[sp.spmatrix]]",
    n_cols: int,
    batch_shape: tuple[int, ...],
    row_offsets: "Sequence[int] | None" = None,
    dtype: torch.dtype | None = None,
):
    """Row-compact stacking for tall operators that are nonzero on few rows.

    ``mats_groups``: lists of equally-indexed sparse matrices sharing row
    sparsity; the union row set per slot is used for all groups so they
    share one scatter index.  ``row_offsets``: optional per-slot offset added
    to the stored row ids (e.g. body*n_pad for scatter into a stacked (B, n)
    vector).  Each group is stored by ``device_sparse``, in the format it
    picks.

    Returns ([op, ...] one per group — (batch..., r_pad, ...), idx
    (batch..., r_pad) int64); padded rows carry no entries (mv -> exact 0)
    and scatter into slot 0 harmlessly.  Applied as
    ``full.index_add_(0, idx, op.mv(x))``."""
    n_slots = len(mats_groups[0])
    rowsets = []
    for j in range(n_slots):
        rs = np.unique(
            np.concatenate(
                [g[j].tocoo().row for g in mats_groups]
                + [np.zeros(0, dtype=np.int64)]
            )
        )
        rowsets.append(rs)
    r_pad = int(round_up(max([rs.size for rs in rowsets] + [1]), 8))
    idxs = np.zeros((n_slots, r_pad), dtype=np.int64)
    for j, rs in enumerate(rowsets):
        off = 0 if row_offsets is None else int(row_offsets[j])
        idxs[j, : rs.size] = rs + off
    ops = []
    for g in mats_groups:
        comp = [
            m.tocsr()[rs] if rs.size else sp.csr_matrix((0, m.shape[1]))
            for m, rs in zip(g, rowsets)
        ]
        ops.append(
            device_sparse(comp, r_pad, n_cols, dtype=dtype,
                          batch_shape=batch_shape)
        )
    return ops, torch.from_numpy(
        idxs.reshape(tuple(batch_shape) + (r_pad,))
    )
