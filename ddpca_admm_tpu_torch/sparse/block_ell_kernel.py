"""K2: the batched Block-ELL SpMV as a hand-written CUDA kernel.

    y[b, 8r + i] = sum_s sum_c tiles[b, r, s, i, c] * x[b, 128 cblk[b, r, s] + c]

Counterpart of an XLA op, not of a Pallas kernel: the JAX package computes
``BlockEll.mv`` (``ddpca_admm_tpu/sparse/bell.py``, a block gather
``xb[cblk]`` and an ``einsum`` at ``Precision.HIGHEST``) through XLA.  On an
H100 the product is bound by memory: 2 flops per tile entry read, so its
least time is the tiles, the column blocks, x and y moved once over the
memory rate.  The CUDA kernel (``csrc/block_ell.cu``) gives one warp to
each (batch entry, row block), loads each 128-wide block of x once per slot
and reads the tiles with 16-byte loads that a warp takes as contiguous
512-byte spans; one launch covers the whole batch.

``block_ell_mv`` is the wrapper, and ``BlockEll.mv`` always calls it: the
plain version for CPU tensors only; for CUDA tensors it launches the kernel
or raises.  ``LAUNCHES`` counts its launches.  ``block_ell_mv_plain`` is
the torch form of the JAX package's product (a gather of x's blocks by
``cblk``, then an ``einsum``).
"""

from __future__ import annotations

import math

import torch

from ..utils import cuda_lib
from .ell import broadcast_shapes

# kernel launches made by block_ell_mv (and nowhere else)
LAUNCHES = 0

_CB = 128   # the column block; tiles are (RB, CB) = (8, 128)


def _flat(t: torch.Tensor, batch: tuple, tail: tuple) -> torch.Tensor:
    return t.expand(batch + tail).reshape((-1,) + tail)


def block_ell_mv_plain(be, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Block-ELL SpMV: x (..., n_cols) broadcast against the
    matrix's batch axes, its 128-wide blocks gathered by ``cblk`` and
    contracted with the tiles, in the promoted dtype."""
    n_rb, S, RB, CB = be.tiles.shape[-4:]
    batch = broadcast_shapes(be.tiles.shape[:-4], x.shape[:-1])
    dtype = torch.promote_types(be.dtype, x.dtype)
    tiles = _flat(be.tiles, batch, (n_rb, S, RB, CB)).to(dtype)
    cblk = _flat(be.cblk, batch, (n_rb, S)).long()
    xb = _flat(x, batch, (x.shape[-1],)).to(dtype).reshape(
        tiles.shape[0], -1, CB)
    rows = torch.arange(xb.shape[0], device=xb.device)[:, None, None]
    xg = xb[rows, cblk]                               # (F, n_rb, S, CB)
    y = torch.einsum("frsic,frsc->fri", tiles, xg)
    return y.reshape(batch + (n_rb * RB,))


def _operand(t: torch.Tensor, batch: tuple, tail: tuple):
    """``t`` as a contiguous batch of ``tail``-shaped entries and its batch
    stride in elements: 0 where t has one batch entry (a broadcast taken
    by stride), the entry's size where t has the whole batch; a copy only
    where t broadcasts over some batch axes and not others."""
    lead = tuple(t.shape[:t.ndim - len(tail)])
    if math.prod(lead) == 1:
        return t.contiguous(), 0
    if lead == batch:
        return t.contiguous(), math.prod(tail)
    return _flat(t, batch, tail).contiguous(), math.prod(tail)


def block_ell_mv(be, x: torch.Tensor) -> torch.Tensor:
    """y = be @ x for x (..., n_cols) whose batch axes broadcast against
    the matrix's.

    x must be in the tiles' dtype, on every device: the kernel computes in
    it, and the plain version in the promoted dtype, so a mixed call would
    round differently on the card - it raises instead.  CPU tensors take
    the plain version; CUDA tensors launch the kernel, once for the whole
    batch."""
    global LAUNCHES
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"block_ell_mv: unsupported device {x.device}")
    if x.dtype != be.dtype:
        raise TypeError(f"block_ell_mv: x is {x.dtype}, the tiles "
                        f"{be.dtype}: cast x to the tiles' dtype")
    if x.shape[-1] != be.n_cols:
        raise ValueError(f"block_ell_mv: x has {x.shape[-1]} columns, the "
                         f"matrix {be.n_cols}")
    if x.device.type == "cpu":
        return block_ell_mv_plain(be, x)
    n_rb, S, RB, CB = be.tiles.shape[-4:]
    if (RB, CB) != (8, _CB) or be.n_cols % _CB:
        raise ValueError(f"block_ell_mv: tiles {(RB, CB)}, n_cols "
                         f"{be.n_cols}: the kernel takes (8, 128) tiles")
    if be.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"block_ell_mv: tiles dtype {be.dtype} is not "
                        f"float32 or float64")
    if be.cblk.dtype != torch.int32:
        raise TypeError("block_ell_mv: cblk must be int32")
    if tuple(be.cblk.shape[-2:]) != (n_rb, S) or \
            be.cblk.shape[:-2] != be.tiles.shape[:-4]:
        raise ValueError("block_ell_mv: cblk does not match the tiles")
    for name, t in (("tiles", be.tiles), ("cblk", be.cblk)):
        if t.device != x.device:
            raise ValueError(f"block_ell_mv: {name} on {t.device}, x on "
                             f"{x.device}")
    batch = broadcast_shapes(be.tiles.shape[:-4], x.shape[:-1])
    tiles, ts = _operand(be.tiles, batch, (n_rb, S, RB, CB))
    cblk, cs = _operand(be.cblk, batch, (n_rb, S))
    xf, xs = _operand(x, batch, (be.n_cols,))
    F = math.prod(batch)
    if F * n_rb >= 2 ** 31:
        raise ValueError(f"block_ell_mv: {F} x {n_rb} row blocks pass int32")
    if tiles.data_ptr() % 16:
        raise ValueError("block_ell_mv: tiles must start on 16 bytes")
    if xf.data_ptr() % 16:
        xf = xf.clone()          # the kernel reads x in 16-byte chunks
    y = torch.empty(batch + (n_rb * RB,), dtype=x.dtype, device=x.device)
    lib = cuda_lib.load()
    fn = (lib.block_ell_mv_f64 if x.dtype == torch.float64
          else lib.block_ell_mv_f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(tiles.data_ptr(), cblk.data_ptr(), xf.data_ptr(), y.data_ptr(),
             F, n_rb, S, be.n_cols // _CB, ts, cs, xs, stream)
    if err != 0:
        raise RuntimeError(f"block_ell_mv: kernel launch failed, "
                           f"cudaError {err}")
    LAUNCHES += 1
    return y
