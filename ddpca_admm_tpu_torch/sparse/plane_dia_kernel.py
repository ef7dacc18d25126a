"""K1: the batched PlaneDia SpMV as a hand-written CUDA kernel.

    y[b, z*P + p] = sum_d vals[kz[b, z], d, p] * x[b, z*P + p + off_d]

over the active rows z*P + p < nz*P, x counting as 0 outside [0, nz*P);
the rows past nz*P copy x (``tail_identity``) or are 0.

Replaces the JAX package's Pallas TPU kernel
``ddpca_admm_tpu/sparse/pallas_dia.py::_kernel`` (``pl.pallas_call`` in
``plane_dia_mv_pallas``), which kept the whole (C, D, P) table resident in
VMEM and shifted x by lane rotations.  On an H100 the SpMV is bound by
memory: 2 flops per value read, so its least time is the table, x and y
read or written once, over the memory rate.  The CUDA kernel
(``csrc/plane_dia.cu``) follows the operator's plan (``PlaneDia``'s
``plan_pairs``, ``plan_items``, ``plan_groups``, built once on the host):
a block reads one class slab tile once and applies it to every plane of its
work item, and the same launch writes the tail rows.

``plane_dia_mv`` is the wrapper, and ``PlaneDia.mv`` always calls it: the
plain version for CPU tensors only; for CUDA tensors it launches the kernel
or raises.  ``LAUNCHES`` counts its launches.  ``plane_dia_mv_plain`` is the torch form of the JAX package's
``PlaneDia.mv`` (a row gather by ``kz`` and per-offset shifted slices).
"""

from __future__ import annotations

import torch

from ..utils import cuda_lib
from . import dia
from .dia import _shifted_sum, _with_tail
from .ell import broadcast_shapes

# kernel launches made by plane_dia_mv (and nowhere else)
LAUNCHES = 0


def plane_dia_mv_plain(pd, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch PlaneDia SpMV: a row gather of the class slabs by
    ``kz`` and the per-offset shifted windows of x; x (..., n_rows) is
    broadcast against the (B,) batch of ``pd.kz``."""
    C, D, P = pd.vals.shape
    nz = pd.kz.shape[-1]
    na = nz * P
    n = pd.n_rows
    batch = broadcast_shapes(pd.kz.shape[:-1], x.shape[:-1])
    xb = x.expand(batch + (n,))
    out_dtype = torch.promote_types(pd.dtype, x.dtype)
    kz = pd.kz.expand(batch + (nz,)).reshape(-1)
    vals = torch.index_select(pd.vals, 0, kz).reshape(batch + (nz, D, P))
    vals = vals.to(out_dtype)
    y = _shifted_sum(pd, lambda d0, d1: vals[..., d0:d1, :],
                     xb[..., :na].to(out_dtype), na, plane=P)
    return _with_tail(y, xb, n, pd.tail_identity)


def plane_dia_mv(pd, x: torch.Tensor) -> torch.Tensor:
    """y = pd @ x for x of shape (B, n_rows), B = pd.kz.shape[0].

    x must be in the table's dtype, on every device: the kernel computes
    in it, and the plain version in the promoted dtype, so a mixed call
    would round differently on the card (a float64 x through a float32
    table keeps float32 noise) - it raises instead.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    global LAUNCHES
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"plane_dia_mv: unsupported device {x.device}")
    if x.dtype != pd.dtype:
        raise TypeError(f"plane_dia_mv: x is {x.dtype}, the table "
                        f"{pd.dtype}: cast x to the table's dtype")
    if x.device.type == "cpu":
        return plane_dia_mv_plain(pd, x)
    C, D, P = pd.vals.shape
    B, nz = pd.kz.shape
    n = pd.n_rows
    if pd.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"plane_dia_mv: table dtype {pd.dtype} is not "
                        f"float32 or float64")
    x = x.contiguous()
    if tuple(x.shape) != (B, n):
        raise ValueError(
            f"plane_dia_mv: x shape {tuple(x.shape)} must be (B, n_rows) = "
            f"{(B, n)}"
        )
    if not (P == pd.plane and nz * P <= n and B * nz < 2 ** 31):
        raise ValueError(f"plane_dia_mv: unsupported shape B={B} nz={nz} "
                         f"P={P} n={n}")
    if len(pd.offsets) != D or max(abs(o) for o in pd.offsets) >= 2 * P:
        raise ValueError("plane_dia_mv: the offsets must match the table "
                         "and lie within two planes (|off| < 2P)")
    plan = (pd.plan_pairs, pd.plan_items, pd.plan_groups)
    for name, t in (("vals", pd.vals), ("plan_pairs", plan[0]),
                    ("plan_items", plan[1]), ("plan_groups", plan[2])):
        if t.device != x.device:
            raise ValueError(f"plane_dia_mv: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"plane_dia_mv: {name} is not contiguous")
    if any(t.dtype != torch.int32 for t in plan):
        raise TypeError("plane_dia_mv: the plan must be int32")
    if (plan[0].numel() != B * nz or plan[1].ndim != 2
            or plan[1].shape[1] != 3
            or tuple(plan[2].shape[1:]) != (dia.PLAN_WINDOW + 1,)):
        raise ValueError("plane_dia_mv: the plan does not match the "
                         "operator")
    if pd.vals.data_ptr() % 16:
        raise ValueError("plane_dia_mv: vals must start on 16 bytes")
    if x.data_ptr() % 16:
        x = x.clone()             # the kernel reads x in 16-byte chunks
    lib = cuda_lib.load()
    fn = (lib.plane_dia_mv_f64 if x.dtype == torch.float64
          else lib.plane_dia_mv_f32)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(pd.vals.data_ptr(), plan[0].data_ptr(), plan[1].data_ptr(),
             plan[2].data_ptr(), x.data_ptr(), y.data_ptr(), B, C, nz, P, D,
             plan[2].shape[0], plan[1].shape[0], n, int(pd.tail_identity),
             dia.PLAN_WINDOW, dia.PLAN_CAP, stream)
    if err != 0:
        raise RuntimeError(f"plane_dia_mv: kernel launch failed, "
                           f"cudaError {err}")
    LAUNCHES += 1
    return y
