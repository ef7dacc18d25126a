"""Precision policy of the port.

The solve dtype is float64 unless the caller or ``DDPCA_SOLVE_DTYPE`` asks
for float32, on every device.  The JAX package defaults to float32 off the
CPU because a TPU emulates float64; an H100 computes float64 in hardware,
so the port keeps float64, the reference's precision, as its default.

  * float64: ``A_top`` (the Krylov matvec operator), the Krylov loops and
    the monitors in float64; the multigrid V-cycle, which only
    preconditions, in float32.
  * float32 (the JAX package's accelerator path): every floating tensor of
    the problem in float32, ``A_top`` the finest level's own operator.
    ``floor_rtol`` floors the inner tolerances at 40*eps and ``floor_crit``
    the ADMM criterion at (100*eps)^2 ~ 1.42e-10, so the loop stops a few
    iterations earlier; the monitors run on max-normalised vectors, whose
    squared norms stay in float32's range.

``floor_rtol``, ``floor_crit`` and the override's spellings are the JAX
package's; in float64 the clamps leave the reference's tolerances as they
are.
"""

from __future__ import annotations

import os

import torch

from .device import tree_map

# DDPCA_SOLVE_DTYPE's spellings (the JAX package's, jnp.dtype names)
_DTYPES = {"f32": torch.float32, "float32": torch.float32,
           "f64": torch.float64, "float64": torch.float64}


def _as_dtype(value) -> torch.dtype:
    if isinstance(value, torch.dtype):
        return value
    name = getattr(value, "__name__", None) or str(value)
    if name not in _DTYPES:
        raise ValueError(f"solve dtype {value!r}: not float32 or float64")
    return _DTYPES[name]


def solve_dtype(explicit=None) -> torch.dtype:
    """The dtype of the ADMM solve path: ``explicit`` (a torch dtype or a
    name) where given, else ``DDPCA_SOLVE_DTYPE`` (``f32``, ``f64``,
    ``float32``, ``float64``) where set, else float64."""
    if explicit is not None:
        return _as_dtype(explicit)
    env = os.environ.get("DDPCA_SOLVE_DTYPE")
    if env:
        return _as_dtype(env)
    return torch.float64


def floor_rtol(rtol: float, dtype: torch.dtype) -> float:
    """Clamp a relative residual tolerance to what ``dtype`` can reach."""
    eps = float(torch.finfo(dtype).eps)
    return max(float(rtol), 40.0 * eps)


def floor_crit(crit: float, dtype: torch.dtype) -> float:
    """Clamp the ADMM convergence criterion (a squared-norm ratio,
    MCONTACT.h:2733: ||du||^2 <= crit*||u||^2) to the dtype's floor,
    (100*eps)^2."""
    eps = float(torch.finfo(dtype).eps)
    return max(float(crit), (100.0 * eps) ** 2)


def cast_problem(tree, dtype: torch.dtype, keep=()):
    """``tree`` with every floating tensor in ``dtype`` (the JAX package's
    ``cast_pytree``); integer and bool tensors and other leaves pass
    through, and so do the objects in ``keep`` (the float64 operator of a
    composed coarse correction, ``admm/multiscale.py::ComposedTranD``).  A
    tensor or operator that two fields share stays shared (``tree_map``),
    so an ``A_top`` that aliases the finest level still does."""
    return tree_map(
        lambda t: t.to(dtype) if t.is_floating_point() else t, tree,
        keep=keep)
