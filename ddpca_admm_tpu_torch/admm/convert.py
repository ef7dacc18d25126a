"""Carry a problem built by the JAX package over into the port.

``problem_from_arrays`` takes the JAX package's ``AdmmProblem`` after its
leaves were turned into numpy arrays (``jax.tree_util.tree_map(np.asarray,
prob)``) and returns the port's ``AdmmProblem`` on ``device``.  It reads the
problem by class and attribute name only and imports nothing of the JAX
package, so both solvers can be fed identical operators in the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solvers.mg import (
    BatchBlocks,
    MgHierarchy,
    MgLevel,
    StructuredProl,
    StructuredRest,
)
from ..sparse.bell import BlockEll
from ..sparse.dia import Dia, PlaneDia
from ..sparse.ell import Ell
from ..utils.device import resolve_device, to_device, tree_map
from .multiscale import (
    CoarseCorrection,
    ComposedAccu,
    ComposedTranD,
    with_chains,
)
from .problem import AdmmProblem, RegionGroup

# index arrays the port keeps as int64 (gather/scatter/take indices)
_INDEX_FIELDS = ("cols", "t_idx", "tranL_idx", "tranZ_idx", "idx",
                 "body_idx")


def _t(a, index: bool = False) -> torch.Tensor:
    a = np.asarray(a)
    if index:
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a))


def _conv(obj, index: bool = False):
    """Convert one node of the numpy-leaved JAX problem tree."""
    if obj is None:
        return None
    name = type(obj).__name__
    if isinstance(obj, np.ndarray) or np.isscalar(obj):
        return _t(obj, index)
    if name == "Ell":
        return Ell(vals=_t(obj.vals), cols=_t(obj.cols, True),
                   n_cols=int(obj.n_cols))
    if name == "BlockEll":
        return BlockEll(tiles=_t(obj.tiles),
                        cblk=_t(np.asarray(obj.cblk).astype(np.int32)),
                        n_cols=int(obj.n_cols))
    if name == "Dia":
        return Dia(_t(obj.vals), obj.offsets, obj.n_rows,
                   tail_identity=obj.tail_identity)
    if name == "PlaneDia":
        return PlaneDia(_t(obj.vals), _t(obj.kz).to(torch.int32),
                        obj.offsets, obj.n_rows, obj.plane,
                        tail_identity=obj.tail_identity)
    if name == "BatchBlocks":
        return BatchBlocks(tuple(_conv(op) for op in obj.ops), obj.bounds)
    if name == "StructuredProl":
        return StructuredProl(_conv(obj.S), obj.fshape, obj.cshape,
                              obj.strides, obj.n_c_pad)
    if name == "StructuredRest":
        return StructuredRest(_conv(obj.St), obj.fshape, obj.cshape,
                              obj.strides, obj.n_c_pad)
    # the chains come from the converted hierarchy (problem_from_arrays)
    if name == "ComposedTranD":
        return ComposedTranD(_conv(obj.reg), _t(obj.idx, True),
                             _t(obj.mask), obj.level, chain=(), A=None)
    if name == "ComposedAccu":
        return ComposedAccu(_t(obj.idx, True), _t(obj.mask), obj.level,
                            obj.n_dole_pad, obj.n_bodies, chain=())
    for cls in (MgLevel, MgHierarchy, CoarseCorrection, RegionGroup,
                AdmmProblem):
        if name == cls.__name__:
            return cls(**{
                f: _conv(getattr(obj, f), f in _INDEX_FIELDS)
                for f in cls._fields
            })
    if isinstance(obj, tuple):
        return tuple(_conv(v, index) for v in obj)
    raise TypeError(f"problem_from_arrays: unknown node {name}")


def _tensors(op) -> list:
    found = []
    tree_map(lambda t: found.append(t) or t, op)
    return found


def _alias_top(mg: MgHierarchy) -> MgHierarchy:
    """``mg`` with A_top the finest level's operator where the two hold the
    same tables, as the port's ``build_hierarchy`` makes them when the
    dtypes agree (the JAX package's float32 problem): numpy leaves carry
    them over as two copies."""
    top, fine = mg.A_top, mg.levels[-1].A
    if type(top) is not type(fine) or top.dtype != fine.dtype:
        return mg
    a, b = _tensors(top), _tensors(fine)
    if len(a) == len(b) and all(
            x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
            for x, y in zip(a, b)):
        return mg._replace(A_top=fine)
    return mg


def problem_from_arrays(prob_np, device="cuda") -> AdmmProblem:
    """The port's AdmmProblem on ``device`` from the JAX package's problem
    with numpy leaves.  A float32 problem keeps its float32 leaves, and
    A_top aliases the finest level, in the body hierarchy and in a coarse
    correction's own."""
    prob = _conv(prob_np)
    prob = prob._replace(mg=_alias_top(prob.mg))
    if prob.coarse:
        prob = prob._replace(coarse=tuple(
            with_chains(co if co.mg is None
                        else co._replace(mg=_alias_top(co.mg)), prob.mg)
            for co in prob.coarse))
    return to_device(prob, resolve_device(device))
