"""Device selection and moving operator trees between devices."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.  ``"cuda"`` (the default)
    requires a card and raises without one: the port never falls back to
    the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def tree_map(fn, obj, keep=()):
    """Apply ``fn`` to every tensor in a tree of NamedTuples, tuples, lists
    and operator objects (whose attributes are mapped); other leaves, and
    the objects in ``keep``, pass through.  Operator objects are copied,
    never mutated.  A tensor or object reached twice
    (``MgHierarchy.A_top`` aliasing the finest level's operator) is mapped
    once, and both places get the one result."""
    memo: dict[int, object] = {id(o): o for o in keep}

    def go(o):
        key = id(o)
        if key in memo:
            return memo[key]
        if isinstance(o, torch.Tensor):
            out = fn(o)
        elif isinstance(o, tuple) and hasattr(o, "_fields"):
            out = type(o)(*(go(v) for v in o))
        elif isinstance(o, (tuple, list)):
            out = type(o)(go(v) for v in o)
        elif o is None or isinstance(o, (bool, int, float, str, np.generic,
                                         np.ndarray, torch.dtype)):
            return o
        else:
            out = object.__new__(type(o))
            out.__dict__.update({k: go(v) for k, v in vars(o).items()})
        memo[key] = out
        return out

    return go(obj)


def to_device(tree, device):
    dev = torch.device(device)
    return tree_map(lambda t: t.to(dev), tree)
