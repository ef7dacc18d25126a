"""ADMM state checkpoint and resume (the port of ``utils/checkpoint.py``).

The reference has no resume capability (SURVEY.md section 5: state is only
written as final text files).  The whole solver state is one ``AdmmState``
(u, z, lambda, monitors), so a checkpoint is a straight serialization: its
tensors are saved from the CPU with ``torch.save`` and loaded with
``torch.load(weights_only=True)``, which unpickles tensors and plain
containers only.  :func:`admm.loop.contact_analysis_stepwise` takes a
callback that can save one after any iteration.
"""

from __future__ import annotations

import os

import torch

from ..admm.loop import AdmmState, GroupState
from ..utils.device import resolve_device


def save_state(path: str, state: AdmmState) -> None:
    """Write ``state`` to ``path`` (its tensors copied to the CPU)."""
    host = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in state._asdict().items()}
    host["groups"] = [{k: v.cpu() for k, v in g._asdict().items()}
                      for g in state.groups]
    host["coarse_x"] = [x.cpu() for x in state.coarse_x]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(host, path)


def load_state(path: str, device="cuda") -> AdmmState:
    """The state saved at ``path``, with its tensors on ``device`` (default
    the card; raises without one unless ``"cpu"``)."""
    host = torch.load(path, map_location=resolve_device(device),
                      weights_only=True)
    host["groups"] = tuple(GroupState(**g) for g in host["groups"])
    host["coarse_x"] = tuple(host["coarse_x"])
    return AdmmState(**host)
