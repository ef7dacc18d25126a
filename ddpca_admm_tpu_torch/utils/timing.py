"""Phase timing + profiler hooks (reference OUTPUT_TIME, PREP.h:88-93).

The reference stamps wall-clock at every phase boundary.  Here:

  * :func:`phase` — context manager that records (tag, seconds) into the
    module-level ``PHASES`` list and, when ``DDPCA_TIME`` is set (or
    :func:`enable` was called), prints ``tag: <seconds>`` on exit — the
    OUTPUT_TIME equivalent with durations instead of raw ctime stamps.
  * :func:`trace` — context manager around ``torch.profiler.profile``
    writing a Chrome trace (``trace.json``) when ``DDPCA_PROFILE_DIR`` (or
    the argument) is set; a no-op otherwise, so production paths can stay
    annotated.  The solve loop's ``record_function`` ranges (admm/loop.py)
    appear in it by name.
"""

from __future__ import annotations

import contextlib
import os
import time

PHASES: list[tuple[str, float]] = []
_enabled = [bool(os.environ.get("DDPCA_TIME"))]


def enable(on: bool = True) -> None:
    _enabled[0] = on


def reset() -> list[tuple[str, float]]:
    out = list(PHASES)
    PHASES.clear()
    return out


@contextlib.contextmanager
def phase(tag: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        PHASES.append((tag, dt))
        if _enabled[0]:
            print(f"{tag}: {dt:.3f} s", flush=True)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """torch.profiler trace into ``log_dir`` / $DDPCA_PROFILE_DIR (no-op
    when neither is set); the card's activity is traced when there is one."""
    log_dir = log_dir or os.environ.get("DDPCA_PROFILE_DIR")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
