"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source has a plain C interface.  ``nvcc`` compiles them
into one shared library for ``sm_90a`` at first use, and ``ctypes`` loads
it; no PyTorch headers are compiled, so the build takes seconds.  The
library goes into ``ddpca_admm_tpu_torch/_build/<hash>/``, keyed by a hash
of the sources and flags, so a changed source rebuilds.  The build writes
to a temporary name and renames it into place, so it takes no lock.  A
failed build raises with nvcc's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libddpca_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp = ctypes.c_void_p
_i = ctypes.c_int
# name -> argtypes of every C entry point the library exports
# plane_dia_mv_*: vals, pairs, items, groups, x, y, B, C, nz, P, D, G,
# n_items, n_rows, tail_identity, window, cap, stream
_PLANE_DIA = [_vp] * 6 + [_i] * 7 + [ctypes.c_longlong] + [_i] * 3 + [_vp]
SIGNATURES = {
    "plane_dia_mv_f32": _PLANE_DIA,
    "plane_dia_mv_f64": _PLANE_DIA,
}


class KernelLibrary:
    """The loaded library, with the build's seconds and nvcc's log."""

    def __init__(self, path: Path, build_s: float, log: str):
        self.path = path
        self.build_s = build_s
        self.log = log
        self.cdll = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


# the library this process loaded (the hash is taken once per process: the
# wrappers call load() on every launch)
_LOADED: list[KernelLibrary] = []


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built"
        )
    return found


def build_key() -> str:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load() -> KernelLibrary:
    """Build the library if this source hash has none yet, then load it."""
    if _LOADED:
        return _LOADED[0]
    key = build_key()
    out_dir = BUILD_DIR / key
    lib_path = out_dir / LIB_NAME
    build_s, log = 0.0, "(cached build)"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in _sources())]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_s = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, lib_path)
    lib = KernelLibrary(lib_path, build_s, log)
    _LOADED.append(lib)
    return lib
