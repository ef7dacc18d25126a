"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source has a plain C interface.  At first use ``nvcc``
compiles each source into a shared library of its own for ``sm_90a``, all
of them at once (one process per source, started together), and
``ctypes`` loads them; no PyTorch headers are compiled, so the build takes
seconds.  The libraries go into ``ddpca_admm_tpu_torch/_build/<hash>/``,
keyed by a hash of the sources and flags, so a changed source rebuilds.
Each build writes to a temporary name and renames it into place, so it
takes no lock.  A failed build raises with nvcc's output: there is no
fallback.
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
# plane_dia_mv_*: vals, pairs, items, groups, x, y, B, C, nz, P, D, G,
# n_items, n_rows, tail_identity, window, cap, stream
_PLANE_DIA = [_vp] * 6 + [_i] * 7 + [_ll] + [_i] * 3 + [_vp]
# block_ell_mv_*: tiles, cblk, x, y, F, n_rb, S, n_cb, tile, cblk and x
# batch strides, stream
_BLOCK_ELL = [_vp] * 4 + [_i] * 4 + [_ll] * 3 + [_vp]
# name -> argtypes of every C entry point the libraries export
SIGNATURES = {
    "plane_dia_mv_f32": _PLANE_DIA,
    "plane_dia_mv_f64": _PLANE_DIA,
    "block_ell_mv_f32": _BLOCK_ELL,
    "block_ell_mv_f64": _BLOCK_ELL,
}


class KernelLibrary:
    """The loaded libraries, one per source, with the build's wall seconds
    and nvcc's log; every entry point of SIGNATURES is an attribute."""

    def __init__(self, paths: list[Path], build_s: float, log: str):
        self.paths = paths
        self.build_s = build_s
        self.log = log
        self.cdlls = [ctypes.CDLL(str(p)) for p in paths]
        for name, argtypes in SIGNATURES.items():
            found = [c for c in self.cdlls if hasattr(c, name)]
            if len(found) != 1:
                raise RuntimeError(f"{name}: exported by {len(found)} of the "
                                   f"kernel libraries, not one")
            fn = getattr(found[0], name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


# the libraries this process loaded (the hash is taken once per process: the
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
    """Build the libraries if this source hash has none yet, then load
    them."""
    if _LOADED:
        return _LOADED[0]
    out_dir = BUILD_DIR / build_key()
    libs = [out_dir / f"lib{src.stem}.so" for src in _sources()]
    build_s, log = 0.0, "(cached build)"
    todo = [(src, lib) for src, lib in zip(_sources(), libs)
            if not lib.exists()]
    if todo:
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        runs = []
        for src, lib in todo:
            tmp = out_dir / f".{lib.name}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            runs.append((cmd, tmp, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, tmp, lib, proc in runs:
            out = proc.communicate()[0]
            logs.append(f"{lib.name}:\n{out}")
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed (exit {proc.returncode}): "
                              f"{' '.join(cmd)}\n{out}")
            else:
                os.replace(tmp, lib)
        build_s = time.perf_counter() - t0
        log = "".join(logs)
        if failed:
            raise RuntimeError("\n".join(failed))
    lib = KernelLibrary(libs, build_s, log)
    _LOADED.append(lib)
    return lib
