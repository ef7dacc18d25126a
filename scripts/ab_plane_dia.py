#!/usr/bin/env python3
"""A/B of K1, the PlaneDia SpMV, against an earlier version of its CUDA
source on one card, in turns within one process.

    git show <rev>:ddpca_admm_tpu_torch/csrc/plane_dia.cu > _scratch/old.cu
    python3 scripts/ab_plane_dia.py --old-src _scratch/old.cu [--seed N]

The earlier source must export the row-per-thread kernel's C interface
(``plane_dia_mv_f32/f64(vals, kz, offsets, x, y, B, nz, P, D, n_rows,
stream)``, offsets as int64, the tail rows left to the caller), as
``csrc/plane_dia.cu`` did before the class-plan kernel; this script builds
it with the same nvcc flags into ``ddpca_admm_tpu_torch/_build/`` and
writes the tail rows after it as that version's wrapper did.  For every
shape of ``chip_smoke.py``'s ``K1_CASES`` both versions are held against
the plain version, then timed cold and warm (``chip_smoke.cold_ms`` and
``warm_ms``) in the order old, new, new, old.  One JSON line per shape,
the card's name and power limit, and the whole result in
``chiprun_out/ab_plane_dia.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def build_old(src: Path):
    """Build the earlier source into its own library and bind it."""
    from ddpca_admm_tpu_torch.utils import cuda_lib

    key = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = cuda_lib.BUILD_DIR / f"ab_{key}" / "libold.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out),
               str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            cs.fail(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name in ("plane_dia_mv_f32", "plane_dia_mv_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 5 + [i] * 4 + [ctypes.c_longlong, vp]
        fn.restype = i
        fns[name] = fn
    return fns


def old_mv_of(torch, fns):
    def old_mv(pd, x):
        C, D, P = pd.vals.shape
        B, nz = pd.kz.shape
        n, na = pd.n_rows, nz * P
        fn = fns["plane_dia_mv_f64" if x.dtype == torch.float64
                 else "plane_dia_mv_f32"]
        y = torch.empty_like(x)
        err = fn(pd.vals.data_ptr(), pd.kz.data_ptr(), pd.ab_off.data_ptr(),
                 x.data_ptr(), y.data_ptr(), B, nz, P, D, n,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"old kernel: cudaError {err}")
        if na < n:
            if pd.tail_identity:
                y[:, na:].copy_(x[:, na:])
            else:
                y[:, na:].zero_()
        return y
    return old_mv


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-src", required=True, type=Path)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: the A/B needs a card")
    from ddpca_admm_tpu_torch.sparse import plane_dia_kernel as K

    old_mv = old_mv_of(torch, build_old(args.old_src))
    new_mv = K.plane_dia_mv
    smi = cs.smi_line()
    rows = []
    for i, (label, dtype, C, grid, kind, B, n, tail, layout) in \
            enumerate(cs.K1_CASES):
        pd, x = cs.make_plane_dia(torch, args.seed + i, dtype, C, grid, kind,
                                  B, n, tail, layout)
        pd.ab_off = torch.tensor(pd.offsets, dtype=torch.int64,
                                 device="cuda")
        y_plain = K.plane_dia_mv_plain(pd, x)
        scale = float(y_plain.abs().max())
        rel = 1e-12 if pd.dtype == torch.float64 else 1e-5
        errs = {}
        for name, mv in (("old", old_mv), ("new", new_mv)):
            errs[name] = float((mv(pd, x) - y_plain).abs().max())
            cs.check(errs[name] <= rel * scale,
                     f"A/B {label}: {name} disagrees ({errs[name]})")
        del y_plain
        order = (("old", old_mv), ("new", new_mv), ("new", new_mv),
                 ("old", old_mv))
        cold = {"old": [], "new": []}
        warm = {"old": [], "new": []}
        for name, mv in order:
            cold[name].append(cs.cold_ms(torch, mv, pd, x))
        for name, mv in order:
            warm[name].append(cs.warm_ms(torch, lambda mv=mv: mv(pd, x)))
        bound_ms, bound_by, nbytes, _ = cs.k1_bound(pd, x)
        row = dict(case=label, dtype=dtype, vals=list(pd.vals.shape),
                   kz=list(pd.kz.shape), layout=layout, max_abs_err=errs,
                   cold_ms=cold, warm_ms=warm, bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes,
                   cold_speedup=sum(cold["old"]) / sum(cold["new"]),
                   bound_share_cold_new=bound_ms / min(cold["new"]))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del pd, x
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_plane_dia.json").write_text(json.dumps(
        {"nvidia_smi": smi, "cases": rows}, indent=1))
    print(smi, flush=True)
    slower = [r["case"] for r in rows
              if max(r["cold_ms"]["new"]) > min(r["cold_ms"]["old"])]
    print(json.dumps({"ok": True, "new_slower_cold_in_some_turn": slower}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
