#!/usr/bin/env python3
"""How far the port's float32 solve of BLOCK menu-1 ends from its float64
solve, and what sets that distance.

    python3 scripts/f32_accuracy.py --glob-leve 4 [--device cuda|cpu]
        [--compose-min-dofs N] [--threads N]

Builds ``BlockConfig(divi=(6,6,6), glob_leve=L, doma_numb=(2,2,2))`` (the
problem of ``chip_smoke.py``'s ``slice`` and ``full`` phases: dole 1,
MULTISCALE_1), solves it in float64, then builds it in float32 and solves
it under these variants, each from the zero state:

  port          the float32 path as the port ships it;
  a_u_float32   a composed coarse correction's F^T A u with A u in float32
                (A = the finest level's float32 operator, the JAX package's
                semantics); only where the correction is composed;
  floor_4eps    a_u_float32 (or port) with the body PCG floored at 4 eps
                instead of 40 eps;
  crit_1e-12    a_u_float32 (or port) run 30 iterations against the
                reference's 1e-12 criterion instead of (100 eps)^2.

One JSON line per solve: ``it``, ``converged``, ``inner_iters``,
``solve_s``, the monitor ratio and the largest |u - u64| over max|u64| after
every iteration, the same per body at the end, and the patch test's error
over |p|H/E.  ``--compose-min-dofs 0`` forces the composed coarse
correction at any size (``DDPCA_COMPOSE_TRAND_MIN_DOFS``).  Imports nothing
of JAX; glob_leve=4 builds only on the card's machine (~48 GB of host
memory).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CRIT_ITERS = 30


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--glob-leve", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compose-min-dofs", type=int, default=None)
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args()
    if args.compose_min_dofs is not None:
        os.environ["DDPCA_COMPOSE_TRAND_MIN_DOFS"] = str(args.compose_min_dofs)

    import numpy as np
    import torch

    from chip_smoke import patch_error
    from ddpca_admm_tpu_torch.admm import loop
    from ddpca_admm_tpu_torch.admm.multiscale import ComposedTranD
    from ddpca_admm_tpu_torch.admm.problem import build_problem
    from ddpca_admm_tpu_torch.models.block import (
        BlockConfig,
        build_block_model,
    )
    from ddpca_admm_tpu_torch.utils.device import resolve_device, to_device

    if args.threads:
        torch.set_num_threads(args.threads)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    cfg = BlockConfig(divi=(6, 6, 6), glob_leve=args.glob_leve,
                      doma_numb=(2, 2, 2))
    model = build_block_model(cfg)
    dole = [1] * len(model.systems)

    def problem(dtype):
        prob, meta = build_problem(model.systems, model.regions, dole=dole,
                                   musc_sett=2, device="cpu", dtype=dtype)
        return to_device(prob, dev), meta

    def solve(name, prob, meta, max_iter, u64=None):
        errs = []
        scale = 1.0 if u64 is None else float(u64.abs().max())

        def track(s):
            if u64 is not None:
                errs.append(float((s.u.double() - u64).abs().max()) / scale)

        sync()
        t = time.perf_counter()
        st = loop.contact_analysis(prob, tuple(meta.group_modes),
                                   max_iter=max_iter, device=dev,
                                   record_moni=True, callback=track)
        sync()
        solve_s = time.perf_counter() - t
        u = st.u.double()
        ratio = st.moni_hist[:st.it].double().amax(dim=1).tolist()
        err, pscale = patch_error(np, cfg, model, meta, u.cpu().numpy(), name)
        row = dict(glob_leve=args.glob_leve, variant=name, it=st.it,
                   converged=st.converged, inner_iters=st.inner_iters,
                   solve_s=solve_s, ratio=ratio, patch_err_rel=err / pscale)
        if u64 is not None:
            row["err_rel"] = errs
            row["err_rel_by_body"] = (
                (u - u64).abs().amax(dim=1) / scale).tolist()
        print(json.dumps(row), flush=True)
        return u

    prob, meta = problem(torch.float64)
    u64 = solve("float64", prob, meta, 60)
    del prob

    prob, meta = problem(torch.float32)
    co = prob.coarse[0]
    composed = isinstance(co.tranD, ComposedTranD)
    solve("port", prob, meta, 60, u64)
    if composed:
        t = co.tranD
        jax_like = ComposedTranD(t.reg, t.idx, t.mask, t.level, t.chain,
                                 prob.mg.A_top)
        prob = prob._replace(coarse=(co._replace(tranD=jax_like),)
                             + prob.coarse[1:])
        solve("a_u_float32", prob, meta, 60, u64)
    eps = float(torch.finfo(torch.float32).eps)
    floor_rtol, floor_crit = loop.floor_rtol, loop.floor_crit
    try:
        loop.floor_rtol = lambda rtol, dtype: max(float(rtol), 4.0 * eps)
        solve("floor_4eps", prob, meta, 60, u64)
        loop.floor_rtol = floor_rtol
        loop.floor_crit = lambda crit, dtype: float(crit)
        solve("crit_1e-12", prob, meta, CRIT_ITERS, u64)
    finally:
        loop.floor_rtol, loop.floor_crit = floor_rtol, floor_crit
    return 0


if __name__ == "__main__":
    sys.exit(main())
