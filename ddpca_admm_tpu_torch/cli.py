"""The command line of the example problems (the port of the JAX
package's ``cli.py``).

Replaces the reference's interactive stdin menus (Test.cpp:33-67 and the
per-example .cpp programs) with argparse subcommands.  Each example runs the
full pipeline (mesh -> search -> ESTABLISH -> ADMM or LAGRANGE), writes the
reference-compatible result files (resuNode_/resuElem_/resuDisp_/resuStre_/
resuCont_*.txt), and prints a JSON summary line with the JAX CLI's keys.

Usage:
  python -m ddpca_admm_tpu_torch.cli block    [--divi 2 --glob-leve 1 ...]
  python -m ddpca_admm_tpu_torch.cli torsion  [--scale small|full]
  python -m ddpca_admm_tpu_torch.cli beam     [--scale small|full]
  python -m ddpca_admm_tpu_torch.cli cylinder [--scale small|full]
  python -m ddpca_admm_tpu_torch.cli dehw     [--self-locking ...]
                                             [--apps global|coarse|macro]
  python -m ddpca_admm_tpu_torch.cli boxes    [--levels 0]
                                             [--lagrange --prec-type 1|2]
  python -m ddpca_admm_tpu_torch.cli postprocess <outdir>

Every solving subcommand takes ``--device`` (default ``cuda``: the solve
runs on the card and the command fails when there is none; ``--device cpu``
runs it on the CPU).  ``dehw --apps`` (eigen analysis) and ``postprocess``
(PNG figures, needs matplotlib) are host code.
"""

from __future__ import annotations

import argparse
import json
import os
import time

# the small configurations of the JAX CLI (its cli.py:256-258, 269-270,
# 280-282, 304-310), shared with chip_smoke.py and the tests
SMALL_TORSION = dict(divi=(1, 8, 2), doma=(1, 4, 2), glob_inho=1, glob_homo=1)
SMALL_BEAM = dict(divi=(8, 4, 2), doma=(4, 2, 1), glob_leve=1)
SMALL_CYLINDER = dict(glob_inho=2, glob_homo=0, loca_leve=4,
                      divi=(2, 2, 1, 2), band_widt=8e-4)
SMALL_DEHW = dict(worm_numb=(2, 1, 1, 2, 2), whee_numb=(2, 2, 1, 2, 2),
                  glob_inho=0, glob_homo=1, loca_leve=1)


def cylinder_config(scale: str, stack4: bool = False,
                    cross_corner: bool = False, copy_numb: int = 1):
    from .models.cylinder import CylinderConfig

    cfg = CylinderConfig(**SMALL_CYLINDER) if scale == "small" \
        else CylinderConfig()
    if scale == "small" and (stack4 or cross_corner):
        cfg.loca_leve = 3
    cfg.stack4 = stack4
    cfg.copy_numb = copy_numb
    cfg.cross_corner = cross_corner
    return cfg


def dehw_grid(full: bool = False):
    from .models.dehw_surf import DehwGrid

    return DehwGrid() if full else DehwGrid(**SMALL_DEHW)


def solve(prob, meta, max_iter: int = 3000, moni: bool = False,
          device="cuda"):
    """The ADMM solve under ``timing.trace`` (a torch.profiler trace of the
    whole solve when DDPCA_PROFILE_DIR is set); returns (state, seconds)."""
    import torch

    from .admm.loop import contact_analysis
    from .utils import timing

    t0 = time.time()
    with timing.trace():
        state = contact_analysis(prob, tuple(meta.group_modes),
                                 max_iter=max_iter, record_moni=moni,
                                 device=device)
        if state.u.is_cuda:
            torch.cuda.synchronize()
    return state, time.time() - t0


def write_results(state, meta, bodies, outdir: str, moni: bool = False):
    """The reference's result files from a solved state."""
    from .utils import io as rio

    if moni:
        hist = state.moni_hist.cpu().numpy()[: int(state.it)]
        rio.write_moni(outdir, hist)

    os.makedirs(outdir, exist_ok=True)
    u_all = state.u.cpu().numpy()
    for b, (body, sysm) in enumerate(zip(bodies, meta.systems)):
        full = sysm.full_displacement(u_all[b][: sysm.n_dof])
        rio.write_mesh(outdir, body.mesh, b)
        rio.write_displacement(outdir, full, b, body.node_rota)
        stre = rio.stress_recovery(
            body.mesh, full, body.e_mod, body.nu, body.node_rota
        )
        rio.write_stress(outdir, stre, b)
    for g_i, mode in enumerate(meta.group_modes):
        gs = state.groups[g_i]
        gamma_all = gs.gamma.cpu().numpy()
        z_all, lam_all = gs.z.cpu().numpy(), gs.lam.cpu().numpy()
        for slot, ri in enumerate(meta.group_region_idx[g_i]):
            ip = meta.regions[ri].region.ip
            ndof = ip.n if mode == "scalar" else 3 * ip.n
            rio.write_contact(outdir, gamma_all[slot][:ndof], ip.basis,
                              mode == "scalar", ri)
            rio.write_integral_points(outdir, ip, ri)
            rio.write_segments(outdir, ip, ri)
            for side in (0, 1):
                mdof = meta.regions[ri].sides[side].inte_mass.shape[0]
                rio.write_aula(outdir, z_all[slot, side][:mdof],
                               lam_all[slot, side][:mdof],
                               mode == "scalar", ri, side)


def _solve_and_write(prob, meta, bodies, outdir: str, max_iter: int = 3000,
                     moni: bool = False, device="cuda"):
    from .utils import timing

    state, solve_s = solve(prob, meta, max_iter=max_iter, moni=moni,
                           device=device)
    write_results(state, meta, bodies, outdir, moni=moni)
    return {
        "iterations": int(state.it),
        "converged": bool(state.converged),
        "inner_cg_iterations": int(state.inner_iters),
        "solve_seconds": round(solve_s, 3),
        "setup_phases": {t: round(s, 3) for t, s in timing.reset()},
        "outdir": outdir,
    }


def _apps(args, cfg, bodies, regions) -> dict:
    """DEHW's APPS eigen-analysis path (SOLVE appsCont <= 0,
    DEHW.h:2261-2272), host code: the global problem takes the finest
    level as its "coarse" space, coarse takes doleMcsc, macro runs
    APPS_MPL on the variant-A coarse operator."""
    from .admm.eigen import run_apps, run_apps_mpl, write_freq, write_modes
    from .models.simple import assemble_bodies

    systems = assemble_bodies(bodies, regions)
    if args.apps == "global":
        dole = [s.n_levels - 1 for s in systems]
    else:
        dole = [cfg.dole] * len(systems)
    if args.apps == "macro":
        res = run_apps_mpl(systems, regions, [b.mesh for b in bodies], dole)
    else:
        res = run_apps(systems, regions, dole)
    write_freq(args.outdir, res.vals, res.corr)
    write_modes(args.outdir, res, bodies)
    return {
        "solver": "apps",
        "frequencies": [float(v) for v in res.vals],
        "correlations": [float(c) for c in res.corr],
        "outdir": args.outdir,
    }


def _lagrange(args, meta, bodies) -> dict:
    """The dual-mortar LAGRANGE solve of the boxes on ``args.device``, with
    the penalty-free stiffness (MCONTACT.h:2850-2860); writes resuNode_/
    resuDisp_ per body and resuLagr_ per region."""
    from .admm.lagrange import solve_lagrange
    from .models.simple import assemble_bodies
    from .utils import io as rio

    systems = assemble_bodies(bodies, meta.regions, include_penalty=False)
    res = solve_lagrange(systems, meta.regions, [b.mesh for b in bodies],
                         prec_type=args.prec_type, device=args.device)
    os.makedirs(args.outdir, exist_ok=True)
    for b, (body, sysm) in enumerate(zip(bodies, systems)):
        full = sysm.full_displacement(res.u[b])
        rio.write_mesh(args.outdir, body.mesh, b)
        rio.write_displacement(args.outdir, full, b)
    for ri, r in enumerate(meta.regions):
        rio.write_lagrange(args.outdir, res.lagr[ri], res.status[ri],
                           res.nm_nodes[ri], float(r.region.fric), ri)
    return {
        "solver": "lagrange",
        "newton_iterations": res.iters,
        "outdir": args.outdir,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="ddpca_admm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("block", help="3-block contact patch test (BLOCK)")
    p.add_argument("--divi", type=int, default=2)
    p.add_argument("--glob-leve", type=int, default=1)
    p.add_argument("--doma", type=int, default=1)
    p.add_argument(
        "--coarse-solver", choices=["auto", "direct", "ddmg"], default="auto",
        help="coarse-correction solve: dense inverse or DOUBLE_M DD-multigrid"
             " (auto switches at 120k coarse DOF, PREP.h DIRE_MAXI)",
    )
    p.add_argument(
        "--cross-corner", action="store_true",
        help="BLOCK_1 variant: no guard slabs, subdomain corners on the "
             "contact interfaces (examples/BLOCK_1.h)",
    )
    p.add_argument(
        "--dole", type=int, default=None,
        help="doleMcsc coarse level (reference: 1, BLOCK.cpp:69-71; "
             "default 1 when glob_leve>=1 else 0)",
    )
    p.add_argument("--outdir", default="Block")

    p = sub.add_parser("torsion", help="hollow cylinder under torque (TORSION)")
    p.add_argument("--scale", choices=["small", "full"], default="small")
    p.add_argument("--outdir", default="Torsion")

    p = sub.add_parser("beam", help="pre-twisted tapered cantilever (BEAM)")
    p.add_argument("--scale", choices=["small", "full"], default="small")
    p.add_argument("--outdir", default="Beam")

    p = sub.add_parser("cylinder", help="Hertz contact of cylinders (CYLINDER)")
    p.add_argument("--scale", choices=["small", "full"], default="small")
    p.add_argument(
        "--stack4", action="store_true",
        help="full 4-section stack x mirror halves (CYLINDER.h:440-551)",
    )
    p.add_argument(
        "--copy-numb", type=int, default=1,
        help="axial copies replicated by COPY+RIGI_ROTR (CYLINDER.h:41; "
             "reference: 16)",
    )
    p.add_argument(
        "--cross-corner", action="store_true",
        help="CYLINDER_1 cross-corner variant (4 full sections per copy, "
             "fixed penalty 210e9*1000)",
    )
    p.add_argument("--outdir", default="Cylinder")

    p = sub.add_parser(
        "dehw", help="double-enveloping hourglass worm drive (DEHW, flagship)"
    )
    p.add_argument(
        "--self-locking", action="store_true",
        help="self-locking analysis with driving wheel: mu=0.2, distCrit "
             "{65,45,25} um (DEHW.cpp ISNO_SELO; DEHW.h:1619,2229-2234)",
    )
    p.add_argument(
        "--tape-coef", type=float, default=25.0,
        choices=[0.025, 0.25, 2.5, 25.0],
        help="tangential/normal penalty ratio menu (DEHW.h:6, "
             "DEHW.cpp:123-153)",
    )
    p.add_argument(
        "--full", action="store_true",
        help="reference-scale grid: worm_numb (4,2,2,4,4), whee_numb "
             "(4,4,2,4,8), globInho=1 globHomo=2 locaLeve=3 "
             "(DEHWSURF.h:185-196)",
    )
    p.add_argument(
        "--no-dd", action="store_true",
        help="menu 0: ADMM without DD (1 worm + 1 wheel domain)",
    )
    p.add_argument(
        "--cross-corner", action="store_true",
        help="DEHW_1 variant: wheel teeth split by face-width sections with "
             "full-width blocks — DD corners cross the contact zone "
             "(examples/DEHW_1.h:762-812)",
    )
    p.add_argument("--glob-inho", type=int, default=None)
    p.add_argument("--glob-homo", type=int, default=None)
    p.add_argument("--loca-leve", type=int, default=None)
    p.add_argument(
        "--apps", choices=["global", "coarse", "macro"], default=None,
        help="eigen analysis instead of contact solve (DEHW.cpp:110-121: "
             "1 = global problem, 2 = global coarse problem; macro = "
             "APPS_MPL on the variant-A coarse operator, "
             "MCONTACT.h:2405-2474); writes resuFreq.txt + per-body modes",
    )
    p.add_argument("--outdir", default="Dehw")

    p = sub.add_parser("boxes", help="two-box contact demo / LAGRANGE check")
    p.add_argument("--lagrange", action="store_true")
    p.add_argument(
        "--prec-type", type=int, choices=[1, 2], default=2,
        help="LAGRANGE preconditioner: 1=restricted-GMG, 2=Jacobi "
             "(reference precType menu)",
    )
    p.add_argument("--levels", type=int, default=0,
                   help="global refinement levels of the two boxes")
    p.add_argument("--outdir", default="Boxes")

    p = sub.add_parser(
        "postprocess",
        help="render result files to PNGs (Postprocess.m equivalent)",
    )
    p.add_argument("outdir", help="result directory written by a solve run")

    for name, sp in sub.choices.items():
        if name == "postprocess":
            continue
        sp.add_argument(
            "--moni", action="store_true",
            help="write resuMoni.txt per-iteration convergence monitors "
                 "(MCONTACT.h:2742)",
        )
        sp.add_argument(
            "--max-iter", type=int, default=3000,
            help="ADMM outer-iteration cap (MCONTACT.h:2502 maxiIter)",
        )
        sp.add_argument(
            "--device", default="cuda",
            help="torch device of the solve (default cuda: fails without a "
                 "card; cpu runs it on the CPU)",
        )

    args = ap.parse_args(argv)
    t0 = time.time()

    if args.cmd == "postprocess":
        from .utils.postprocess import postprocess

        print(json.dumps({"plots": postprocess(args.outdir)}))
        return

    dev = args.device
    run = dict(moni=args.moni, max_iter=args.max_iter, device=dev)

    if args.cmd == "block":
        from .admm.problem import build_problem
        from .models.block import BlockConfig, build_block_model

        cfg = BlockConfig(
            divi=(args.divi,) * 3,
            glob_leve=args.glob_leve,
            doma_numb=(args.doma,) * 3,
            guard_slabs=not args.cross_corner,
        )
        model = build_block_model(cfg)
        dole_lv = args.dole if args.dole is not None else (
            1 if args.glob_leve >= 1 else 0
        )
        prob, meta = build_problem(
            model.systems, model.regions,
            dole=[dole_lv] * len(model.systems),
            coarse_solver=args.coarse_solver, device=dev,
        )
        summary = _solve_and_write(prob, meta, model.bodies, args.outdir,
                                   **run)
    elif args.cmd == "torsion":
        from .models.torsion import TorsionConfig, build_torsion_model

        cfg = TorsionConfig(**SMALL_TORSION) if args.scale == "small" \
            else TorsionConfig()
        prob, meta, bodies, cfg = build_torsion_model(cfg, device=dev)
        summary = _solve_and_write(prob, meta, bodies, args.outdir, **run)
        summary["analytic_twist"] = cfg.analytic_twist
    elif args.cmd == "beam":
        from .models.beam import BeamConfig, build_beam_model

        cfg = BeamConfig(**SMALL_BEAM) if args.scale == "small" \
            else BeamConfig()
        prob, meta, bodies, cfg = build_beam_model(cfg, device=dev)
        summary = _solve_and_write(prob, meta, bodies, args.outdir, **run)
    elif args.cmd == "cylinder":
        from .models.cylinder import build_cylinder_model

        cfg = cylinder_config(args.scale, args.stack4, args.cross_corner,
                              args.copy_numb)
        prob, meta, bodies, cfg = build_cylinder_model(cfg, device=dev)
        summary = _solve_and_write(prob, meta, bodies, args.outdir, **run)
        a, p_max = cfg.hertz
        summary["hertz_half_width"] = a
        summary["hertz_p_max"] = p_max
    elif args.cmd == "dehw":
        from .models.dehw_assembly import (
            DehwDDConfig,
            build_dehw_assembly,
            finalize_dehw_problem,
        )

        grid = dehw_grid(args.full)
        for name in ("glob_inho", "glob_homo", "loca_leve"):
            v = getattr(args, name)
            if v is not None:
                setattr(grid, name, v)
        cfg = DehwDDConfig(
            grid=grid,
            drive="wheel" if args.self_locking else "worm",
            dode=not args.no_dd,
            tape_coef=args.tape_coef,
            cross_corner=args.cross_corner,
        )
        bodies, regions, info = build_dehw_assembly(cfg)
        if args.apps:
            summary = _apps(args, cfg, bodies, regions)
        else:
            prob, meta = finalize_dehw_problem(bodies, regions, cfg,
                                               device=dev)
            summary = _solve_and_write(prob, meta, bodies, args.outdir,
                                       **run)
            summary["self_locking"] = args.self_locking
            summary["tape_coef"] = args.tape_coef
            summary["n_worm"] = info["n_worm"]
            summary["n_whee"] = info["n_whee"]
            summary["n_contact_regions"] = sum(
                1 for k in info["region_kinds"] if k[0] == "contact"
            )
    elif args.cmd == "boxes":
        from .models.simple import stacked_boxes_problem

        prob, meta, bodies = stacked_boxes_problem(levels=args.levels,
                                                   device=dev)
        if args.lagrange:
            summary = _lagrange(args, meta, bodies)
        else:
            summary = _solve_and_write(prob, meta, bodies, args.outdir,
                                       **run)

    summary["total_seconds"] = round(time.time() - t0, 3)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
