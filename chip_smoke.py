#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ddpca_admm_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N]

Phases, one line each with its ``elapsed_s``:

  1. device  — the card's name and power limit (nvidia-smi), and the nvcc
     build of the kernel library (``csrc/*.cu``) with its seconds;
  2. kernels — K1, the PlaneDia SpMV, against its plain PyTorch version at
     every shape the BLOCK glob_leve=2 solve gives it, plus a tail-identity
     and a zero-tail case, and at the glob_leve=4 (8.8M DOF) shapes of the
     finest level and A_top, on inputs made from ``--seed``; per shape the
     kernel's time warm (CUDA-graph replays, inputs warm in L2 from the
     call before) and cold (a graph that cycles through copies of the
     inputs larger than twice the L2), its bound, the plain version's time
     and, as a yardstick only, the time of ``torch.sparse.mm`` on a CSR
     tensor of the same matrix, the last two warm;
  3. small   — the small BLOCK (divi 2, glob_leve 1, one core per block) with
     the PlaneDia path forced, solved on the CPU (plain versions) and on the
     card (K1): the same ADMM iteration count and u within 1e-6 max|u|;
  4. slice   — the BLOCK menu-1 problem at glob_leve=2 (180,684 DOF, 30
     bodies, MULTISCALE_1 at doleMcsc=1) built by the port's own host code,
     K1 held against its plain version on every PlaneDia operator of the
     problem and timed there warm and cold, then solved on the card through ``contact_analysis``: it must
     converge in 19-21 ADMM iterations through K1 and pass the patch test
     (u_z = p z / E);
  5. examples — TORSION, BEAM, CYLINDER (the 4-section stack and the
     CYLINDER_1 cross-corner variant) and DEHW built by the port's host
     code and solved through the CLI's solve: at the JAX CLI's small
     configuration on the card against the CPU (the CPU solves run in
     worker processes from the start of the script), then one level of
     refinement above it on the card alone, held to the example's oracle
     (TORSION's analytic twist, BEAM's unsplit solve, CYLINDER's line load
     and Hertz peak, DEHW's monitors and contact pressures after a fixed
     iteration count).  One line per solve, with its cuts from the
     reference's settings, K1 launches and peak device memory;
  6. lagrange — the dual-mortar LAGRANGE solver: the stacked boxes at one
     refinement level (BiCGSTAB on the device) on the card against the
     CPU, at both preconditioners and with Coulomb friction, then BLOCK
     at glob_leve=2 without domain decomposition (163,125 DOF) on the
     card at both preconditioners, held to the patch test and the
     expected contact states; no K1 launch (every operator is ELL);
  7. apps    — DEHW's APPS eigen-analysis (``dehw --apps coarse``) through
     the port's command line, host code, at the small grid.

Then the ``kernels`` JSON line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Any failed check ends the run
with a non-zero exit.  The script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, dense, without sparsity): HBM3 rate and
# the CUDA-core (non-tensor-core) rates the SpMV's multiply-adds run at
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
REPLACES = "ddpca_admm_tpu/sparse/pallas_dia.py:117"
# cold timing: the copies of a case's inputs pass twice the 50 MB L2
COLD_BYTES = 2 * 50 * 2 ** 20
COLD_COPIES_MAX = 512
# a table above this is timed with fewer calls in the plain version
BIG_TABLE_BYTES = 100 * 2 ** 20
# the BLOCK size of the slice phase: 180,684 DOF (the only size whose
# iteration gate below holds; the JAX package and the C++ reference take 20)
GLOB_LEVE = 2
SOURCE = "ddpca_admm_tpu_torch/csrc/plane_dia.cu"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase,
                      "elapsed_s": round(time.perf_counter() - T0, 3),
                      **kw}), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing

def graph_ms(torch, calls, reps: int = 5) -> float:
    """Device time of one call: a CUDA graph of the callables ``calls``,
    in order, replayed ``reps`` times between CUDA events (no host
    overhead), over the number of calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (reps * len(calls))


def warm_ms(torch, fn, inner: int = 20, reps: int = 5) -> float:
    """One fn() call with its inputs warm in L2 from the call before."""
    return graph_ms(torch, [fn] * inner, reps)


def cold_ms(torch, mv, pd, x, reps: int = 3) -> float:
    """One mv(pd, x) call with its table and x out of L2: the graph cycles
    through k copies of (vals, x) that together pass COLD_BYTES, so the
    calls since a copy's last turn have evicted it (k >= 2, the plan is
    shared)."""
    per = (pd.vals.numel() * pd.vals.element_size()
           + 2 * x.numel() * x.element_size())
    k = min(COLD_COPIES_MAX, max(2, -(-COLD_BYTES // per)))
    copies = []
    for _ in range(k):
        c = copy.copy(pd)
        c.vals = pd.vals.clone()
        copies.append((c, x.clone()))
    calls = [lambda c=c, xc=xc: mv(c, xc) for c, xc in copies]
    ms = graph_ms(torch, calls, reps=max(reps, -(-20 // k)))
    del copies, calls
    torch.cuda.empty_cache()
    return ms


# ------------------------------------------------------------- K1 cases

def stencil_offsets(grid, kind: str) -> list[int]:
    """DIA offsets of a hex8 operator on an (nz, ny, nx) node grid with 3
    dofs per node: the stiffness couples the 27 neighbour nodes, every dof
    pair (99 offsets); a nested-grid transfer stencil couples the 27 (or,
    for a slab refined in x and y only, the 9 in-plane) neighbours, same
    dof only."""
    nz, ny, nx = grid
    P = 3 * ny * nx
    if kind == "stiffness":
        offs = {dz * P + dy * 3 * nx + e
                for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                for e in range(-5, 6)}
    else:
        dzs = (0,) if kind == "slab_transfer" else (-1, 0, 1)
        offs = {3 * (dz * ny * nx + dy * nx + dx)
                for dz in dzs for dy in (-1, 0, 1) for dx in (-1, 0, 1)}
    return sorted(offs)


def padded_rows(grid) -> int:
    """n_rows of a level whose largest body has this node grid: the port's
    padding rule (solvers/mg.py::build_hierarchy rounds up to 128 rows)."""
    nz, ny, nx = grid
    return -(-3 * nz * ny * nx // 128) * 128


G2, G4 = (13, 13, 13), (49, 49, 49)   # core-body node grids, glob_leve 2, 4
N2, N4 = padded_rows(G2), padded_rows(G4)   # 6656, 353024

# (label, dtype, classes C, grid (nz, ny, nx), kind, bodies B, n_rows, tail,
# class layout: "uniform" draws kz uniformly over the C classes, "half"
# gives class 0 half of the planes and draws the rest uniformly).  The
# glob_leve=2 class counts are those of the real operators (72 for A, 14
# for P, 19 for Pt, 2 for the slabs' stencils); the glob_leve=4 layouts are
# synthetic (the real ones need the 44-minute host build).
K1_CASES = [
    ("A_top core f64", "float64", 72, G2, "stiffness", 24, N2, True,
     "uniform"),
    ("A finest core f32", "float32", 72, G2, "stiffness", 24, N2, True,
     "uniform"),
    ("P core level 2", "float32", 14, G2, "transfer", 24, N2, False,
     "uniform"),
    ("Pt core level 2", "float32", 19, G2, "transfer", 24, N2, False,
     "uniform"),
    ("P core level 1", "float32", 14, (7, 7, 7), "transfer", 24, 1152, False,
     "uniform"),
    ("Pt core level 1", "float32", 19, (7, 7, 7), "transfer", 24, 1152,
     False, "uniform"),
    ("P/Pt slab level 2", "float32", 2, (2, 25, 25), "slab_transfer", 6,
     N2, False, "uniform"),
    ("P/Pt slab level 1", "float32", 2, (2, 13, 13), "slab_transfer", 6,
     1152, False, "uniform"),
    ("zero tail, A_top shape", "float64", 72, G2, "stiffness", 24, N2, False,
     "uniform"),
    ("identity tail, transfer shape", "float32", 14, G2, "transfer", 24, N2,
     True, "uniform"),
    ("A_top core f64, glob_leve=4", "float64", 72, G4, "stiffness", 24, N4,
     True, "uniform"),
    ("A finest core f32, glob_leve=4", "float32", 72, G4, "stiffness", 24,
     N4, True, "uniform"),
    ("Pt core finest f32, glob_leve=4", "float32", 19, G4, "transfer", 24,
     N4, False, "uniform"),
    ("A finest f32, half the planes in one class, glob_leve=4", "float32",
     72, G4, "stiffness", 24, N4, True, "half"),
]


def make_plane_dia(torch, seed, dtype, C, grid, kind, B, n, tail,
                   layout="uniform"):
    """A PlaneDia with random values on the card, and an x for it, made
    from ``seed`` on the card (the glob_leve=4 tables hold 51M values)."""
    from ddpca_admm_tpu_torch.sparse.dia import PlaneDia

    nz, ny, nx = grid
    P = 3 * ny * nx
    offs = stencil_offsets(grid, kind)
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    vals = torch.randn((C, len(offs), P), generator=gen, device=dev,
                       dtype=dt)
    kz = torch.randint(0, C, (B, nz), generator=gen, device=dev)
    if layout == "half":
        half = torch.randperm(B * nz, generator=gen, device=dev)
        kz.view(-1)[half[: B * nz // 2]] = 0
    x = torch.randn((B, n), generator=gen, device=dev, dtype=dt)
    pd = PlaneDia(vals, kz.to(torch.int32), tuple(offs), n, P,
                  tail_identity=tail)
    return pd, x


def csr_of(torch, pd):
    """The block-diagonal (B*n, B*n) CSR matrix of a PlaneDia, built on the
    card with int32 indices and no COO coalesce (the yardstick for
    torch.sparse.mm), or None when its nonzeros pass int32."""
    C, D, P = pd.vals.shape
    B, nz = pd.kz.shape
    n, na = pd.n_rows, nz * P
    dev = pd.vals.device
    i = torch.arange(na, device=dev)
    off = torch.tensor(pd.offsets, device=dev)
    j = i[:, None] + off[None, :]                        # (na, D), sorted
    ok = (j >= 0) & (j < na)
    per_row = ok.sum(1)
    tail = n - na if pd.tail_identity else 0
    nnz_b = int(per_row.sum()) + tail
    if B * nnz_b >= 2 ** 31:
        return None
    counts = torch.cat([per_row, torch.ones(tail, dtype=per_row.dtype,
                                            device=dev),
                        torch.zeros(n - na - tail, dtype=per_row.dtype,
                                    device=dev)])
    crow = torch.zeros(B * n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(counts.repeat(B), 0)
    vals = torch.empty(B * nnz_b, dtype=pd.dtype, device=dev)
    cols = torch.empty(B * nnz_b, dtype=torch.int32, device=dev)
    j_ok = j[ok]
    for b in range(B):
        slab = pd.vals.index_select(0, pd.kz[b].long())   # (nz, D, P)
        v = slab.permute(0, 2, 1).reshape(na, D)[ok]
        s0 = b * nnz_b
        s1 = s0 + nnz_b - tail
        vals[s0:s1] = v
        cols[s0:s1] = (j_ok + b * n).to(torch.int32)
        if tail:
            vals[s1:s0 + nnz_b] = 1
            cols[s1:s0 + nnz_b] = torch.arange(
                b * n + na, (b + 1) * n, device=dev, dtype=torch.int32)
        del slab, v
    return torch.sparse_csr_tensor(crow.to(torch.int32), cols, vals,
                                   (B * n, B * n), check_invariants=False)


def k1_bound(pd, x):
    """Least time of one SpMV on the card: each input read once and the
    output written once over the memory rate, against 2 flops per stored
    (class-expanded) value over the dtype's peak."""
    C, D, P = pd.vals.shape
    B, nz = pd.kz.shape
    item = pd.vals.element_size()
    plan = pd.plan_pairs.numel() + pd.plan_items.numel() \
        + pd.plan_groups.numel()
    nbytes = pd.vals.numel() * item + plan * 4 + 2 * x.numel() * item
    ops = 2.0 * D * B * nz * P
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[str(pd.dtype).replace("torch.", "")]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def run_k1_case(torch, K, pd, x, label):
    y = K.plane_dia_mv(pd, x)
    y_plain = K.plane_dia_mv_plain(pd, x)
    torch.cuda.synchronize()
    scale = float(y_plain.abs().max())
    err = float((y - y_plain).abs().max())
    rel = 1e-12 if pd.dtype == torch.float64 else 1e-5
    check(bool(torch.isfinite(y).all()), f"K1 {label}: non-finite output")
    check(err <= rel * scale,
          f"K1 {label}: max|y - y_plain| = {err} > {rel} * {scale}")
    return err, scale, rel


def time_k1(torch, K, pd, x, label) -> dict:
    """K1 against its plain version, then its warm and cold times beside
    its bound (the share of the bound is taken from the cold time)."""
    err, scale, rel = run_k1_case(torch, K, pd, x, label)
    ms_warm = warm_ms(torch, lambda: K.plane_dia_mv(pd, x))
    ms_cold = cold_ms(torch, K.plane_dia_mv, pd, x)
    bound_ms, bound_by, nbytes, ops = k1_bound(pd, x)
    return dict(dtype=str(pd.dtype).replace("torch.", ""),
                vals=list(pd.vals.shape), kz=list(pd.kz.shape),
                n_rows=pd.n_rows, tail_identity=pd.tail_identity,
                work_items=pd.plan_items.shape[0],
                offset_groups=pd.plan_groups.shape[0], max_abs_err=err,
                max_abs_y=scale, tol_rel=rel, ms=ms_warm, ms_warm=ms_warm,
                ms_cold=ms_cold, bound_ms=bound_ms, bound_by=bound_by,
                bound_share_cold=bound_ms / ms_cold, bytes=nbytes, flops=ops)


def library_case(torch, K, pd, x, label, scale, rel):
    """torch.sparse.mm on the CSR of the same matrix, checked and timed
    warm as K1 is; None where the CSR cannot be built (int32 nonzeros)."""
    A = csr_of(torch, pd)
    if A is None:
        return None, "CSR nonzeros pass int32"
    xcol = x.reshape(-1, 1)
    y_lib = torch.sparse.mm(A, xcol).reshape(x.shape)
    lib_err = float((y_lib - K.plane_dia_mv_plain(pd, x)).abs().max())
    check(lib_err <= rel * scale,
          f"K1 {label}: torch.sparse.mm disagrees ({lib_err})")
    del y_lib
    ms = warm_ms(torch, lambda: torch.sparse.mm(A, xcol))
    del A
    torch.cuda.empty_cache()
    return ms, None


def phase_kernels(torch, args):
    from ddpca_admm_tpu_torch.sparse import plane_dia_kernel as K

    rows = []
    for i, (label, dtype, C, grid, kind, B, n, tail, layout) in \
            enumerate(K1_CASES):
        pd, x = make_plane_dia(torch, args.seed + i, dtype, C, grid, kind, B,
                               n, tail, layout)
        row = dict(case=label, layout=layout, **time_k1(torch, K, pd, x,
                                                        label))
        big = row["bytes"] > BIG_TABLE_BYTES
        row["plain_ms"] = warm_ms(torch, lambda: K.plane_dia_mv_plain(pd, x),
                                  inner=4 if big else 20,
                                  reps=2 if big else 5)
        torch.cuda.empty_cache()
        row["library_ms"], why = library_case(
            torch, K, pd, x, label, row["max_abs_y"], row["tol_rel"])
        if why:
            row["library_not_measured"] = why
        rows.append(row)
        del pd, x
        torch.cuda.empty_cache()
    emit("kernels", cases=rows)
    return rows


# ------------------------------------------------------------ BLOCK runs

def force_plane_dia():
    """The PlaneDia path on tiny fixtures, as tests/test_dia.py forces it:
    no Block-ELL budget and no plain-Dia demotion."""
    import ddpca_admm_tpu_torch.solvers.mg as mgmod
    import ddpca_admm_tpu_torch.sparse.bell as bell

    saved = (bell.BELL_MAX_BYTES, mgmod.DIA_LATENCY_BYTES)
    bell.BELL_MAX_BYTES = 0
    mgmod.DIA_LATENCY_BYTES = 0
    return saved


def restore_formats(saved):
    import ddpca_admm_tpu_torch.solvers.mg as mgmod
    import ddpca_admm_tpu_torch.sparse.bell as bell

    bell.BELL_MAX_BYTES, mgmod.DIA_LATENCY_BYTES = saved


def phase_small(torch, np):
    from ddpca_admm_tpu_torch.admm.loop import contact_analysis
    from ddpca_admm_tpu_torch.admm.problem import build_problem
    from ddpca_admm_tpu_torch.models.block import BlockConfig, build_block_model
    from ddpca_admm_tpu_torch.sparse import plane_dia_kernel as K

    saved = force_plane_dia()
    cfg = BlockConfig(divi=(2, 2, 2), glob_leve=1, doma_numb=(1, 1, 1))
    model = build_block_model(cfg)
    dole = [0] * len(model.systems)
    out = {}
    for dev in ("cpu", "cuda"):
        prob, meta = build_problem(model.systems, model.regions, dole=dole,
                                   device=dev)
        ops = prob.mg.A_top.ops
        check(any(type(op).__name__ == "PlaneDia" for op in ops),
              "small BLOCK: the PlaneDia path was not taken")
        K.LAUNCHES = 0
        st = contact_analysis(prob, tuple(meta.group_modes), max_iter=1500,
                              device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (st, K.LAUNCHES)
    restore_formats(saved)
    (s_cpu, _), (s_gpu, launches) = out["cpu"], out["cuda"]
    u_cpu, u_gpu = s_cpu.u.numpy(), s_gpu.u.cpu().numpy()
    scale = float(np.abs(u_cpu).max())
    err = float(np.abs(u_gpu - u_cpu).max())
    check(s_cpu.converged and s_gpu.converged, "small BLOCK: no convergence")
    check(s_cpu.it == s_gpu.it,
          f"small BLOCK: it {s_gpu.it} on the card, {s_cpu.it} on the CPU")
    check(err <= 1e-6 * scale, f"small BLOCK: max|du| = {err} > 1e-6*{scale}")
    check(launches > 0, "small BLOCK: K1 was not launched")
    emit("small", it_cpu=s_cpu.it, it_cuda=s_gpu.it,
         inner_iters_cpu=s_cpu.inner_iters, inner_iters_cuda=s_gpu.inner_iters,
         max_abs_du=err, max_abs_u=scale, k1_launches=launches)


def plane_dias(prob):
    """Every PlaneDia operator of a problem's body hierarchy, labelled."""
    found = []

    def visit(op, label):
        name = type(op).__name__
        if name == "BatchBlocks":
            for g, sub in enumerate(op.ops):
                visit(sub, f"{label}[group {g}]")
        elif name == "StructuredProl":
            visit(op.S, label)
        elif name == "StructuredRest":
            visit(op.St, label)
        elif name == "PlaneDia":
            found.append((label, op))

    mg = prob.mg
    visit(mg.A_top, "A_top")
    for lv_i, lv in enumerate(mg.levels):
        visit(lv.A, f"A level {lv_i}")
        if lv.P is not None:
            visit(lv.P, f"P level {lv_i}")
            visit(lv.Pt, f"Pt level {lv_i}")
    return found


def phase_slice(torch, np, args):
    from ddpca_admm_tpu_torch.admm.loop import contact_analysis
    from ddpca_admm_tpu_torch.admm.problem import build_problem
    from ddpca_admm_tpu_torch.models.block import BlockConfig, build_block_model
    from ddpca_admm_tpu_torch.sparse import plane_dia_kernel as K

    t = time.perf_counter()
    cfg = BlockConfig(divi=(6, 6, 6), glob_leve=GLOB_LEVE,
                      doma_numb=(2, 2, 2))
    model = build_block_model(cfg)
    prob, meta = build_problem(
        model.systems, model.regions,
        dole=[1] * len(model.systems),   # doleMcsc=1 (BLOCK.cpp:69-71)
        musc_sett=2,                     # MULTISCALE_1 (BLOCK.h:38)
        device="cuda",
    )
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    n_dof = int(sum(s.n_dof for s in meta.systems))

    # K1 against its plain version on every PlaneDia the problem holds, and
    # its warm and cold times there (the real class layouts)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + len(K1_CASES))
    ops = []
    for label, pd in plane_dias(prob):
        x = torch.randn((pd.kz.shape[0], pd.n_rows), generator=gen,
                        device="cuda", dtype=pd.dtype)
        ops.append(dict(op=label, **time_k1(torch, K, pd, x, label)))
    check(len(ops) > 0, "slice: the problem holds no PlaneDia operator")

    modes = tuple(meta.group_modes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES = 0
    t = time.perf_counter()
    st = contact_analysis(prob, modes, max_iter=60, device="cuda")
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t
    launches = K.LAUNCHES
    peak = torch.cuda.max_memory_allocated()

    u = st.u.cpu().numpy()
    check(u.shape == (len(meta.systems), meta.n_pad),
          f"slice: u has shape {u.shape}")
    check(bool(np.isfinite(u).all()), "slice: u is not finite")
    # the patch test (examples/BLOCK.cpp:43-49): u_z = p z / E everywhere
    E, p = cfg.e_mod, cfg.pressure
    scale = abs(p) * sum(cfg.leng) / E
    err = max(
        float(np.abs(
            s.full_displacement(u[b, : s.n_dof])[2::3]
            - p * body.mesh.coords[:, 2] / E
        ).max())
        for b, (body, s) in enumerate(zip(model.bodies, meta.systems))
    )
    emit("slice", setup_s=setup_s, dof=n_dof, bodies=len(meta.systems),
         n_pad=meta.n_pad, coarse_ddmg=prob.coarse[0].mg is not None,
         plane_dia_operators=ops, it=st.it, converged=st.converged,
         inner_iters=st.inner_iters, solve_s=solve_s,
         s_per_iteration=solve_s / max(st.it, 1), k1_launches=launches,
         max_memory_allocated=peak, patch_err_rel=err / scale)
    check(st.converged, f"slice: no convergence in {st.it} iterations")
    check(19 <= st.it <= 21, f"slice: it = {st.it}, not in 19-21")
    check(launches > 0, "slice: K1 was not launched on the main path")
    check(err <= 1e-4 * scale, f"slice: patch test error {err / scale}")
    return launches


# ------------------------------------------------------------- examples

# The examples' CPU solves run in worker processes beside the card phases
# (the longest, DEHW, takes minutes on the CPU); each worker runs this many
# torch threads.
EXAMPLE_WORKERS = 3
WORKER_THREADS = 2
# the card against the CPU: the same iteration count and u, z, lambda,
# gamma within this fraction of their largest entries
EXAMPLE_TOL = 1e-8
# DEHW does not converge in 3000 iterations (nor does the JAX package, nor
# the C++ reference): its card and CPU solves are compared after
# DEHW_CHECK_ITERS iterations (one costs ~45 s on the CPU), and its larger
# run on the card stops at DEHW_ITERS
DEHW_CHECK_ITERS = 2
DEHW_ITERS = 20
# the examples in the order the card runs them; the pool computes their
# CPU references in the same order, so each is ready when the card needs it
EXAMPLES = ("torsion", "beam", "cylinder_stack4", "cylinder_cross_corner",
            "dehw")


def example_model(name: str, scale: str):
    """An example built on the CPU by the port's host code at ``scale``
    "small" (the JAX CLI's small configuration) or "larger" (one level of
    refinement above it).  Returns (prob, meta, bodies, cfg, cuts): the
    cuts list each setting that differs from the reference's."""
    from ddpca_admm_tpu_torch import cli

    if name == "torsion":
        from ddpca_admm_tpu_torch.models.torsion import (
            TorsionConfig,
            build_torsion_model,
        )

        homo = 1 if scale == "small" else 2
        cfg = TorsionConfig(**dict(cli.SMALL_TORSION, glob_homo=homo))
        prob, meta, bodies, cfg = build_torsion_model(cfg, device="cpu")
        cuts = ["divi (1,8,2) of (1,32,8)", "doma (1,4,2) of (1,32,8)",
                f"glob_homo {homo} of 4"]
    elif name == "beam":
        from ddpca_admm_tpu_torch.models.beam import (
            BeamConfig,
            build_beam_model,
        )

        leve = 1 if scale == "small" else 2
        cfg = BeamConfig(**dict(cli.SMALL_BEAM, glob_leve=leve))
        prob, meta, bodies, cfg = build_beam_model(cfg, device="cpu")
        cuts = ["divi (8,4,2) of (64,4,2)", "doma (4,2,1) of (32,4,2)",
                f"glob_leve {leve} of 4"]
    elif name.startswith("cylinder"):
        from ddpca_admm_tpu_torch.models.cylinder import build_cylinder_model

        stack4 = name == "cylinder_stack4"
        cfg = cli.cylinder_config("small", stack4=stack4,
                                  cross_corner=not stack4)
        if scale != "small":
            cfg.loca_leve += 1
        prob, meta, bodies, cfg = build_cylinder_model(cfg, device="cpu")
        cuts = ["glob_inho 2 of 3", f"loca_leve {cfg.loca_leve} of 7",
                "band_widt 8e-4 of 1e-4", "copy_numb 1 of 16"]
    elif name == "dehw":
        from ddpca_admm_tpu_torch.models.dehw_assembly import (
            DehwDDConfig,
            build_dehw_assembly,
            finalize_dehw_problem,
        )

        grid = cli.dehw_grid()
        if scale != "small":
            grid.glob_homo += 1
        cfg = DehwDDConfig(grid=grid)
        bodies, regions, _ = build_dehw_assembly(cfg)
        prob, meta = finalize_dehw_problem(bodies, regions, cfg,
                                           device="cpu")
        cuts = ["worm_numb (2,1,1,2,2) of (4,2,2,4,4)",
                "whee_numb (2,2,1,2,2) of (4,4,2,4,8)", "glob_inho 0 of 1",
                f"glob_homo {grid.glob_homo} of 2", "loca_leve 1 of 3"]
    else:
        raise ValueError(name)
    return prob, meta, bodies, cfg, cuts


def state_arrays(st) -> dict:
    out = {"u": st.u.cpu().numpy()}
    for g, gs in enumerate(st.groups):
        out[f"z[{g}]"] = gs.z.cpu().numpy()
        out[f"lam[{g}]"] = gs.lam.cpu().numpy()
        out[f"gamma[{g}]"] = gs.gamma.cpu().numpy()
    return out


def cpu_reference(name: str) -> dict:
    """Worker process: the small example solved on the CPU through the
    CLI's solve (the plain versions of every kernel)."""
    import torch

    from ddpca_admm_tpu_torch import cli

    torch.set_num_threads(WORKER_THREADS)
    t = time.perf_counter()
    prob, meta, _, _, _ = example_model(name, "small")
    setup_s = time.perf_counter() - t
    max_iter = DEHW_CHECK_ITERS if name == "dehw" else 3000
    st, solve_s = cli.solve(prob, meta, max_iter=max_iter, device="cpu")
    return dict(arrays=state_arrays(st), it=st.it, converged=st.converged,
                inner_iters=st.inner_iters, setup_s=setup_s,
                solve_s=solve_s)


def card_solve(torch, prob, meta, max_iter, moni=False):
    """The CLI's solve on the card with K1's launches counted and the peak
    device memory read: (state, solve_s, launches, peak bytes)."""
    import gc

    from ddpca_admm_tpu_torch import cli
    from ddpca_admm_tpu_torch.sparse import plane_dia_kernel as K

    # the peak counts this solve alone: collect what an earlier solve left
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES = 0
    st, solve_s = cli.solve(prob, meta, max_iter=max_iter, moni=moni,
                            device="cuda")
    launches = K.LAUNCHES
    # K1 serves PlaneDia operators only: where the example builds none (all
    # its levels are ELL, as the JAX package's are), it has no launch
    if plane_dias(prob):
        check(launches > 0, "examples: PlaneDia operators but no K1 launch")
    else:
        check(launches == 0, f"examples: {launches} K1 launches on a "
                             "problem without PlaneDia operators")
    return st, solve_s, launches, torch.cuda.max_memory_allocated()


def full_displacements(meta, bodies, u):
    """Per body, the nodal displacements (N, 3) in global axes."""
    out = []
    for b, (body, s) in enumerate(zip(bodies, meta.systems)):
        d = s.full_displacement(u[b][: s.n_dof]).reshape(-1, 3).copy()
        for i, R in body.node_rota.items():
            d[i] = R @ d[i]
        out.append(d)
    return out


def torsion_oracle(np, meta, bodies, cfg, u) -> dict:
    """Tangential displacement at the outer radius of the loaded end face
    against T l R / (G I_p)."""
    ut = []
    for body, d in zip(bodies, full_displacements(meta, bodies, u)):
        X = body.mesh.coords
        r = np.hypot(X[:, 0], X[:, 1])
        sel = (np.abs(r - cfg.oute_radi) < 1e-9) \
            & (np.abs(X[:, 2] - cfg.axia_leng) < 1e-9)
        ut.append((-X[sel, 1] * d[sel, 0] + X[sel, 0] * d[sel, 1]) / r[sel])
    ut = np.concatenate(ut)
    check(ut.size > 0, "torsion: no node on the loaded outer edge")
    return dict(twist=float(ut.mean()), analytic_twist=cfg.analytic_twist,
                twist_ratio=float(ut.mean()) / cfg.analytic_twist)


def beam_oracle(np, meta, bodies, cfg, u) -> dict:
    """The DD solution against the unsplit single-body spsolve (the
    reference's SOLVE_NODD oracle, examples/BEAM.h:55-57,403-416)."""
    import scipy.sparse.linalg as spla

    from ddpca_admm_tpu_torch.fem.assembly import assemble_stiffness
    from ddpca_admm_tpu_torch.fem.constraints import constrain
    from ddpca_admm_tpu_torch.mesh.hexmesh import HexMesh
    from ddpca_admm_tpu_torch.models.beam import (
        _beam_load,
        straight_grid,
        twist_map,
    )
    from ddpca_admm_tpu_torch.models.simple import Body

    m = HexMesh()
    m.add_box_grid(np.zeros(3), np.ones(3), cfg.divi,
                   coords_fn=straight_grid(cfg, np.zeros(3), cfg.divi,
                                           cfg.divi, (0, 0, 0)))
    m.refine_uniform(cfg.glob_leve, pattern=0)
    m.transform(twist_map(cfg, 1))
    m.transfer()
    mb = Body(mesh=m, e_mod=cfg.e_mod, nu=cfg.nu)
    for i, c in enumerate(m.coords):
        if c[0] <= 1e-10:
            for k in range(3):
                mb.cons_dofv[3 * i + k] = 0.0
    _beam_load(cfg, mb, 0)
    A = assemble_stiffness(m, mb.e_mod, mb.nu)
    sysm = constrain(m, A, mb.cons_dofv, mb.exte_forc)
    u_mono = sysm.full_displacement(
        spla.spsolve(sysm.cons_stif[-1].tocsc(), sysm.cons_forc)
    ).reshape(-1, 3)
    scale = float(np.abs(u_mono).max())
    worst = 0.0
    for body, d in zip(bodies, full_displacements(meta, bodies, u)):
        ids = m.add_nodes(body.mesh.coords)
        worst = max(worst, float(np.linalg.norm(d - u_mono[ids],
                                                axis=1).max()))
    return dict(unsplit_dof=int(sysm.cons_forc.size), max_abs_u=scale,
                dd_vs_unsplit_rel=worst / scale)


def region_pressures(np, meta, st) -> dict:
    """Per region: (peak normal traction, integrated normal force, active
    integral points), from the solved gamma."""
    out = {}
    for g_i, mode in enumerate(meta.group_modes):
        gamma = st.groups[g_i].gamma.cpu().numpy()
        for slot, ri in enumerate(meta.group_region_idx[g_i]):
            reg = meta.regions[ri].region
            ip = reg.ip
            gn = gamma[slot][: ip.n] if mode == "scalar" \
                else gamma[slot][: 3 * ip.n: 3]
            out[ri] = dict(fric=float(reg.fric), points=int(ip.n),
                           active=int((gn > 0).sum()),
                           p_max=float(gn.max(initial=0.0)),
                           force=float(gn @ ip.weight))
    return out


def cylinder_oracle(np, meta, cfg, st, cross_corner) -> dict:
    """Each cylinder contact transmits the line load (mirror halves half
    each) within 5%, and its peak pressure lies within 0.6-1.3 of Hertz's
    p_max (the JAX package's tests/test_cylinder_stack.py)."""
    a, p_max = cfg.hertz
    pres = region_pressures(np, meta, st)
    n_cont = 2 if cross_corner else 4
    f_expect = abs(cfg.load_inte) * cfg.leng / (1 if cross_corner else 2)
    force_rel = [pres[ri]["force"] / f_expect for ri in range(n_cont)]
    p_rel = [pres[ri]["p_max"] / p_max for ri in range(n_cont)]
    check(all(abs(f - 1.0) <= 0.05 for f in force_rel),
          f"cylinder: contact forces / line load {force_rel}")
    check(all(0.6 < p < 1.3 for p in p_rel),
          f"cylinder: contact p_max / Hertz {p_rel}")
    return dict(hertz_half_width=a, hertz_p_max=p_max,
                contact_force_over_load=force_rel,
                contact_p_max_over_hertz=p_rel)


def dehw_oracle(np, meta, st) -> dict:
    """The last monitor row's median and, per contact region, its active
    integral points and peak pressure."""
    hist = st.moni_hist.cpu().numpy()[: st.it]
    check(bool(np.isfinite(hist[-1]).all()), "dehw: non-finite monitors")
    pres = region_pressures(np, meta, st)
    contact = {f"region_{ri}": dict(points=v["points"], active=v["active"],
                                    p_max_Pa=v["p_max"])
               for ri, v in pres.items() if v["fric"] > 0.0}
    check(sum(v["active"] for v in contact.values()) > 0,
          "dehw: no active contact point")
    return dict(monitor_last_median=float(np.median(hist[-1])),
                contact_regions=contact)


def compare_states(np, name, card, cpu) -> dict:
    """The card's state against the CPU's: each quantity's largest error
    over its largest entry (for DEHW, the largest entry over all region
    groups: a group of open contacts holds only rounding noise)."""
    scales = {}
    for k, b in cpu["arrays"].items():
        key = k.split("[")[0] if name == "dehw" else k
        scales[key] = max(scales.get(key, 0.0), float(np.abs(b).max()))
    rel = {}
    for k, b in cpu["arrays"].items():
        a = card[k]
        check(a.shape == b.shape, f"{name}: {k} shapes {a.shape} {b.shape}")
        check(bool(np.isfinite(a).all()), f"{name}: {k} is not finite")
        scale = scales[k.split("[")[0] if name == "dehw" else k]
        rel[k] = float(np.abs(a - b).max()) / scale if scale else 0.0
        check(rel[k] <= EXAMPLE_TOL,
              f"{name}: card against CPU, {k} off by {rel[k]} of its "
              f"largest entry")
    return rel


def phase_examples(torch, np, refs):
    """Each example at the JAX CLI's small configuration on the card,
    against its CPU solve from the worker pool; then one larger solve on
    the card alone, held to the example's oracle."""
    import tempfile

    from ddpca_admm_tpu_torch import cli

    launches_by_path = {}
    for name in EXAMPLES:
        for scale in ("small", "larger"):
            t = time.perf_counter()
            prob, meta, bodies, cfg, cuts = example_model(name, scale)
            setup_s = time.perf_counter() - t
            row = dict(example=name, scale=scale, cuts=cuts,
                       bodies=len(meta.systems),
                       dof=int(sum(s.n_dof for s in meta.systems)),
                       n_pad=meta.n_pad, group_modes=meta.group_modes,
                       coarse=[("ddmg" if co.mg is not None else "dense")
                               for co in (prob.coarse or ())],
                       setup_s=setup_s)
            if name == "dehw":
                max_iter = DEHW_CHECK_ITERS if scale == "small" \
                    else DEHW_ITERS
            else:
                max_iter = 3000
            st, solve_s, launches, peak = card_solve(
                torch, prob, meta, max_iter, moni=(name == "dehw"))
            launches_by_path[f"{name} {scale}"] = launches
            row.update(solve_s=solve_s, it=st.it, converged=st.converged,
                       inner_iters=st.inner_iters, k1_launches=launches,
                       max_memory_allocated=peak)
            converges = name != "dehw"
            if converges:
                check(st.converged, f"{name} {scale}: no convergence in "
                                    f"{st.it} iterations")
            else:
                check(st.it == max_iter, f"dehw {scale}: it = {st.it}")
            u = st.u.cpu().numpy()
            check(u.shape == (len(meta.systems), meta.n_pad)
                  and bool(np.isfinite(u).all()),
                  f"{name} {scale}: u is not finite or of shape {u.shape}")
            if scale == "small":
                cpu = refs[name].get(timeout=900)
                row.update(it_cpu=cpu["it"], inner_iters_cpu=cpu["inner_iters"],
                           cpu_setup_s=cpu["setup_s"],
                           cpu_solve_s=cpu["solve_s"])
                check(st.it == cpu["it"] and st.converged == cpu["converged"],
                      f"{name}: it {st.it} on the card, {cpu['it']} on the "
                      "CPU")
                row["card_vs_cpu_rel"] = compare_states(
                    np, name, state_arrays(st), cpu)
                # the CLI's result writers, on the card's state
                with tempfile.TemporaryDirectory() as d:
                    cli.write_results(st, meta, bodies, d,
                                      moni=(name == "dehw"))
                    row["result_files"] = len(os.listdir(d))
            elif name == "torsion":
                row["oracle"] = torsion_oracle(np, meta, bodies, cfg, u)
                check(abs(row["oracle"]["twist_ratio"] - 1.0) <= 1e-3,
                      f"torsion: twist ratio {row['oracle']['twist_ratio']}")
            elif name == "beam":
                row["oracle"] = beam_oracle(np, meta, bodies, cfg, u)
                check(row["oracle"]["dd_vs_unsplit_rel"] < 2e-3,
                      f"beam: DD against unsplit {row['oracle']}")
            elif name.startswith("cylinder"):
                row["oracle"] = cylinder_oracle(
                    np, meta, cfg, st, cross_corner=cfg.cross_corner)
            else:
                row["oracle"] = dehw_oracle(np, meta, st)
            emit("examples", **row)
            del prob, st
            torch.cuda.empty_cache()
    return launches_by_path


# ------------------------------------------------------------- LAGRANGE

# the card against the CPU: u and lambda within this fraction of their
# largest entries, BiCGSTAB iterations of each Newton pass within this many
LAGRANGE_TOL = 1e-8
LAGRANGE_KRYLOV_SLACK = 2
# (label, solve_lagrange's prec_type, stacked_boxes_problem's fixture): the
# boxes at one refinement level, where Khat passes 500 rows and BiCGSTAB
# runs on the device, frictionless (the patch test) and with the friction
# fixture of the JAX package's tests/test_lagrange.py
LAGRANGE_CASES = [
    ("boxes levels=1", 1, {}),
    ("boxes levels=1", 2, {}),
    ("boxes levels=1, friction mu 0.15 shear 1.2e6", 1,
     dict(pressure=-1.0e7, fric=0.15, shear=1.2e6)),
]


def lagrange_solve(torch, systems, regions, meshes, prec_type, dev):
    """solve_lagrange on ``dev`` with K1's launches counted and the peak
    device memory read: (result, seconds, launches, peak bytes or None)."""
    import gc

    from ddpca_admm_tpu_torch.admm.lagrange import solve_lagrange
    from ddpca_admm_tpu_torch.sparse import plane_dia_kernel as K

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES = 0
    t = time.perf_counter()
    res = solve_lagrange(systems, regions, meshes, prec_type=prec_type,
                         device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = K.LAUNCHES
    # Khat is ELL and its restricted-GMG hierarchy has no grids (every
    # level ELL): the LAGRANGE path launches no K1
    check(launches == 0, f"lagrange: {launches} K1 launches")
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None
    return res, seconds, launches, peak


def pass_rows(res) -> list:
    return [dict(khat_rows=p["khat_rows"], bicgstab_iters=p["krylov_iters"],
                 host_s=p["host_s"], prec_s=p["prec_s"],
                 bicgstab_s=p["solve_s"])
            for p in res.passes]


def phase_lagrange(torch, np):
    """The dual-mortar LAGRANGE solver: the boxes on the card against the
    CPU, then BLOCK at glob_leve=2 without domain decomposition (the
    monolithic form the reference's LAGRANGE case solves) on the card at
    both preconditioners, held to the patch test."""
    from ddpca_admm_tpu_torch.models import simple as S
    from ddpca_admm_tpu_torch.models.block import BlockConfig, build_block_model

    launches_by_path = {}
    for label, prec_type, fixture in LAGRANGE_CASES:
        _, meta, bodies = S.stacked_boxes_problem(
            div_bot=3, div_top=2, levels=1, device="cpu", **fixture)
        systems = S.assemble_bodies(bodies, meta.regions,
                                    include_penalty=False)
        meshes = [b.mesh for b in bodies]
        cpu, cpu_s, _, _ = lagrange_solve(torch, systems, meta.regions,
                                          meshes, prec_type, "cpu")
        card, card_s, launches, peak = lagrange_solve(
            torch, systems, meta.regions, meshes, prec_type, "cuda")
        name = f"lagrange {label} prec_type {prec_type}"
        launches_by_path[name] = launches
        check(card.iters == cpu.iters,
              f"{name}: Newton iters {card.iters} on the card, {cpu.iters} "
              "on the CPU")
        check(all(p["krylov_iters"] is not None for p in card.passes),
              f"{name}: a Newton pass did not run BiCGSTAB")
        check(all(abs(a["krylov_iters"] - b["krylov_iters"])
                  <= LAGRANGE_KRYLOV_SLACK
                  for a, b in zip(card.passes, cpu.passes)),
              f"{name}: BiCGSTAB iterations {pass_rows(card)} against "
              f"{pass_rows(cpu)}")
        check(all(np.array_equal(a, b)
                  for a, b in zip(card.status, cpu.status)),
              f"{name}: the states differ")
        rel = {}
        for key, a, b in (("u", card.u, cpu.u), ("lagr", card.lagr, cpu.lagr)):
            a, b = np.concatenate(a), np.concatenate(b)
            check(bool(np.isfinite(a).all()), f"{name}: {key} not finite")
            rel[key] = float(np.abs(a - b).max() / np.abs(b).max())
            check(rel[key] <= LAGRANGE_TOL,
                  f"{name}: card against CPU, {key} off by {rel[key]}")
        emit("lagrange", case=label, prec_type=prec_type,
             dof=int(sum(s.n_dof for s in systems)),
             newton_iters=card.iters, passes=pass_rows(card),
             passes_cpu=pass_rows(cpu), solve_s=card_s, cpu_solve_s=cpu_s,
             card_vs_cpu_rel=rel, k1_launches=launches,
             max_memory_allocated=peak)

    # BLOCK glob_leve=2, no DD: one host build for both preconditioners
    t = time.perf_counter()
    cfg = BlockConfig(divi=(6, 6, 6), glob_leve=GLOB_LEVE,
                      doma_numb=(1, 1, 1))
    model = build_block_model(cfg)
    # LAGRANGE takes the penalty-free stiffness (MCONTACT.h:2850-2860)
    systems = S.assemble_bodies(model.bodies, model.regions,
                                include_penalty=False)
    setup_s = time.perf_counter() - t
    meshes = [b.mesh for b in model.bodies]
    E, p = cfg.e_mod, cfg.pressure
    scale = abs(p) * sum(cfg.leng) / E
    for prec_type in (1, 2):
        res, solve_s, launches, peak = lagrange_solve(
            torch, systems, model.regions, meshes, prec_type, "cuda")
        name = f"lagrange block glob_leve={GLOB_LEVE} prec_type {prec_type}"
        launches_by_path[name] = launches
        check(all(pr["krylov_iters"] is not None for pr in res.passes),
              f"{name}: a Newton pass did not run BiCGSTAB")
        err = max(
            float(np.abs(s.full_displacement(res.u[b])[2::3]
                         - p * body.mesh.coords[:, 2] / E).max())
            for b, (body, s) in enumerate(zip(model.bodies, systems))
        )
        regions = []
        for ri, r in enumerate(model.regions):
            fric = float(r.region.fric)
            want = 1 if fric == 0.0 else 2
            st = res.status[ri]
            regions.append(dict(region=ri, fric=fric, nodes=int(st.size),
                                at_status=int((st == want).sum()),
                                status=want))
        emit("lagrange", case=f"block divi 6 glob_leve={GLOB_LEVE} doma 1",
             prec_type=prec_type, bodies=len(systems),
             dof=int(sum(s.n_dof for s in systems)),
             khat_rows=res.passes[-1]["khat_rows"], setup_s=setup_s,
             newton_iters=res.iters, passes=pass_rows(res),
             host_s=sum(pr["host_s"] for pr in res.passes),
             prec_s=sum(pr["prec_s"] for pr in res.passes),
             bicgstab_s=sum(pr["solve_s"] for pr in res.passes),
             bicgstab_iters=sum(pr["krylov_iters"] for pr in res.passes),
             solve_s=solve_s, regions=regions, patch_err_rel=err / scale,
             k1_launches=launches, max_memory_allocated=peak)
        check(bool(all(np.isfinite(u).all() for u in res.u)),
              f"{name}: u is not finite")
        check(err <= 5e-4 * scale, f"{name}: patch test error {err / scale}")
        check(all(rg["at_status"] == rg["nodes"] for rg in regions),
              f"{name}: contact nodes not all active (1) or interface "
              f"nodes not all sticking (2): {regions}")
        check(sum(rg["fric"] == 0.0 for rg in regions) == 2,
              f"{name}: not two contact regions")
    return launches_by_path


def phase_apps(np):
    """DEHW's APPS eigen-analysis through the port's command line, in
    process, at the small grid (host code: the check is that it runs on
    this machine's scipy without JAX)."""
    import contextlib
    import io
    import tempfile

    from ddpca_admm_tpu_torch import cli

    t = time.perf_counter()
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as d:
        with contextlib.redirect_stdout(buf):
            cli.main(["dehw", "--apps", "coarse", "--outdir", d])
        seconds = time.perf_counter() - t
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        freq = np.loadtxt(os.path.join(d, "resuFreq.txt"), ndmin=2)
        files = os.listdir(d)
    modes = [f for f in files if f.startswith("resuDisp_")]
    n_bodies = len({f.rsplit("-", 1)[1] for f in modes})
    emit("apps", command="dehw --apps coarse", seconds=seconds,
         frequencies=summary["frequencies"],
         correlations=summary["correlations"], mode_files=len(modes),
         bodies=n_bodies)
    check(freq.shape == (10, 2) and bool(np.isfinite(freq).all()),
          f"apps: resuFreq.txt holds {freq.shape}, or is not finite")
    check(len(summary["frequencies"]) == 10
          and bool(np.isfinite(summary["frequencies"]).all()),
          "apps: not 10 finite frequencies")
    check(n_bodies > 0 and len(modes) == 10 * n_bodies,
          f"apps: {len(modes)} mode files for {n_bodies} bodies")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "ddpca_admm_tpu_torch")):
        fail("the port's package ddpca_admm_tpu_torch/ is not beside this "
             "script")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    sys.path.insert(0, HERE)
    from ddpca_admm_tpu_torch.utils import cuda_lib

    smi = smi_line()
    t = time.perf_counter()
    lib = cuda_lib.load()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=lib.build_s,
         load_s=time.perf_counter() - t,
         ptxas=[ln for ln in lib.log.splitlines() if "Used" in ln])

    # the examples' CPU references, computed beside the card phases
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(EXAMPLE_WORKERS)
    try:
        refs = {name: pool.apply_async(cpu_reference, (name,))
                for name in EXAMPLES}
        rows = phase_kernels(torch, args)
        phase_small(torch, np)
        launches = phase_slice(torch, np, args)
        example_launches = phase_examples(torch, np, refs)
    finally:
        pool.terminate()
        pool.join()
    lagrange_launches = phase_lagrange(torch, np)
    phase_apps(np)

    main_row = rows[0]   # A_top, the largest K1 call of the main path
    kernels = [{
        "name": "plane_dia_mv",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "launches_by_path": {"block glob_leve=2": launches,
                             **example_launches, **lagrange_launches},
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "ms_cold": main_row["ms_cold"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "at": main_row["case"],
        "shapes": rows,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
