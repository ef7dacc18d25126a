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
     (u_z = p z / E).

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

    rows = phase_kernels(torch, args)
    phase_small(torch, np)
    launches = phase_slice(torch, np, args)

    main_row = rows[0]   # A_top, the largest K1 call of the main path
    kernels = [{
        "name": "plane_dia_mv",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
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
