#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ddpca_admm_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N]

Phases, one line each with its ``elapsed_s``:

  1. device  — the card's name and power limit (nvidia-smi), and the nvcc
     builds of the kernel libraries (one per ``csrc/*.cu``, started
     together) with their seconds;
  2. kernels — K1, the PlaneDia SpMV, against its plain PyTorch version at
     every shape the BLOCK glob_leve=2 solve gives it, plus a tail-identity
     and a zero-tail case, and at the glob_leve=4 (8.8M DOF) shapes of the
     finest level and A_top, on inputs made from ``--seed``; per shape the
     kernel's time warm (CUDA-graph replays, inputs warm in L2 from the
     call before) and cold (a graph that cycles through copies of the
     inputs larger than twice the L2), its bound, the plain version's time
     and, as a yardstick only, the time of ``torch.sparse.mm`` on a CSR
     tensor of the same matrix, the last two warm; and that K1's wrapper
     refuses an x in another dtype than the table's (the main path gives
     it the table's dtype only);
  3. small   — the small BLOCK (divi 2, glob_leve 1, one core per block) with
     the PlaneDia path forced, solved on the CPU (plain versions) and on the
     card (K1): the same ADMM iteration count and u within 1e-6 max|u|;
     ``small_f32``: the same in float32 (``build_problem(dtype=
     torch.float32)``, the JAX package's accelerator path), ``it`` within
     1 and u within 1e-4 max|u|; ``small_bell``: the small BLOCK
     (MULTISCALE_1 at doleMcsc=1) under ``DDPCA_SPARSE_FORMAT=bell``, the
     JAX package's accelerator format, on the CPU and on the card (K2,
     the Block-ELL SpMV): the same ``it``, u, z and lambda within 1e-8;
  4. slice   — the BLOCK menu-1 problem at glob_leve=2 (180,684 DOF, 30
     bodies, MULTISCALE_1 at doleMcsc=1) built by the port's own host code,
     K1 held against its plain version on every PlaneDia operator of the
     problem and timed there warm and cold, then solved on the card through ``contact_analysis``: it must
     converge in 19-21 ADMM iterations through K1 and pass the patch test
     (u_z = p z / E); ``slice_f32``: the same host model's problem in
     float32, built by phase on the host, uploaded and solved through K1's
     float32 entry point: every floating tensor float32 with A_top the
     finest level's operator (a composed coarse correction keeps its
     float64 A for F^T A u), convergence, u within 3e-4 max|u| of the
     float64 solve, the patch test within 3e-4, K1 launched; ``it``,
     ``inner_iters``, seconds, K1 launches, ``problem_bytes`` (floating
     and integer) and peak card memory on the line; ``slice_bell`` and
     ``slice_bell_f32``: the same host model's problem under
     ``DDPCA_SPARSE_FORMAT=bell`` in float64 and in float32 (the JAX
     package's own accelerator configuration), the tiles built on the
     card (the rest on the host by phase), each freed before the next
     phase: as many Block-ELL operators as the JAX package builds (23 and
     22), K2 held against its plain version on every one of them and
     timed (warm, cold, bound, plain version, ``torch.sparse.mm`` on the
     CSR of the same operator) on the largest and smallest stacks, the
     coarse hierarchy's operator and the shapes of ``K2_NAMED``, and its
     refusal of another dtype, then the solve through K1 and K2: in
     float64 the ELL
     slice's ``it`` and u within 1e-8 of max|u| of its solve, in float32
     convergence and u within 3e-4, the patch test, K1 and K2 launched;
  5. full    — BLOCK menu-1 at the reference's own size, glob_leve=4
     (8,809,452 DOF): the host build in the port's process pool (its
     phases, worker count and peak host memory on the line), K1 held
     against its plain version and timed on every PlaneDia of the problem
     (the coarse correction's float64 chains too), the coarse correction
     through the hierarchy (ComposedTranD / ComposedAccu), and the solve on
     the card: 24-26 ADMM iterations (the reference's 25) through K1 and
     the patch test; the problem's bytes by placement and the peak card
     memory; then ``full_f32``: the float64 problem freed (its u kept on
     the host), the same host model's problem in float32, as
     ``slice_f32``;
  6. sharding — the body axis split over ranks that share the card
     (``parallel/sharding.py``, gloo; NCCL where every rank has a card):
     ``graft_entry.dryrun_multichip`` at 2 and 4 ranks (two chain
     configurations, each against a one-card solve), then the slice's
     BLOCK problem over 2 ranks, each rank holding K1 against its plain
     version on every PlaneDia of its slice before the solve: the slice's
     ``it`` and ``inner_iters``, u within 1e-9 of max|u| of the one-card
     solve, the patch test, and K1 launched on every rank.  One line per
     run with its ranks' devices, bodies, setup and solve seconds, K1
     launches and peak memory; the BLOCK line also gives the bytes of the
     one-card problem and of each rank's by placement (``problem_bytes``)
     and each rank's bytes on the card before its solve;
  7. examples — TORSION, BEAM, CYLINDER (the 4-section stack and the
     CYLINDER_1 cross-corner variant) and DEHW built by the port's host
     code and solved through the CLI's solve: at the JAX CLI's small
     configuration on the card against the CPU (the CPU solves run in
     worker processes from the end of the full phase), and the card's
     state held to the example's oracle: TORSION's analytic twist, BEAM's
     unsplit solve, CYLINDER's line load and Hertz peak, DEHW's monitors
     and contact pressures after its fixed iteration count.  The runs one
     refinement above it are cut since the full phase came.  One line per
     solve, with its cuts from the reference's settings, K1 launches and
     peak device memory;
  8. lagrange — the dual-mortar LAGRANGE solver: the stacked boxes at one
     refinement level (BiCGSTAB on the device) on the card against the
     CPU, at both preconditioners and with Coulomb friction, then BLOCK
     at glob_leve=2 without domain decomposition (163,125 DOF) on the
     card at both preconditioners, held to the patch test and the
     expected contact states; no K1 launch (every operator is ELL);
  9. apps    — DEHW's APPS eigen-analysis (``dehw --apps coarse``) through
     the port's command line, host code, at the small grid, computed in
     the examples' CPU pool beside the card phases.

Then the ``kernels`` JSON line (K1 and K2), the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Any failed
check ends the run with a non-zero exit.  The script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
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


def cold_ms(torch, mv, pd, x, reps: int = 3, tables=None) -> float:
    """One mv(pd, x) call with its tables and x out of L2: the graph cycles
    through k copies of (tables, x) that together pass COLD_BYTES, so the
    calls since a copy's last turn have evicted it (k >= 2).  ``tables``
    names the operator's large tensors (default: a PlaneDia's ``vals``, its
    plan shared); the copies are shallow copies of the operator with those
    tensors cloned."""
    tables = tables or ("vals",)
    per = sum(getattr(pd, t).numel() * getattr(pd, t).element_size()
              for t in tables) + 2 * x.numel() * x.element_size()
    k = min(COLD_COPIES_MAX, max(2, -(-COLD_BYTES // per)))
    copies = []
    for _ in range(k):
        fresh = {t: getattr(pd, t).clone() for t in tables}
        if hasattr(pd, "_replace"):
            c = pd._replace(**fresh)
        else:
            c = copy.copy(pd)
            vars(c).update(fresh)
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


def run_case(torch, mv, plain, op, x, label):
    """A kernel's wrapper ``mv`` against its plain version on (op, x):
    finite, and within 1e-12 (float64) or 1e-5 (float32) of max|y|."""
    y = mv(op, x)
    y_plain = plain(op, x)
    torch.cuda.synchronize()
    scale = float(y_plain.abs().max())
    err = float((y - y_plain).abs().max())
    rel = 1e-12 if op.dtype == torch.float64 else 1e-5
    check(bool(torch.isfinite(y).all()), f"{label}: non-finite output")
    check(err <= rel * scale,
          f"{label}: max|y - y_plain| = {err} > {rel} * {scale}")
    return err, scale, rel


def run_k1_case(torch, K, pd, x, label):
    return run_case(torch, K.plane_dia_mv, K.plane_dia_mv_plain, pd, x,
                    f"K1 {label}")


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


def library_case(torch, A, x, y_plain, label, rel):
    """torch.sparse.mm on ``A``, the CSR of the same matrix, checked
    against the plain version's ``y_plain`` and timed warm as the kernel
    is; None where the CSR cannot be built (int32 nonzeros)."""
    if A is None:
        return None, "CSR nonzeros pass int32"
    xcol = x.reshape(-1, 1)
    y_lib = torch.sparse.mm(A, xcol).reshape(y_plain.shape)
    scale = float(y_plain.abs().max())
    lib_err = float((y_lib - y_plain).abs().max())
    check(lib_err <= rel * scale,
          f"{label}: torch.sparse.mm disagrees ({lib_err})")
    del y_lib, y_plain
    ms = warm_ms(torch, lambda: torch.sparse.mm(A, xcol))
    del A
    torch.cuda.empty_cache()
    return ms, None


def refuse_mixed_dtype(torch, K, mv, op, x, label) -> None:
    """A kernel's wrapper ``mv`` raises, launching nothing (``K.LAUNCHES``
    unchanged), on an x whose dtype is not the operator's: the kernel
    computes in the operator's dtype, so the main path can only give it
    that dtype, the one the kernel is held at here."""
    other = torch.float32 if op.dtype == torch.float64 else torch.float64
    before = K.LAUNCHES
    try:
        mv(op, x.to(other))
    except TypeError:
        check(K.LAUNCHES == before, f"{label}: launched on a mixed call")
        return
    fail(f"{label}: a {other} x through a {op.dtype} operator did not "
         "raise")


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
            torch, csr_of(torch, pd), x, K.plane_dia_mv_plain(pd, x),
            f"K1 {label}", row["tol_rel"])
        if why:
            row["library_not_measured"] = why
        rows.append(row)
        refuse_mixed_dtype(torch, K, K.plane_dia_mv, pd, x, f"K1 {label}")
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
    # float64 (the port's default), then the float32 solve path: its gates
    # allow the rounding of a float32 solve, whose criterion is looser
    for label, dtype, it_slack, tol in (
            ("small", torch.float64, 0, 1e-6),
            ("small_f32", torch.float32, 1, 1e-4)):
        out = {}
        for dev in ("cpu", "cuda"):
            prob, meta = build_problem(model.systems, model.regions,
                                       dole=dole, device=dev, dtype=dtype)
            ops = prob.mg.A_top.ops
            check(any(type(op).__name__ == "PlaneDia" for op in ops),
                  f"{label}: the PlaneDia path was not taken")
            check(prob.mg.A_top.dtype == dtype,
                  f"{label}: A_top is {prob.mg.A_top.dtype}")
            K.LAUNCHES = 0
            st = contact_analysis(prob, tuple(meta.group_modes),
                                  max_iter=1500, device=dev)
            if dev == "cuda":
                torch.cuda.synchronize()
            out[dev] = (st, K.LAUNCHES)
        (s_cpu, _), (s_gpu, launches) = out["cpu"], out["cuda"]
        u_cpu = s_cpu.u.double().numpy()
        u_gpu = s_gpu.u.cpu().double().numpy()
        scale = float(np.abs(u_cpu).max())
        err = float(np.abs(u_gpu - u_cpu).max())
        emit(label, it_cpu=s_cpu.it, it_cuda=s_gpu.it,
             inner_iters_cpu=s_cpu.inner_iters,
             inner_iters_cuda=s_gpu.inner_iters,
             max_abs_du=err, max_abs_u=scale, k1_launches=launches)
        check(s_cpu.converged and s_gpu.converged,
              f"{label}: no convergence")
        check(abs(s_cpu.it - s_gpu.it) <= it_slack,
              f"{label}: it {s_gpu.it} on the card, {s_cpu.it} on the CPU")
        check(err <= tol * scale,
              f"{label}: max|du| = {err} > {tol}*{scale}")
        check(launches > 0, f"{label}: K1 was not launched")
    restore_formats(saved)


def plane_dias(prob):
    """Every PlaneDia operator of a problem's body hierarchy and of its
    composed coarse correction's chains, labelled."""
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
    for co in prob.coarse or ():
        for name in ("tranD", "accu"):
            for i, op in enumerate(getattr(getattr(co, name), "chain", ())):
                visit(op, f"coarse {name} chain {i}")
        A = getattr(co.tranD, "A", None)
        if A is not None and A is not mg.A_top:
            visit(A, "coarse tranD A (float64)")
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
    err, scale = patch_error(np, cfg, model, meta, u, "slice")
    emit("slice", setup_s=setup_s, workers=model.workers, dof=n_dof,
         bodies=len(meta.systems),
         n_pad=meta.n_pad, coarse_ddmg=prob.coarse[0].mg is not None,
         plane_dia_operators=ops, it=st.it, converged=st.converged,
         inner_iters=st.inner_iters, solve_s=solve_s,
         s_per_iteration=solve_s / max(st.it, 1), k1_launches=launches,
         max_memory_allocated=peak, patch_err_rel=err / scale)
    check(st.converged, f"slice: no convergence in {st.it} iterations")
    check(19 <= st.it <= 21, f"slice: it = {st.it}, not in 19-21")
    check(launches > 0, "slice: K1 was not launched on the main path")
    check(err <= 1e-4 * scale, f"slice: patch test error {err / scale}")
    return dict(launches=launches, prob=prob, meta=meta, model=model,
                cfg=cfg, state=st, u=u, solve_s=solve_s, peak=peak)


# the float32 solve path against the float64 solve of the same size: the
# JAX package's bound on float32 against float64 (tests/test_precision.py)
F32_TOL = 3e-4


def phase_f32(torch, np, label, model, cfg, u64, max_iter):
    """BLOCK menu-1 in float32 (``build_problem(dtype=torch.float32)``, the
    JAX package's accelerator path) from a host model already built: the
    problem built on the host by phase, cast there, uploaded (timed
    apart), and solved on the card through K1's float32 entry point.
    Gates: every floating tensor float32 with A_top the finest level's
    operator (apart from the composed coarse correction's float64 A, whose
    dtype is checked too), convergence within ``max_iter``, u within
    F32_TOL max|u| of the float64 solve ``u64``, the patch test within
    F32_TOL, K1 launched."""
    import gc

    from ddpca_admm_tpu_torch.admm.loop import contact_analysis
    from ddpca_admm_tpu_torch.admm.problem import build_problem
    from ddpca_admm_tpu_torch.sparse import plane_dia_kernel as K
    from ddpca_admm_tpu_torch.utils import timing
    from ddpca_admm_tpu_torch.utils.device import to_device

    # what earlier phases keep on the card (the slice's float64 problem
    # stays for the sharding phase): the peak below includes it
    before = torch.cuda.memory_allocated()
    timing.reset()
    t = time.perf_counter()
    prob, meta = build_problem(
        model.systems, model.regions,
        dole=[1] * len(model.systems),   # doleMcsc=1 (BLOCK.cpp:69-71)
        musc_sett=2,                     # MULTISCALE_1 (BLOCK.h:38)
        device="cpu", dtype=torch.float32,
    )
    t2 = time.perf_counter()
    dtypes = sorted(str(d) for d in float_dtypes(torch, prob))
    aliased = prob.mg.A_top is prob.mg.levels[-1].A
    product_dtype = str(getattr(prob.coarse[0].tranD, "A", prob.mg.A_top)
                        .dtype)
    prob = to_device(prob, "cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t2
    problem_s = time.perf_counter() - t
    phases = [[tag, dt] for tag, dt in timing.reset()] + [
        ["upload", upload_s]]
    nbytes = problem_bytes(torch, prob)
    resident = torch.cuda.memory_allocated()
    co = prob.coarse[0]

    modes = tuple(meta.group_modes)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES = 0
    t = time.perf_counter()
    st = contact_analysis(prob, modes, max_iter=max_iter, device="cuda")
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t
    launches = K.LAUNCHES
    peak = torch.cuda.max_memory_allocated()

    u = st.u.cpu().double().numpy()
    err, scale = patch_error(np, cfg, model, meta, u, label)
    u_scale = float(np.abs(u64).max())
    du = float(np.abs(u - u64).max())
    emit(label, glob_leve=cfg.glob_leve, dtypes=dtypes,
         a_top_aliased=aliased, coarse_product_dtype=product_dtype,
         problem_s=problem_s, setup_phases=phases,
         coarse_tranD=type(co.tranD).__name__,
         coarse_accu=type(co.accu).__name__,
         coarse_ddmg=co.mg is not None, it=st.it, converged=st.converged,
         inner_iters=st.inner_iters, solve_s=solve_s,
         s_per_iteration=solve_s / max(st.it, 1), k1_launches=launches,
         max_abs_du_vs_f64=du, max_abs_u_f64=u_scale,
         patch_err_rel=err / scale, problem_bytes=nbytes,
         resident_before_bytes=before, resident_bytes=resident,
         max_memory_allocated=peak)
    check(dtypes == ["torch.float32"],
          f"{label}: floating tensors in {dtypes}, not float32 alone")
    check(aliased, f"{label}: A_top is not the finest level's operator")
    check(product_dtype == "torch.float64" or type(co.tranD).__name__ != (
        "ComposedTranD"), f"{label}: the composed F^T A u runs in "
        f"{product_dtype}")
    check(st.converged, f"{label}: no convergence in {st.it} iterations")
    check(launches > 0, f"{label}: K1 was not launched on the path")
    check(du <= F32_TOL * u_scale,
          f"{label}: u {du / u_scale} of max|u| from the float64 solve")
    check(err <= F32_TOL * scale, f"{label}: patch test error {err / scale}")
    del prob, meta, st, co
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------ Block-ELL and K2

K2_SOURCE = "ddpca_admm_tpu_torch/csrc/block_ell.cu"
# K2 replaces no Pallas kernel: the JAX package's BlockEll.mv is an XLA
# block gather and einsum
K2_REPLACES = "ddpca_admm_tpu/sparse/bell.py:84-115"
# Block-ELL operators the JAX package builds for BLOCK glob_leve=2 under
# DDPCA_SPARSE_FORMAT=bell, by solve dtype: every one of its device_sparse
# calls takes Block-ELL (counted on the CPU through the JAX package's own
# device_sparse); in float32 the coarse hierarchy's A_top is its finest
# level's operator, one call fewer
BELL_OPS = {"float64": 23, "float32": 22}
# the card against the CPU, and Block-ELL against ELL, in float64
BELL_TOL = 1e-8


@contextlib.contextmanager
def sparse_format(fmt: str):
    """DDPCA_SPARSE_FORMAT set to ``fmt`` for the builds inside."""
    saved = os.environ.get("DDPCA_SPARSE_FORMAT")
    os.environ["DDPCA_SPARSE_FORMAT"] = fmt
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("DDPCA_SPARSE_FORMAT", None)
        else:
            os.environ["DDPCA_SPARSE_FORMAT"] = saved


def block_ells(prob) -> list:
    """Every distinct BlockEll operator of a problem, labelled by its
    place in the problem tree."""
    found, seen = [], set()

    def walk(obj, label):
        name = type(obj).__name__
        if name == "BlockEll":
            if id(obj) not in seen:
                seen.add(id(obj))
                found.append((label, obj))
        elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
            for f in obj._fields:
                walk(getattr(obj, f), f"{label}.{f}")
        elif isinstance(obj, (tuple, list)):
            for i, v in enumerate(obj):
                walk(v, f"{label}[{i}]")
        elif type(obj).__module__.startswith("ddpca_admm_tpu_torch"):
            for k, v in vars(obj).items():
                walk(v, f"{label}.{k}")

    walk(prob, "prob")
    return found


def k2_bound(be, x):
    """Least time of one Block-ELL SpMV on the card: the tiles, cblk, x
    and y moved once over the memory rate, against 2 flops per tile entry
    over the dtype's peak."""
    item = be.tiles.element_size()
    F = x.numel() // be.n_cols
    nbytes = (be.tiles.numel() * item + be.cblk.numel() * 4
              + x.numel() * item + F * be.n_rows * item)
    ops = 2.0 * math.prod(be.tiles.shape[-4:]) * F
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[str(be.dtype).replace("torch.", "")]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def bell_csr(torch, be):
    """The block-diagonal CSR matrix of a (batched) BlockEll, built on the
    card from its nonzero tile entries (the yardstick for
    torch.sparse.mm), or None when its nonzeros pass int32."""
    n_rb, S, RB, CB = be.tiles.shape[-4:]
    tiles = be.tiles.reshape(-1, n_rb, S, RB, CB)
    cblk = be.cblk.reshape(-1, n_rb, S)
    F = tiles.shape[0]
    f, r, s, i, c = (tiles != 0).nonzero().unbind(1)
    if f.numel() >= 2 ** 31:
        return None
    rows = f * be.n_rows + r * RB + i
    cols = f * be.n_cols + cblk[f, r, s].long() * CB + c
    vals = tiles[f, r, s, i, c]
    del f, r, s, i, c
    order = torch.argsort(rows * (F * be.n_cols) + cols)
    rows, cols, vals = rows[order], cols[order], vals[order]
    crow = torch.zeros(F * be.n_rows + 1, dtype=torch.int64,
                       device=tiles.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=F * be.n_rows), 0)
    return torch.sparse_csr_tensor(
        crow.to(torch.int32), cols.to(torch.int32), vals,
        (F * be.n_rows, F * be.n_cols), check_invariants=False)


def run_k2_case(torch, K2, be, x, label):
    return run_case(torch, K2.block_ell_mv, K2.block_ell_mv_plain, be, x,
                    f"K2 {label}")


def time_k2(torch, K2, be, x, label) -> dict:
    """K2 against its plain version, its warm and cold times beside its
    bound, the plain version's time and torch.sparse.mm's on the CSR of
    the same operator (both warm); and K2's refusal of another dtype."""
    err, scale, rel = run_k2_case(torch, K2, be, x, label)
    ms_warm = warm_ms(torch, lambda: K2.block_ell_mv(be, x))
    ms_cold = cold_ms(torch, K2.block_ell_mv, be, x, tables=("tiles",))
    bound_ms, bound_by, nbytes, ops = k2_bound(be, x)
    big = nbytes > BIG_TABLE_BYTES
    plain_ms = warm_ms(torch, lambda: K2.block_ell_mv_plain(be, x),
                       inner=4 if big else 20, reps=2 if big else 5)
    torch.cuda.empty_cache()
    A = bell_csr(torch, be)
    nnz = None if A is None else A.values().numel()
    library_ms, why = library_case(torch, A, x, K2.block_ell_mv_plain(be, x),
                                   f"K2 {label}", rel)
    refuse_mixed_dtype(torch, K2, K2.block_ell_mv, be, x, f"K2 {label}")
    row = dict(ms=ms_warm, ms_warm=ms_warm, ms_cold=ms_cold,
               bound_ms=bound_ms, bound_by=bound_by,
               bound_share_cold=bound_ms / ms_cold, bytes=nbytes, flops=ops,
               plain_ms=plain_ms, library_ms=library_ms, max_abs_err=err,
               max_abs_y=scale, tol_rel=rel, nnz=nnz,
               fill=None if nnz is None else nnz / be.tiles.numel())
    if why:
        row["library_not_measured"] = why
    return row


# (stack, rows, cols) of operators K2 is also timed on: the region stack
# of the interface traces, the coarse hierarchy's operator and the guard
# slabs' row-compacted stack at glob_leve=2
K2_NAMED = ((120, 6912, 6656), (1, 30848, 30848), (4, 632, 640))


def k2_timed(ops) -> dict:
    """The operators whose K2 times are taken, by role: the largest and the
    smallest by tile bytes, the coarse hierarchy's operator (the largest
    single square one, in the wider dtype where two share the shape), and
    the first of each K2_NAMED shape."""
    size = {label: be.tiles.numel() * be.tiles.element_size()
            for label, be in ops}
    single = {label: (be.n_rows, be.tiles.element_size())
              for label, be in ops
              if be.tiles.ndim == 4 and be.n_rows == be.n_cols}
    picks = {"largest": max(size, key=size.get),
             "smallest": min(size, key=size.get)}
    if single:
        picks["coarse"] = max(single, key=single.get)
    for label, be in ops:
        key = (math.prod(be.tiles.shape[:-4]), be.n_rows, be.n_cols)
        role = "x".join(map(str, key))
        if key in K2_NAMED and role not in picks \
                and label not in picks.values():
            picks[role] = label
    return {label: role for role, label in picks.items()}


def phase_small_bell(torch, np) -> int:
    """The small BLOCK (divi 2, glob_leve 1, MULTISCALE_1 at doleMcsc=1)
    under DDPCA_SPARSE_FORMAT=bell, on the CPU (plain versions) and on
    the card (K2): the same ``it``, u, z and lambda within BELL_TOL of
    their largest entries, K2 launched."""
    from ddpca_admm_tpu_torch.admm.loop import contact_analysis
    from ddpca_admm_tpu_torch.admm.problem import build_problem
    from ddpca_admm_tpu_torch.models.block import BlockConfig, build_block_model
    from ddpca_admm_tpu_torch.sparse import block_ell_kernel as K2
    from ddpca_admm_tpu_torch.sparse import plane_dia_kernel as K

    model = build_block_model(
        BlockConfig(divi=(2, 2, 2), glob_leve=1, doma_numb=(1, 1, 1)))
    out = {}
    for dev in ("cpu", "cuda"):
        with sparse_format("bell"):
            prob, meta = build_problem(model.systems, model.regions,
                                       dole=[1] * len(model.systems),
                                       musc_sett=2, device=dev)
        n_ops = len(block_ells(prob))
        K.LAUNCHES = K2.LAUNCHES = 0
        st = contact_analysis(prob, tuple(meta.group_modes), max_iter=800,
                              device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (st, K2.LAUNCHES, K.LAUNCHES)
    (s_cpu, _, _), (s_gpu, launches, k1) = out["cpu"], out["cuda"]
    errs = {}
    pairs = [("u", s_cpu.u, s_gpu.u)]
    for g, (a, b) in enumerate(zip(s_cpu.groups, s_gpu.groups)):
        pairs += [(f"z[{g}]", a.z, b.z), (f"lam[{g}]", a.lam, b.lam)]
    for name, a, b in pairs:
        scale = float(a.abs().max())
        errs[name] = float((b.cpu() - a).abs().max()) / max(scale, 1e-300)
    emit("small_bell", block_ell_operators=n_ops, it_cpu=s_cpu.it,
         it_cuda=s_gpu.it, inner_iters_cpu=s_cpu.inner_iters,
         inner_iters_cuda=s_gpu.inner_iters, max_rel_err=errs,
         k2_launches=launches, k1_launches=k1)
    check(s_cpu.converged and s_gpu.converged, "small_bell: no convergence")
    check(s_cpu.it == s_gpu.it,
          f"small_bell: it {s_gpu.it} on the card, {s_cpu.it} on the CPU")
    for name, err in errs.items():
        check(err <= BELL_TOL, f"small_bell: {name} {err} of its largest "
              f"entry from the CPU")
    check(n_ops > 0, "small_bell: the problem holds no Block-ELL operator")
    check(launches > 0, "small_bell: K2 was not launched")
    return launches


def phase_slice_bell(torch, np, args, sl, label, dtype) -> dict:
    """BLOCK glob_leve=2 under DDPCA_SPARSE_FORMAT=bell in ``dtype``, built
    from the slice phase's host model (no second host build), its tiles
    on the card: K2 held against its plain version on every
    Block-ELL operator and timed on three of them, then the solve through
    K1 and K2, against the ELL slice's float64 solve.  Freed at the end,
    on the host and the card."""
    import gc

    from ddpca_admm_tpu_torch.admm.loop import contact_analysis
    from ddpca_admm_tpu_torch.admm.problem import build_problem
    from ddpca_admm_tpu_torch.sparse import block_ell_kernel as K2
    from ddpca_admm_tpu_torch.sparse import plane_dia_kernel as K
    from ddpca_admm_tpu_torch.utils import timing

    model, cfg, ref = sl["model"], sl["cfg"], sl["state"]
    before = torch.cuda.memory_allocated()
    timing.reset()
    t = time.perf_counter()
    # the tiles are built on the card inside (sparse/bell.py::tiles_on),
    # the rest on the host and uploaded at the end
    with sparse_format("bell"):
        prob, meta = build_problem(
            model.systems, model.regions,
            dole=[1] * len(model.systems),   # doleMcsc=1 (BLOCK.cpp:69-71)
            musc_sett=2,                     # MULTISCALE_1 (BLOCK.h:38)
            device="cuda", dtype=dtype,
        )
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    phases = [[tag, dt] for tag, dt in timing.reset()]
    dtypes = sorted(str(d) for d in float_dtypes(torch, prob))
    nbytes = problem_bytes(torch, prob)
    resident = torch.cuda.memory_allocated()
    ops = block_ells(prob)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + len(K1_CASES) + (2 if dtype ==
                                                 torch.float64 else 3))
    timed = k2_timed(ops)
    rows = []
    for op_label, be in ops:
        x = torch.randn(tuple(be.tiles.shape[:-4]) + (be.n_cols,),
                        generator=gen, device="cuda", dtype=be.dtype)
        row = dict(op=op_label, dtype=str(be.dtype).replace("torch.", ""),
                   tiles=list(be.tiles.shape), n_cols=be.n_cols)
        if op_label in timed:
            row.update(case=timed[op_label],
                       **time_k2(torch, K2, be, x, op_label))
        else:
            err, scale, rel = run_k2_case(torch, K2, be, x, op_label)
            row.update(max_abs_err=err, max_abs_y=scale, tol_rel=rel)
        rows.append(row)
        del x
    torch.cuda.empty_cache()

    modes = tuple(meta.group_modes)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES = K2.LAUNCHES = 0
    t = time.perf_counter()
    st = contact_analysis(prob, modes, max_iter=60, device="cuda")
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t
    k1, k2 = K.LAUNCHES, K2.LAUNCHES
    peak = torch.cuda.max_memory_allocated()

    u = st.u.cpu().double().numpy()
    err, scale = patch_error(np, cfg, model, meta, u, label)
    u_scale = float(np.abs(sl["u"]).max())
    du = float(np.abs(u - sl["u"]).max())
    n_jax = BELL_OPS[str(dtype).replace("torch.", "")]
    emit(label, glob_leve=cfg.glob_leve, dtypes=dtypes,
         block_ell_operators=len(ops), block_ell_operators_jax=n_jax,
         setup_s=setup_s, setup_phases=phases, it=st.it,
         converged=st.converged, inner_iters=st.inner_iters,
         solve_s=solve_s, s_per_iteration=solve_s / max(st.it, 1),
         k1_launches=k1, k2_launches=k2, max_abs_du_vs_ell_f64=du,
         max_abs_u_ell_f64=u_scale, patch_err_rel=err / scale,
         problem_bytes=nbytes, resident_before_bytes=before,
         resident_bytes=resident, max_memory_allocated=peak,
         block_ell_cases=rows,
         ell_slice=dict(it=ref.it, inner_iters=ref.inner_iters,
                        solve_s=sl["solve_s"], k1_launches=sl["launches"],
                        max_memory_allocated=sl["peak"],
                        problem_bytes=problem_bytes(torch, sl["prob"])))
    check(len(ops) == n_jax, f"{label}: {len(ops)} Block-ELL operators, "
          f"the JAX package builds {n_jax}")
    check(st.converged, f"{label}: no convergence in {st.it} iterations")
    check(k1 > 0, f"{label}: K1 was not launched on the path")
    check(k2 > 0, f"{label}: K2 was not launched on the path")
    if dtype == torch.float64:
        check(st.it == ref.it, f"{label}: it {st.it}, the ELL slice's "
              f"{ref.it}")
        check(du <= BELL_TOL * u_scale, f"{label}: u {du / u_scale} of "
              "max|u| from the ELL slice")
        check(err <= 1e-4 * scale,
              f"{label}: patch test error {err / scale}")
    else:
        check(dtypes == ["torch.float32"],
              f"{label}: floating tensors in {dtypes}, not float32 alone")
        check(du <= F32_TOL * u_scale, f"{label}: u {du / u_scale} of "
              "max|u| from the float64 ELL slice")
        check(err <= F32_TOL * scale,
              f"{label}: patch test error {err / scale}")
    main = next((r for r in rows if r.get("case") == "largest"), rows[0])
    del prob, meta, st, ops
    gc.collect()
    torch.cuda.empty_cache()
    return dict(k1=k1, k2=k2, rows=[r for r in rows if "case" in r],
                main=main)


# the reference's own BLOCK size (examples/BLOCK.cpp compiles glob_leve=4):
# 8,809,452 DOF, which the reference solves in 25 ADMM iterations
# (baseline_measured.json, block_divi6_leve4_doma2)
FULL_LEVE = 4
FULL_DOF = 8_809_452
FULL_IT = (24, 26)
FULL_MAX_ITER = 40


def host_memory() -> dict:
    """Peak resident bytes of this process and of its largest finished
    child (the build pool's workers), and the machine's MemTotal."""
    import resource

    with open("/proc/meminfo") as f:
        total = next(int(ln.split()[1]) * 1024 for ln in f
                     if ln.startswith("MemTotal:"))
    return dict(
        peak_rss=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        peak_rss_worker=resource.getrusage(
            resource.RUSAGE_CHILDREN).ru_maxrss * 1024,
        mem_total=total)


def phase_full(torch, np, args):
    """BLOCK menu-1 at the reference's size, glob_leve=4: the host build in
    the port's process pool, K1 held against its plain version and timed
    on every PlaneDia of the problem, the coarse correction through the
    hierarchy (ComposedTranD / ComposedAccu, on by the problem's size), and
    the solve on the card, held to the reference's iteration count and the
    patch test."""
    import gc
    import resource

    from ddpca_admm_tpu_torch.admm.loop import contact_analysis
    from ddpca_admm_tpu_torch.admm.multiscale import (
        ComposedAccu,
        ComposedTranD,
    )
    from ddpca_admm_tpu_torch.admm.problem import build_problem
    from ddpca_admm_tpu_torch.models.block import BlockConfig, build_block_model
    from ddpca_admm_tpu_torch.sparse import plane_dia_kernel as K
    from ddpca_admm_tpu_torch.utils import timing
    from ddpca_admm_tpu_torch.utils.device import to_device
    from ddpca_admm_tpu_torch.utils.pool import mem_available

    timing.reset()
    avail = mem_available()
    t = time.perf_counter()
    cfg = BlockConfig(divi=(6, 6, 6), glob_leve=FULL_LEVE,
                      doma_numb=(2, 2, 2))
    model = build_block_model(cfg)
    model_s = time.perf_counter() - t
    rss_model = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    t1 = time.perf_counter()
    # built on the host, then moved to the card as build_problem's device
    # argument does it, to time the upload apart
    prob, meta = build_problem(
        model.systems, model.regions,
        dole=[1] * len(model.systems),   # doleMcsc=1 (BLOCK.cpp:69-71)
        musc_sett=2,                     # MULTISCALE_1 (BLOCK.h:38)
        device="cpu",
    )
    t2 = time.perf_counter()
    prob = to_device(prob, "cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t2
    problem_s = time.perf_counter() - t1
    setup_s = time.perf_counter() - t
    phases = [[tag, dt] for tag, dt in model.phases + timing.reset()] + [
        ["upload", upload_s]]
    n_dof = int(sum(s.n_dof for s in meta.systems))
    co = prob.coarse[0]
    composed = (isinstance(co.tranD, ComposedTranD)
                and isinstance(co.accu, ComposedAccu))
    nbytes = problem_bytes(torch, prob)
    resident = torch.cuda.memory_allocated()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + len(K1_CASES) + 1)
    ops = []
    for label, pd in plane_dias(prob):
        x = torch.randn((pd.kz.shape[0], pd.n_rows), generator=gen,
                        device="cuda", dtype=pd.dtype)
        ops.append(dict(op=label, **time_k1(torch, K, pd, x, label)))
        del x
    torch.cuda.empty_cache()
    check(len(ops) > 0, "full: the problem holds no PlaneDia operator")

    modes = tuple(meta.group_modes)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES = 0
    t = time.perf_counter()
    st = contact_analysis(prob, modes, max_iter=FULL_MAX_ITER, device="cuda")
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t
    launches = K.LAUNCHES
    peak = torch.cuda.max_memory_allocated()

    u = st.u.cpu().numpy()
    err, scale = patch_error(np, cfg, model, meta, u, "full")
    emit("full", glob_leve=FULL_LEVE, setup_s=setup_s, model_s=model_s,
         problem_s=problem_s, setup_phases=phases, workers=model.workers,
         dof=n_dof, bodies=len(meta.systems), n_pad=meta.n_pad,
         coarse_tranD=type(co.tranD).__name__,
         coarse_accu=type(co.accu).__name__,
         coarse_ddmg=co.mg is not None, plane_dia_operators=ops,
         it=st.it, converged=st.converged, inner_iters=st.inner_iters,
         solve_s=solve_s, s_per_iteration=solve_s / max(st.it, 1),
         k1_launches=launches, patch_err_rel=err / scale,
         problem_bytes=nbytes, resident_bytes=resident,
         max_memory_allocated=peak, mem_available_at_build=avail,
         peak_rss_model=rss_model, **host_memory())
    check(n_dof == FULL_DOF, f"full: {n_dof} DOF, not {FULL_DOF}")
    check(composed, "full: the coarse correction is not ComposedTranD / "
                    f"ComposedAccu ({type(co.tranD).__name__}, "
                    f"{type(co.accu).__name__})")
    check(st.converged, f"full: no convergence in {st.it} iterations")
    check(FULL_IT[0] <= st.it <= FULL_IT[1],
          f"full: it = {st.it}, not in {FULL_IT[0]}-{FULL_IT[1]}")
    check(launches > 0, "full: K1 was not launched on the path")
    check(err <= 1e-4 * scale, f"full: patch test error {err / scale}")
    # the float32 solve of the same host model: the float64 problem goes
    # first, its u stays on the host
    del prob, meta, st, co
    gc.collect()
    torch.cuda.empty_cache()
    f32_launches = phase_f32(torch, np, "full_f32", model, cfg, u,
                             FULL_MAX_ITER)
    del model
    gc.collect()
    return launches, f32_launches


def patch_error(np, cfg, model, meta, u, label):
    """The BLOCK patch test (examples/BLOCK.cpp:43-49), u_z = p z / E
    everywhere: the largest error and its scale |p| H / E."""
    check(u.shape == (len(meta.systems), meta.n_pad),
          f"{label}: u has shape {u.shape}")
    check(bool(np.isfinite(u).all()), f"{label}: u is not finite")
    E, p = cfg.e_mod, cfg.pressure
    scale = abs(p) * sum(cfg.leng) / E
    err = max(
        float(np.abs(
            s.full_displacement(u[b, : s.n_dof])[2::3]
            - p * body.mesh.coords[:, 2] / E
        ).max())
        for b, (body, s) in enumerate(zip(model.bodies, meta.systems))
    )
    return err, scale


# ------------------------------------------------------------- sharding

# seconds a sharded solve may take before the launcher kills its ranks
SHARD_TIMEOUT = 300.0
SHARD_WORLD = 2


def float_dtypes(torch, prob) -> set:
    """The dtypes of a problem's floating tensors, apart from the float64
    operator of F^T A u in a composed coarse correction
    (``ComposedTranD.A``, float64 in either solve dtype)."""
    from ddpca_admm_tpu_torch.utils.device import tree_map

    found = set()
    keep = [co.tranD.A for co in prob.coarse or ()
            if type(co.tranD).__name__ == "ComposedTranD"]
    tree_map(lambda t: found.add(t.dtype) if t.is_floating_point() else None,
             prob, keep=keep)
    return found


def problem_bytes(torch, prob) -> dict:
    """Bytes of a problem's tensors by placement over ranks: the
    body-batched fields and the hierarchy (both sliced), the PlaneDia class
    tables of the hierarchy (whole on every rank), the region groups and
    the coarse correction (replicated); under ``floating`` and ``integer``
    the same split of the floating and of the integer and bool tensors.  A
    storage that two fields share counts once, under the first."""
    import numpy as np

    seen, sizes = set(), {}
    kinds = {"floating": {}, "integer": {}}

    def add(key, t):
        store = t.untyped_storage()
        if store.data_ptr() not in seen:
            seen.add(store.data_ptr())
            sizes[key] = sizes.get(key, 0) + store.nbytes()
            kind = kinds["floating" if t.is_floating_point() else "integer"]
            kind[key] = kind.get(key, 0) + store.nbytes()

    def walk(key, obj):
        if isinstance(obj, torch.Tensor):
            add(key, obj)
        elif isinstance(obj, (tuple, list)):
            for v in obj:
                walk(key, v)
        elif type(obj).__name__ == "PlaneDia":
            add("mg_class_tables", obj.vals)
            for k, v in vars(obj).items():
                if k != "vals":
                    walk(key, v)
        elif obj is not None and not isinstance(
                obj, (bool, int, float, str, np.generic, np.ndarray,
                      torch.dtype)):
            for v in vars(obj).values():
                walk(key, v)

    for name in ("cons_forc", "gram", "gram_lin", "gram_const", "u_mask"):
        walk("body_fields", getattr(prob, name))
    walk("mg_sliced", prob.mg)
    walk("groups", prob.groups)
    walk("coarse", prob.coarse)
    for part in (sizes, *kinds.values()):
        part["total"] = sum(part.values())
    return dict(sizes, **kinds)


def k1_rank_hook(prob, shard):
    """In every rank of the sharded BLOCK solve, before it: K1 against its
    plain version on each PlaneDia of the rank's slice of the problem
    (these launches are not counted: the rank zeroes the count after), the
    bytes of the rank's problem by placement, and the bytes allocated on
    the card once the rank's problem and state are loaded."""
    import torch

    from ddpca_admm_tpu_torch.sparse import plane_dia_kernel as K

    resident = torch.cuda.memory_allocated(shard.device)
    gen = torch.Generator(device=shard.device)
    gen.manual_seed(1000 + shard.rank)
    rows = []
    for label, pd in plane_dias(prob):
        x = torch.randn((pd.kz.shape[0], pd.n_rows), generator=gen,
                        device=shard.device, dtype=pd.dtype)
        err, scale, rel = run_k1_case(torch, K, pd, x,
                                      f"rank {shard.rank} {label}")
        rows.append(dict(op=label, kz=list(pd.kz.shape), max_abs_err=err,
                         max_abs_y=scale, tol_rel=rel))
    return dict(k1=rows, problem_bytes=problem_bytes(torch, prob),
                resident_bytes=resident)


def rank_lines(ranks, mesh, backend, prepare_s, joined_s) -> dict:
    """The figures of a sharded run, one list entry per rank; ``timeline``:
    seconds from the spawn to each stage of a rank (``_rank_solve``)."""
    return dict(
        world=len(ranks), mesh=list(mesh), backend=backend,
        prepare_s=prepare_s, joined_s=joined_s,
        devices=[r["device"] for r in ranks],
        device_names=sorted({r["device_name"] for r in ranks}),
        bodies_per_rank=[r["bodies"][1] - r["bodies"][0] for r in ranks],
        setup_s=[r["setup_s"] for r in ranks],
        solve_s=[r["solve_s"] for r in ranks],
        k1_launches=[r["k1_launches"] for r in ranks],
        max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
        timeline=[r["timeline"] for r in ranks],
    )


def phase_sharding(torch, np, sl):
    """The body axis over ranks sharing the card: the dry run at 2 and 4
    ranks, then BLOCK glob_leve=2 over SHARD_WORLD ranks from the slice
    phase's problem, against the slice's one-card solve."""
    from ddpca_admm_tpu_torch import graft_entry
    from ddpca_admm_tpu_torch.parallel.sharding import solve_sharded

    launches = {}
    for n in (2, 4):
        t = time.perf_counter()
        rows = graft_entry.dryrun_multichip(n, timeout=SHARD_TIMEOUT)
        for row in rows:
            emit("sharding", run=f"dryrun_multichip({n})",
                 config=row["config"], it=row["it"],
                 inner_iters=row["inner_iters"],
                 inner_iters_one_card=row["inner_iters_single"],
                 solve_s_one_card=row["solve_s_single"],
                 max_rel_du=row["max_rel_du"],
                 **rank_lines(row["ranks"], row["mesh"], row["backend"],
                              row["prepare_s"], row["joined_s"]))
            check(all(r["device"].startswith("cuda") for r in row["ranks"]),
                  f"dryrun_multichip({n}): a rank did not run on the card")
        launches[f"dryrun_multichip({n})"] = sum(
            r["k1_launches"] for row in rows for r in row["ranks"])
        emit("sharding", run=f"dryrun_multichip({n})", runs=len(rows),
             wall_s=time.perf_counter() - t)

    meta, st = sl["meta"], sl["state"]
    t = time.perf_counter()
    run = solve_sharded(sl["prob"], tuple(meta.group_modes), SHARD_WORLD,
                        max_iter=60, device="cuda", timeout=SHARD_TIMEOUT,
                        rank_hook=k1_rank_hook)
    wall_s = time.perf_counter() - t
    sh = run.state
    u = sh.u.numpy()
    scale_u = float(np.abs(sl["u"]).max())
    du = float(np.abs(u - sl["u"]).max())
    err, scale = patch_error(np, sl["cfg"], sl["model"], meta, u, "sharding")
    lines = rank_lines(run.ranks, run.mesh_shape, run.backend,
                       run.prepare_s, run.joined_s)
    emit("sharding", run=f"block glob_leve={GLOB_LEVE}", it=sh.it,
         it_one_card=st.it, inner_iters=sh.inner_iters,
         inner_iters_one_card=st.inner_iters, converged=sh.converged,
         max_abs_du=du, max_abs_u=scale_u, patch_err_rel=err / scale,
         solve_s_one_card=sl["solve_s"], wall_s=wall_s,
         k1_checked=[len(r["hook"]["k1"]) for r in run.ranks],
         k1_max_rel_err=max(c["max_abs_err"] / c["max_abs_y"]
                            for r in run.ranks for c in r["hook"]["k1"]),
         problem_bytes_one_card=problem_bytes(torch, sl["prob"]),
         max_memory_allocated_one_card=sl["peak"],
         problem_bytes=[r["hook"]["problem_bytes"] for r in run.ranks],
         resident_bytes=[r["hook"]["resident_bytes"] for r in run.ranks],
         **lines)
    check(sh.converged, f"sharding: no convergence in {sh.it} iterations")
    check(sh.it == st.it, f"sharding: it {sh.it} over {SHARD_WORLD} ranks, "
          f"{st.it} on one card")
    check(sh.inner_iters == st.inner_iters,
          f"sharding: inner_iters {sh.inner_iters} over {SHARD_WORLD} ranks, "
          f"{st.inner_iters} on one card")
    check(du <= 1e-9 * scale_u,
          f"sharding: max|du| = {du} > 1e-9 * {scale_u} against one card")
    check(err <= 1e-4 * scale, f"sharding: patch test error {err / scale}")
    for r in run.ranks:
        check(r["device"].startswith("cuda"),
              f"sharding: rank {r['rank']} ran on {r['device']}")
        check(len(r["hook"]["k1"]) > 0,
              f"sharding: rank {r['rank']} holds no PlaneDia to check K1 on")
        check(r["k1_launches"] > 0,
              f"sharding: rank {r['rank']} did not launch K1 in the solve")
    launches[f"block glob_leve={GLOB_LEVE}, {SHARD_WORLD} ranks"] = sum(
        lines["k1_launches"])
    return launches


# ------------------------------------------------------------- examples

# The examples' CPU solves run in worker processes beside the card phases
# (the longest, DEHW, takes minutes on the CPU); each worker runs this many
# torch threads and host-build threads, and this process keeps the rest.
EXAMPLE_WORKERS = 3
WORKER_THREADS = 2
# the card against the CPU: the same iteration count and u, z, lambda,
# gamma within this fraction of their largest entries
EXAMPLE_TOL = 1e-8
# DEHW does not converge in 3000 iterations (nor does the JAX package, nor
# the C++ reference): its card and CPU solves are compared after
# DEHW_CHECK_ITERS iterations (one costs ~45 s on the CPU)
DEHW_CHECK_ITERS = 2
# the examples in the order the card runs them; the pool computes their
# CPU references in the same order, so each is ready when the card needs it
EXAMPLES = ("torsion", "beam", "cylinder_stack4", "cylinder_cross_corner",
            "dehw")


def example_model(name: str):
    """An example built on the CPU by the port's host code at the JAX
    CLI's small configuration.  Returns (prob, meta, bodies, cfg, cuts):
    the cuts list each setting that differs from the reference's."""
    from ddpca_admm_tpu_torch import cli

    if name == "torsion":
        from ddpca_admm_tpu_torch.models.torsion import (
            TorsionConfig,
            build_torsion_model,
        )

        cfg = TorsionConfig(**cli.SMALL_TORSION)
        prob, meta, bodies, cfg = build_torsion_model(cfg, device="cpu")
        cuts = ["divi (1,8,2) of (1,32,8)", "doma (1,4,2) of (1,32,8)",
                f"glob_homo {cfg.glob_homo} of 4"]
    elif name == "beam":
        from ddpca_admm_tpu_torch.models.beam import (
            BeamConfig,
            build_beam_model,
        )

        cfg = BeamConfig(**cli.SMALL_BEAM)
        prob, meta, bodies, cfg = build_beam_model(cfg, device="cpu")
        cuts = ["divi (8,4,2) of (64,4,2)", "doma (4,2,1) of (32,4,2)",
                f"glob_leve {cfg.glob_leve} of 4"]
    elif name.startswith("cylinder"):
        from ddpca_admm_tpu_torch.models.cylinder import build_cylinder_model

        stack4 = name == "cylinder_stack4"
        cfg = cli.cylinder_config("small", stack4=stack4,
                                  cross_corner=not stack4)
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
    from ddpca_admm_tpu_torch.utils.pool import THREADS_ENV

    torch.set_num_threads(WORKER_THREADS)
    os.environ[THREADS_ENV] = str(WORKER_THREADS)
    t = time.perf_counter()
    prob, meta, _, _, _ = example_model(name)
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


def example_oracle(np, name, meta, bodies, cfg, st) -> dict:
    """The example's own oracle on a solved state: TORSION's analytic
    twist, BEAM's unsplit solve, CYLINDER's line load and Hertz peak,
    DEHW's monitors and contact pressures."""
    u = st.u.cpu().numpy()
    if name == "torsion":
        out = torsion_oracle(np, meta, bodies, cfg, u)
        check(abs(out["twist_ratio"] - 1.0) <= 1e-3,
              f"torsion: twist ratio {out['twist_ratio']}")
    elif name == "beam":
        out = beam_oracle(np, meta, bodies, cfg, u)
        check(out["dd_vs_unsplit_rel"] < 2e-3,
              f"beam: DD against unsplit {out}")
    elif name.startswith("cylinder"):
        out = cylinder_oracle(np, meta, cfg, st,
                              cross_corner=cfg.cross_corner)
    else:
        out = dehw_oracle(np, meta, st)
    return out


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
    against its CPU solve from the worker pool."""
    import tempfile

    from ddpca_admm_tpu_torch import cli

    launches_by_path = {}
    for name in EXAMPLES:
        t = time.perf_counter()
        prob, meta, bodies, cfg, cuts = example_model(name)
        setup_s = time.perf_counter() - t
        row = dict(example=name, scale="small", cuts=cuts,
                   bodies=len(meta.systems),
                   dof=int(sum(s.n_dof for s in meta.systems)),
                   n_pad=meta.n_pad, group_modes=meta.group_modes,
                   coarse=[("ddmg" if co.mg is not None else "dense")
                           for co in (prob.coarse or ())],
                   setup_s=setup_s)
        max_iter = DEHW_CHECK_ITERS if name == "dehw" else 3000
        st, solve_s, launches, peak = card_solve(
            torch, prob, meta, max_iter, moni=(name == "dehw"))
        launches_by_path[f"{name} small"] = launches
        row.update(solve_s=solve_s, it=st.it, converged=st.converged,
                   inner_iters=st.inner_iters, k1_launches=launches,
                   max_memory_allocated=peak)
        if name != "dehw":
            check(st.converged, f"{name}: no convergence in {st.it} "
                                "iterations")
        else:
            check(st.it == max_iter, f"dehw: it = {st.it}")
        u = st.u.cpu().numpy()
        check(u.shape == (len(meta.systems), meta.n_pad)
              and bool(np.isfinite(u).all()),
              f"{name}: u is not finite or of shape {u.shape}")
        cpu = refs[name].get(timeout=900)
        row.update(it_cpu=cpu["it"], inner_iters_cpu=cpu["inner_iters"],
                   cpu_setup_s=cpu["setup_s"], cpu_solve_s=cpu["solve_s"])
        check(st.it == cpu["it"] and st.converged == cpu["converged"],
              f"{name}: it {st.it} on the card, {cpu['it']} on the CPU")
        row["card_vs_cpu_rel"] = compare_states(
            np, name, state_arrays(st), cpu)
        row["oracle"] = example_oracle(np, name, meta, bodies, cfg, st)
        # the CLI's result writers, on the card's state
        with tempfile.TemporaryDirectory() as d:
            cli.write_results(st, meta, bodies, d, moni=(name == "dehw"))
            row["result_files"] = len(os.listdir(d))
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


def apps_run() -> dict:
    """Worker process: DEHW's APPS eigen-analysis through the port's
    command line, in process, at the small grid."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from ddpca_admm_tpu_torch import cli
    from ddpca_admm_tpu_torch.utils.pool import THREADS_ENV

    torch.set_num_threads(WORKER_THREADS)
    os.environ[THREADS_ENV] = str(WORKER_THREADS)
    t = time.perf_counter()
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as d:
        with contextlib.redirect_stdout(buf):
            cli.main(["dehw", "--apps", "coarse", "--outdir", d])
        seconds = time.perf_counter() - t
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        freq = np.loadtxt(os.path.join(d, "resuFreq.txt"), ndmin=2)
        files = os.listdir(d)
    return dict(seconds=seconds, summary=summary, freq=freq, files=files)


def phase_apps(np, run):
    """Checks ``apps_run``'s result (host code: the check is that it runs
    on this machine's scipy without JAX)."""
    summary, freq = run["summary"], run["freq"]
    modes = [f for f in run["files"] if f.startswith("resuDisp_")]
    n_bodies = len({f.rsplit("-", 1)[1] for f in modes})
    emit("apps", command="dehw --apps coarse", seconds=run["seconds"],
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

    rows = phase_kernels(torch, args)
    phase_small(torch, np)
    small_bell_launches = phase_small_bell(torch, np)
    sl = phase_slice(torch, np, args)
    launches = sl["launches"]
    slice_f32_launches = phase_f32(torch, np, "slice_f32", sl["model"],
                                   sl["cfg"], sl["u"], 60)
    # the JAX package's accelerator format, Block-ELL, in float64 and in
    # float32 (its own accelerator configuration), each freed after it
    bell = phase_slice_bell(torch, np, args, sl, "slice_bell", torch.float64)
    bell32 = phase_slice_bell(torch, np, args, sl, "slice_bell_f32",
                              torch.float32)
    # the host build of the full phase takes every core and most of the
    # host memory: the examples' CPU references start after it
    full_launches, full_f32_launches = phase_full(torch, np, args)

    # the examples' CPU references, computed beside the card phases; this
    # process's host work keeps the cores they leave
    import multiprocessing

    from ddpca_admm_tpu_torch.utils.pool import THREADS_ENV, host_threads

    cores = host_threads()
    os.environ[THREADS_ENV] = str(
        max(1, cores - EXAMPLE_WORKERS * WORKER_THREADS))
    pool = multiprocessing.get_context("spawn").Pool(EXAMPLE_WORKERS)
    try:
        refs = {name: pool.apply_async(cpu_reference, (name,))
                for name in EXAMPLES}
        apps = pool.apply_async(apps_run)
        sharding_launches = phase_sharding(torch, np, sl)
        del sl
        torch.cuda.empty_cache()
        example_launches = phase_examples(torch, np, refs)
        apps = apps.get(timeout=900)
    finally:
        pool.terminate()
        pool.join()
        os.environ[THREADS_ENV] = str(cores)
    lagrange_launches = phase_lagrange(torch, np)
    phase_apps(np, apps)

    main_row = rows[0]   # A_top, the largest K1 call of the main path
    kernels = [{
        "name": "plane_dia_mv",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "launches_by_path": {"block glob_leve=2": launches,
                             "block glob_leve=2 f32": slice_f32_launches,
                             f"block glob_leve={FULL_LEVE}": full_launches,
                             f"block glob_leve={FULL_LEVE} f32":
                                 full_f32_launches,
                             "block glob_leve=2 bell": bell["k1"],
                             "block glob_leve=2 bell f32": bell32["k1"],
                             **sharding_launches, **example_launches,
                             **lagrange_launches},
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "ms_cold": main_row["ms_cold"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "at": main_row["case"],
        "shapes": rows,
    }, {
        "name": "block_ell_mv",
        "route": "cuda",
        "source": K2_SOURCE,
        "replaces": K2_REPLACES,
        "replaces_kind": "XLA op (BlockEll.mv: gather and einsum), no "
                         "Pallas kernel",
        "launches": bell["k2"],
        "launches_by_path": {"block glob_leve=2 bell": bell["k2"],
                             "block glob_leve=2 bell f32": bell32["k2"],
                             "small block bell": small_bell_launches},
        "max_abs_err": bell["main"]["max_abs_err"],
        "ms": bell["main"]["ms"],
        "ms_cold": bell["main"]["ms_cold"],
        "plain_ms": bell["main"]["plain_ms"],
        "bound_ms": bell["main"]["bound_ms"],
        "bound_by": bell["main"]["bound_by"],
        "library_ms": bell["main"]["library_ms"],
        "at": bell["main"]["op"],
        "shapes": bell["rows"] + bell32["rows"],
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
