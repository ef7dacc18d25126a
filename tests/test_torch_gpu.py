"""Card-only checks of the port: the CUDA kernel K1 against its plain
PyTorch version (at the slice's shape and at the edges of its plan and
tiles), plain ``Dia.mv``'s card branch against its CPU branch, the small
BLOCK solved on the card against the CPU, the stacked boxes with
Coulomb friction and with coarse correction variants A and B solved on the
card against the CPU, and BiCGSTAB, GMRES and the dual-mortar LAGRANGE
solve on the card against the CPU.
Each test decides inside itself whether a card is present and skips
without one.  This file imports no JAX (the card's machine has none):

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports JAX, which the card's
machine does not have.)
"""

import numpy as np
import pytest
import torch

from ddpca_admm_tpu_torch.sparse import plane_dia_kernel as K
from ddpca_admm_tpu_torch.sparse.dia import Dia, PlaneDia

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: K1 runs only on the card")


def _stiffness_offsets(grid):
    """The 99 DIA offsets of a hex8 stiffness on an (nz, ny, nx) node grid
    with 3 dofs per node."""
    nz, ny, nx = grid
    P = 3 * ny * nx
    return sorted({dz * P + dy * 3 * nx + e for dz in (-1, 0, 1)
                   for dy in (-1, 0, 1) for e in range(-5, 6)})


def _plane_dia(rng, dtype, C, grid, B, n, tail):
    nz, ny, nx = grid
    P = 3 * ny * nx
    offs = _stiffness_offsets(grid)
    vals = torch.from_numpy(rng.standard_normal((C, len(offs), P))).to(dtype)
    kz = torch.from_numpy(rng.integers(0, C, (B, nz)).astype(np.int32))
    return PlaneDia(vals.cuda(), kz.cuda(), tuple(offs), n, P,
                    tail_identity=tail)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("tail", [True, False])
def test_k1_matches_plain_on_card(dtype, rtol, tail):
    _need_card()
    rng = np.random.default_rng(0)
    pd = _plane_dia(rng, dtype, 72, (13, 13, 13), 24, 6656, tail)
    x = torch.from_numpy(rng.standard_normal((24, 6656))).to("cuda", dtype)
    before = K.LAUNCHES
    y = K.plane_dia_mv(pd, x)
    assert K.LAUNCHES == before + 1
    y_plain = K.plane_dia_mv_plain(pd, x)
    torch.cuda.synchronize()
    scale = float(y_plain.abs().max())
    assert float((y - y_plain).abs().max()) <= rtol * scale


# (label, B, node grid (nz, ny, nx), classes C, class layout, offsets, n_rows
# past the active rows, x misaligned by one element).  The kernel's tile is
# 32 * V plane columns: 128 in f32, 64 in f64.
EDGE_CASES = [
    ("nz 1, C 1", 3, (1, 5, 7), 1, "uniform", "stiffness", 17, False),
    ("a class with no planes", 4, (6, 3, 4), 6, "no_last", "stiffness", 0,
     False),
    ("one class with all planes", 4, (9, 3, 3), 3, "all_first", "stiffness",
     3, False),
    ("P < tile", 2, (5, 2, 3), 4, "uniform", "stiffness", 7, False),
    ("P not a multiple of the tile", 3, (4, 7, 11), 5, "uniform",
     "stiffness", 64, False),
    ("offsets up to 2P - 1", 2, (7, 2, 5), 3, "uniform", "wide", 9, False),
    ("B 1", 1, (8, 5, 5), 2, "uniform", "stiffness", 0, False),
    ("x off 16-byte alignment", 3, (5, 4, 6), 3, "uniform", "stiffness", 1,
     True),
]


def _edge_plane_dia(dtype, B, grid, C, layout, kind, extra, tail, seed):
    rng = np.random.default_rng(seed)
    nz, ny, nx = grid
    P = 3 * ny * nx
    if kind == "wide":
        offs = sorted({-(2 * P - 1), -P - 3, -7, 0, 1, 9, P + 4, 2 * P - 1})
    else:
        offs = [o for o in _stiffness_offsets(grid) if abs(o) < 2 * P]
    if layout == "uniform":
        kz = rng.integers(0, C, (B, nz))
    elif layout == "no_last":
        kz = rng.integers(0, C - 1, (B, nz))
    else:
        kz = np.zeros((B, nz), np.int64)
    n = nz * P + extra
    vals = torch.from_numpy(rng.standard_normal((C, len(offs), P))).to(dtype)
    pd = PlaneDia(vals.cuda(), torch.from_numpy(kz.astype(np.int32)).cuda(),
                  tuple(offs), n, P, tail_identity=tail)
    return pd, torch.from_numpy(rng.standard_normal((B, n))).to(dtype), n


@pytest.mark.parametrize("tail", [True, False])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_k1_edge_shapes_match_plain_on_card(case, dtype, rtol, tail):
    """One launch per call writes the active and the tail rows, at shapes
    at the edges of the kernel's plan and tiles."""
    _need_card()
    label, B, grid, C, layout, kind, extra, misalign = case
    pd, x_host, n = _edge_plane_dia(dtype, B, grid, C, layout, kind, extra,
                                    tail, seed=len(label))
    if misalign:
        buf = torch.empty(B * n + 1, dtype=dtype, device="cuda")
        x = buf[1:].view(B, n)
        x.copy_(x_host)
        assert x.data_ptr() % 16 != 0
    else:
        x = x_host.cuda()
    before = K.LAUNCHES
    y = K.plane_dia_mv(pd, x)
    assert K.LAUNCHES == before + 1
    y_plain = K.plane_dia_mv_plain(pd, x)
    torch.cuda.synchronize()
    scale = float(y_plain.abs().max())
    assert scale > 0
    assert float((y - y_plain).abs().max()) <= rtol * scale


def test_k1_refuses_offsets_past_two_planes_on_card():
    _need_card()
    P = 6
    pd = PlaneDia(torch.ones((1, 2, P), device="cuda"),
                  torch.zeros((1, 3), dtype=torch.int32, device="cuda"),
                  (0, 2 * P), 3 * P, P)
    with pytest.raises(ValueError):
        K.plane_dia_mv(pd, torch.ones((1, 3 * P), device="cuda"))


def test_k1_wrapper_casts_and_refuses_on_card():
    """The wrapper computes in the table's dtype and returns the promoted
    dtype; it refuses a half-precision table and a batch that is not the
    table's."""
    _need_card()
    rng = np.random.default_rng(1)
    pd = _plane_dia(rng, torch.float32, 4, (4, 3, 3), 2, 120, True)
    x = torch.from_numpy(rng.standard_normal((2, 120))).cuda()
    y = K.plane_dia_mv(pd, x)
    assert y.dtype == torch.float64
    y_plain = K.plane_dia_mv_plain(pd, x.float())
    torch.cuda.synchronize()
    scale = float(y_plain.abs().max())
    assert float((y.float() - y_plain).abs().max()) <= 1e-5 * scale
    with pytest.raises(ValueError):
        K.plane_dia_mv(pd, torch.zeros((3, 120), dtype=torch.float32,
                                       device="cuda"))
    pd.vals = pd.vals.half()
    with pytest.raises(TypeError):
        K.plane_dia_mv(pd, x)


@pytest.mark.parametrize("tail", [True, False])
def test_dia_card_branch_matches_cpu_branch(tail):
    """Plain Dia.mv gathers all windows at once on the card and multiplies
    strided views on the CPU: both give the same y in f64, at the guard
    slabs' size (6 bodies, a 3 x 25 x 25 node grid, padded to 6656 rows)."""
    _need_card()
    rng = np.random.default_rng(2)
    grid, B, n = (3, 25, 25), 6, 6656
    offs = tuple(_stiffness_offsets(grid))
    na = 3 * grid[0] * grid[1] * grid[2]
    vals = torch.from_numpy(rng.standard_normal((B, len(offs), na)))
    x = torch.from_numpy(rng.standard_normal((B, n)))
    y_cpu = Dia(vals, offs, n, tail_identity=tail).mv(x)
    y_gpu = Dia(vals.cuda(), offs, n, tail_identity=tail).mv(x.cuda())
    scale = float(y_cpu.abs().max())
    assert float((y_gpu.cpu() - y_cpu).abs().max()) <= 1e-12 * scale


def test_small_block_card_matches_cpu(monkeypatch):
    _need_card()
    import ddpca_admm_tpu_torch.solvers.mg as mgmod
    import ddpca_admm_tpu_torch.sparse.bell as bell
    from ddpca_admm_tpu_torch.admm.loop import contact_analysis
    from ddpca_admm_tpu_torch.admm.problem import build_problem
    from ddpca_admm_tpu_torch.models.block import (
        BlockConfig,
        build_block_model,
    )

    monkeypatch.setattr(bell, "BELL_MAX_BYTES", 0)
    monkeypatch.setattr(mgmod, "DIA_LATENCY_BYTES", 0)
    model = build_block_model(
        BlockConfig(divi=(2, 2, 2), glob_leve=1, doma_numb=(1, 1, 1)))
    states = {}
    for dev in ("cpu", "cuda"):
        prob, meta = build_problem(model.systems, model.regions,
                                   dole=[0] * len(model.systems), device=dev)
        before = K.LAUNCHES
        states[dev] = contact_analysis(prob, tuple(meta.group_modes),
                                       max_iter=1500, device=dev)
        launched = K.LAUNCHES - before
    assert launched > 0
    cpu, gpu = states["cpu"], states["cuda"]
    assert cpu.converged and gpu.converged and cpu.it == gpu.it
    scale = float(cpu.u.abs().max())
    assert float((gpu.u.cpu() - cpu.u).abs().max()) <= 1e-6 * scale


def _card_and_cpu_states(build, max_iter):
    """Solve the problem ``build(device)`` gives on the CPU and on the card;
    returns the two states."""
    from ddpca_admm_tpu_torch.admm.loop import contact_analysis

    states = {}
    for dev in ("cpu", "cuda"):
        prob, meta = build(dev)
        states[dev] = contact_analysis(prob, tuple(meta.group_modes),
                                       max_iter=max_iter, device=dev)
    return states["cpu"], states["cuda"]


def _assert_card_matches_cpu(cpu, gpu, tol=1e-8):
    """The same iteration count, and u, z, lambda, gamma within ``tol`` of
    their largest entries."""
    assert cpu.it == gpu.it and cpu.converged == gpu.converged
    pairs = [(cpu.u, gpu.u)]
    for gc, gg in zip(cpu.groups, gpu.groups):
        pairs += [(gc.z, gg.z), (gc.lam, gg.lam), (gc.gamma, gg.gamma)]
    for a, b in pairs:
        scale = float(a.abs().max())
        assert float((b.cpu() - a).abs().max()) <= tol * scale


@pytest.mark.parametrize("fric,max_iter", [(0.4, 300), (0.05, 40)],
                         ids=["stick", "slide"])
def test_friction_boxes_card_match_cpu(fric, max_iter):
    """Coulomb friction (vector mode, the cone clip) on the stacked boxes
    of the JAX package's friction test, held after a fixed count."""
    _need_card()
    from ddpca_admm_tpu_torch.models.simple import stacked_boxes_problem

    def build(dev):
        prob, meta, _ = stacked_boxes_problem(
            div_bot=3, div_top=2, levels=0, pressure=-1.0e7, fric=fric,
            shear=1.0e6, device=dev)
        return prob, meta

    cpu, gpu = _card_and_cpu_states(build, max_iter)
    assert gpu.it == max_iter
    _assert_card_matches_cpu(cpu, gpu)


@pytest.mark.parametrize("musc", [1, 2])
@pytest.mark.parametrize("solver", ["direct", "ddmg"])
def test_coarse_variants_card_match_cpu(solver, musc):
    """Coarse correction variant A (musc_sett 1) and B (2) with the dense
    and the DD-multigrid coarse solve, on the refined stacked boxes."""
    _need_card()
    from ddpca_admm_tpu_torch.admm.problem import build_problem
    from ddpca_admm_tpu_torch.models import simple as S

    _, _, bodies = S.stacked_boxes_problem(div_bot=3, div_top=2, levels=1,
                                           device="cpu")
    rho = S.penalty(25.0, S.char_length(bodies))
    regions = [S.make_region(
        bodies, 0, 1, S.plane_predicate(2, 1.0), S.plane_predicate(2, 1.0),
        lambda x: x[:, :2], (6,) * 2, fric=0.0, pena_n=rho)]
    systems = S.assemble_bodies(bodies, regions)

    def build(dev):
        return build_problem(systems, regions, dole=[1, 1], musc_sett=musc,
                             meshes=[b.mesh for b in bodies],
                             coarse_solver=solver, device=dev)

    cpu, gpu = _card_and_cpu_states(build, 800)
    assert cpu.converged
    _assert_card_matches_cpu(cpu, gpu)


@pytest.mark.parametrize("solver", ["bicgstab", "gmres"])
def test_krylov_card_matches_cpu(solver):
    """BiCGSTAB and GMRES with the Jacobi preconditioner on a batch of two
    random nonsymmetric systems held as an ELL matrix: the same iteration
    count on the card and the CPU, x within 1e-10 of its largest entry."""
    _need_card()
    import scipy.sparse as sp

    from ddpca_admm_tpu_torch.solvers import krylov
    from ddpca_admm_tpu_torch.sparse.ell import stack_ells

    rng = np.random.default_rng(2)
    n = 600
    mats = [(sp.random(n, n, density=0.01, random_state=rng, format="csr")
             + sp.diags(4.0 + rng.random(n))).tocsr() for _ in range(2)]
    e = stack_ells(mats)
    diag = torch.from_numpy(np.stack([m.diagonal() for m in mats]))
    b = torch.from_numpy(rng.standard_normal((2, n)))
    out = {}
    for dev in ("cpu", "cuda"):
        ed = type(e)(e.vals.to(dev), e.cols.to(dev), e.n_cols)
        out[dev] = getattr(krylov, solver)(
            ed.mv, krylov.jacobi_preconditioner(diag.to(dev)), b.to(dev))
    cpu, gpu = out["cpu"], out["cuda"]
    assert gpu.x.is_cuda and cpu.iters == gpu.iters > 0
    scale = float(cpu.x.abs().max())
    assert float((gpu.x.cpu() - cpu.x).abs().max()) <= 1e-10 * scale


@pytest.mark.parametrize("prec_type", [1, 2])
def test_lagrange_boxes_card_matches_cpu(prec_type):
    """The dual-mortar solve of the refined stacked boxes (Khat above 500
    rows: BiCGSTAB on the device, under the restricted-GMG V-cycle or
    Jacobi): the same Newton passes and states on the card and the CPU,
    BiCGSTAB iterations within 2 per pass, u and lambda within 1e-8 of
    their largest entries, and no K1 launch (every level is ELL)."""
    _need_card()
    from ddpca_admm_tpu_torch.admm.lagrange import solve_lagrange
    from ddpca_admm_tpu_torch.models import simple as S

    _, meta, bodies = S.stacked_boxes_problem(div_bot=3, div_top=2, levels=1,
                                              device="cpu")
    systems = S.assemble_bodies(bodies, meta.regions, include_penalty=False)
    res = {}
    for dev in ("cpu", "cuda"):
        before = K.LAUNCHES
        res[dev] = solve_lagrange(systems, meta.regions,
                                  [b.mesh for b in bodies],
                                  prec_type=prec_type, device=dev)
        assert K.LAUNCHES == before
    cpu, gpu = res["cpu"], res["cuda"]
    assert cpu.iters == gpu.iters
    assert all(p["krylov_iters"] is not None for p in gpu.passes)
    assert all(abs(a["krylov_iters"] - b["krylov_iters"]) <= 2
               for a, b in zip(cpu.passes, gpu.passes, strict=True))
    for a, b in zip(cpu.status, gpu.status, strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in ((cpu.u, gpu.u), (cpu.lagr, gpu.lagr)):
        a, b = np.concatenate(a), np.concatenate(b)
        assert float(np.abs(a - b).max()) <= 1e-8 * float(np.abs(a).max())
