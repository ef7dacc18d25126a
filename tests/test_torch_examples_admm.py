"""The port's ADMM solve paths that the examples past BLOCK depend on,
each built by the port's own host code and solved with ``device="cpu"``,
against the JAX package's build and solve of the same problem: Coulomb
friction (vector mode, cone clip), coarse correction variant A (and B)
with the direct and the DD-multigrid coarse solver, the composed coarse
operators, BLOCK_1, BEAM and the per-iteration monitor history.  Each holds
the same iteration count and u, z, lambda (and gamma) within 1e-8 of their
largest entries (``torch_parity.TOL``)."""

import numpy as np
import pytest
import torch

from ddpca_admm_tpu.admm.loop import contact_analysis as jax_contact_analysis
from ddpca_admm_tpu.admm.problem import build_problem as jax_build_problem
from ddpca_admm_tpu_torch.admm.loop import contact_analysis
from ddpca_admm_tpu_torch.admm.problem import build_problem
from torch_parity import TOL, assert_states_match

# the suite runs one worker per file on a shared CPU: one torch thread each
torch.set_num_threads(1)

MU, TAU, PRESSURE = 0.4, 1.0e6, -1.0e7


def _boxes(pkg, **kw):
    if pkg == "jax":
        from ddpca_admm_tpu.models.simple import stacked_boxes_problem

        return stacked_boxes_problem(**kw)
    from ddpca_admm_tpu_torch.models.simple import stacked_boxes_problem

    return stacked_boxes_problem(device="cpu", **kw)


def test_friction_stacked_boxes_matches_jax():
    """The stacked boxes of the JAX package's friction test (mu 0.4, shear
    1e6): pressure tilts and the Coulomb cone holds at every point."""
    kw = dict(div_bot=3, div_top=2, levels=0, pressure=PRESSURE, fric=MU,
              shear=TAU)
    prob_j, meta_j, _ = _boxes("jax", **kw)
    prob, meta, _ = _boxes("torch", **kw)
    assert meta.group_modes == meta_j.group_modes == ["vector"]
    assert float(prob.groups[0].fric[0]) == MU
    ref = jax_contact_analysis(prob_j, tuple(meta_j.group_modes),
                               max_iter=3000)
    st = contact_analysis(prob, tuple(meta.group_modes), max_iter=3000,
                          device="cpu")
    assert_states_match(st, ref)

    ip = meta.regions[0].region.ip
    gamma = st.groups[0].gamma[0].numpy()[: 3 * ip.n].reshape(-1, 3)
    w = ip.weight
    assert np.isclose((w * gamma[:, 0]).sum(), -PRESSURE, rtol=1e-6)
    assert gamma[:, 0].min() < -PRESSURE - 4.0 * TAU
    assert gamma[:, 0].max() > -PRESSURE + 4.0 * TAU
    tx = (w * (gamma[:, 1] * ip.basis[:, 1, 0]
               + gamma[:, 2] * ip.basis[:, 2, 0])).sum()
    assert np.isclose(abs(tx), TAU, rtol=1e-2)
    # the Coulomb cone at every integral point
    assert (np.hypot(gamma[:, 1], gamma[:, 2])
            <= MU * gamma[:, 0] * (1 + 1e-8) + 1.0).all()


def test_friction_cone_clips_sliding_points():
    """A shear above mu*|p| slides: the cone clip is active, and the port's
    projection gives the JAX package's after a fixed number of steps."""
    kw = dict(div_bot=3, div_top=2, levels=0, pressure=PRESSURE, fric=0.05,
              shear=TAU)
    prob_j, meta_j, _ = _boxes("jax", **kw)
    prob, meta, _ = _boxes("torch", **kw)
    ref = jax_contact_analysis(prob_j, tuple(meta_j.group_modes),
                               max_iter=40)
    st = contact_analysis(prob, tuple(meta.group_modes), max_iter=40,
                          device="cpu")
    assert_states_match(st, ref, converged=None)
    ip = meta.regions[0].region.ip
    gamma = st.groups[0].gamma[0].numpy()[: 3 * ip.n].reshape(-1, 3)
    t = np.hypot(gamma[:, 1], gamma[:, 2])
    on_cone = np.isclose(t, 0.05 * gamma[:, 0], rtol=1e-9)
    assert on_cone.any()
    assert (t <= 0.05 * gamma[:, 0] * (1 + 1e-8) + 1.0).all()


@pytest.fixture(scope="module")
def boxes_levels1():
    """The refined stacked boxes of the JAX package's coarse-solver test,
    built by both packages, with the frictionless region it makes."""
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            from ddpca_admm_tpu.models import simple as S
        else:
            from ddpca_admm_tpu_torch.models import simple as S
        _, _, bodies = _boxes(pkg, div_bot=3, div_top=2, levels=1)
        rho = S.penalty(25.0, S.char_length(bodies))
        regions = [
            S.make_region(
                bodies, 0, 1,
                S.plane_predicate(2, 1.0), S.plane_predicate(2, 1.0),
                lambda x: x[:, :2], (6,) * 2, fric=0.0, pena_n=rho,
            )
        ]
        systems = S.assemble_bodies(bodies, regions)
        out[pkg] = (systems, regions, [b.mesh for b in bodies])
    return out


@pytest.mark.parametrize("musc", [1, 2])
@pytest.mark.parametrize("solver", ["direct", "ddmg"])
def test_coarse_variants_match_jax(boxes_levels1, solver, musc):
    """Coarse correction variant A (musc_sett 1) and B (2), with the dense
    coarse inverse and the DD-multigrid coarse solve (DOUBLE_M)."""
    results = {}
    for pkg, build in (("jax", jax_build_problem), ("torch", build_problem)):
        systems, regions, meshes = boxes_levels1[pkg]
        kw = dict(dole=[1, 1], musc_sett=musc, meshes=meshes,
                  coarse_solver=solver)
        if pkg == "torch":
            kw["device"] = "cpu"
        results[pkg] = build(systems, regions, **kw)
    (prob_j, meta_j), (prob, meta) = results["jax"], results["torch"]
    assert len(prob.coarse) == len(prob_j.coarse) == 1
    co, co_j = prob.coarse[0], prob_j.coarse[0]
    assert (co.mg is not None) == (co_j.mg is not None) == (solver == "ddmg")
    if co.mg is None:
        np.testing.assert_array_equal(co.inv.numpy(), np.asarray(co_j.inv))
    ref = jax_contact_analysis(prob_j, tuple(meta_j.group_modes), max_iter=800)
    st = contact_analysis(prob, tuple(meta.group_modes), max_iter=800,
                          device="cpu")
    assert_states_match(st, ref)


def _small_block(pkg, **kw):
    if pkg == "jax":
        from ddpca_admm_tpu.models.block import BlockConfig, build_block_model
    else:
        from ddpca_admm_tpu_torch.models.block import (
            BlockConfig,
            build_block_model,
        )
    return build_block_model(BlockConfig(**kw))


def test_composed_coarse_operators_match_jax(monkeypatch):
    """ComposedTranD/ComposedAccu (the large-problem path: F^T A and the
    accumulated prolongation applied through the hierarchy), switched on
    for the small BLOCK by DDPCA_COMPOSE_TRAND_MIN_DOFS=0 in both packages."""
    from ddpca_admm_tpu.admm.multiscale import ComposedAccu as JAccu
    from ddpca_admm_tpu.admm.multiscale import ComposedTranD as JTranD
    from ddpca_admm_tpu_torch.admm.multiscale import (
        ComposedAccu,
        ComposedTranD,
    )

    monkeypatch.setenv("DDPCA_COMPOSE_TRAND_MIN_DOFS", "0")
    kw = dict(divi=(2, 2, 2), glob_leve=1, doma_numb=(1, 1, 1))
    ref_model, model = _small_block("jax", **kw), _small_block("torch", **kw)
    dole = [1] * len(model.systems)
    prob_j, meta_j = jax_build_problem(ref_model.systems, ref_model.regions,
                                       dole=dole, musc_sett=2)
    prob, meta = build_problem(model.systems, model.regions, dole=dole,
                               musc_sett=2, device="cpu")
    assert isinstance(prob_j.coarse[0].tranD, JTranD)
    assert isinstance(prob_j.coarse[0].accu, JAccu)
    assert isinstance(prob.coarse[0].tranD, ComposedTranD)
    assert isinstance(prob.coarse[0].accu, ComposedAccu)
    ref = jax_contact_analysis(prob_j, tuple(meta_j.group_modes), max_iter=800)
    st = contact_analysis(prob, tuple(meta.group_modes), max_iter=800,
                          device="cpu")
    assert_states_match(st, ref)


def test_block1_cross_corner_matches_jax():
    """BLOCK_1: no guard slabs, subdomain corners on the contact planes."""
    kw = dict(divi=(2, 2, 2), glob_leve=1, doma_numb=(2, 2, 2),
              guard_slabs=False)
    ref_model, model = _small_block("jax", **kw), _small_block("torch", **kw)
    assert len(model.bodies) == 24
    dole = [0] * len(model.bodies)
    prob_j, meta_j = jax_build_problem(ref_model.systems, ref_model.regions,
                                       dole=dole)
    prob, meta = build_problem(model.systems, model.regions, dole=dole,
                               device="cpu")
    ref = jax_contact_analysis(prob_j, tuple(meta_j.group_modes),
                               max_iter=1500)
    st = contact_analysis(prob, tuple(meta.group_modes), max_iter=1500,
                          device="cpu")
    assert_states_match(st, ref)
    # the patch test: u_z = p z / E in every body
    E, p = 210.0e9, -1.0e7
    scale = abs(p) * 0.075 / E
    u = st.u.numpy()
    for b, (body, sysm) in enumerate(zip(model.bodies, meta.systems)):
        full = sysm.full_displacement(u[b][: sysm.n_dof])
        expect = p * body.mesh.coords[:, 2] / E
        assert np.abs(full[2::3] - expect).max() <= 1e-4 * scale


def test_beam_matches_jax_and_unsplit_solve():
    """BEAM at the JAX package's test configuration: the port's DD solve
    against the JAX solve, and against the unsplit single-body spsolve
    within 2e-3 (the reference's SOLVE_NODD oracle)."""
    import scipy.sparse.linalg as spla

    from ddpca_admm_tpu.models.beam import BeamConfig as JBeamConfig
    from ddpca_admm_tpu.models.beam import build_beam_model as jax_build_beam
    from ddpca_admm_tpu_torch.fem.assembly import assemble_stiffness
    from ddpca_admm_tpu_torch.fem.constraints import constrain
    from ddpca_admm_tpu_torch.mesh.hexmesh import HexMesh
    from ddpca_admm_tpu_torch.models.beam import (
        BeamConfig,
        _beam_load,
        build_beam_model,
        straight_grid,
        twist_map,
    )
    from ddpca_admm_tpu_torch.models.simple import Body

    kw = dict(divi=(4, 2, 2), doma=(2, 1, 1), glob_leve=1)
    prob_j, meta_j, _, _ = jax_build_beam(JBeamConfig(**kw))
    prob, meta, bodies, cfg = build_beam_model(BeamConfig(**kw),
                                               device="cpu")
    ref = jax_contact_analysis(prob_j, tuple(meta_j.group_modes),
                               max_iter=2000)
    st = contact_analysis(prob, tuple(meta.group_modes), max_iter=2000,
                          device="cpu")
    assert_states_match(st, ref)

    m = HexMesh()
    m.add_box_grid(
        np.zeros(3), np.ones(3), cfg.divi,
        coords_fn=straight_grid(cfg, np.zeros(3), cfg.divi, cfg.divi,
                                (0, 0, 0)),
    )
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
    )
    scale = np.abs(u_mono).max()
    worst = 0.0
    u = st.u.numpy()
    for b, bsys in enumerate(meta.systems):
        full = bsys.full_displacement(u[b][: bsys.n_dof])
        ids = m.add_nodes(bodies[b].mesh.coords)
        d = full.reshape(-1, 3) - u_mono.reshape(-1, 3)[ids]
        worst = max(worst, float(np.linalg.norm(d, axis=1).max()))
    assert worst < 2e-3 * scale, worst / scale


def test_record_moni_history_matches_jax():
    """``record_moni``: every iteration's monitor ratios (resuMoni.txt) in
    a max_iter-row history, rows past convergence left at +inf."""
    kw = dict(div_bot=3, div_top=2, levels=0)
    prob_j, meta_j, _ = _boxes("jax", **kw)
    prob, meta, _ = _boxes("torch", **kw)
    ref = jax_contact_analysis(prob_j, tuple(meta_j.group_modes),
                               max_iter=800, record_moni=True)
    st = contact_analysis(prob, tuple(meta.group_modes), max_iter=800,
                          record_moni=True, device="cpu")
    assert_states_match(st, ref)
    hist, hist_j = st.moni_hist.numpy(), np.asarray(ref.moni_hist)
    assert hist.shape == hist_j.shape and hist.shape[0] == 800
    n = st.it
    assert np.isinf(hist[n:]).all() and np.isinf(hist_j[n:]).all()
    # the first row's body ratio is 0/0 in both packages (u = du = 0 there)
    nan = np.isnan(hist_j[:n])
    np.testing.assert_array_equal(np.isnan(hist[:n]), nan)
    assert np.isfinite(hist[:n][~nan]).all()
    # ratios relative to each column's largest entry
    h, hj = np.where(nan, 0.0, hist[:n]), np.where(nan, 0.0, hist_j[:n])
    assert (np.abs(h - hj) <= TOL * np.abs(hj).max(axis=0)).all()
    # without recording, one row is overwritten each iteration
    st1 = contact_analysis(prob, tuple(meta.group_modes), max_iter=800,
                           device="cpu")
    assert st1.moni_hist.shape == (1, hist.shape[1])
    np.testing.assert_array_equal(st1.moni_hist.numpy()[0], hist[n - 1])
