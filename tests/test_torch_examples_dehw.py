"""DEHW, the worm drive, in the port against the JAX package at the JAX
package's test grid (``DehwGrid`` small: worm_numb (2,1,1,2,2), whee_numb
(2,2,1,2,2), glob_homo 1, loca_leve 1):

* the exact-surface grids, the ``CurvedSurface`` snapping plan and the
  ``adaptive_refine`` flags of one tooth pair, bit for bit;
* the DEHW and DEHW_1 (cross-corner) assemblies — bodies, meshes, hub
  loads, contact and interface regions — bit for bit;
* the solve with Coulomb friction (mu 0.08) and coarse correction variant A
  through the DD-multigrid coarse solver, after ``DEHW_ITERS`` fixed
  iterations: the same iteration and inner counts, and u, z, lambda, gamma
  within ``DEHW_TOL`` of their largest entries over all region groups.

The surfaces are built once per package with the disk cache off, so the
two builds share nothing."""

import numpy as np
import pytest
import torch

from torch_parity import (
    assert_bodies_same,
    assert_same,
    assert_states_match,
    format_signature,
)

torch.set_num_threads(1)

# The small DEHW does not converge in 3000 iterations in either package, and
# one iteration costs 25-70 s on one CPU core (its coarse DD-multigrid solve
# takes ~180 PCG iterations over 39,296 coarse rows), so the solves are held
# after one iteration here (chip_smoke.py holds the card against the CPU
# after two).  The tolerance is the one of the converged examples,
# relative to the largest entry over all region groups: the last group's two
# contact regions are open (gamma = 0), and their lambda is the mass solve's
# rounding noise, ~4e-5 against ~1.5e9 in the first group.
DEHW_ITERS = 1
DEHW_TOL = 1e-8


def _modules(pkg):
    if pkg == "jax":
        from ddpca_admm_tpu.contact import adaptive
        from ddpca_admm_tpu.mesh import curveds
        from ddpca_admm_tpu.models import dehw_assembly, dehw_surf
    else:
        from ddpca_admm_tpu_torch.contact import adaptive
        from ddpca_admm_tpu_torch.mesh import curveds
        from ddpca_admm_tpu_torch.models import dehw_assembly, dehw_surf
    return dehw_surf, dehw_assembly, curveds, adaptive


def _grid(dehw_surf):
    from ddpca_admm_tpu_torch.cli import SMALL_DEHW

    return dehw_surf.DehwGrid(**SMALL_DEHW)


@pytest.fixture(scope="module")
def dehw():
    out = {}
    for pkg in ("jax", "torch"):
        S, A, _, _ = _modules(pkg)
        grid = _grid(S)
        base = A.DehwDDConfig(grid=grid)
        surfs = S.build_surfaces(base.params, grid, cache=False)
        out[pkg] = {"surfs": surfs}
        for cross in (False, True):
            cfg = A.DehwDDConfig(grid=grid, cross_corner=cross)
            out[pkg][cross] = (cfg,) + A.build_dehw_assembly(cfg, surfs=surfs)
    return out


def test_dehw_surfaces_match_jax_bit_for_bit(dehw):
    assert_same(dehw["torch"]["surfs"], dehw["jax"]["surfs"], "surfs")


def test_curved_surface_and_adaptive_refine_match_jax(dehw):
    """One AMR round of the first tooth pair, done by hand in each package
    on freshly built worm and wheel domains: the surface membership of
    their nodes, the snapping plan and the refine flag agree, and so do
    the refined meshes."""
    res = {}
    for pkg in ("jax", "torch"):
        S, A, C, AR = _modules(pkg)
        surfs = dehw[pkg]["surfs"]
        cfg = dehw[pkg][False][0]
        p, g = cfg.params, cfg.grid
        worm, _, _ = A.build_worm_domains(surfs, cfg.cent_erro, cfg.anal_angl)
        whee, _, _ = A.build_whee_domains(surfs, cfg.anal_angl,
                                          cfg.cent_erro)
        mast, slav = worm[2], whee[6]
        R_pl, t_pl = A.worm_placement(p, cfg.cent_erro, cfg.anal_angl)
        mast_surf = C.CurvedSurface(surfs.worm_tosu)
        mast_surf.rigid_transform(R_pl, t_pl)
        slav_surf = C.CurvedSurface(surfs.whee_tosu)
        slav_surf.rigid_transform(A._rotz(cfg.anal_angl[1]
                                          + 2.0 * np.pi / p.z[1]),
                                  np.zeros(3))
        on = mast_surf.contains(mast.coords)
        plan = mast_surf.plan_surf(mast, mast.leaf_elems())
        a_ce = p.a_h2 + cfg.cent_erro

        def cart_curv(c):
            c = np.asarray(c)
            return np.stack([c[..., 1], np.hypot(c[..., 0] + a_ce, c[..., 2])],
                            axis=-1)

        gigh = g.glob_inho + g.glob_homo
        flag = AR.adaptive_refine(
            mast, slav, mast_surf, slav_surf, level=gigh,
            dist_crit=cfg.dist_crit[0],
            buck_divisions=(g.worm_numb[4], g.worm_numb[3]),
            cart_curv=cart_curv,
        )
        res[pkg] = (on, plan, flag, mast, slav)
    (on_j, plan_j, flag_j, mast_j, slav_j) = res["jax"]
    (on, plan, flag, mast, slav) = res["torch"]
    assert on.any() and not on.all()
    np.testing.assert_array_equal(on, on_j)
    assert plan and plan.keys() == plan_j.keys()
    for k in plan:
        np.testing.assert_array_equal(plan[k], plan_j[k])
    assert flag is True and flag_j is True
    for m, m_j in ((mast, mast_j), (slav, slav_j)):
        np.testing.assert_array_equal(m.coords, m_j.coords)
        np.testing.assert_array_equal(m.elem_corn, m_j.elem_corn)
        np.testing.assert_array_equal(m.leaf_elems(), m_j.leaf_elems())


@pytest.mark.parametrize("cross_corner", [False, True],
                         ids=["dehw", "dehw_1"])
def test_dehw_assembly_matches_jax_bit_for_bit(dehw, cross_corner):
    _, bodies_j, regions_j, info_j = dehw["jax"][cross_corner]
    _, bodies, regions, info = dehw["torch"][cross_corner]
    assert info["n_worm"] == 34 and info["n_whee"] == 18
    assert_same(info, info_j, "info")
    assert_bodies_same(bodies, bodies_j)
    assert len(regions) == len(regions_j)
    for r, (r_port, r_ref) in enumerate(zip(regions, regions_j)):
        assert_same(r_port, r_ref, f"regions[{r}]")
    fric = {float(r.region.fric) for r, k in zip(regions, info["region_kinds"])
            if k[0] == "contact"}
    assert fric == {0.08}


def test_dehw_solve_matches_jax_after_fixed_iterations(dehw):
    from ddpca_admm_tpu.admm.loop import (
        contact_analysis as jax_contact_analysis,
    )
    from ddpca_admm_tpu_torch.admm.loop import contact_analysis

    probs = {}
    for pkg in ("jax", "torch"):
        _, A, _, _ = _modules(pkg)
        cfg, bodies, regions, _ = dehw[pkg][False]
        kw = {"device": "cpu"} if pkg == "torch" else {}
        probs[pkg] = A.finalize_dehw_problem(bodies, regions, cfg, **kw)
    (prob_j, meta_j), (prob, meta) = probs["jax"], probs["torch"]
    assert meta.group_modes == meta_j.group_modes
    assert set(meta.group_modes) == {"vector"}
    # variant A through the DD-multigrid coarse solve, as in the JAX build
    assert len(prob.coarse) == 1 and prob.coarse[0].mg is not None
    assert prob_j.coarse[0].mg is not None
    sig = format_signature(prob)
    assert sig == format_signature(prob_j)
    assert {f for _, f in sig if isinstance(f, str)} == {"Ell"}
    ref = jax_contact_analysis(prob_j, tuple(meta_j.group_modes),
                               max_iter=DEHW_ITERS)
    st = contact_analysis(prob, tuple(meta.group_modes), max_iter=DEHW_ITERS,
                          device="cpu")
    assert st.it == DEHW_ITERS
    assert st.inner_iters == int(ref.inner_iters)
    assert_states_match(st, ref, tol=DEHW_TOL, converged=False,
                        across_groups=True)
    # the contact points carry traction, within the Coulomb cone
    n_active = 0
    for g, gs in zip(prob.groups, st.groups):
        gam = gs.gamma.reshape(gs.gamma.shape[0], -1, 3)
        mu = g.fric[:, None]
        t = torch.hypot(gam[..., 1], gam[..., 2])
        fr = (mu > 0) & (gam[..., 0] > 0)
        n_active += int(fr.sum())
        assert bool((t[fr] <= (mu.expand_as(t)[fr] * gam[..., 0][fr])
                     * (1 + 1e-12)).all())
    assert n_active > 0
