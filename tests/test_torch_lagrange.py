"""The port's BiCGSTAB, GMRES and dual-mortar LAGRANGE solver against the
JAX package's on the same inputs, on the CPU.

Krylov: a batch of two random nonsymmetric systems (dense matvec, n=40, as
tests/test_aux.py) and an ELL matrix, with the Jacobi preconditioner: the
same iteration count and x within 1e-10 of its largest entry.

LAGRANGE: the stacked boxes (patch test, and the friction fixture of
tests/test_lagrange.py with its slide/stick transitions) through the host
``spsolve`` and, at one refinement level, through BiCGSTAB under both
preconditioners; and the BLOCK divi-2 monolithic case against the port's
own ADMM solve.  Each case gives the same Newton ``iters``, the same
``status`` and ``nm_nodes`` arrays, and u and lambda within 1e-8 of their
largest entries; the JAX tests' own oracles (patch test, transitions,
Coulomb cone) are restated for the port.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ddpca_admm_tpu.admm.lagrange as jlag
import ddpca_admm_tpu.models.simple as jsimple
import ddpca_admm_tpu.solvers.krylov as jkrylov
import ddpca_admm_tpu_torch.admm.lagrange as tlag
import ddpca_admm_tpu_torch.models.simple as tsimple
from ddpca_admm_tpu.sparse.ell import ell_from_csr as jell_from_csr
from ddpca_admm_tpu.sparse.ell import to_device
from ddpca_admm_tpu_torch.solvers import krylov as tkrylov
from ddpca_admm_tpu_torch.sparse.ell import Ell, ell_from_csr

import jax.numpy as jnp

# the suite runs one worker per file on a shared CPU: one torch thread each
torch.set_num_threads(1)

X_TOL = 1e-10     # Krylov x against the JAX package's, of max|x|
TOL = 1e-8        # LAGRANGE u and lambda, of their largest entries
E, NU, P = 210.0e9, 0.3, -1.0e7
FRICTION = dict(pressure=-1.0e7, fric=0.15, shear=1.2e6)


# ------------------------------------------------------------------ Krylov

def _dense_case():
    rng = np.random.default_rng(0)
    n = 40
    A = np.eye(n) * 4.0 + 0.5 * rng.standard_normal((n, n))
    b = rng.standard_normal((2, n)) @ A.T
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    return (lambda x: x @ At.T), (lambda x: x @ Aj.T), np.diag(A).copy(), b


def _ell_case():
    rng = np.random.default_rng(1)
    n = 300
    A = sp.random(n, n, density=0.03, random_state=rng, format="csr")
    A = (A + sp.diags(4.0 + rng.random(n))).tocsr()
    vals, cols, n_cols = ell_from_csr(A)
    te = Ell(torch.from_numpy(vals), torch.from_numpy(cols), n_cols)
    je = to_device(jell_from_csr(A))
    b = rng.standard_normal(n)
    return te.mv, je.mv, A.diagonal(), b


@pytest.mark.parametrize("solver", ["bicgstab", "gmres"])
@pytest.mark.parametrize("case", [_dense_case, _ell_case],
                         ids=["dense_batch2", "ell"])
def test_krylov_matches_jax(solver, case):
    t_mv, j_mv, diag, b = case()
    res = getattr(tkrylov, solver)(
        t_mv, tkrylov.jacobi_preconditioner(torch.from_numpy(diag)),
        torch.from_numpy(b))
    ref = getattr(jkrylov, solver)(
        j_mv, jkrylov.jacobi_preconditioner(jnp.asarray(diag)),
        jnp.asarray(b))
    assert isinstance(res.iters, int) and res.iters > 0
    assert res.iters == int(ref.iters)
    x_ref = np.asarray(ref.x)
    err = float(np.abs(res.x.numpy() - x_ref).max())
    assert err <= X_TOL * float(np.abs(x_ref).max())
    # and the solution solves the system
    assert float(res.res_norm.max()) <= 1e-10 * float(np.abs(b).max())


# ---------------------------------------------------------------- LAGRANGE

def _spy_jax_bicgstab(monkeypatch):
    """Record the JAX package's BiCGSTAB iterations per Newton pass."""
    iters = []
    real = jlag.bicgstab

    def spy(*a, **kw):
        res = real(*a, **kw)
        iters.append(int(res.iters))
        return res

    monkeypatch.setattr(jlag, "bicgstab", spy)
    return iters


def _solve_both(monkeypatch, build_jax, build_port, **kw):
    """The same problem through both packages' solve_lagrange; returns
    (port result, JAX result, JAX BiCGSTAB iterations per pass, port
    bodies, port systems)."""
    jax_iters = _spy_jax_bicgstab(monkeypatch)
    jbodies, jregions = build_jax()
    tbodies, tregions = build_port()
    js = jsimple.assemble_bodies(jbodies, jregions, include_penalty=False)
    ts = tsimple.assemble_bodies(tbodies, tregions, include_penalty=False)
    ref = jlag.solve_lagrange(js, jregions, [b.mesh for b in jbodies], **kw)
    res = tlag.solve_lagrange(ts, tregions, [b.mesh for b in tbodies],
                              device="cpu", **kw)
    return res, ref, jax_iters, tbodies, ts


def _assert_results_match(res, ref, jax_iters):
    assert res.iters == ref.iters
    for a, b in zip(res.status, ref.status, strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(res.nm_nodes, ref.nm_nodes, strict=True):
        np.testing.assert_array_equal(a, b)
    for name, a, b in (("u", res.u, ref.u), ("lagr", res.lagr, ref.lagr)):
        a, b = np.concatenate(a), np.concatenate(b)
        assert a.shape == b.shape, name
        err = float(np.abs(a - b).max())
        assert err <= TOL * float(np.abs(b).max()), (name, err)
    port_iters = [p["krylov_iters"] for p in res.passes
                  if p["krylov_iters"] is not None]
    assert len(port_iters) == len(jax_iters)
    # the f32 V-cycle sums in another order on each side
    assert all(abs(a - b) <= 2 for a, b in zip(port_iters, jax_iters))
    assert len(res.passes) == res.iters + 1


def _boxes(levels, **fixture):
    def build(mod):
        def go():
            kw = dict(device="cpu") if mod is tsimple else {}
            _, meta, bodies = mod.stacked_boxes_problem(
                div_bot=3, div_top=2, levels=levels, **fixture, **kw)
            return bodies, meta.regions
        return go
    return build(jsimple), build(tsimple)


def _assert_patch(bodies, systems, u):
    """The contact patch test: u_z = p z / E in every body."""
    for b, (body, sysm) in enumerate(zip(bodies, systems)):
        uz = sysm.full_displacement(u[b])[2::3]
        expect = P * body.mesh.coords[:, 2] / E
        scale = np.abs(expect).max()
        assert np.allclose(uz, expect, atol=5e-4 * scale), b


def test_lagrange_boxes_patch_matches_jax(monkeypatch):
    res, ref, jax_iters, bodies, systems = _solve_both(
        monkeypatch, *_boxes(0), use_device=False)
    _assert_results_match(res, ref, jax_iters)
    _assert_patch(bodies, systems, res.u)
    # all nodes in contact: every status active, uniform-sign multipliers
    assert all((s == 1).all() for s in res.status)
    lam_n = res.lagr[0][0::3]
    assert (lam_n < 0).all() or (lam_n > 0).all()
    assert all(p["krylov_iters"] is None for p in res.passes)


def test_lagrange_friction_slide_stick_matches_jax(monkeypatch):
    """The semi-smooth Newton friction state machine (MCONTACT.h:
    3639-3689): nodes start sticking (2); low-pressure nodes end sliding (1)
    with no stored tangential multiplier, sticking ones inside the cone."""
    mu = FRICTION["fric"]
    res, ref, jax_iters, _, _ = _solve_both(
        monkeypatch, *_boxes(0, **FRICTION), use_device=False)
    _assert_results_match(res, ref, jax_iters)
    st = res.status[0]
    assert res.iters >= 1
    assert (st == 1).sum() >= 1 and (st == 2).sum() >= 1
    lam = res.lagr[0].reshape(-1, 3)
    lam_n, lam_t = np.abs(lam[:, 0]), np.hypot(lam[:, 1], lam[:, 2])
    slide, stick = st == 1, st == 2
    assert np.allclose(lam_t[slide], 0.0, atol=1e-6 * lam_n.max())
    assert (lam_t[stick] <= mu * lam_n[stick] * (1 + 1e-8)).all()


@pytest.mark.parametrize("prec_type", [1, 2])
def test_lagrange_bicgstab_path_matches_jax(monkeypatch, prec_type):
    """One refinement level: Khat passes 500 rows, so each Newton pass runs
    BiCGSTAB (1: restricted-GMG V-cycle, 2: Jacobi) on the torch device."""
    res, ref, jax_iters, bodies, systems = _solve_both(
        monkeypatch, *_boxes(1), use_device=True, prec_type=prec_type)
    assert all(p["khat_rows"] > 500 and p["krylov_iters"] > 0
               for p in res.passes)
    _assert_results_match(res, ref, jax_iters)
    _assert_patch(bodies, systems, res.u)


def test_lagrange_block_matches_jax_and_port_admm(monkeypatch):
    """The cross-solver oracle of tests/test_lagrange.py on the BLOCK
    geometry (3 blocks + guard slabs, divi 2, glob_leve 1, no DD): the
    port's LAGRANGE against the JAX package's, and against the port's own
    ADMM solve within 1e-3 of |p| H / E."""
    from ddpca_admm_tpu.models.block import BlockConfig as JCfg
    from ddpca_admm_tpu.models.block import build_block_model as jbuild
    from ddpca_admm_tpu_torch.admm.loop import contact_analysis
    from ddpca_admm_tpu_torch.admm.problem import build_problem
    from ddpca_admm_tpu_torch.models.block import BlockConfig, \
        build_block_model

    kw = dict(divi=(2, 2, 2), glob_leve=1, doma_numb=(1, 1, 1))
    model = build_block_model(BlockConfig(**kw))

    def jax_model():
        m = jbuild(JCfg(**kw))
        return m.bodies, m.regions

    res, ref, jax_iters, _, systems = _solve_both(
        monkeypatch, jax_model, lambda: (model.bodies, model.regions),
        use_device=False)
    _assert_results_match(res, ref, jax_iters)

    prob, meta = build_problem(model.systems, model.regions,
                               dole=[0] * len(model.systems), device="cpu")
    st = contact_analysis(prob, tuple(meta.group_modes), max_iter=1500,
                          device="cpu")
    assert st.converged
    u_admm = st.u.numpy()
    scale = 1.0e7 * 0.075 / 210.0e9   # |p| H / E
    for b, sysm in enumerate(systems):
        ua = meta.systems[b].full_displacement(
            u_admm[b][: meta.systems[b].n_dof])
        ul = sysm.full_displacement(res.u[b])
        assert np.abs(ua - ul).max() / scale < 1e-3, b


def test_lagrange_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, meta, bodies = tsimple.stacked_boxes_problem(
        div_bot=2, div_top=2, levels=0, device="cpu")
    systems = tsimple.assemble_bodies(bodies, meta.regions,
                                      include_penalty=False)
    with pytest.raises(RuntimeError, match="cuda"):
        tlag.solve_lagrange(systems, meta.regions, [b.mesh for b in bodies])
