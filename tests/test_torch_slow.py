"""The slice's own size on the CPU: BLOCK glob_leve=2 (180,684 DOF) solved
by the port (on operators carried over from the JAX build) against the JAX
package's CPU solve, which takes 20 ADMM iterations; and, at BLOCK
glob_leve=1 without domain decomposition, why the two packages' Jacobi
BiCGSTAB counts differ.  Takes minutes:

    JAX_PLATFORMS=cpu python -m pytest -q -s -m slow tests/test_torch_slow.py
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ddpca_admm_tpu.solvers.krylov as jkrylov
import ddpca_admm_tpu_torch.admm.lagrange as tlag
import ddpca_admm_tpu_torch.models.block as tblock
from ddpca_admm_tpu.admm.problem import build_problem as jax_build_problem
from ddpca_admm_tpu.models.block import BlockConfig, build_block_model
from ddpca_admm_tpu.sparse.ell import Ell as JEll
from ddpca_admm_tpu_torch.models.simple import assemble_bodies
from ddpca_admm_tpu_torch.solvers import krylov as tkrylov
from ddpca_admm_tpu_torch.sparse.ell import Ell
from test_torch_admm import assert_states_match, solve_both


@pytest.mark.slow
def test_block_leve2_matches_jax():
    cfg = BlockConfig(divi=(6, 6, 6), glob_leve=2, doma_numb=(2, 2, 2))
    model = build_block_model(cfg)
    prob, meta = jax_build_problem(model.systems, model.regions,
                                   dole=[1] * len(model.systems), musc_sett=2)
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)   # run alone: every core
    try:
        st, ref, port_prob = solve_both(prob, tuple(meta.group_modes),
                                        max_iter=100)
    finally:
        torch.set_num_threads(threads)
    assert int(ref.it) == 20
    assert any(type(op).__name__ == "PlaneDia"
               for op in port_prob.mg.A_top.ops)
    assert_states_match(st, ref)


class _Captured(Exception):
    pass


def _block_khat():
    """The first Newton pass's condensed system of BLOCK divi 6,
    glob_leve=1 without DD (Khat 22,573 rows), as the port's LAGRANGE hands
    it to BiCGSTAB: (ELL vals, ELL cols, Fhat)."""
    cfg = tblock.BlockConfig(divi=(6, 6, 6), glob_leve=1, doma_numb=(1, 1, 1))
    model = tblock.build_block_model(cfg)
    systems = assemble_bodies(model.bodies, model.regions,
                              include_penalty=False)
    cap = {}

    def spy(matvec, precond, b, **kw):
        cap.update(ell=matvec.__self__, b=b)
        raise _Captured

    orig, tlag.bicgstab = tlag.bicgstab, spy
    try:
        tlag.solve_lagrange(systems, model.regions,
                            [b.mesh for b in model.bodies], prec_type=2,
                            device="cpu")
    except _Captured:
        pass
    finally:
        tlag.bicgstab = orig
    return (cap["ell"].vals.numpy(), cap["ell"].cols.numpy(),
            cap["b"].numpy())


@pytest.mark.slow
def test_block_jacobi_bicgstab_drift_is_rounding():
    """The port's Jacobi BiCGSTAB takes a few more or fewer iterations than
    the JAX package's on this Khat.  The witness that rounding alone moves
    the count: the two solvers' preconditioner inputs (p, then s, in each
    iteration) agree to rounding (below 1e-13 relative) for the first six
    iterations and then drift apart geometrically, where a slip in the
    rho / alpha / omega recurrences would differ at O(1) from the second
    iteration on; and swapping only the matvec's summation order (ELL against
    scipy's CSR) moves either package's count as far."""
    vals, cols, b = _block_khat()
    n = b.size
    diag = np.where(cols == np.arange(n)[:, None], vals, 0.0).sum(-1)
    csr = sp.csr_matrix((vals.ravel(), (np.repeat(np.arange(n), vals.shape[1]),
                                        cols.ravel())), shape=(n, n))

    def jax_run(csr_mv=False, seen=None):
        jp = jkrylov.jacobi_preconditioner(jnp.asarray(diag))

        def prec(r):
            if seen is not None:
                jax.debug.callback(lambda x: seen.append(np.array(x)), r,
                                   ordered=True)
            return jp(r)

        @jax.jit
        def run(v, c, rhs):
            if csr_mv:
                def mv(x):
                    return jax.pure_callback(
                        lambda xx: csr @ np.asarray(xx),
                        jax.ShapeDtypeStruct(x.shape, x.dtype), x)
            else:
                mv = JEll(vals=v, cols=c, n_cols=n).mv
            return jkrylov.bicgstab(mv, prec, rhs, maxiter=n).iters

        return int(run(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(b)))

    def port_run(csr_mv=False, seen=None):
        tp = tkrylov.jacobi_preconditioner(torch.from_numpy(diag))
        e = Ell(vals=torch.from_numpy(vals), cols=torch.from_numpy(cols),
                n_cols=n)

        def prec(r):
            if seen is not None:
                seen.append(r.numpy().copy())
            return tp(r)

        mv = (lambda x: torch.from_numpy(csr @ x.numpy())) if csr_mv else e.mv
        return tkrylov.bicgstab(mv, prec, torch.from_numpy(b),
                                maxiter=n).iters

    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)   # run alone: every core
    try:
        seen_j, seen_t = [], []
        it_j, it_t = jax_run(seen=seen_j), port_run(seen=seen_t)
        it_j_csr, it_t_csr = jax_run(csr_mv=True), port_run(csr_mv=True)
    finally:
        torch.set_num_threads(threads)
    assert len(seen_j) == 2 * it_j and len(seen_t) == 2 * it_t
    rel = [float(np.linalg.norm(a - c) / np.linalg.norm(c))
           for a, c in zip(seen_t, seen_j)]
    print(f"\nKhat rows {n}; Jacobi BiCGSTAB iterations: JAX {it_j}, port "
          f"{it_t}; with scipy's CSR matvec: JAX {it_j_csr}, port {it_t_csr}")
    print("relative gap of the preconditioner inputs (iteration: p, s): " +
          "; ".join(f"{k + 1}: {rel[2 * k]:.2e}, {rel[2 * k + 1]:.2e}"
                    for k in (0, 1, 2, 5, 10, 20, 30, 50, 100)
                    if 2 * k + 1 < len(rel)))
    assert max(rel[:12]) <= 1e-13
    assert abs(it_t - it_j) <= max(abs(it_j_csr - it_j), abs(it_t_csr - it_t))
