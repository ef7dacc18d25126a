"""The port's body axis split over gloo ranks on the CPU for the problems
that take the other paths of ``parallel/sharding.py``: the structured
friction chain (DIA/PlaneDia hierarchy, Coulomb friction), the composed
coarse operators, and the small BLOCK whose rank ranges cut through a
``BatchBlocks`` group.  Each against the single-device port and the JAX
package's ``shard_problem`` solve, as in ``test_torch_sharding.py``."""

import torch

from ddpca_admm_tpu.parallel import sharding as jsh
from ddpca_admm_tpu_torch.admm.loop import contact_analysis
from ddpca_admm_tpu_torch.admm.multiscale import ComposedAccu, ComposedTranD
from ddpca_admm_tpu_torch.parallel.sharding import solve_sharded
from ddpca_admm_tpu_torch.solvers.mg import BatchBlocks
from ddpca_admm_tpu_torch.sparse.dia import PlaneDia
from test_torch_sharding import (  # noqa: F401 (force_plane_dia: a fixture)
    MAX_ITER,
    TIMEOUT,
    _crosses_a_group,
    _small_block,
    _structured_chain,
    assert_same_solve,
    force_plane_dia,
    jax_chain_problem,
    jax_sharded,
    to_port,
)

# the suite runs one worker per file on a shared CPU: one torch thread each
torch.set_num_threads(1)


def test_structured_friction_chain_four_ranks():
    """Two levels with structured transfers, a Coulomb friction region (the
    cone projection active) and the DIA/PlaneDia hierarchy, over 4 ranks."""
    prob, meta, _ = _structured_chain(n_bodies=4, div=2, levels=1,
                                      fric_mid=0.2)
    modes = tuple(meta.group_modes)
    assert "vector" in modes
    port = to_port(prob)
    assert isinstance(port.mg.levels[-1].A, BatchBlocks)
    single = contact_analysis(port, modes, max_iter=MAX_ITER, device="cpu")
    run = solve_sharded(port, modes, 4, max_iter=MAX_ITER, device="cpu",
                        timeout=TIMEOUT)
    assert run.state.inner_iters == single.inner_iters
    assert_same_solve(run.state, single)
    assert_same_solve(run.state, jax_sharded(prob, modes, jsh.domain_mesh(4)))


def test_composed_coarse_operators_two_ranks(monkeypatch):
    """ComposedTranD / ComposedAccu: the A_top and Pt chain on each rank's
    bodies, ``take`` and the region part on the gathered vectors."""
    monkeypatch.setenv("DDPCA_COMPOSE_TRAND_MIN_DOFS", "0")
    prob, meta, _ = jax_chain_problem(n_bodies=4, div=2, levels=1,
                                      structured=True)
    modes = tuple(meta.group_modes)
    port = to_port(prob)
    assert isinstance(port.coarse[0].tranD, ComposedTranD)
    assert isinstance(port.coarse[0].accu, ComposedAccu)
    single = contact_analysis(port, modes, max_iter=MAX_ITER, device="cpu")
    run = solve_sharded(port, modes, 2, max_iter=MAX_ITER, device="cpu",
                        timeout=TIMEOUT)
    assert_same_solve(run.state, single)
    assert_same_solve(run.state, jax_sharded(prob, modes, jsh.domain_mesh(2)))


def test_small_block_three_ranks_cross_a_group(force_plane_dia):
    """The small BLOCK (9 bodies) with the PlaneDia path forced, over 3
    ranks: a rank's range cuts through a BatchBlocks group, which the rank
    keeps only in part."""
    prob, modes = _small_block()
    port = to_port(prob)
    A = port.mg.A_top
    assert any(isinstance(op, PlaneDia) for op in A.ops)
    assert any(_crosses_a_group(A, 3 * r, 3 * r + 3) for r in range(3))
    single = contact_analysis(port, modes, max_iter=1500, device="cpu")
    run = solve_sharded(port, modes, 3, max_iter=1500, device="cpu",
                        timeout=TIMEOUT)
    assert run.state.inner_iters == single.inner_iters
    assert_same_solve(run.state, single)
    assert_same_solve(run.state, jax_sharded(prob, modes, jsh.domain_mesh(3),
                                             max_iter=1500))
