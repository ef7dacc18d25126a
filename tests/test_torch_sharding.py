"""The port's body axis split over ``torch.distributed`` ranks
(``ddpca_admm_tpu_torch/parallel/sharding.py``), gloo ranks on the CPU,
against the single-device port and the JAX package's ``shard_problem`` solve
over the conftest's 8 CPU devices: the same ADMM iteration count, and u, z
and lambda within 1e-9 of their largest entries.  The JAX problem is carried
into the port by ``problem_from_arrays``, so both packages shard the same
operators.  Every spawn goes through ``solve_sharded``'s timeout."""

import time

import jax
import numpy as np
import pytest
import torch

import ddpca_admm_tpu.solvers.mg as jmg
import ddpca_admm_tpu.sparse.bell as jbell
import ddpca_admm_tpu_torch.solvers.mg as tmg
import ddpca_admm_tpu_torch.sparse.bell as tbell
from ddpca_admm_tpu.admm.loop import admm_step as jax_admm_step
from ddpca_admm_tpu.admm.loop import contact_analysis as jax_contact_analysis
from ddpca_admm_tpu.admm.loop import init_state as jax_init_state
from ddpca_admm_tpu.admm.problem import build_problem as jax_build_problem
from ddpca_admm_tpu.models.block import BlockConfig as JaxBlockConfig
from ddpca_admm_tpu.models.block import build_block_model as jax_build_block
from ddpca_admm_tpu.models.simple import chain_problem as jax_chain_problem
from ddpca_admm_tpu.parallel import sharding as jsh
from ddpca_admm_tpu_torch import graft_entry
from ddpca_admm_tpu_torch.admm.convert import problem_from_arrays
from ddpca_admm_tpu_torch.admm.loop import (
    admm_step,
    contact_analysis,
    init_state,
)
from ddpca_admm_tpu_torch.admm.problem import build_problem
from ddpca_admm_tpu_torch.models.block import BlockConfig, build_block_model
from ddpca_admm_tpu_torch.models.simple import chain_problem
from ddpca_admm_tpu_torch.parallel.sharding import (
    _check_divisible,
    shard_problem,
    solve_sharded,
)
from ddpca_admm_tpu_torch.solvers.mg import (
    BatchBlocks,
    StructuredProl,
    StructuredRest,
)
from ddpca_admm_tpu_torch.sparse.dia import Dia
from ddpca_admm_tpu_torch.sparse.ell import Ell
from ddpca_admm_tpu_torch.utils.device import tree_map

# the suite runs one worker per file on a shared CPU: one torch thread each
torch.set_num_threads(1)

TOL = 1e-9
MAX_ITER = 600
# seconds a spawned solve may take before the launcher kills its ranks
TIMEOUT = 240.0


def _states(st):
    """(name, numpy array) of u, z and lambda of a port or JAX state."""
    out = [("u", st.u)]
    for g, gs in enumerate(st.groups):
        out += [(f"z[{g}]", gs.z), (f"lam[{g}]", gs.lam)]
    return [(n, a.cpu().numpy() if isinstance(a, torch.Tensor)
             else np.asarray(a)) for n, a in out]


def assert_same_solve(st, ref, converged=True):
    """``st`` against ``ref`` (either package): the same iteration count,
    and u, z, lambda within TOL of their largest entries."""
    assert bool(st.converged) is converged and bool(ref.converged) is converged
    assert int(st.it) == int(ref.it)
    for (name, a), (_, b) in zip(_states(st), _states(ref), strict=True):
        assert a.shape == b.shape, name
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        assert err <= TOL * scale, (name, err, scale)


def jax_sharded(prob, modes, mesh, max_iter=MAX_ITER):
    probs = jsh.shard_problem(prob, mesh)
    st0 = jsh.shard_state(jax_init_state(probs), probs, mesh)
    return jax_contact_analysis(probs, modes, max_iter=max_iter, state0=st0)


def to_port(prob):
    return problem_from_arrays(jax.tree_util.tree_map(np.asarray, prob),
                               device="cpu")


@pytest.fixture(scope="module")
def chain8():
    prob, meta, _ = jax_chain_problem(n_bodies=8, div=2, levels=0)
    modes = tuple(meta.group_modes)
    port = to_port(prob)
    single = contact_analysis(port, modes, max_iter=MAX_ITER, device="cpu")
    return prob, port, modes, single


def test_eight_ranks_match_single_device(chain8):
    prob, port, modes, single = chain8
    run = solve_sharded(port, modes, 8, max_iter=MAX_ITER, device="cpu",
                        timeout=TIMEOUT)
    assert run.backend == "gloo" and run.mesh_shape == (8,)
    assert [r["bodies"] for r in run.ranks] == [[r, r + 1] for r in range(8)]
    assert run.state.inner_iters == single.inner_iters
    assert_same_solve(run.state, single)
    assert_same_solve(run.state, jax_sharded(prob, modes, jsh.domain_mesh(8)))


def test_host_domain_mesh_matches_single_device(chain8):
    """The (host, domain) = (2, 4) layout: bodies split over both axes in
    row-major order."""
    prob, port, modes, single = chain8
    run = solve_sharded(port, modes, 8, mesh_shape=(2, 4), max_iter=MAX_ITER,
                        device="cpu", timeout=TIMEOUT)
    assert all(r["mesh"] == [2, 4] for r in run.ranks)
    assert [r["bodies"] for r in run.ranks] == [[r, r + 1] for r in range(8)]
    assert_same_solve(run.state, single)
    assert_same_solve(run.state,
                      jax_sharded(prob, modes, jsh.host_domain_mesh(2, 4)))


def test_step_preserves_designed_sharding(chain8):
    """One sharded step: every rank checks ``assert_state_sharding`` on its
    state (``_rank_main``), and the step matches one JAX sharded step and
    one single-device step of the port."""
    prob, port, modes, _ = chain8
    run = solve_sharded(port, modes, 8, max_iter=1, device="cpu",
                        timeout=TIMEOUT)
    assert run.state.it == 1
    assert all(r["bodies"][1] - r["bodies"][0] == 1 for r in run.ranks)
    one = admm_step(port, init_state(port), modes)
    mesh = jsh.domain_mesh(8)
    probs = jsh.shard_problem(prob, mesh)
    ref = jax_admm_step(probs, jsh.shard_state(jax_init_state(probs), probs,
                                               mesh), modes)
    jsh.assert_state_sharding(ref, mesh)
    assert_same_solve(run.state, one, converged=False)
    assert_same_solve(run.state, ref, converged=False)


def test_indivisible_body_count_raises():
    prob, meta, _ = chain_problem(n_bodies=3, div=2, levels=0, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        shard_problem(prob, 0, 2)
    # the launcher refuses before it spawns a rank
    with pytest.raises(ValueError, match="not divisible"):
        solve_sharded(prob, tuple(meta.group_modes), 2, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        _check_divisible(8, (2, 3), ("host", "domain"))


def _structured_chain(**kw):
    saved = jbell.BELL_MAX_BYTES
    jbell.BELL_MAX_BYTES = 0
    try:
        return jax_chain_problem(structured=True, **kw)
    finally:
        jbell.BELL_MAX_BYTES = saved


@pytest.fixture
def force_plane_dia(monkeypatch):
    """The PlaneDia path on the tiny BLOCK, in both packages, as
    tests/test_dia.py forces it."""
    for bell, mg in ((jbell, jmg), (tbell, tmg)):
        monkeypatch.setattr(bell, "BELL_MAX_BYTES", 0)
        monkeypatch.setattr(mg, "DIA_LATENCY_BYTES", 0)


def _small_block():
    kw = dict(divi=(2, 2, 2), glob_leve=1, doma_numb=(1, 1, 1))
    model = jax_build_block(JaxBlockConfig(**kw))
    prob, meta = jax_build_problem(model.systems, model.regions,
                                   dole=[0] * len(model.systems))
    return prob, tuple(meta.group_modes)


def _crosses_a_group(op, lo, hi):
    return any(a < lo < b or a < hi < b for a, b in op.bounds)


def _operators(prob):
    """(label, operator) of every body-batched operator of a problem."""
    mg = prob.mg
    out = [("A_top", mg.A_top), ("gram", prob.gram)]
    for i, lv in enumerate(mg.levels):
        out += [(f"A{i}", lv.A), (f"P{i}", lv.P), (f"Pt{i}", lv.Pt)]
    return [(n, op) for n, op in out if op is not None]


def _in_width(op):
    if isinstance(op, BatchBlocks):
        return _in_width(op.ops[0])
    if isinstance(op, StructuredProl):
        return op.n_c_pad
    if isinstance(op, StructuredRest):
        return op.St.n_rows
    if isinstance(op, Ell):
        return op.n_cols
    return op.n_rows


def _dtype(op):
    """The dtype of an operator's tables, the one it takes x in."""
    if isinstance(op, BatchBlocks):
        return _dtype(op.ops[0])
    if isinstance(op, StructuredProl):
        return _dtype(op.S)
    if isinstance(op, StructuredRest):
        return _dtype(op.St)
    return op.dtype


def _kinds(op):
    if isinstance(op, BatchBlocks):
        return {"BatchBlocks"}.union(*(_kinds(o) for o in op.ops))
    if isinstance(op, (StructuredProl, StructuredRest)):
        inner = op.S if isinstance(op, StructuredProl) else op.St
        return {type(op).__name__} | _kinds(inner)
    return {type(op).__name__}


@pytest.mark.parametrize("case", ["block_plane_dia", "chain_structured",
                                  "chain_ell"])
def test_sliced_operators_match_full(case, force_plane_dia):
    """Process-free: for every operator type and every rank,
    ``local.mv(x[lo:hi]) == full.mv(x)[lo:hi]``, and the materialized
    accu's rows are the rank's."""
    if case == "block_plane_dia":
        prob, _ = _small_block()
        worlds = (3, 9)
    elif case == "chain_structured":
        prob, _, _ = _structured_chain(n_bodies=4, div=2, levels=1)
        worlds = (2, 4)
    else:
        prob, _, _ = jax_chain_problem(n_bodies=4, div=2, levels=1)
        worlds = (2, 4)
    port = to_port(prob)
    B, n_pad = port.cons_forc.shape
    rng = np.random.default_rng(0)
    ops = _operators(port)
    xs = {label: torch.from_numpy(rng.standard_normal((B, _in_width(op))))
          .to(_dtype(op)) for label, op in ops}
    ys = {label: op.mv(xs[label]) for label, op in ops}
    accu = port.coarse[0].accu if port.coarse else None
    sol = None
    if isinstance(accu, Ell):
        sol = torch.from_numpy(rng.standard_normal(accu.n_cols))
        full = accu.mv(sol).reshape(B, n_pad)
    for world in worlds:
        for rank in range(world):
            local = shard_problem(port, rank, world)
            lo, hi = rank * B // world, (rank + 1) * B // world
            for label, lop in _operators(local):
                torch.testing.assert_close(lop.mv(xs[label][lo:hi]),
                                           ys[label][lo:hi], rtol=0, atol=0,
                                           msg=label)
            if sol is not None:
                torch.testing.assert_close(
                    local.coarse[0].accu.mv(sol).reshape(hi - lo, n_pad),
                    full[lo:hi], rtol=0, atol=0)
    kinds = set().union(*(_kinds(op) for _, op in ops))
    expect = {"block_plane_dia": {"BatchBlocks", "PlaneDia", "Dia",
                                  "StructuredProl", "StructuredRest"},
              "chain_structured": {"BatchBlocks", "StructuredProl",
                                   "StructuredRest"},
              "chain_ell": {"Ell"}}[case]
    assert expect <= kinds, kinds
    if case == "block_plane_dia":
        assert isinstance(port.gram, Dia)


def test_dryrun_multichip_four_ranks_cpu():
    rows = graft_entry.dryrun_multichip(4, device="cpu")
    assert [(r["config"], r["mesh"]) for r in rows] == [
        (0, [4]), (0, [2, 2]), (1, [4]), (1, [2, 2])]
    assert all(r["backend"] == "gloo" and r["max_rel_du"] < 1e-9
               for r in rows)


def _failing_hook(prob, shard):
    if shard.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return None


def _sleeping_hook(prob, shard):
    time.sleep(600)


def test_launcher_raises_when_a_rank_fails_or_hangs(chain8):
    """A failed rank, or ranks past the timeout, end the solve with an
    error: nothing falls back."""
    _, port, modes, _ = chain8
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        solve_sharded(port, modes, 2, device="cpu", timeout=TIMEOUT,
                      rank_hook=_failing_hook)
    t = time.monotonic()
    with pytest.raises(TimeoutError):
        solve_sharded(port, modes, 2, device="cpu", timeout=15.0,
                      rank_hook=_sleeping_hook)
    assert time.monotonic() - t < 60.0


def _f32_hook(prob, shard):
    """In each rank: the dtypes of its problem's floating tensors and
    whether A_top is still the finest level's operator."""
    dtypes = set()
    tree_map(lambda t: dtypes.add(str(t.dtype)) if t.is_floating_point()
             else None, prob)
    return dict(dtypes=sorted(dtypes),
                alias=prob.mg.A_top is prob.mg.levels[-1].A)


def test_f32_block_two_ranks_match_one_device():
    """The float32 problem (``build_problem(dtype=torch.float32)``) of the
    divi 2 BLOCK with 2x2x2 cores per block (30 bodies) over 2 ranks,
    against the one-device float32 solve: the same ``it`` and u within
    1e-5 of max|u| (measured: 56 iterations, the same bits).  Each rank's
    problem holds float32 tensors only, with A_top the finest level."""
    model = build_block_model(BlockConfig(divi=(2, 2, 2), glob_leve=1,
                                          doma_numb=(2, 2, 2)))
    prob, meta = build_problem(model.systems, model.regions,
                               dole=[0] * len(model.systems), device="cpu",
                               dtype=torch.float32)
    modes = tuple(meta.group_modes)
    single = contact_analysis(prob, modes, max_iter=MAX_ITER * 5,
                              device="cpu")
    run = solve_sharded(prob, modes, 2, max_iter=MAX_ITER * 5, device="cpu",
                        timeout=TIMEOUT, rank_hook=_f32_hook)
    assert [r["hook"] for r in run.ranks] == [
        dict(dtypes=["torch.float32"], alias=True)] * 2
    assert single.converged and run.state.converged
    assert run.state.it == single.it
    assert run.state.u.dtype == torch.float32
    scale = float(single.u.abs().max())
    assert float((run.state.u - single.u).abs().max()) <= 1e-5 * scale
