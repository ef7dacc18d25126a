"""The port's float32 solve path (``utils/precision.py``), the counterpart
of ``tests/test_precision.py``: selected by ``build_problem(dtype=)`` or
``DDPCA_SOLVE_DTYPE`` as the JAX package selects it, every floating tensor
of the problem in float32 with ``A_top`` the finest level's operator, held
against the port's float64 solve and against the JAX package's float32
solve on the same inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpca_admm_tpu.admm.loop import contact_analysis as jax_contact_analysis
from ddpca_admm_tpu.admm.problem import build_problem as jax_build_problem
from ddpca_admm_tpu.models.block import BlockConfig as JaxBlockConfig
from ddpca_admm_tpu.models.block import build_block_model as jax_build_block
from ddpca_admm_tpu.models.simple import (
    stacked_boxes_problem as jax_stacked_boxes,
)
from ddpca_admm_tpu_torch.admm.convert import problem_from_arrays
from ddpca_admm_tpu_torch.admm.loop import contact_analysis, init_state
from ddpca_admm_tpu_torch.admm.multiscale import ComposedAccu, ComposedTranD
from ddpca_admm_tpu_torch.admm.problem import build_problem
from ddpca_admm_tpu_torch.models.block import BlockConfig, build_block_model
from ddpca_admm_tpu_torch.models.simple import stacked_boxes_problem
from ddpca_admm_tpu_torch.utils.device import to_device, tree_map
from ddpca_admm_tpu_torch.utils.precision import (
    cast_problem,
    floor_crit,
    floor_rtol,
    solve_dtype,
)

# the suite runs one worker per file on a shared CPU: one torch thread each
torch.set_num_threads(1)

SMALL = dict(divi=(2, 2, 2), glob_leve=1, doma_numb=(1, 1, 1))
# the JAX package's bound on float32 against float64 (tests/test_precision.py)
F32_VS_F64 = 3e-4
# the port's float32 solve against the JAX package's
F32_VS_JAX = 1e-4


def _floating(tree, keep=()) -> list:
    """The floating tensors of ``tree``, apart from those of the objects in
    ``keep``."""
    found = []
    tree_map(lambda t: found.append(t) if t.is_floating_point() else None,
             tree, keep=keep)
    return found


def _solve_dtypes(prob) -> set:
    """The dtypes of a problem's floating tensors, apart from the float64
    operator of a composed coarse correction (checked on its own)."""
    keep = [co.tranD.A for co in prob.coarse or ()
            if isinstance(co.tranD, ComposedTranD)]
    assert all(A.dtype == torch.float64 for A in keep)
    return {t.dtype for t in _floating(prob, keep)}


def _small_problem(dtype, dole=0, **kw):
    model = build_block_model(BlockConfig(**SMALL))
    return build_problem(model.systems, model.regions,
                         dole=[dole] * len(model.systems), device="cpu",
                         dtype=dtype, **kw)


def test_f32_matches_f64_solution():
    """Measured: 21 iterations (float64: 36), u within 6.2e-5 of max|u|."""
    u = {}
    for dtype in (torch.float64, torch.float32):
        prob, meta = _small_problem(dtype)
        st = contact_analysis(prob, tuple(meta.group_modes), max_iter=3000,
                              device="cpu")
        assert st.converged
        assert st.u.dtype == dtype
        u[dtype] = st.u.double().numpy()
    ref = np.abs(u[torch.float64]).max()
    assert np.abs(u[torch.float32] - u[torch.float64]).max() <= \
        F32_VS_F64 * ref


def test_f32_problem_dtypes():
    prob, _ = _small_problem(torch.float32, dole=1)
    assert prob.cons_forc.dtype == torch.float32
    assert prob.mg.A_top is prob.mg.levels[-1].A
    assert prob.mg.A_top.dtype == torch.float32
    for g in prob.groups:
        assert g.Bp.vals.dtype == torch.float32
        assert g.body_idx.dtype == torch.int64      # ints untouched
        assert g.Bp.cols.dtype == torch.int64
        assert g.m_mask.dtype == torch.bool
    assert prob.coarse
    for co in prob.coarse:
        assert co.inv.dtype == torch.float32
        assert co.forc0.dtype == torch.float32
    # every floating tensor of the problem, and of the loop's first state
    assert {t.dtype for t in _floating(prob)} == {torch.float32}
    assert {t.dtype for t in _floating(init_state(prob))} == {torch.float32}


def test_f32_composed_chains_are_the_vcycle_tables(monkeypatch):
    """In float32 the composed coarse chains hold the V-cycle's own Pt/P
    tables (float64 keeps float64 copies for its own solve only), and F^T A
    u takes A in float64: a float64 copy of the finest operator, the one
    float64 operator of a float32 problem."""
    monkeypatch.setenv("DDPCA_COMPOSE_TRAND_MIN_DOFS", "0")
    prob, _ = _small_problem(torch.float32, dole=0)
    co = prob.coarse[0]
    assert isinstance(co.tranD, ComposedTranD)
    assert isinstance(co.accu, ComposedAccu)
    assert co.tranD.mask.dtype == torch.float32
    assert co.tranD.A.dtype == torch.float64
    assert co.tranD.A is not prob.mg.A_top
    assert prob.mg.A_top is prob.mg.levels[-1].A
    assert _solve_dtypes(prob) == {torch.float32}
    assert _solve_dtypes(to_device(prob, "cpu")) == {torch.float32}
    levels = prob.mg.levels
    for op, lv in zip(co.tranD.chain, reversed(levels[1:])):
        assert {t.data_ptr() for t in _floating(op)} == \
            {t.data_ptr() for t in _floating(lv.Pt)}
    prob64, _ = _small_problem(torch.float64, dole=0)
    chain64 = prob64.coarse[0].tranD.chain
    assert {t.dtype for op in chain64 for t in _floating(op)} == \
        {torch.float64}
    assert prob64.coarse[0].tranD.A is prob64.mg.A_top


def test_floor_rtol():
    assert floor_rtol(1e-14, torch.float64) == 1e-14
    assert floor_rtol(1e-14, torch.float32) > 1e-6
    assert floor_crit(1e-12, torch.float64) == 1e-12
    assert floor_crit(1e-12, torch.float32) == pytest.approx(
        (100 * float(torch.finfo(torch.float32).eps)) ** 2)


class _Op:
    def __init__(self, vals, cols):
        self.vals = vals
        self.cols = cols
        self.n = 7


def test_cast_problem_preserves_ints_and_aliases():
    op = _Op(torch.zeros(3, dtype=torch.float64),
             torch.zeros(3, dtype=torch.int32))
    tree = (op, op, torch.zeros(2, dtype=torch.bool), 7, np.zeros(2),
            torch.zeros(2, dtype=torch.int64))
    out = cast_problem(tree, torch.float32)
    assert out[0].vals.dtype == torch.float32
    assert out[0].cols.dtype == torch.int32
    assert out[0].n == 7
    assert out[0] is out[1]              # one operator, reached twice
    assert out[0] is not op              # copied, never mutated
    assert op.vals.dtype == torch.float64
    assert out[2].dtype == torch.bool
    assert out[3] == 7
    assert out[4].dtype == np.float64    # host numpy leaves pass through
    assert out[5].dtype == torch.int64


def test_to_device_keeps_the_a_top_alias():
    """tree_map maps a shared operator once: moving a float32 problem keeps
    A_top the finest level's operator, with one copy of its tables (it
    copied the object per field, and so the tables per field, before)."""
    prob, _ = _small_problem(torch.float32)
    moved = to_device(prob, "cpu")
    assert moved.mg.A_top is moved.mg.levels[-1].A
    assert moved.mg is not prob.mg


def test_solve_dtype_explicit_override(monkeypatch):
    monkeypatch.delenv("DDPCA_SOLVE_DTYPE", raising=False)
    assert solve_dtype(torch.float32) == torch.float32
    assert solve_dtype("float32") == torch.float32
    assert solve_dtype(np.float32) == torch.float32
    # float64 is the port's default on every device
    assert solve_dtype() == torch.float64
    monkeypatch.setenv("DDPCA_SOLVE_DTYPE", "f32")
    assert solve_dtype(torch.float64) == torch.float64
    with pytest.raises(ValueError):
        solve_dtype("bfloat16")


@pytest.mark.parametrize("env,want", [("f32", torch.float32),
                                      ("float32", torch.float32),
                                      ("f64", torch.float64),
                                      ("float64", torch.float64)])
def test_solve_dtype_env_override(monkeypatch, env, want):
    monkeypatch.setenv("DDPCA_SOLVE_DTYPE", env)
    assert solve_dtype() == want
    if want == torch.float32:
        prob, _ = stacked_boxes_problem(div_bot=2, div_top=2, levels=0,
                                        device="cpu")[:2]
        assert {t.dtype for t in _floating(prob)} == {torch.float32}


# ------------------------------------------------- the port against JAX

# lambda is held looser than u and z: it accumulates the interface
# residual times the penalty, and in float32 it moves by 1.2-1.6e-3 of its
# largest entry between any two roundings (the JAX package's own float32
# lambda against its float64 one on the divi 2 BLOCK: 1.6e-3 and 1.2e-3)
F32_VS_JAX_LAM = 3e-3
DIVI6 = dict(divi=(6, 6, 6), glob_leve=1, doma_numb=(2, 2, 2))


@functools.lru_cache(maxsize=None)
def _block_models(key):
    """Each package's own host model of one BLOCK configuration (the
    problem builds leave them as they were)."""
    kw = dict(key)
    return (jax_build_block(JaxBlockConfig(**kw)),
            build_block_model(BlockConfig(**kw)))


def _block_case(kw, dole, monkeypatch, compose):
    if compose:
        monkeypatch.setenv("DDPCA_COMPOSE_TRAND_MIN_DOFS", "0")
    ref_model, model = _block_models(tuple(kw.items()))
    dole = [dole] * len(ref_model.systems)
    prob_j, meta_j = jax_build_problem(ref_model.systems, ref_model.regions,
                                       dole=dole, musc_sett=2,
                                       dtype=jnp.float32)
    prob, meta = build_problem(model.systems, model.regions, dole=dole,
                               musc_sett=2, device="cpu",
                               dtype=torch.float32)
    return prob_j, tuple(meta_j.group_modes), prob, tuple(meta.group_modes)


def _friction_case(monkeypatch):
    """tests/test_friction.py's stacked boxes: mu 0.4, shear 1e6."""
    monkeypatch.setenv("DDPCA_SOLVE_DTYPE", "float32")
    kw = dict(div_bot=3, div_top=2, levels=0, pressure=-1.0e7, fric=0.4,
              shear=1.0e6)
    prob_j, meta_j, _ = jax_stacked_boxes(**kw)
    prob, meta, _ = stacked_boxes_problem(device="cpu", **kw)
    return prob_j, tuple(meta_j.group_modes), prob, tuple(meta.group_modes)


# case: (build, iterations by which the port's count may differ from JAX's)
CASES = {
    "block_divi2": (lambda mp: _block_case(SMALL, 0, mp, False), 0),
    "block_divi6_ddmg": (lambda mp: _block_case(DIVI6, 1, mp, False), 0),
    "block_divi6_chains": (lambda mp: _block_case(DIVI6, 1, mp, True), 0),
    # the friction monitor decays by 0.6% an iteration where it meets the
    # float32 criterion (100*eps)^2 near iteration 1724, and float32
    # rounding moves it by up to 0.45% (the port's float32 ratio against
    # its float64 one at iteration 1600): the exit falls one apart
    "friction": (_friction_case, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_f32_matches_jax(case, monkeypatch):
    """The port's float32 build and solve against the JAX package's, each
    package building its own host model: the same ``it`` (friction: within
    1), inner iterations within 2 of JAX's count, u and z within 1e-4 and
    lambda within 3e-3 of their largest entries.  Then the JAX problem
    carried over by ``problem_from_arrays`` keeps its float32 leaves and
    the A_top alias.  Measured (CPU): it 21, 3, 3 and inner 30, 6, 6 in the
    three BLOCK cases, as in JAX; u within 1.3e-5, 1.3e-5, 2.2e-5, z within
    1.1e-5, 1.5e-5, 2.3e-5, lambda within 1.4e-3, 5.6e-4, 8.4e-4 of their
    largest entries; friction it 1723 against JAX's 1724."""
    build, it_slack = CASES[case]
    prob_j, modes_j, prob, modes = build(monkeypatch)
    assert _solve_dtypes(prob) == {torch.float32}
    assert prob.mg.A_top is prob.mg.levels[-1].A
    # the DOUBLE_M_1 hierarchy's A_top is built in the solve dtype too (it
    # took the policy's default, float64, and the cast made it a copy)
    for co in prob.coarse or ():
        if co.mg is not None:
            assert co.mg.A_top is co.mg.levels[-1].A
    ref = jax_contact_analysis(prob_j, modes_j, max_iter=3000)
    st = contact_analysis(prob, modes, max_iter=3000, device="cpu")
    assert bool(ref.converged) and st.converged
    assert abs(st.it - int(ref.it)) <= it_slack, (st.it, int(ref.it))
    assert abs(st.inner_iters - int(ref.inner_iters)) <= 2
    pairs = [("u", st.u, ref.u)]
    for g, (gs, gr) in enumerate(zip(st.groups, ref.groups)):
        pairs += [(f"z[{g}]", gs.z, gr.z), (f"lam[{g}]", gs.lam, gr.lam)]
    for name, a, b in pairs:
        assert a.dtype == torch.float32, name
        a, b = a.double().numpy(), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        rel = float(np.abs(a - b).max()) / float(np.abs(b).max())
        tol = F32_VS_JAX_LAM if name.startswith("lam") else F32_VS_JAX
        assert rel <= tol, (name, rel)

    carried = problem_from_arrays(jax.tree_util.tree_map(np.asarray, prob_j),
                                  device="cpu")
    assert {t.dtype for t in _floating(carried)} == {torch.float32}
    assert carried.mg.A_top is carried.mg.levels[-1].A
    for co in carried.coarse or ():
        if co.mg is not None:
            assert co.mg.A_top is co.mg.levels[-1].A
