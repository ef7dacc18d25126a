"""The port's Block-ELL path (``DDPCA_SPARSE_FORMAT=bell``) against the JAX
package's on the CPU: the tiles and their products, the format choices of
``device_sparse``, the small BLOCK built and solved by each package under
the variable, the port's default build without it, and the Block-ELL
problem split over two ranks.  Inputs are made with numpy from a seed; the
variable is set with ``monkeypatch.setenv``, read at build time by both
packages.

    DDPCA_SPARSE_FORMAT=bell JAX_PLATFORMS=cpu python -m pytest tests/test_torch_bell.py
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ddpca_admm_tpu.sparse.bell as jbell
import ddpca_admm_tpu_torch.sparse.bell as pbell
from ddpca_admm_tpu.admm.loop import contact_analysis as jax_contact_analysis
from ddpca_admm_tpu.admm.problem import build_problem as jax_build_problem
from ddpca_admm_tpu.models.block import BlockConfig as JaxBlockConfig
from ddpca_admm_tpu.models.block import build_block_model as jax_build_block
from ddpca_admm_tpu_torch.admm.convert import problem_from_arrays
from ddpca_admm_tpu_torch.admm.loop import contact_analysis
from ddpca_admm_tpu_torch.admm.problem import build_problem
from ddpca_admm_tpu_torch.models.block import BlockConfig, build_block_model
from ddpca_admm_tpu_torch.parallel.sharding import shard_problem
from torch_parity import assert_states_match

# the suite runs one worker per file on a shared CPU: one torch thread each
torch.set_num_threads(1)

SMALL = dict(divi=(2, 2, 2), glob_leve=1, doma_numb=(1, 1, 1))


def _rand_csr(seed, n, m, density=0.02):
    return sp.random(n, m, density=density, format="csr",
                     random_state=np.random.RandomState(seed))


def _duplicates():
    """A COO matrix with a duplicated entry (1, 4), as tests/test_bell.py."""
    return sp.coo_matrix(
        (np.array([1.0, 2.0, 3.0, 0.1]),
         (np.array([1, 1, 5, 1]), np.array([4, 4, 9, 4]))), shape=(8, 128))


# (label, matrices, batch_shape, x batch shapes to apply): the counterparts
# of tests/test_bell.py's single, batched-with-broadcast and duplicate cases
BUILD_CASES = [
    ("single 100x100", lambda: [_rand_csr(0, 100, 100)], None, [()]),
    ("single 57x300", lambda: [_rand_csr(0, 57, 300)], None, [()]),
    ("single 260x130", lambda: [_rand_csr(0, 260, 130)], None, [()]),
    ("batched (3, 2)", lambda: [_rand_csr(i, 40, 70) for i in range(6)],
     (3, 2), [(3, 2), ()]),
    ("duplicates", lambda: [_duplicates()], None, [()]),
]


@pytest.mark.parametrize("case", BUILD_CASES, ids=[c[0] for c in BUILD_CASES])
def test_tiles_and_products_match_jax(case):
    """Tiles and column blocks equal the JAX package's ``bell_from_csr_list``
    (bit for bit without duplicate entries, within 1e-15 of the largest
    entry with them), and ``mv`` matches the JAX ``BlockEll.mv`` within
    1e-12 of max|y| in float64, with x broadcast against the batch."""
    label, make, batch_shape, x_batches = case
    mats = make()
    ref = jbell.bell_from_csr_list(mats, dtype=np.float64,
                                   batch_shape=batch_shape)
    be = pbell.bell_from_csr_list(mats, dtype=torch.float64,
                                  batch_shape=batch_shape)
    assert be.tiles.dtype == torch.float64 and be.cblk.dtype == torch.int32
    assert be.n_cols == ref.n_cols and be.n_rows == ref.n_rows
    np.testing.assert_array_equal(be.cblk.numpy(), np.asarray(ref.cblk))
    tiles, ref_tiles = be.tiles.numpy(), np.asarray(ref.tiles)
    assert tiles.shape == ref_tiles.shape
    if label == "duplicates":
        scale = float(np.abs(ref_tiles).max())
        assert float(np.abs(tiles - ref_tiles).max()) <= 1e-15 * scale
    else:
        np.testing.assert_array_equal(tiles, ref_tiles)
    rng = np.random.default_rng(1)
    for xb in x_batches:
        x = rng.standard_normal(xb + (be.n_cols,))
        y_ref = np.asarray(ref.mv(x))
        y = be.mv(torch.from_numpy(x)).numpy()
        assert y.shape == y_ref.shape
        scale = float(np.abs(y_ref).max())
        assert float(np.abs(y - y_ref).max()) <= 1e-12 * scale
    if label == "duplicates":
        x = np.zeros(128)
        x[4], x[9] = 1.0, 2.0
        y = be.mv(torch.from_numpy(x)).numpy()
        assert abs(y[1] - 3.1) <= 1e-15 * 3.1 and y[5] == 6.0


def test_float32_tiles_and_mixed_dtype():
    """Tiles built straight in float32 equal the JAX package's float32
    tiles; a float64 x through float32 tiles raises (the card's kernel
    computes in the tiles' dtype)."""
    mats = [_rand_csr(i, 60, 200) for i in range(4)]
    ref = jbell.bell_from_csr_list(mats, dtype=np.float32)
    be = pbell.bell_from_csr_list(mats, dtype=torch.float32)
    assert be.tiles.dtype == torch.float32
    np.testing.assert_array_equal(be.tiles.numpy(), np.asarray(ref.tiles))
    with pytest.raises(TypeError):
        be.mv(torch.zeros((4, be.n_cols), dtype=torch.float64))


def _budget_edge(mats, n_rows, n_cols):
    """Bytes of the tiles of ``mats`` at the budget's 4 bytes an entry."""
    S = jbell._max_slots(mats, n_cols)
    return len(mats) * (n_rows // 8) * S * 8 * 128 * 4


# (label, matrices, n_rows, n_cols, batch_shape, force_ell, budget): budget
# None keeps the default; an int sets both packages' BELL_MAX_BYTES
CHOICE_CASES = [
    ("fits", lambda: [_rand_csr(i, 100, 300) for i in range(4)], 104, 384,
     (2, 2), False, None),
    ("force_ell", lambda: [_rand_csr(i, 100, 300) for i in range(4)], 104,
     384, (2, 2), True, None),
    ("at the budget", lambda: [_rand_csr(i, 100, 300) for i in range(4)],
     104, 384, None, False, "edge"),
    ("one byte past the budget",
     lambda: [_rand_csr(i, 100, 300) for i in range(4)], 104, 384, None,
     False, "edge-1"),
    ("single, padded", lambda: [_rand_csr(5, 90, 200)], None, None, None,
     False, None),
    ("empty matrix in the batch",
     lambda: [_rand_csr(6, 50, 50), sp.csr_matrix((50, 50))], None, None,
     None, False, None),
]


@pytest.mark.parametrize("fmt", ["bell", "ell"])
@pytest.mark.parametrize("case", CHOICE_CASES,
                         ids=[c[0] for c in CHOICE_CASES])
def test_device_sparse_choices_match_jax(case, fmt, monkeypatch):
    """Under DDPCA_SPARSE_FORMAT=bell (and =ell) ``device_sparse`` picks the
    JAX package's format for the same matrices: Block-ELL within the byte
    budget, ELL past it and under ``force_ell``; the operators hold the
    same arrays."""
    label, make, n_rows, n_cols, batch_shape, force_ell, budget = case
    monkeypatch.setenv("DDPCA_SPARSE_FORMAT", fmt)
    mats = make()
    if budget is not None:
        edge = _budget_edge(mats, pbell.round_up(n_rows, 8),
                            pbell.round_up(n_cols, 128))
        value = edge if budget == "edge" else edge - 1
        monkeypatch.setattr(jbell, "BELL_MAX_BYTES", value)
        monkeypatch.setattr(pbell, "BELL_MAX_BYTES", value)
    ref = jbell.device_sparse(mats, n_rows, n_cols, dtype=np.float64,
                              batch_shape=batch_shape, force_ell=force_ell)
    op = pbell.device_sparse(mats, n_rows, n_cols, dtype=torch.float64,
                             batch_shape=batch_shape, force_ell=force_ell)
    assert type(op).__name__ == type(ref).__name__, label
    expect = "BlockEll" if fmt == "bell" and not force_ell and \
        budget != "edge-1" else "Ell"
    assert type(op).__name__ == expect
    for name in op._fields:
        a, b = getattr(op, name), getattr(ref, name)
        if name == "n_cols":
            assert a == b
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _walk(obj, path, out):
    """(path, class name) of every operator and tensor of a problem tree,
    the JAX package's and the port's alike."""
    name = type(obj).__name__
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return
    if name in ("Ell", "BlockEll", "Dia", "PlaneDia"):
        out.append((path, name))
        return
    if hasattr(obj, "_fields"):
        for f in obj._fields:
            _walk(getattr(obj, f), f"{path}.{f}", out)
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            _walk(v, f"{path}[{i}]", out)
    elif name in ("BatchBlocks", "StructuredProl", "StructuredRest"):
        for k in ("ops", "S", "St"):
            if hasattr(obj, k):
                _walk(getattr(obj, k), f"{path}.{k}", out)
    elif name in ("ComposedTranD", "ComposedAccu"):
        out.append((path, name))
    else:
        out.append((path, "array"))


def _signature(prob):
    out = []
    _walk(prob, "prob", out)
    return out


def _block_ells(prob):
    return [p for p, n in _signature(prob) if n == "BlockEll"]


@pytest.fixture(scope="module")
def bell_builds():
    """The small BLOCK (divi 2, glob_leve 1) under DDPCA_SPARSE_FORMAT=bell:
    the JAX package's problem and solve, the port's own build, and the
    port's ELL build (the variable unset)."""
    mp = pytest.MonkeyPatch()
    dole_kw = dict(musc_sett=2)
    mp.delenv("DDPCA_SPARSE_FORMAT", raising=False)
    try:
        mp.setenv("DDPCA_SPARSE_FORMAT", "bell")
        jm = jax_build_block(JaxBlockConfig(**SMALL))
        dole = [1] * len(jm.systems)
        jprob, jmeta = jax_build_problem(jm.systems, jm.regions, dole=dole,
                                         **dole_kw)
        ref = jax_contact_analysis(jprob, tuple(jmeta.group_modes),
                                   max_iter=800)
        model = build_block_model(BlockConfig(**SMALL))
        prob, meta = build_problem(model.systems, model.regions, dole=dole,
                                   device="cpu", **dole_kw)
        mp.delenv("DDPCA_SPARSE_FORMAT")
        ell_prob, _ = build_problem(model.systems, model.regions, dole=dole,
                                    device="cpu", **dole_kw)
        jm_ell = jax_build_block(JaxBlockConfig(**SMALL))
        jprob_ell, _ = jax_build_problem(jm_ell.systems, jm_ell.regions,
                                         dole=dole, **dole_kw)
    finally:
        mp.undo()
    return dict(jprob=jprob, modes=tuple(jmeta.group_modes), ref=ref,
                prob=prob, meta=meta, model=model, ell_prob=ell_prob,
                jprob_ell=jprob_ell)


def test_small_block_bell_matches_jax(bell_builds):
    """The small BLOCK under bell: the port's operator types equal the JAX
    package's field by field; the JAX problem carried across by
    ``problem_from_arrays`` and the port's own build both solve in the JAX
    solve's ``it`` with u, z and lambda within 1e-8 of their largest
    entries, and within 1e-8 of the port's ELL solve."""
    b = bell_builds
    assert _signature(b["prob"]) == _signature(b["jprob"])
    assert len(_block_ells(b["prob"])) > 0
    assert "prob.groups[0].E" not in _block_ells(b["prob"])   # force_ell
    modes, ref = b["modes"], b["ref"]
    carried = problem_from_arrays(
        jax.tree_util.tree_map(np.asarray, b["jprob"]), device="cpu")
    assert _signature(carried) == _signature(b["jprob"])
    for name, prob in (("carried", carried), ("own", b["prob"])):
        st = contact_analysis(prob, modes, max_iter=800, device="cpu")
        assert_states_match(st, ref)
        if name == "own":
            own = st
    ell = contact_analysis(b["ell_prob"], modes, max_iter=800, device="cpu")
    assert_states_match(own, ell)


def test_default_build_keeps_ell(bell_builds, monkeypatch):
    """Without the variable the port builds the operator types it built
    before this format existed, and the JAX package's CPU types: no
    Block-ELL anywhere."""
    b = bell_builds
    assert _block_ells(b["ell_prob"]) == []
    assert _signature(b["ell_prob"]) == _signature(b["jprob_ell"])
    monkeypatch.delenv("DDPCA_SPARSE_FORMAT", raising=False)
    assert pbell.use_block_format() is False


@pytest.mark.parametrize("structured", [True, False])
def test_shard_bell_problem_gives_each_rank_its_rows(structured,
                                                     monkeypatch):
    """``shard_problem`` of a Block-ELL problem over 2 ranks: every
    body-batched Block-ELL operator (the whole hierarchy when it is not
    structured) keeps the rank's bodies, and the coarse correction's accu
    the rank's rows of the whole problem's product."""
    monkeypatch.setenv("DDPCA_SPARSE_FORMAT", "bell")
    # 12 bodies (two cores per block), an even split
    model = build_block_model(BlockConfig(divi=(2, 2, 2), glob_leve=1,
                                          doma_numb=(2, 1, 1)))
    prob, _ = build_problem(model.systems, model.regions,
                            dole=[1] * len(model.systems), musc_sett=2,
                            structured=structured, device="cpu")
    B, n_pad = prob.cons_forc.shape
    rng = np.random.default_rng(2)
    accu = prob.coarse[0].accu
    assert type(accu).__name__ == "BlockEll"
    sol = torch.from_numpy(rng.standard_normal(accu.n_cols))
    whole = accu.mv(sol).reshape(B, n_pad)
    levels = [lv.A for lv in prob.mg.levels]
    if not structured:
        assert all(type(A).__name__ == "BlockEll" for A in levels)
    lo = 0
    for rank in range(2):
        local = shard_problem(prob, rank, 2)
        hi = lo + local.cons_forc.shape[0]
        got = local.coarse[0].accu.mv(sol).reshape(hi - lo, n_pad)
        assert torch.equal(got, whole[lo:hi])
        for A, A_loc in zip(levels, (lv.A for lv in local.mg.levels)):
            if type(A).__name__ != "BlockEll":
                continue
            assert torch.equal(A_loc.tiles, A.tiles[lo:hi])
            x = torch.from_numpy(rng.standard_normal((B, A.n_cols))).to(
                A.dtype)
            assert torch.equal(A_loc.mv(x[lo:hi]), A.mv(x)[lo:hi])
        lo = hi
    assert lo == B
