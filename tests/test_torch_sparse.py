"""The port's sparse formats against the JAX package's on the same inputs:
Ell.mv/tmv, Dia.mv and PlaneDia.mv (through plane_dia_mv_plain, the plain
version of the CUDA kernel K1) at 1e-12 in float64, and the host builders.
The JAX side of K1 is its Pallas kernel in interpret mode."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ddpca_admm_tpu.sparse.dia as jdia
import ddpca_admm_tpu.sparse.ell as jell
from ddpca_admm_tpu.sparse.pallas_dia import plane_dia_mv_pallas
from ddpca_admm_tpu_torch.sparse import bell, dia, ell
from ddpca_admm_tpu_torch.sparse.plane_dia_kernel import (
    plane_dia_mv,
    plane_dia_mv_plain,
)
from test_dia import _banded_grid_matrix

# the suite runs one worker per file on a shared CPU: one torch thread each
torch.set_num_threads(1)

RTOL = 1e-12   # float64, sums taken in another order


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= rtol * scale


def _grid_mats(seed, B, grid, pad, repeat_planes=False):
    rng = np.random.default_rng(seed)
    mats = [_banded_grid_matrix(*grid, rng, repeat_planes=repeat_planes)
            for _ in range(B)]
    if pad:
        mats = [sp.block_diag([m, sp.identity(pad)], format="csr")
                for m in mats]
    return rng, mats


@pytest.mark.parametrize("kind", ["sparse", "dense_rows", "banded_grid"])
def test_ell_mv_tmv_match_jax(kind):
    rng = np.random.default_rng(3)
    if kind == "banded_grid":
        _, mats = _grid_mats(4, 6, (3, 3, 2), 6)
        n_rows = n_cols = mats[0].shape[0]
    else:
        n_rows, n_cols = 70, 90
        # k below / above ELL_UNROLL_MAX
        dens = 0.6 if kind == "dense_rows" else 0.08
        mats = [sp.random(n_rows, n_cols, density=dens, random_state=s,
                          format="csr") for s in (1, 2, 3, 4, 5, 6)]
    k_big = kind == "dense_rows"
    je = jell.stack_ells(mats)
    te = ell.stack_ells(mats)
    assert (te.vals.shape[-1] > ell.ELL_UNROLL_MAX) == k_big
    np.testing.assert_array_equal(te.vals.numpy(), je.vals)
    np.testing.assert_array_equal(te.cols.numpy(), je.cols)
    jv = jell.Ell(je.vals.reshape(3, 2, n_rows, -1),
                  je.cols.reshape(3, 2, n_rows, -1), je.n_cols)
    tv = ell.Ell(te.vals.reshape(3, 2, n_rows, -1),
                 te.cols.reshape(3, 2, n_rows, -1), te.n_cols)
    x = rng.standard_normal((3, 2, n_cols))
    _close(tv.mv(torch.from_numpy(x)), jv.mv(x))
    # broadcast: one x for every matrix of the batch
    _close(tv.mv(torch.from_numpy(x[0, 0])), jv.mv(x[0, 0]))
    xt = rng.standard_normal((3, 2, n_rows))
    _close(tv.tmv(torch.from_numpy(xt), 100), jv.tmv(xt, 100))
    _close(tv.tmv(torch.from_numpy(xt[1, 1])), jv.tmv(xt[1, 1]))


def test_device_sparse_and_compact_match_jax_cpu_layout():
    import ddpca_admm_tpu.sparse.bell as jbell

    mats = [sp.random(50, 40, density=0.1, random_state=s, format="csr")
            for s in range(4)]
    je = jbell.device_sparse(mats, batch_shape=(2, 2))
    te = bell.device_sparse(mats, batch_shape=(2, 2))
    assert te.vals.shape == je.vals.shape and te.n_cols == je.n_cols == 128
    np.testing.assert_array_equal(te.vals.numpy(), np.asarray(je.vals))
    np.testing.assert_array_equal(te.cols.numpy(), np.asarray(je.cols))
    (jt,), jidx = jbell.compact_device_sparse([mats], 128, (2, 2),
                                              row_offsets=[0, 7, 9, 100])
    (tt,), tidx = bell.compact_device_sparse([mats], 128, (2, 2),
                                             row_offsets=[0, 7, 9, 100])
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tt.vals.numpy(), np.asarray(jt.vals))
    assert bell.round_up(129, 128) == jbell.round_up(129, 128) == 256


@pytest.mark.parametrize("pad,tail", [(0, True), (40, True), (40, False)])
def test_dia_mv_matches_jax(pad, tail):
    rng, mats = _grid_mats(5, 3, (5, 3, 2), pad)
    n = mats[0].shape[0]
    jd = jdia.dia_from_csr_list(mats, n, np.float64, pad_identity=tail)
    td = dia.dia_from_csr_list(mats, n, np.float64, pad_identity=tail)
    assert td.offsets == jd.offsets and td.n_active == jd.n_active
    np.testing.assert_array_equal(td.vals.numpy(), np.asarray(jd.vals))
    x = rng.standard_normal((3, n))
    _close(td.mv(torch.from_numpy(x)), jd.mv(x))
    _close(td.mv(torch.from_numpy(x[0])), jd.mv(x[0]))


@pytest.mark.parametrize("pad,tail", [(0, True), (64, True), (64, False)])
def test_plane_dia_plain_matches_jax_and_pallas(pad, tail):
    """PlaneDia.mv on CPU tensors (plane_dia_mv_plain) against the JAX
    PlaneDia.mv and the Pallas kernel run in interpret mode."""
    grid = (10, 3, 2)
    rng, mats = _grid_mats(7, 3, grid, pad)
    n = mats[0].shape[0]
    if not tail:
        # transfer-stencil convention: no identity block in the matrix
        mats = [m[: n - pad] for m in mats]
        mats = [sp.vstack([m, sp.csr_matrix((pad, n))], format="csr")
                for m in mats]
    kw = dict(pad_identity=tail, max_classes=3 * grid[0] + 2)
    jp = jdia.plane_dia_from_csr_list(mats, grid, n, np.float64, **kw)
    tp = dia.plane_dia_from_csr_list(mats, grid, n, np.float64, **kw)
    assert jp is not None and tp is not None
    assert tp.offsets == jp.offsets and tp.plane == jp.plane
    np.testing.assert_array_equal(tp.vals.numpy(), np.asarray(jp.vals))
    np.testing.assert_array_equal(tp.kz.numpy(), np.asarray(jp.kz))
    assert tp.kz.dtype == torch.int32
    x = rng.standard_normal((3, n))
    y_ref = np.asarray(jp.mv(x))
    y_port = plane_dia_mv_plain(tp, torch.from_numpy(x))
    _close(y_port, y_ref)
    _close(y_port, plane_dia_mv_pallas(jp, x, interpret=True))
    # the wrapper takes the plain version for CPU tensors, and so does mv
    _close(plane_dia_mv(tp, torch.from_numpy(x)), y_ref)
    _close(tp.mv(torch.from_numpy(x)), y_ref)
    ref = np.stack([m @ x[b] for b, m in enumerate(mats)])
    _close(y_port, ref)


def test_plane_dia_builder_dedup_and_cap_match_jax():
    rng, mats = _grid_mats(1, 2, (8, 2, 2), 0, repeat_planes=True)
    n = mats[0].shape[0]
    jp = jdia.plane_dia_from_csr_list(mats, (8, 2, 2), n, np.float32)
    tp = dia.plane_dia_from_csr_list(mats, (8, 2, 2), n, np.float32)
    assert tp.vals.shape == tuple(jp.vals.shape) and tp.vals.shape[0] < 16
    assert tp.vals.dtype == torch.float32
    np.testing.assert_array_equal(tp.kz.numpy(), np.asarray(jp.kz))
    # the class cap: both packages refuse the same uncompressible table
    _, mats = _grid_mats(3, 1, (6, 3, 2), 0)
    n = mats[0].shape[0]
    for mod in (jdia, dia):
        assert mod.plane_dia_from_csr_list(mats, (6, 3, 2), n, np.float64,
                                           max_classes=2) is None
    assert dia.PLANE_DIA_CLASS_BYTES == 48 * 1024 * 1024
    assert dia.DEDUP_RTOL == jdia.DEDUP_RTOL


def test_plane_dia_wrapper_refuses_mixed_dtypes():
    """x in another dtype than the table's raises on the CPU too, where the
    plain version would promote it: the card's kernel computes in the
    table's dtype, so a mixed caller would round differently there."""
    rng, mats = _grid_mats(2, 2, (4, 2, 2), 0)
    n = mats[0].shape[0]
    x = rng.standard_normal((2, n))
    for dtype, other in ((np.float32, torch.float64),
                         (np.float64, torch.float32)):
        tp = dia.plane_dia_from_csr_list(mats, (4, 2, 2), n, dtype,
                                         max_classes=8)
        with pytest.raises(TypeError):
            plane_dia_mv(tp, torch.from_numpy(x).to(other))
        with pytest.raises(TypeError):
            tp.mv(torch.from_numpy(x).to(other))
        y = plane_dia_mv(tp, torch.from_numpy(x).to(tp.dtype))
        assert y.dtype == tp.dtype


def test_plane_dia_wrapper_refuses_bad_calls():
    """Shape and dtype checks of the wrapper (the CPU path is plain, so a
    meta tensor stands in for a device tensor the kernel cannot take)."""
    rng, mats = _grid_mats(2, 2, (4, 2, 2), 0)
    n = mats[0].shape[0]
    tp = dia.plane_dia_from_csr_list(mats, (4, 2, 2), n, np.float64,
                                     max_classes=8)
    with pytest.raises(ValueError):
        plane_dia_mv(tp, torch.empty((2, n), device="meta"))
