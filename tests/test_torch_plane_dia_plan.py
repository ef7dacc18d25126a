"""The CUDA PlaneDia kernel's host plan (``sparse/dia.py``: ``class_plan``,
``offset_groups``, built by the ``PlaneDia`` constructor): every (body,
plane) pair once, work items of one class and at most ``PLAN_CAP`` planes,
offset groups that hold every offset once, and a plan that moves with its
operator.  ``_plan_mv`` walks the plan as the kernel does (work items,
offset groups of ``PLAN_WINDOW`` shifts, x zero outside the active rows,
the tail written by the same pass); it is held against the JAX package's
``PlaneDia.mv`` on the same inputs, so the plan is checked here on the CPU
although the kernel runs only on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpca_admm_tpu.sparse import dia as jdia
from ddpca_admm_tpu_torch.sparse import dia
from ddpca_admm_tpu_torch.utils.device import to_device

# class sizes of Pt level 2 in the core group of BLOCK menu-1 at
# glob_leve=2, as the port's builder makes them: 19 classes for 24 x 13
# planes, one class holding 144
PT_LEVEL2_SIZES = [144, 30, 30, 30, 30, 6, 6] + [3] * 12


def _kz(layout, rng, B, nz, C):
    if layout == "uniform":
        return rng.integers(0, C, (B, nz))
    if layout == "half":          # class 0 holds half of the planes
        kz = rng.integers(1, C, B * nz)
        kz[rng.permutation(B * nz)[: B * nz // 2]] = 0
        return kz.reshape(B, nz)
    if layout == "pt_level2":
        sizes = PT_LEVEL2_SIZES
    elif layout == "one_class":   # every plane in class 2, the rest empty
        sizes = [0, 0, B * nz] + [0] * (C - 3)
    else:
        raise ValueError(layout)
    assert sum(sizes) == B * nz and len(sizes) == C
    kz = np.repeat(np.arange(C), sizes)
    return rng.permutation(kz).reshape(B, nz)


LAYOUTS = [("uniform", 24, 13, 72), ("half", 24, 13, 72),
           ("pt_level2", 24, 13, 19), ("one_class", 3, 7, 5),
           ("uniform", 1, 1, 1), ("uniform", 2, 5, 40)]


def _plan(layout, B, nz, C, seed=0):
    kz = _kz(layout, np.random.default_rng(seed), B, nz, C)
    pairs, items = dia.class_plan(kz.astype(np.int32), C)
    return kz, pairs, items


@pytest.mark.parametrize("layout,B,nz,C", LAYOUTS)
def test_plan_takes_every_plane_once(layout, B, nz, C):
    kz, pairs, items = _plan(layout, B, nz, C)
    assert pairs.dtype == np.int32 and items.dtype == np.int32
    np.testing.assert_array_equal(np.sort(pairs), np.arange(B * nz))
    taken = np.concatenate([pairs[f:f + n] for _, f, n in items])
    np.testing.assert_array_equal(np.sort(taken), np.arange(B * nz))


@pytest.mark.parametrize("layout,B,nz,C", LAYOUTS)
def test_plan_items_hold_one_class_within_the_cap(layout, B, nz, C):
    kz, pairs, items = _plan(layout, B, nz, C)
    flat = kz.reshape(-1)
    assert (items[:, 2] >= 1).all() and (items[:, 2] <= dia.PLAN_CAP).all()
    for c, f, n in items:
        assert (flat[pairs[f:f + n]] == c).all()
    # a class of n planes takes ceil(n / cap) items; an empty class none
    counts = np.bincount(flat, minlength=C)
    per_class = np.bincount(items[:, 0], minlength=C)
    np.testing.assert_array_equal(per_class, -(-counts // dia.PLAN_CAP))


def test_plan_refuses_class_ids_outside_the_table():
    with pytest.raises(ValueError):
        dia.class_plan(np.array([[0, 3]], np.int32), 3)


@pytest.mark.parametrize("B,nz,C,P,itemsize,layout,cap", [
    (24, 49, 72, 7203, 4, "uniform", 8),   # finest level, 8.8M DOF
    (24, 49, 72, 7203, 4, "half", 8),
    (24, 13, 72, 507, 8, "uniform", 8),    # A_top, 180k DOF
    (24, 13, 14, 507, 4, "uniform", 2),    # a transfer stencil there
    (24, 13, 19, 507, 4, "pt_level2", 2),
    (6, 2, 2, 1875, 4, "uniform", 1),      # the slabs' stencil
])
def test_plan_cap_cuts_small_launches_finer(B, nz, C, P, itemsize, layout,
                                            cap):
    """A large operator keeps PLAN_CAP planes per item; a small one gets
    the largest cap that still gives PLAN_MIN_BLOCKS blocks, or 1."""
    kz = _kz(layout, np.random.default_rng(7), B, nz, C)
    assert dia.plan_cap(kz, C, P, itemsize) == cap
    tiles = -(-P * itemsize // dia.PLAN_TILE_BYTES)
    blocks = lambda c: dia.class_plan(kz, C, c)[1].shape[0] * tiles
    assert cap == 1 or blocks(cap) >= dia.PLAN_MIN_BLOCKS
    assert cap == dia.PLAN_CAP or blocks(2 * cap) < dia.PLAN_MIN_BLOCKS


def _stiffness_offsets(grid):
    nz, ny, nx = grid
    P = 3 * ny * nx
    return sorted({dz * P + dy * 3 * nx + e for dz in (-1, 0, 1)
                   for dy in (-1, 0, 1) for e in range(-5, 6)})


def _transfer_offsets(grid):
    nz, ny, nx = grid
    return sorted({3 * (dz * ny * nx + dy * nx + dx) for dz in (-1, 0, 1)
                   for dy in (-1, 0, 1) for dx in (-1, 0, 1)})


OFFSETS = {
    "stiffness": _stiffness_offsets((13, 13, 13)),
    "transfer": _transfer_offsets((13, 13, 13)),
    "wide": [-11, -6, 0, 1, 5, 11],              # |off| up to 2P - 1, P = 6
    "unsorted": [7, -3, 0, 2, -40, 19],
    "single": [0],
}


@pytest.mark.parametrize("kind", sorted(OFFSETS))
def test_offset_groups_hold_every_offset_once(kind):
    offs = OFFSETS[kind]
    groups = dia.offset_groups(offs)
    W = dia.PLAN_WINDOW
    assert groups.dtype == np.int32 and groups.shape[1] == 1 + W
    slots = groups[:, 1:]
    np.testing.assert_array_equal(np.sort(slots[slots >= 0]),
                                  np.arange(len(offs)))
    for g0, *ds in groups:
        for k, d in enumerate(ds):
            if d >= 0:
                assert offs[d] == g0 + k
    if kind == "stiffness":     # 9 runs of 11 consecutive offsets
        assert groups.shape[0] == 9


def test_plan_survives_to_device():
    rng = np.random.default_rng(3)
    kz = _kz("pt_level2", rng, 24, 13, 19)
    P = 6
    pd = dia.PlaneDia(torch.from_numpy(rng.standard_normal((19, 3, P))),
                      torch.from_numpy(kz.astype(np.int32)), (-P, 0, P),
                      24 * 13 * P, P)
    moved = to_device(pd, "cpu")
    assert moved is not pd
    for name in ("plan_pairs", "plan_items", "plan_groups"):
        a, b = getattr(pd, name), getattr(moved, name)
        assert b.dtype == torch.int32 and b.device.type == "cpu"
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    pairs, items = dia.class_plan(kz, 19, dia.plan_cap(kz, 19, P, 8))
    np.testing.assert_array_equal(moved.plan_pairs.numpy(), pairs)
    np.testing.assert_array_equal(moved.plan_items.numpy(), items)


def _plan_mv(pd, x):
    """y = pd @ x computed by walking the kernel's plan (numpy)."""
    vals = pd.vals.numpy()
    C, D, P = vals.shape
    B, nz = pd.kz.shape
    n, na = pd.n_rows, nz * P
    W = dia.PLAN_WINDOW
    x = np.asarray(x, np.float64)
    y = np.full((B, n), np.nan)
    y[:, na:] = x[:, na:] if pd.tail_identity else 0.0
    pairs = pd.plan_pairs.numpy()
    p = np.arange(P)
    for c, first, cnt in pd.plan_items.numpy():
        for pr in pairs[first:first + cnt]:
            b, z = divmod(int(pr), nz)
            acc = np.zeros(P)
            for g0, *ds in pd.plan_groups.numpy():
                for k in range(W):
                    if ds[k] < 0:
                        continue
                    r = z * P + p + g0 + k
                    ok = (r >= 0) & (r < na)
                    acc += vals[c, ds[k]] * np.where(ok, x[b, r % n], 0.0)
            y[b, z * P:(z + 1) * P] = acc
    return y


@pytest.mark.parametrize("layout,C,kind,tail", [
    ("uniform", 9, "stiffness", True),
    ("half", 9, "transfer", False),
    ("one_class", 5, "wide", True),
    ("uniform", 1, "unsorted", False),
])
def test_plan_walk_matches_jax(layout, C, kind, tail):
    """Walking the plan gives the JAX package's PlaneDia.mv, the tail
    included, at a small size (grid 4 x 2 x 1 nodes, P = 6)."""
    rng = np.random.default_rng(5)
    B, grid = 3, (4, 2, 1)
    nz, P = grid[0], 3 * grid[1] * grid[2]
    offs = OFFSETS[kind]
    if kind in ("stiffness", "transfer"):
        offs = (_stiffness_offsets if kind == "stiffness"
                else _transfer_offsets)(grid)
    offs = [o for o in offs if abs(o) < 2 * P]
    n = nz * P + 5
    kz = _kz(layout, rng, B, nz, C).astype(np.int32)
    vals = rng.standard_normal((C, len(offs), P))
    x = rng.standard_normal((B, n))
    pd = dia.PlaneDia(torch.from_numpy(vals), torch.from_numpy(kz),
                      tuple(offs), n, P, tail_identity=tail)
    jp = jdia.PlaneDia(jnp.asarray(vals), jnp.asarray(kz), tuple(offs), n,
                       P, tail_identity=tail)
    y_ref = np.asarray(jp.mv(jnp.asarray(x)))
    np.testing.assert_allclose(_plan_mv(pd, x), y_ref, rtol=0,
                               atol=1e-12 * np.abs(y_ref).max())
