"""The port's host build against the JAX package's, bit for bit: BLOCK
menu-1 built in the port's process pool at one and at two workers, the
vectorised ``HexMesh.transfer`` and 2:1 rule on meshes with hanging nodes,
and the load accumulation that replaced a Python loop; and the ring load
at glob_leve=4, where the port's clipping drops a vertex that the JAX
package's keeps."""

import numpy as np
import pytest

from ddpca_admm_tpu.mesh.hexmesh import HexMesh as JaxHexMesh
from ddpca_admm_tpu.models.block import BlockConfig as JaxBlockConfig
from ddpca_admm_tpu.models.block import build_block_model as jax_build_block
from ddpca_admm_tpu_torch.fem.assembly import accumulate_loads
from ddpca_admm_tpu_torch.mesh.hexmesh import HexMesh
from ddpca_admm_tpu_torch.models.block import BlockConfig, build_block_model
from ddpca_admm_tpu_torch.utils.pool import HostPool
from torch_parity import assert_same

# BLOCK menu-1's layout (divi 6, doma 2: 30 bodies, 62 regions) at the
# smallest refinement, 30,780 DOF
BLOCK_KW = dict(divi=(6, 6, 6), glob_leve=1, doma_numb=(2, 2, 2))


@pytest.fixture(scope="module")
def jax_block():
    return jax_build_block(JaxBlockConfig(**BLOCK_KW))


@pytest.mark.parametrize("workers", [1, 2])
def test_block_model_matches_jax_at_worker_count(jax_block, workers):
    port = build_block_model(BlockConfig(**BLOCK_KW), workers=workers)
    ref = jax_block
    assert port.workers == workers
    assert len(port.systems) == len(ref.systems) == 30
    assert int(sum(s.n_dof for s in port.systems)) == 30_780
    for b, (s_port, s_ref) in enumerate(zip(port.systems, ref.systems)):
        assert s_port.grid is not None
        assert_same(s_port, s_ref, f"systems[{b}]")
    assert len(port.regions) == len(ref.regions) == 62
    for r, (r_port, r_ref) in enumerate(zip(port.regions, ref.regions)):
        assert_same(r_port, r_ref, f"regions[{r}]")
    for b, (body_port, body_ref) in enumerate(zip(port.bodies, ref.bodies)):
        np.testing.assert_array_equal(body_port.mesh.coords,
                                      body_ref.mesh.coords)
        assert list(body_port.cons_dofv.items()) == \
            list(body_ref.cons_dofv.items())
        assert list(body_port.exte_forc.items()) == \
            list(body_ref.exte_forc.items())
        for l, (p_port, p_ref) in enumerate(zip(body_port.mesh.scal_prol,
                                                body_ref.mesh.scal_prol)):
            assert_same(p_port, p_ref, f"bodies[{b}].scal_prol[{l}]")


def _hanging_mesh(cls, case):
    """A mesh with hanging nodes, built by the same calls in either
    package: a corner cell refined twice over a 3x3x2 grid (the 2:1 rule
    forces its neighbours), plus anisotropic cells (patterns 1 and 4), and
    in ``coupled`` a rigid-coupling set on the -x face; or, in
    ``random_amr``, three rounds of full refinement of a seeded eighth of
    the leaves of a 4x3x3 grid."""
    m = cls()
    if case == "random_amr":
        rng = np.random.default_rng(0)
        m.add_box_grid(np.zeros(3), np.array([0.3, 0.5, 0.2]), (4, 3, 3))
        for _ in range(3):
            leaves = m.leaf_elems()
            pick = rng.choice(leaves, size=leaves.size // 8, replace=False)
            m.elem_patt[pick] = 0
            m.refine({int(e) for e in pick})
        m.transfer()
        return m
    m.add_box_grid(np.array([0.1, -0.2, 0.0]),
                   np.array([0.5, 0.4, 0.3]), (3, 3, 2))
    m.elem_patt[0] = 0
    m.refine({0})
    child = int(m.elem_child0[0]) + 7
    m.elem_patt[child] = 0
    m.refine({child})
    leaves = m.leaf_elems()
    far = [int(e) for e in leaves if m.elem_level[e] == 0][-2:]
    m.elem_patt[far[0]] = 1
    m.elem_patt[far[1]] = 4
    m.refine(set(far))
    if case == "coupled":
        face = np.nonzero(np.abs(m.coords[:, 0] - 0.1) < 1e-12)[0]
        m.coup_reps = int(face[0])
        m.coup_nodes = {int(n) for n in face[1:5]}
    m.transfer()
    return m


@pytest.mark.parametrize("case", ["hanging", "coupled", "random_amr"])
def test_transfer_matches_jax_on_hanging_nodes(case):
    port = _hanging_mesh(HexMesh, case)
    ref = _hanging_mesh(JaxHexMesh, case)
    assert len(ref.fino_cono) > 0, "the fixture has no hanging node"
    np.testing.assert_array_equal(port.coords, ref.coords)
    assert list(port.fino_cono.items()) == list(ref.fino_cono.items())
    assert list(port.cono_fino.items()) == list(ref.cono_fino.items())
    for name in ("elem_corn", "elem_patt", "elem_level", "node_level",
                 "node_pos", "pos_node"):
        assert_same(getattr(port, name), getattr(ref, name), name)
    assert_same(port.level_nodes, ref.level_nodes, "level_nodes")
    assert len(port.scal_prol) == len(ref.scal_prol)
    for l, (p_port, p_ref) in enumerate(zip(port.scal_prol, ref.scal_prol)):
        assert_same(p_port, p_ref, f"scal_prol[{l}]")


def test_clipping_drops_a_vertex_outside_the_master_square():
    """A slave quad ~190 faces long whose bottom edge runs along the
    master's, with the 1e-12 rounding of its projected corners (BLOCK's
    ring load at glob_leve=4): the far corner passes for an endpoint on the
    master's edge; the intersection is the master square, area 4."""
    from ddpca_admm_tpu_torch.contact.geometry import clip_pairs

    slav = np.array([[[-180.99999999999983, -1.0000000000010074],
                      [-180.99999999999986, 14.999999999991989],
                      [10.999999999999975, 15.000000000000506],
                      [10.999999999999973, -0.9999999999999417]]])
    _, valid, area = clip_pairs(slav)
    assert valid.any()
    np.testing.assert_allclose(area, [4.0], rtol=1e-12)


@pytest.mark.parametrize("body,half", [(25, (0.015, 0.0125)),
                                       (27, (0.0125, 0.01))])
def test_ring_load_at_glob_leve4_is_the_uncovered_area(body, half):
    """LOAD_SUB on the top slabs of blocks 0 and 1 at the reference's size:
    the pressure times the ring the next block leaves uncovered."""
    from ddpca_admm_tpu_torch.models.block import _block_body

    cfg = BlockConfig(divi=(6, 6, 6), glob_leve=4, doma_numb=(2, 2, 2))
    slab = _block_body(cfg, body)
    fz = sum(v for d, v in slab.exte_forc.items() if d % 3 == 2)
    lb, ls = half
    np.testing.assert_allclose(fz, cfg.pressure * 4 * (lb**2 - ls**2),
                               rtol=1e-12)


def test_accumulate_loads_matches_the_loop():
    rng = np.random.default_rng(7)
    dofs = rng.integers(0, 40, size=(60, 4, 3))
    vals = rng.standard_normal((60, 4, 3)) * 1e5
    start = {31: 0.25, 5: -1.5}
    ref = dict(start)
    for d, v in zip(dofs.ravel(), vals.ravel()):
        ref[int(d)] = ref.get(int(d), 0.0) + float(v)
    got = dict(start)
    accumulate_loads(got, dofs, vals)
    assert list(got.items()) == list(ref.items())


def _fails(x):
    raise ValueError(f"task {x} failed")


def test_host_pool_raises_a_task_failure():
    with HostPool(2) as pool:
        assert pool.map(divmod, [(7, 2), (9, 4)]) == [(3, 1), (2, 1)]
        with pytest.raises(ValueError, match="task 3 failed"):
            pool.map(_fails, [(3,)])


def _worker_allowance(_):
    from ddpca_admm_tpu_torch.utils.pool import host_threads

    return host_threads()


def test_host_threads_follow_the_allowance(monkeypatch):
    """The pool's workers run with an allowance of one core, so their own
    thread_imap runs inline; a process's allowance (DDPCA_HOST_THREADS)
    bounds its threads and its workers, and the workers are counted after
    the memory this process will gather is set aside."""
    import threading

    from ddpca_admm_tpu_torch.utils import pool as P

    with HostPool(2) as pool:
        assert pool.map(_worker_allowance, [(0,), (1,)]) == [1, 1]
    monkeypatch.setenv(P.THREADS_ENV, "1")
    assert P.host_threads() == 1
    main = threading.get_ident()
    assert set(P.thread_imap(lambda _: threading.get_ident(),
                             range(4))) == {main}
    monkeypatch.setenv(P.THREADS_ENV, "3")
    names = set(P.thread_imap(lambda _: threading.get_ident(), range(64)))
    assert main not in names and 1 <= len(names) <= 3
    assert list(P.thread_imap(lambda x: x * x, range(10))) == [
        x * x for x in range(10)]
    monkeypatch.setattr(P, "mem_available", lambda: 10 * 2 ** 30)
    assert P.host_workers(2 ** 30, 8, 0) == 3
    monkeypatch.setenv(P.THREADS_ENV, "16")
    assert P.host_workers(2 ** 30, 8, 0) == 8
    assert P.host_workers(2 ** 30, 8, 4 * 2 ** 30) == 6
    assert P.host_workers(2 ** 30, 8, 20 * 2 ** 30) == 1
