"""BLOCK example: three stacked elastic blocks — the contact patch test.

Re-design of examples/BLOCK.{h,cpp}: blocks of edge length 0.03/0.025/0.02 m
stacked in z, pressure -1e7 Pa on top, frictionless contact between blocks,
domain decomposition of each block into domaNumb^3 core subdomains plus one
full-area thin "guard slab" at the bottom and top of each block (avoiding the
cross-corner problem, BLOCK.h:11-13).  Core subdomains refine with pattern 0,
slabs anisotropically with pattern 1 (xi,eta only, BLOCK.h:355) so every body
has the same multigrid depth.

Interfaces: perfect (fric=-1) between core subdomains and core<->slab;
frictionless contact (fric=0) between the facing slabs of adjacent blocks
(BLOCK.h:574-585).  Penalty rho = E*charFact/charLeng, charFact=25
(BLOCK.h:30,577).

Oracle: uniform stress sigma_zz = -1e7 through all non-matching interfaces,
displacement linear in z (the patch test, examples/BLOCK.cpp:43-49).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import numpy as np

from ..admm.operators import RegionOps
from ..contact.search import mortar_integrate, surface_faces
from ..fem.assembly import accumulate_loads
from ..mesh.hexmesh import HexMesh
from ..utils.pool import HostPool, host_workers
from ..utils.quadrature import quad4_shape
from .simple import (
    Body,
    apply_pressure,
    body_system,
    char_length_of,
    penalty,
    penalty_masses,
    plane_predicate,
    region_from_faces,
)

TOL = 1.0e-9


@dataclass
class BlockConfig:
    leng: tuple[float, float, float] = (0.03, 0.025, 0.02)
    divi: tuple[int, int, int] = (6, 6, 6)
    glob_leve: int = 4
    doma_numb: tuple[int, int, int] = (3, 3, 3)
    pressure: float = -1.0e7
    char_fact: float = 25.0
    e_mod: float = 210.0e9
    nu: float = 0.3
    # False = BLOCK_1 cross-corner variant (examples/BLOCK_1.h): no guard
    # slabs, subdomain corners meet on the contact interfaces, contact
    # regions pair top-layer cores of each block with the overlapping
    # bottom-layer cores of the next.
    guard_slabs: bool = True


@dataclass
class BlockModel:
    cfg: BlockConfig
    bodies: list[Body]
    regions: list[RegionOps]
    systems: list        # per-body ConstrainedSystem (host)
    n_core: int          # core subdomains per block
    slab_base: int       # index of first slab body
    workers: int = 1     # processes the host build ran in
    phases: list = field(default_factory=list)   # (tag, seconds) of its rounds
    # NOTE: the device problem is NOT built here — every caller passes its
    # own dole/musc_sett to build_problem; building one eagerly would hold
    # two full operator sets in device memory.


def _z_offset(cfg: BlockConfig, tb: int) -> float:
    return float(sum(cfg.leng[:tb]))


def _slab_thickness(cfg: BlockConfig, tb: int) -> float:
    return cfg.leng[tb] / (cfg.divi[tb] * (1 << cfg.glob_leve))


# Below this many DOF the build runs in this process: starting the pool's
# interpreters would cost more than the work they share.
POOL_MIN_DOF = 100_000
# A worker's peak memory per DOF of the largest body, which caps the worker
# count by the machine's available memory (utils/pool.host_workers): 9.48 GB
# for glob_leve=4's 352,947 on the card's machine (one body's task alone
# peaks at 2.59 GB; the workers keep their heaps across tasks).
TASK_BYTES_PER_DOF = 27_000
# What this process holds at the end of the build (the regions and the
# systems the workers send back) per DOF of the model, set aside from the
# available memory before the workers are counted: 4.19-4.23 GB for
# glob_leve=3's 1,211,436 DOF, 1.06 GB for glob_leve=2's 180,684
# (scripts/time_host_build.py, ``peak_rss_model``).
PARENT_BYTES_PER_DOF = 3_500


def _core_index(cfg: BlockConfig, tb: int, g0: int, g1: int, g2: int) -> int:
    d0, d1, d2 = cfg.doma_numb
    return tb * d0 * d1 * d2 + g0 * d1 * d2 + g1 * d2 + g2


def _core_geometry(cfg: BlockConfig, tb: int):
    """(L, z_lo, z_hi) of block ``tb``'s core (BLOCK.h:195-294; BLOCK_1.h:
    slabs absorbed)."""
    L = cfg.leng[tb]
    dz = _slab_thickness(cfg, tb) if cfg.guard_slabs else 0.0
    return L, _z_offset(cfg, tb) + dz, _z_offset(cfg, tb) + L - dz


def _block_mesh(cfg: BlockConfig, b: int) -> HexMesh:
    """The refined mesh of body ``b``: a core subdomain (pattern-0
    refinement) or, from ``3 * prod(doma_numb)`` on, a guard slab
    (BLOCK.h:295-387: 2 per block, pattern-1 refinement)."""
    d0, d1, d2 = cfg.doma_numb
    n_core = d0 * d1 * d2
    m = HexMesh()
    if b < 3 * n_core:
        tb, rest = divmod(b, n_core)
        g0, rest = divmod(rest, d1 * d2)
        g1, g2 = divmod(rest, d2)
        L, z_lo, z_hi = _core_geometry(cfg, tb)
        div = cfg.divi[tb]
        assert div % d0 == 0 and div % d1 == 0 and div % d2 == 0
        nd = (div // d0, div // d1, div // d2)
        spac = np.array(
            [L / div, L / div, (z_hi - z_lo) / div]
        )
        origin = np.array(
            [
                -L / 2 + g0 * nd[0] * spac[0],
                -L / 2 + g1 * nd[1] * spac[1],
                z_lo + g2 * nd[2] * spac[2],
            ]
        )
        m.add_box_grid(origin, spac, nd)
        m.refine_uniform(cfg.glob_leve, pattern=0)
    else:
        tb, bu = divmod(b - 3 * n_core, 2)
        L = cfg.leng[tb]
        dz = _slab_thickness(cfg, tb)
        div = cfg.divi[tb]
        z0 = _z_offset(cfg, tb) + (0.0 if bu == 0 else L - dz)
        m.add_box_grid(
            np.array([-L / 2, -L / 2, z0]),
            np.array([L / div, L / div, dz]),
            (div, div, 1),
        )
        m.refine_uniform(cfg.glob_leve, pattern=1)
    return m


def _fix_dofs(body: Body, conds) -> None:
    """``cons_dofv[3 i + k] = 0`` for each (mask, k) of ``conds`` where
    ``mask[i]``, node by node and, within a node, in the order of
    ``conds``."""
    i3 = 3 * np.arange(body.mesh.n_nodes, dtype=np.int64)
    dofs = np.stack(
        [np.where(mask, i3 + k, -1) for mask, k in conds], axis=1
    ).ravel()
    body.cons_dofv.update(dict.fromkeys(dofs[dofs >= 0].tolist(), 0.0))


def _block_body(cfg: BlockConfig, b: int) -> Body:
    """Body ``b`` with its mesh, rollers and loads."""
    d0, d1, d2 = cfg.doma_numb
    n_core = d0 * d1 * d2
    m = _block_mesh(cfg, b)
    body = Body(mesh=m, e_mod=cfg.e_mod, nu=cfg.nu)
    c = m.coords
    pres = np.array([0.0, 0.0, cfg.pressure])
    if b < 3 * n_core:
        tb, rest = divmod(b, n_core)
        g2 = rest % d2
        L, z_lo, z_hi = _core_geometry(cfg, tb)
        # rollers on the block's -x/-y planes; with guard slabs the
        # z-extreme (slab-interface) node layers are skipped (BLOCK.h:280-291),
        # without them they are kept
        free = np.ones(m.n_nodes, dtype=bool)
        if cfg.guard_slabs:
            free = ~((c[:, 2] <= z_lo + 1e-12) | (c[:, 2] >= z_hi - 1e-12))
        _fix_dofs(body, [(free & (c[:, 0] <= -L / 2 + 1e-12), 0),
                         (free & (c[:, 1] <= -L / 2 + 1e-12), 1)])
        if not cfg.guard_slabs and tb == 0 and g2 == 0:
            _fix_dofs(body, [(c[:, 2] <= 1e-10, 2)])
        # cross-corner variant (BLOCK_1.h): the loads land on the top-layer
        # cores directly
        if not cfg.guard_slabs and g2 == d2 - 1:
            z_top = _z_offset(cfg, tb) + cfg.leng[tb]
            if tb == 2:
                apply_pressure(body, plane_predicate(2, z_top, TOL), pres)
            else:
                _ring_load(cfg, body, tb, z_top, pres)
    else:
        tb, bu = divmod(b - 3 * n_core, 2)
        L = cfg.leng[tb]
        _fix_dofs(body, [(c[:, 2] <= 1e-10, 2),        # global bottom only
                         (c[:, 0] <= -L / 2 + 1e-12, 0),
                         (c[:, 1] <= -L / 2 + 1e-12, 1)])
        # loads (BLOCK.h:377-384): top slab of block 2 gets full pressure;
        # top slabs of blocks 0/1 get the uncovered ring
        if bu == 1:
            z_top = _z_offset(cfg, tb) + cfg.leng[tb]
            if tb == 2:
                apply_pressure(body, plane_predicate(2, z_top, TOL), pres)
            else:
                _ring_load(cfg, body, tb, z_top, pres)
    return body


def _region_specs(cfg: BlockConfig) -> list[tuple]:
    """Every region as (master, slave, plane axis, plane value, curvilinear
    slice, bucket divisions, fric): perfect interfaces (fric=-1) between
    cores and core <-> slab, frictionless contact (fric=0) between the
    facing slabs of adjacent blocks (BLOCK.h:574-585), or in the
    cross-corner variant between overlapping top- and bottom-layer cores."""
    d0, d1, d2 = cfg.doma_numb
    n_core = d0 * d1 * d2
    slab_base = 3 * n_core
    fine = [cfg.divi[tb] * (1 << cfg.glob_leve) for tb in range(3)]
    specs = []
    for tb in range(3):
        L, z_lo, z_hi = _core_geometry(cfg, tb)
        bdiv = (
            fine[tb] // d0,
            fine[tb] // d1,
            fine[tb] // d2,
        )
        for g0 in range(d0):
            for g1 in range(d1):
                for g2 in range(d2):
                    me = _core_index(cfg, tb, g0, g1, g2)
                    if g0 < d0 - 1:
                        x = -L / 2 + (g0 + 1) * L / d0
                        specs.append((me, _core_index(cfg, tb, g0 + 1, g1, g2),
                                      0, x, slice(1, 3), (bdiv[1], bdiv[2]),
                                      -1.0))
                    if g1 < d1 - 1:
                        y = -L / 2 + (g1 + 1) * L / d1
                        specs.append((me, _core_index(cfg, tb, g0, g1 + 1, g2),
                                      1, y, slice(0, 3, 2),
                                      (bdiv[0], bdiv[2]), -1.0))
                    if g2 < d2 - 1:
                        z = z_lo + (g2 + 1) * (z_hi - z_lo) / d2
                        specs.append((me, _core_index(cfg, tb, g0, g1, g2 + 1),
                                      2, z, slice(0, 2), (bdiv[0], bdiv[1]),
                                      -1.0))
        # core <-> slabs
        if cfg.guard_slabs:
            for bu in range(2):
                slab = slab_base + 2 * tb + bu
                z = z_lo if bu == 0 else z_hi
                for g0 in range(d0):
                    for g1 in range(d1):
                        g2 = 0 if bu == 0 else d2 - 1
                        specs.append((_core_index(cfg, tb, g0, g1, g2), slab,
                                      2, z, slice(0, 2), (bdiv[0], bdiv[1]),
                                      -1.0))
    if cfg.guard_slabs:
        # contact between blocks: top slab of tb <-> bottom slab of tb+1
        for tb in range(2):
            z = _z_offset(cfg, tb) + cfg.leng[tb]
            specs.append((slab_base + 2 * tb + 1, slab_base + 2 * (tb + 1),
                          2, z, slice(0, 2), (fine[tb], fine[tb]), 0.0))
    else:
        # BLOCK_1 cross-corner contact: every top-layer core of block tb
        # against every bottom-layer core of block tb+1 whose xy footprints
        # overlap (subdomain corners now sit ON the contact interface)
        def footprint(tb, g0, g1):
            L = cfg.leng[tb]
            return (
                -L / 2 + g0 * L / d0, -L / 2 + (g0 + 1) * L / d0,
                -L / 2 + g1 * L / d1, -L / 2 + (g1 + 1) * L / d1,
            )

        for tb in range(2):
            z = _z_offset(cfg, tb) + cfg.leng[tb]
            for g0 in range(d0):
                for g1 in range(d1):
                    fa = footprint(tb, g0, g1)
                    for h0 in range(d0):
                        for h1 in range(d1):
                            fb = footprint(tb + 1, h0, h1)
                            if (
                                min(fa[1], fb[1]) - max(fa[0], fb[0]) <= TOL
                                or min(fa[3], fb[3]) - max(fa[2], fb[2]) <= TOL
                            ):
                                continue
                            specs.append((
                                _core_index(cfg, tb, g0, g1, d2 - 1),
                                _core_index(cfg, tb + 1, h0, h1, 0),
                                2, z, slice(0, 2),
                                (fine[tb] // d0, fine[tb] // d1), 0.0,
                            ))
    return specs


def _mesh_task(cfg: BlockConfig, b: int, planes) -> tuple:
    """Pool task: body ``b``'s node coordinates, leaf volume, and its
    surface faces on each (axis, value) plane of ``planes``."""
    m = _block_mesh(cfg, b)
    faces = [surface_faces(m, plane_predicate(ax, v, TOL)) for ax, v in planes]
    return m.coords, m.leaf_volume(), faces


@dataclass
class _Nodes:
    """What a region search reads of a body's mesh: its node coordinates."""

    coords: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]


def _cart(c: np.ndarray, sl: slice) -> np.ndarray:
    return c[:, sl]


def _region_task(spec: tuple, rho: float, mast_faces, mast_coords,
                 slav_faces, slav_coords) -> RegionOps:
    """Pool task: search one region and assemble its operators."""
    master, slave, _, _, sl, divisions, fric = spec
    return region_from_faces(
        mast_faces, slav_faces, _Nodes(mast_coords), _Nodes(slav_coords),
        (master, slave), ({}, {}), partial(_cart, sl=sl), divisions,
        fric=fric, pena_n=rho,
    )


def _system_task(cfg: BlockConfig, b: int, masses) -> tuple:
    """Pool task: body ``b`` built again (the same bits), then its TRANSFER,
    stiffness plus the regions' penalty terms ``masses``, and CONSTRAINT."""
    body = _block_body(cfg, b)
    return body, body_system(body, masses)


def block_dof_estimate(cfg: BlockConfig) -> tuple[int, int]:
    """(DOF of the model, DOF of its largest body), from the grid sizes."""
    d0, d1, d2 = cfg.doma_numb
    total = biggest = 0
    for tb in range(3):
        f = cfg.divi[tb] << cfg.glob_leve
        core = 3 * (f // d0 + 1) * (f // d1 + 1) * (f // d2 + 1)
        total += d0 * d1 * d2 * core
        biggest = max(biggest, core)
        if cfg.guard_slabs:
            total += 2 * 3 * 2 * (f + 1) ** 2
    return total, biggest


def block_workers(cfg: BlockConfig) -> int:
    """The build pool's worker count for ``cfg``: one below POOL_MIN_DOF,
    else as many as the cores allow and the available memory holds beside
    what this process gathers."""
    total, biggest = block_dof_estimate(cfg)
    if total < POOL_MIN_DOF:
        return 1
    n_bodies = 3 * int(np.prod(cfg.doma_numb)) + (6 if cfg.guard_slabs else 0)
    return host_workers(TASK_BYTES_PER_DOF * biggest, n_bodies,
                        PARENT_BYTES_PER_DOF * total)


def build_block_model(cfg: BlockConfig = BlockConfig(),
                      workers: int | None = None) -> BlockModel:
    """The BLOCK model: bodies, regions and constrained systems, built in a
    pool of ``workers`` processes (default ``block_workers(cfg)``) in three
    maps: the meshes' contact surfaces, the regions, the bodies' systems -
    with the same bits at any worker count.  ``BlockModel.phases`` holds
    the seconds of the meshes and of the regions; the systems' go to
    ``utils/timing`` under ``assemble_bodies``' tag, so that the phases
    there keep the JAX package's tags, which the command line reports."""
    import time

    from ..utils.timing import phase

    d0, d1, d2 = cfg.doma_numb
    n_core = d0 * d1 * d2
    n_bodies = 3 * n_core + (6 if cfg.guard_slabs else 0)
    specs = _region_specs(cfg)
    planes = [[] for _ in range(n_bodies)]    # (region, side) per body
    for r, (master, slave, ax, v, *_) in enumerate(specs):
        planes[master].append((r, 0, ax, v))
        planes[slave].append((r, 1, ax, v))
    workers = block_workers(cfg) if workers is None else int(workers)
    phases = []
    t = time.perf_counter()
    with HostPool(workers) as pool:
        meshes = pool.map(_mesh_task, [
            (cfg, b, [(ax, v) for _, _, ax, v in planes[b]])
            for b in range(n_bodies)
        ])
        phases.append(("BLOCK meshes (REFINE + surfaces)",
                       time.perf_counter() - t))
        faces = {}
        for b, (_, _, fs) in enumerate(meshes):
            for (r, side, _, _), f in zip(planes[b], fs):
                faces[r, side] = f
        rho = penalty(cfg.char_fact,
                      char_length_of([vol for _, vol, _ in meshes]), 210.0e9)
        # the largest searches first
        order = sorted(range(len(specs)), key=lambda r: -(
            faces[r, 0].shape[0] + faces[r, 1].shape[0]))
        t = time.perf_counter()
        done = pool.map(_region_task, [
            (specs[r], rho, faces[r, 0], meshes[specs[r][0]][0],
             faces[r, 1], meshes[specs[r][1]][0]) for r in order
        ])
        del meshes, faces
        regions: list[RegionOps] = [None] * len(specs)
        for r, reg in zip(order, done):
            regions[r] = reg
        del done
        phases.append(("BLOCK regions (CONTACT_SEARCH + operators)",
                       time.perf_counter() - t))
        with phase("MCONTACT::ESTABLISH bodies (TRANSFER+STIF_MATR+CONSTRAINT)"):
            built = pool.map(_system_task, [
                (cfg, b, penalty_masses(b, [
                    regions[r] for r in sorted({r for r, *_ in planes[b]})
                ])) for b in range(n_bodies)
            ])
    return BlockModel(
        cfg=cfg, bodies=[body for body, _ in built], regions=regions,
        systems=[system for _, system in built], n_core=n_core,
        slab_base=3 * n_core, workers=workers, phases=phases,
    )


def _ring_load(cfg: BlockConfig, slab: Body, tb: int, z_top: float,
               pres: np.ndarray) -> None:
    """LOAD_SUB (BLOCK.h:392-481): pressure on the frame ring of the top
    surface not covered by the next block, integrated by mortar clipping."""
    Lb = cfg.leng[tb] / 2.0
    Ls = cfg.leng[tb + 1] / 2.0
    rings = np.array(
        [
            [[-Lb, -Lb], [-Lb, -Ls], [Lb, -Ls], [Lb, -Lb]],
            [[-Lb, -Ls], [-Lb, Ls], [-Ls, Ls], [-Ls, -Ls]],
            [[Ls, -Ls], [Ls, Ls], [Lb, Ls], [Lb, -Ls]],
            [[-Lb, Ls], [-Lb, Lb], [Lb, Lb], [Lb, Ls]],
        ]
    )  # (4,4,2)
    ring3 = np.concatenate(
        [rings, np.full(rings.shape[:-1] + (1,), z_top)], axis=-1
    )  # (4,4,3)
    faces = surface_faces(slab.mesh, plane_predicate(2, z_top, TOL))
    F = faces.shape[0]
    mast = np.repeat(slab.mesh.coords[faces], 4, axis=0)       # (F*4,4,3)
    slav = np.tile(ring3, (F, 1, 1))                           # (F*4,4,3)
    pair, mxi, sxi, w, basis, gap = mortar_integrate(mast, slav)
    if pair.size == 0:
        return
    face_of_pair = pair // 4
    N = quad4_shape(mxi)                                       # (I,4)
    contrib = w[:, None, None] * N[:, :, None] * pres[None, None, :]
    dofs = 3 * faces[face_of_pair][:, :, None] + np.arange(3)
    accumulate_loads(slab.exte_forc, dofs, contrib)
