"""Minimal multibody fixtures: stacked boxes with contact / split boxes with
perfect interfaces.  These are the smallest end-to-end exercises of the full
pipeline (mesh -> search -> ESTABLISH -> ADMM) and double as integration
tests; the production examples (BLOCK/BEAM/...) build on the same helpers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..admm.operators import Region, RegionOps, build_region_ops
from ..admm.problem import AdmmMeta, AdmmProblem, build_problem
from ..contact.search import region_search, surface_faces
from ..fem.assembly import assemble_stiffness, distribute_face_load
from ..fem.constraints import ConstrainedSystem, constrain
from ..fem.elasticity import DEFAULT_E, DEFAULT_NU
from ..mesh.hexmesh import HexMesh
from ..utils.quadrature import HEX_FACES


@dataclass
class Body:
    mesh: HexMesh
    cons_dofv: dict[int, float] = field(default_factory=dict)
    exte_forc: dict[int, float] = field(default_factory=dict)
    node_rota: dict[int, np.ndarray] = field(default_factory=dict)
    e_mod: float = DEFAULT_E
    nu: float = DEFAULT_NU


def char_length(bodies: list[Body]) -> float:
    """GET_CHAR_LENG (MCONTACT.h:2478-2491): cube root of mean volume."""
    return char_length_of([b.mesh.leaf_volume() for b in bodies])


def char_length_of(vols: list[float]) -> float:
    """``char_length`` from the bodies' leaf volumes."""
    return float(np.mean(vols) ** (1.0 / 3.0))


def penalty(char_fact: float, char_leng: float, e_mod: float = 210.0e9) -> float:
    """rho = E * charFact / charLeng (BLOCK.h:577)."""
    return e_mod * char_fact / char_leng


def plane_predicate(axis: int, value: float, tol: float = 1e-9):
    return lambda c: np.abs(c[..., axis] - value) < tol


def assemble_bodies(
    bodies: list[Body], regions: list[RegionOps], include_penalty: bool = True
) -> list[ConstrainedSystem]:
    """Per-body TRANSFER + STIF_MATR + systMass + CONSTRAINT
    (MCONTACT.h:812-825).  ``include_penalty=False`` gives the penalty-free
    stiffness used by the LAGRANGE dual-mortar solver (MCONTACT.h:2850-2860
    rebuilds without systMass)."""
    from ..utils.timing import phase

    with phase("MCONTACT::ESTABLISH bodies (TRANSFER+STIF_MATR+CONSTRAINT)"):
        return [
            body_system(b, penalty_masses(tv, regions) if include_penalty
                        else [])
            for tv, b in enumerate(bodies)
        ]


def penalty_masses(tv: int, regions: list[RegionOps]) -> list:
    """The penalty stiffness terms ``systMass`` of body ``tv``, in the order
    they are added to its stiffness (region by region, master side first)."""
    return [r.sides[s].syst_mass for r in regions for s in (0, 1)
            if r.region.bodies[s] == tv]


def body_system(b: Body, masses: list) -> ConstrainedSystem:
    """One body's TRANSFER, stiffness plus ``masses``, and CONSTRAINT."""
    if not b.mesh.scal_prol:
        b.mesh.transfer()
    A = assemble_stiffness(b.mesh, b.e_mod, b.nu)
    for M in masses:
        A = (A + M).tocsr()
    return constrain(b.mesh, A, b.cons_dofv, b.exte_forc, b.node_rota)


def make_region(
    bodies: list[Body],
    master: int,
    slave: int,
    mast_pred,
    slav_pred,
    cart_curv,
    divisions: tuple[int, int],
    fric: float,
    pena_n: float,
    pena_f: float | None = None,
    max_dist: float = 1.0e12,
    max_abs_dist: float | None = None,
) -> RegionOps:
    """Search one region and assemble its operators.

    ``max_abs_dist``: point-level |gap| cutoff for *coincident* perfect
    interfaces — unlike the reference's signed pair-level ``maxiDist``
    (CSEARCH.h:796), it also drops spurious penetrating pairs that the mortar
    projection can produce where an interface surface bends (see
    models/dehw_assembly.DehwDDConfig.iface_max_dist)."""
    mm, sm = bodies[master].mesh, bodies[slave].mesh
    return region_from_faces(
        surface_faces(mm, mast_pred), surface_faces(sm, slav_pred), mm, sm,
        (master, slave), (bodies[master].node_rota, bodies[slave].node_rota),
        cart_curv, divisions, fric, pena_n, pena_f, max_dist, max_abs_dist,
    )


def region_from_faces(
    mast_faces: np.ndarray,
    slav_faces: np.ndarray,
    mm,
    sm,
    pair: tuple[int, int],
    node_rota: tuple,
    cart_curv,
    divisions: tuple[int, int],
    fric: float,
    pena_n: float,
    pena_f: float | None = None,
    max_dist: float = 1.0e12,
    max_abs_dist: float | None = None,
) -> RegionOps:
    """``make_region`` from the two sides' surface faces: ``mm``/``sm`` are
    the master's and slave's meshes, of which the search reads ``coords``
    and ``n_nodes``; ``pair`` = (master, slave) body indices."""
    ip = region_search(
        mast_faces, slav_faces, mm, sm, cart_curv, divisions, max_dist
    )
    if max_abs_dist is not None and ip.n:
        keep = np.abs(ip.gap) <= max_abs_dist
        import dataclasses

        ip = dataclasses.replace(
            ip,
            nodes=ip.nodes[:, keep], shape=ip.shape[:, keep],
            points=ip.points[:, keep], basis=ip.basis[keep],
            gap=ip.gap[keep], weight=ip.weight[keep], pair=ip.pair[keep],
        )
    reg = Region(
        ip=ip,
        bodies=tuple(pair),
        fric=fric,
        pena_n=pena_n,
        pena_f=pena_f if pena_f is not None else pena_n,
    )
    return build_region_ops(reg, (mm.n_nodes, sm.n_nodes), node_rota)


def apply_pressure(body: Body, pred, pressure: np.ndarray) -> None:
    faces = surface_faces(body.mesh, pred)
    distribute_face_load(
        body.mesh, faces, lambda x: np.asarray(pressure), body.exte_forc
    )


def fix_plane(body: Body, axis: int, value: float, comps, tol: float = 1e-9):
    for i, c in enumerate(body.mesh.coords):
        if abs(c[axis] - value) < tol:
            for k in comps:
                body.cons_dofv[3 * i + k] = 0.0


def stacked_boxes_problem(
    div_bot: int = 3,
    div_top: int = 2,
    levels: int = 1,
    pressure: float = -1.0e7,
    char_fact: float = 25.0,
    fric: float = 0.0,
    shear: float = 0.0,
    device="cuda",
) -> tuple[AdmmProblem, AdmmMeta, list[Body]]:
    """Two stacked unit-ish boxes, frictionless contact at z=1: the two-body
    contact patch test (BLOCK's physics, minimal geometry).

    Bottom box [0,1]^3 (div_bot^3 cells), top box [0,1]x[0,1]x[1,2]
    (div_top^3 cells, non-matching), pressure on top, rollers on the
    symmetry-style side planes, bottom fixed in z.
    """
    bot = HexMesh()
    bot.add_box_grid(np.zeros(3), np.ones(3) / div_bot, (div_bot,) * 3)
    bot.refine_uniform(levels)
    top = HexMesh()
    top.add_box_grid(np.array([0.0, 0.0, 1.0]), np.ones(3) / div_top, (div_top,) * 3)
    top.refine_uniform(levels)
    bodies = [Body(mesh=bot), Body(mesh=top)]

    if fric > 0.0:
        # frictional fixture: clamp the bottom box; the top box is held only
        # by contact + friction under combined pressure and shear
        for i, c in enumerate(bodies[0].mesh.coords):
            if c[2] < 1e-9:
                for k in range(3):
                    bodies[0].cons_dofv[3 * i + k] = 0.0
        apply_pressure(
            bodies[1], plane_predicate(2, 2.0),
            np.array([shear, 0.0, pressure]),
        )
    else:
        for b in bodies:
            fix_plane(b, 0, 0.0, (0,))
            fix_plane(b, 1, 0.0, (1,))
        fix_plane(bodies[0], 2, 0.0, (2,))
        apply_pressure(
            bodies[1], plane_predicate(2, 2.0), np.array([0, 0, pressure])
        )

    rho = penalty(char_fact, char_length(bodies))
    regions = [
        make_region(
            bodies, 0, 1,
            plane_predicate(2, 1.0), plane_predicate(2, 1.0),
            lambda x: x[:, :2], (div_bot * 2**levels,) * 2,
            fric=fric, pena_n=rho,
        )
    ]
    systems = assemble_bodies(bodies, regions)
    prob, meta = build_problem(systems, regions, device=device)
    return prob, meta, bodies


def chain_problem(
    n_bodies: int = 8,
    div: int = 2,
    levels: int = 1,
    char_fact: float = 25.0,
    structured: bool = False,
    fric_mid: float = 0.0,
    device="cuda",
) -> tuple[AdmmProblem, AdmmMeta, list[Body]]:
    """A chain of n stacked boxes (alternating non-matching meshes) tied by
    perfect interfaces, except the middle joint which is frictionless
    contact (``fric_mid=0``) or Coulomb frictional contact (``fric_mid>0``,
    vector mode with a tangential load component so the cone projection is
    actually exercised) — the JAX package's multi-chip fixture."""
    bodies = []
    for i in range(n_bodies):
        d = div + (i % 2)  # alternate divisions -> non-matching interfaces
        m = HexMesh()
        m.add_box_grid(np.array([0.0, 0.0, float(i)]), np.ones(3) / d, (d, d, d))
        m.refine_uniform(levels)
        b = Body(mesh=m)
        fix_plane(b, 0, 0.0, (0,))
        fix_plane(b, 1, 0.0, (1,))
        bodies.append(b)
    fix_plane(bodies[0], 2, 0.0, (2,))
    shear = 0.2e7 if fric_mid > 0.0 else 0.0
    apply_pressure(
        bodies[-1], plane_predicate(2, float(n_bodies)),
        np.array([shear, 0, -1.0e7]),
    )
    rho = penalty(char_fact, char_length(bodies))
    mid = n_bodies // 2
    regions = []
    for i in range(n_bodies - 1):
        z = float(i + 1)
        regions.append(
            make_region(
                bodies, i, i + 1,
                plane_predicate(2, z), plane_predicate(2, z),
                lambda x: x[:, :2], (div * 2**levels,) * 2,
                fric=fric_mid if i == mid else -1.0, pena_n=rho,
                pena_f=rho if (fric_mid > 0.0 and i == mid) else None,
            )
        )
    systems = assemble_bodies(bodies, regions)
    # MULTISCALE_1 coarse correction: without it an n-body chain propagates
    # boundary information one interface per ADMM iteration (same reason the
    # reference runs BLOCK with muscSett set, MCONTACT.h:2540-2624)
    prob, meta = build_problem(systems, regions, dole=[0] * n_bodies,
                               structured=structured, device=device)
    return prob, meta, bodies


def split_box_problem(
    div: int = 2,
    levels: int = 1,
    char_fact: float = 25.0,
    device="cuda",
) -> tuple[AdmmProblem, AdmmMeta, list[Body]]:
    """Unit box split into two subdomains tied by a perfect interface
    (fric < 0, vector mode), under top pressure.  Oracle: the unsplit
    single-body solution."""
    left = HexMesh()
    left.add_box_grid(np.zeros(3), np.array([0.5 / div, 1.0 / div, 1.0 / div]),
                      (div, div, div))
    left.refine_uniform(levels)
    right = HexMesh()
    right.add_box_grid(np.array([0.5, 0, 0]),
                       np.array([0.5 / div, 1.0 / div, 1.0 / div]),
                       (div, div, div))
    right.refine_uniform(levels)
    bodies = [Body(mesh=left), Body(mesh=right)]
    for b in bodies:
        fix_plane(b, 2, 0.0, (0, 1, 2))
    pres = np.array([0, 0, -1.0e7])
    for b in bodies:
        apply_pressure(b, plane_predicate(2, 1.0), pres)

    rho = penalty(char_fact, char_length(bodies))
    regions = [
        make_region(
            bodies, 0, 1,
            plane_predicate(0, 0.5), plane_predicate(0, 0.5),
            lambda x: x[:, 1:3], (div * 2**levels,) * 2,
            fric=-1.0, pena_n=rho,
        )
    ]
    systems = assemble_bodies(bodies, regions)
    prob, meta = build_problem(systems, regions, device=device)
    return prob, meta, bodies
