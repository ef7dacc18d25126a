"""TORSION example: hollow cylinder under torque — analytic-twist oracle.

Re-design of examples/TORSION.{h,cpp}: hollow cylinder r in [15,25] mm,
length 0.1 m, torque 20 N*m applied as the exact shear traction
tau = T*r/I_p on the top face; bottom face fully fixed.  Cylindrical-shell
domain decomposition (1 x domaNumb_theta x domaNumb_z subdomains, including
the periodic seam interface, TORSION.h:460-464), all interfaces perfect.

Refinement keeps nodes on exact cylinders: every bisection node is placed at
the *cylindrical* average of its parent entity (radius and angle averaged
with branch-cut handling), reproducing COOR_AVER/SUBR_PLSU
(TORSION.h:53-128).

Oracle (TORSION.h:45,49): I_p = pi/32 (D^4 - d^4) = 5.340707511103e-3 m^4,
twist displacement at outer radius u = T*l/(G*I_p)*R = 1.159111630361142e-6 m
for the default geometry.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..admm.operators import RegionOps
from ..admm.problem import AdmmMeta, AdmmProblem, build_problem
from ..mesh.hexmesh import HexMesh
from ..mesh.templates import TEMPLATES
from ..utils.quadrature import HEX_EDGES, HEX_FACES, QUAD_QUAD, surface_jacobian
from .simple import Body, assemble_bodies, char_length, make_region, penalty

TOL = 1.0e-9


def cylindrical_average(coords: np.ndarray) -> np.ndarray:
    """COOR_AVER (TORSION.h:53-79): average radius and angle (branch-cut:
    negative angles get +2pi when the entity straddles the seam).

    coords (..., m, 3) -> (..., 3).
    """
    r = np.hypot(coords[..., 0], coords[..., 1])
    ang = np.arctan2(coords[..., 1], coords[..., 0])
    pos = (ang > np.pi / 2).any(axis=-1)
    neg = (ang < -np.pi / 2).any(axis=-1)
    straddle = pos & neg
    # on straddling entities, shift the negative-side angles by +2pi
    corr = np.where(
        straddle[..., None] & (ang < -np.pi / 2), 2 * np.pi, 0.0
    )
    ang_mean = (ang + corr).mean(axis=-1)
    r_mean = r.mean(axis=-1)
    z_mean = coords[..., 2].mean(axis=-1)
    return np.stack(
        [r_mean * np.cos(ang_mean), r_mean * np.sin(ang_mean), z_mean], axis=-1
    )


def cylindrical_plan_surf(mesh: HexMesh, elems: np.ndarray) -> dict:
    """SUBR_PLSU for a batch of elements: entity keys (sorted node tuples for
    all 12 edges, 6 faces, and the cell) -> cylindrical average position."""
    plan = {}
    corn = mesh.elem_corn[elems]
    for table in (HEX_EDGES, HEX_FACES, np.arange(8)[None, :]):
        for row in table:
            nodes = np.sort(corn[:, row], axis=1)
            coords = cylindrical_average(mesh.coords[nodes])
            for key, val in zip(nodes, coords):
                plan[tuple(int(v) for v in key)] = val
    return plan


def refine_cylindrical(mesh: HexMesh, pattern: int) -> None:
    leaves = mesh.leaf_elems()
    mesh.elem_patt[leaves] = pattern
    plan = cylindrical_plan_surf(mesh, leaves)
    mesh.refine(set(int(x) for x in leaves), plan_surf=plan)


@dataclass
class TorsionConfig:
    axia_leng: float = 0.1
    inne_radi: float = 0.015
    oute_radi: float = 0.025
    divi: tuple[int, int, int] = (1, 32, 8)     # radial, angular, axial cells
    doma: tuple[int, int, int] = (1, 32, 8)     # subdomains per direction
    glob_inho: int = 1                          # axial-only rounds (patt 6)
    glob_homo: int = 4                          # full rounds (patt 0)
    torque: float = 20.0
    char_fact: float = 25.0
    e_mod: float = 210.0e9
    nu: float = 0.3

    @property
    def polar_inertia(self) -> float:
        return np.pi / 32.0 * ((2 * self.oute_radi) ** 4 - (2 * self.inne_radi) ** 4)

    @property
    def analytic_twist(self) -> float:
        G = self.e_mod / (2.0 * (1.0 + self.nu))
        return (
            self.torque * self.axia_leng / (G * self.polar_inertia) * self.oute_radi
        )


def _angle_plane_pred(theta: float):
    s, c = np.sin(theta), np.cos(theta)

    def pred(coords):
        return (np.abs(coords[..., 0] * s - coords[..., 1] * c) < 1e-9) & (
            coords[..., 0] * c + coords[..., 1] * s > 0
        )

    return pred


def _wrapped_angle(coords):
    ang = np.arctan2(coords[:, 1], coords[:, 0])
    ang = np.where(ang < 0.0, ang + 2 * np.pi, ang)
    ang = np.where((coords[:, 0] > 0) & (np.abs(coords[:, 1]) < 1e-10), 0.0, ang)
    return ang


def build_torsion_model(cfg: TorsionConfig = TorsionConfig(), device="cuda"):
    d0, d1, d2 = cfg.doma
    n0, n1, n2 = cfg.divi
    assert n0 % d0 == 0 and n1 % d1 == 0 and n2 % d2 == 0
    nd = (n0 // d0, n1 // d1, n2 // d2)
    bodies: list[Body] = []

    for g0 in range(d0):
        for g1 in range(d1):
            for g2 in range(d2):
                m = HexMesh()

                def to_cyl(lat, g0=g0, g1=g1, g2=g2):
                    r = cfg.inne_radi + (cfg.oute_radi - cfg.inne_radi) / n0 * (
                        g0 * nd[0] + lat[:, 0]
                    )
                    th = 2.0 * np.pi / n1 * (g1 * nd[1] + lat[:, 1])
                    z = cfg.axia_leng / n2 * (g2 * nd[2] + lat[:, 2])
                    return np.stack([r * np.cos(th), r * np.sin(th), z], axis=-1)

                m.add_box_grid(np.zeros(3), np.ones(3), nd, coords_fn=to_cyl)
                for _ in range(cfg.glob_inho):
                    refine_cylindrical(m, 6)     # axial bisection only
                for _ in range(cfg.glob_homo):
                    refine_cylindrical(m, 0)
                b = Body(mesh=m, e_mod=cfg.e_mod, nu=cfg.nu)
                # bottom clamp (TORSION.h:132-138)
                for i, c in enumerate(m.coords):
                    if c[2] <= 1e-10:
                        for k in range(3):
                            b.cons_dofv[3 * i + k] = 0.0
                _torque_load(cfg, b)
                bodies.append(b)

    rho = penalty(cfg.char_fact, char_length(bodies), 210.0e9)

    def idx(g0, g1, g2):
        return g0 * d1 * d2 + g1 * d2 + g2

    regions: list[RegionOps] = []
    for g0 in range(d0):
        for g1 in range(d1):
            for g2 in range(d2):
                me = idx(g0, g1, g2)
                if g0 < d0 - 1:
                    r_if = cfg.inne_radi + (cfg.oute_radi - cfg.inne_radi) * (
                        (g0 + 1) / d0
                    )
                    regions.append(
                        make_region(
                            bodies, me, idx(g0 + 1, g1, g2),
                            lambda c, r=r_if: np.abs(
                                np.hypot(c[..., 0], c[..., 1]) - r
                            ) < 1e-9,
                            lambda c, r=r_if: np.abs(
                                np.hypot(c[..., 0], c[..., 1]) - r
                            ) < 1e-9,
                            lambda c: np.stack(
                                [_wrapped_angle(c), c[:, 2]], axis=-1
                            ),
                            (nd[1] << cfg.glob_homo,
                             nd[2] << (cfg.glob_inho + cfg.glob_homo)),
                            fric=-1.0, pena_n=rho,
                        )
                    )
                if d1 > 1 or True:
                    # angular interface incl. the periodic seam
                    # (TORSION.h:460-464: every g1 has a +theta neighbor)
                    if d1 > 1:
                        mate = idx(g0, (g1 + 1) % d1, g2)
                        theta = 2.0 * np.pi * (g1 + 1) / d1
                        regions.append(
                            make_region(
                                bodies, me, mate,
                                _angle_plane_pred(theta),
                                _angle_plane_pred(theta),
                                lambda c: np.stack(
                                    [np.hypot(c[:, 0], c[:, 1]), c[:, 2]], axis=-1
                                ),
                                (nd[0] << cfg.glob_homo,
                                 nd[2] << (cfg.glob_inho + cfg.glob_homo)),
                                fric=-1.0, pena_n=rho,
                            )
                        )
                if g2 < d2 - 1:
                    z = cfg.axia_leng * (g2 + 1) / d2
                    regions.append(
                        make_region(
                            bodies, me, idx(g0, g1, g2 + 1),
                            lambda c, z=z: np.abs(c[..., 2] - z) < 1e-9,
                            lambda c, z=z: np.abs(c[..., 2] - z) < 1e-9,
                            lambda c: np.stack(
                                [np.hypot(c[:, 0], c[:, 1]), _wrapped_angle(c)],
                                axis=-1,
                            ),
                            (nd[0] << cfg.glob_homo, nd[1] << cfg.glob_homo),
                            fric=-1.0, pena_n=rho,
                        )
                    )

    systems = assemble_bodies(bodies, regions)
    dole = [min(1, s.n_levels - 1) for s in systems]
    prob, meta = build_problem(systems, regions, dole=dole, device=device)
    return prob, meta, bodies, cfg


def _torque_load(cfg: TorsionConfig, body: Body) -> None:
    """Exact torsion shear traction on z = L faces (TORSION.h:140-183)."""
    m = body.mesh
    torq_scal = 2.0 * cfg.torque / (
        (cfg.oute_radi**4 - cfg.inne_radi**4) * np.pi
    )
    from ..contact.search import surface_faces

    faces = surface_faces(
        m, lambda c: c[..., 2] >= cfg.axia_leng - 1e-10
    )
    if faces.size == 0:
        return
    corners = m.coords[faces]                        # (F,4,3)
    for g in range(QUAD_QUAD.n_gp):
        nat = QUAD_QUAD.points[g]
        N = QUAD_QUAD.shape[g]
        w = QUAD_QUAD.weights[g]
        x = np.einsum("a,fac->fc", N, corners)       # (F,3)
        jac = surface_jacobian(
            np.broadcast_to(nat, (corners.shape[0], 2)), corners
        )
        ang = np.arctan2(x[:, 1], x[:, 0]) + np.pi / 2.0
        amp = torq_scal * np.hypot(x[:, 0], x[:, 1])
        trac = np.stack(
            [amp * np.cos(ang), amp * np.sin(ang), np.zeros_like(amp)], axis=-1
        )
        contrib = (w * jac)[:, None, None] * N[None, :, None] * trac[:, None, :]
        dofs = 3 * faces[:, :, None] + np.arange(3)
        for d, v in zip(dofs.ravel(), contrib.ravel()):
            body.exte_forc[int(d)] = body.exte_forc.get(int(d), 0.0) + float(v)
