"""BEAM example: pre-twisted tapered cantilever with 256-subdomain DD.

Re-design of examples/BEAM.{h,cpp}: a 1 x 0.12 x 0.06 m cantilever whose
cross-section tapers linearly to 1/3 at the free end, pre-twisted 45 degrees
about the x axis (twist angle proportional to x, BEAM.h:79-87).  Meshes are
built in straight (untwisted) coordinates, refined, then the twist map is
applied to every node (COOR_ADJU, BEAM.h:89-99).  Loads: centerline line
load -8000 N/m (loadType 0) or equivalent end-face pressure (loadType 1);
clamped at x=0.  All interfaces perfect; oracle = the unsplit single-body
solve (SOLVE_NODD, BEAM.h:403-419).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..admm.operators import RegionOps
from ..admm.problem import build_problem
from ..mesh.hexmesh import HexMesh
from .simple import Body, assemble_bodies, char_length, make_region, penalty

TOL = 1.0e-9


@dataclass
class BeamConfig:
    leng: tuple[float, float, float] = (1.0, 0.12, 0.06)
    leng_fact: float = 1.0 / 3.0
    angl: float = np.pi / 4.0
    divi: tuple[int, int, int] = (64, 4, 2)
    glob_leve: int = 4
    doma: tuple[int, int, int] = (32, 4, 2)
    load_inte: float = -8000.0
    char_fact: float = 25.0
    e_mod: float = 210.0e9
    nu: float = 0.3


def twist_map(cfg: BeamConfig, direction: int = 1):
    """SUBR_ROTA: rotate (y,z) about x by direction*angl*x/L."""

    def fn(coords):
        coords = np.atleast_2d(coords)
        a = direction * cfg.angl * coords[:, 0] / cfg.leng[0]
        c, s = np.cos(a), np.sin(a)
        return np.stack(
            [
                coords[:, 0],
                c * coords[:, 1] - s * coords[:, 2],
                s * coords[:, 1] + c * coords[:, 2],
            ],
            axis=-1,
        )

    return fn


def straight_grid(cfg: BeamConfig, lo: np.ndarray, nd, base_div, offs):
    """Node coords of the tapered straight beam lattice."""

    def fn(lat):
        ti = offs[0] + lat[:, 0]
        x = cfg.leng[0] / base_div[0] * ti
        frac = ti / base_div[0]
        h = cfg.leng[1] * (1.0 - frac * cfg.leng_fact)
        w = cfg.leng[2] * (1.0 - frac * cfg.leng_fact)
        y = -h / 2.0 + h / base_div[1] * (offs[1] + lat[:, 1])
        z = -w / 2.0 + w / base_div[2] * (offs[2] + lat[:, 2])
        return np.stack([x, y, z], axis=-1)

    return fn


def build_beam_model(cfg: BeamConfig = BeamConfig(), load_type: int = 0,
                     device="cuda"):
    d0, d1, d2 = cfg.doma
    n0, n1, n2 = cfg.divi
    nd = (n0 // d0, n1 // d1, n2 // d2)
    inv_twist = twist_map(cfg, -1)
    fwd_twist = twist_map(cfg, 1)
    bodies: list[Body] = []

    for g0 in range(d0):
        for g1 in range(d1):
            for g2 in range(d2):
                m = HexMesh()
                m.add_box_grid(
                    np.zeros(3), np.ones(3), nd,
                    coords_fn=straight_grid(
                        cfg, np.zeros(3), nd, cfg.divi,
                        (g0 * nd[0], g1 * nd[1], g2 * nd[2]),
                    ),
                )
                m.refine_uniform(cfg.glob_leve, pattern=0)
                m.transform(fwd_twist)
                b = Body(mesh=m, e_mod=cfg.e_mod, nu=cfg.nu)
                # clamp at x=0 (BEAM.h:103-109)
                for i, c in enumerate(m.coords):
                    if c[0] <= 1e-10:
                        for k in range(3):
                            b.cons_dofv[3 * i + k] = 0.0
                _beam_load(cfg, b, load_type)
                bodies.append(b)

    rho = penalty(cfg.char_fact, char_length(bodies), 210.0e9)

    def idx(g0, g1, g2):
        return g0 * d1 * d2 + g1 * d2 + g2

    def straight_pred(axis: int, value_fn):
        # predicate in untwisted coordinates
        def pred(coords):
            straight = inv_twist(coords.reshape(-1, 3)).reshape(coords.shape)
            return value_fn(straight)

        return pred

    fine = [cfg.divi[i] * (1 << cfg.glob_leve) for i in range(3)]
    regions: list[RegionOps] = []
    for g0 in range(d0):
        for g1 in range(d1):
            for g2 in range(d2):
                me = idx(g0, g1, g2)
                if g0 < d0 - 1:
                    x = cfg.leng[0] * (g0 + 1) / d0
                    regions.append(
                        make_region(
                            bodies, me, idx(g0 + 1, g1, g2),
                            lambda c, x=x: np.abs(c[..., 0] - x) < TOL,
                            lambda c, x=x: np.abs(c[..., 0] - x) < TOL,
                            lambda c: _straight_uv(inv_twist, c, (1, 2)),
                            (fine[1] // d1, fine[2] // d2),
                            fric=-1.0, pena_n=rho,
                        )
                    )
                if g1 < d1 - 1:
                    yfrac = (g1 + 1) / d1 - 0.5   # y = yfrac * height(x)
                    regions.append(
                        make_region(
                            bodies, me, idx(g0, g1 + 1, g2),
                            straight_pred(1, lambda s, yf=yfrac: _on_taper(
                                cfg, s, 1, yf)),
                            straight_pred(1, lambda s, yf=yfrac: _on_taper(
                                cfg, s, 1, yf)),
                            lambda c: _straight_uv(inv_twist, c, (0, 2)),
                            (fine[0] // d0, fine[2] // d2),
                            fric=-1.0, pena_n=rho,
                        )
                    )
                if g2 < d2 - 1:
                    zfrac = (g2 + 1) / d2 - 0.5
                    regions.append(
                        make_region(
                            bodies, me, idx(g0, g1, g2 + 1),
                            straight_pred(2, lambda s, zf=zfrac: _on_taper(
                                cfg, s, 2, zf)),
                            straight_pred(2, lambda s, zf=zfrac: _on_taper(
                                cfg, s, 2, zf)),
                            lambda c: _straight_uv(inv_twist, c, (0, 1)),
                            (fine[0] // d0, fine[1] // d1),
                            fric=-1.0, pena_n=rho,
                        )
                    )

    systems = assemble_bodies(bodies, regions)
    dole = [min(1, s.n_levels - 1) for s in systems]
    prob, meta = build_problem(systems, regions, dole=dole, device=device)
    return prob, meta, bodies, cfg


def _on_taper(cfg: BeamConfig, straight: np.ndarray, axis: int, frac: float):
    """Is the (untwisted) point on the tapered plane y(or z) = frac*size(x)?"""
    size = (cfg.leng[axis]) * (
        1.0 - straight[..., 0] / cfg.leng[0] * cfg.leng_fact
    )
    return np.abs(straight[..., axis] - frac * size) < 1e-9


def _straight_uv(inv_twist, coords, axes):
    s = inv_twist(coords)
    return np.stack([s[:, axes[0]], s[:, axes[1]]], axis=-1)


def _beam_load(cfg: BeamConfig, body: Body, load_type: int) -> None:
    """SUBR_COLO loads (BEAM.h:110-181)."""
    m = body.mesh
    if load_type == 0:
        # centerline edges (y=z=0 after twist: centerline is twist-invariant)
        from ..utils.quadrature import HEX_EDGES

        leaves = m.leaf_elems()
        # the reference visits each (leaf element, centerline edge) pair and
        # adds loadInte*dx/2/4 each time (/4 since four elements share an
        # interior edge, BEAM.h:133-139) — replicate per-visit accumulation
        edges_all = m.elem_corn[leaves][:, HEX_EDGES].reshape(-1, 2)
        c0 = m.coords[edges_all[:, 0]]
        c1 = m.coords[edges_all[:, 1]]
        on_axis = (
            (np.abs(c0[:, 1]) < 1e-10) & (np.abs(c0[:, 2]) < 1e-10)
            & (np.abs(c1[:, 1]) < 1e-10) & (np.abs(c1[:, 2]) < 1e-10)
        )
        for row, p0, p1 in zip(
            edges_all[on_axis], c0[on_axis], c1[on_axis]
        ):
            val = cfg.load_inte * abs(p0[0] - p1[0]) / 2.0 / 4.0
            for nid, px in zip(row, (p0[0], p1[0])):
                if px > 1e-10:
                    dof = 3 * int(nid) + 2
                    body.exte_forc[dof] = body.exte_forc.get(dof, 0.0) + val
    else:
        from ..contact.search import surface_faces
        from ..fem.assembly import distribute_face_load

        face_inte = cfg.leng[0] * cfg.load_inte / (
            cfg.leng[1] * cfg.leng[2] * (1.0 - cfg.leng_fact) ** 2
        )
        faces = surface_faces(
            m, lambda c: c[..., 0] >= cfg.leng[0] - 1e-12
        )
        if faces.size:
            distribute_face_load(
                m, faces, lambda x: np.array([0.0, 0.0, face_inte]),
                body.exte_forc,
            )
