"""DEHWSURF: double-enveloping hourglass worm drive — exact tooth surfaces.

Re-design of examples/DEHWSURF.h (planar double-enveloping theory after
Zhou, "Modification principle and manufacturing technology for hourglass worm
drives"): the worm thread surface is the first envelope of an inclined
generating plane (tangent to the wheel base circle r_b2, inclination beta_c)
as the plane frame c and the worm frame 1 rotate with ratio i_1c; the wheel
tooth surface is the second envelope of the worm surface with ratio i_h2.

Implemented here (vectorized NumPy, Newton solvers batched over grid points):
  * BASIC_PARAMETER      -> DehwParams        (DEHWSURF.h:199-248)
  * FSME                 -> fsme              first+second meshing equations
                                              (DEHWSURF.h:270-291)
  * WORM_DC2R            -> worm_dc2r         generating-plane point -> worm
                                              frame (DEHWSURF.h:349-372)
  * WHEE_1H2R            -> whee_1h2r         worm point -> wheel frame at
                                              meshing config (DEHWSURF.h:374-401)
  * WORM_CURV_2_CART     -> worm_curv_to_cart batched Newton inversion of the
                                              (xi_11, xi_12) worm
                                              parameterization (DEHWSURF.h:593-673)
  * worm/wheel flank grids for CurvedSurface construction.

All of the reference's zones are implemented in this file: working flanks
(``worm_flank_grid``/``wheel_flank_grid``), former-contact zone
(``former_point``/``_seed_former_zone``), head/rear transition zones
(``transition_point``/``_seed_tran_zone``), curvature-interference
bookkeeping (``curvature_interference``), flank relief
(``worm_relief_grid``/``wheel_relief_grid``), back and root grids
(``*_back_grid``/``*_root_grids``) — DEHWSURF.h:404-1100 parity per
PARITY.md.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

PI = np.pi


@dataclass
class DehwParams:
    """Inputs (DEHWSURF.h:162-197) + derived quantities (BASIC_PARAMETER)."""

    z: tuple[int, int] = (1, 40)
    a_h2: float = 0.25
    modi_tran: float = 0.0
    modi_cent: float = 0.0
    r_b2: float = 0.158 / 2.0
    beta_c: float = 11.0 * PI / 180.0
    z_k: float = 4.2
    d0: float = 0.082
    h_a_s: tuple[float, float] = (0.6, 0.7)
    h_f_s: tuple[float, float] = (0.95, 1.05)
    R_a1: float = 0.0385
    offs_R_a: float = 0.003
    whee_widt: float = 0.06
    inne_radi: tuple[float, float] = (0.018, 0.15)
    inpu_torq: float = 180.0

    def __post_init__(self):
        self.a_1c = self.a_h2 + self.modi_cent
        self.i_h2 = self.z[1] / self.z[0]
        self.i_1c = self.i_h2 + self.modi_tran
        self.i_c1 = 1.0 / self.i_1c
        self.i_2h = 1.0 / self.i_h2
        self.d = [self.d0, 2.0 * self.a_h2 - self.d0]
        self.m_t = self.d[1] / self.z[1]
        self.h_a = [self.h_a_s[0] * self.m_t, self.h_a_s[1] * self.m_t]
        self.h_f = [self.h_f_s[0] * self.m_t, self.h_f_s[1] * self.m_t]
        self.d_f = [self.d[i] - 2.0 * self.h_f[i] for i in range(2)]
        self.d_a = [self.d[i] + 2.0 * self.h_a[i] for i in range(2)]
        self.R_a = [self.a_h2 - 0.5 * self.d_a[0], self.R_a1]
        self.R_f = [self.a_h2 - 0.5 * self.d_f[i] for i in range(2)]
        self.R_t = [
            self.a_h2 - 0.5 * self.d[0] + 0.8 * self.m_t,
            self.a_h2 - 0.5 * self.d[1] + 0.9 * self.m_t,
        ]
        self.alph = np.arcsin(2.0 * self.r_b2 / self.d[1])
        self.lead_angl = np.arctan(self.d[1] / self.i_h2 / self.d[0])
        self.pitc_angl = 2.0 * PI / self.z[1]
        self.toot_thic_coef = (0.45, 0.55)
        self.half_angl = 0.5 * (self.z_k - self.toot_thic_coef[0]) * self.pitc_angl
        self.star_angl = self.alph - self.half_angl
        self.term_angl = self.star_angl + self.z_k * self.pitc_angl
        self.worm_curv = [
            self.i_h2 * self.star_angl,
            0.0,
            self.i_h2 * self.term_angl,
        ]
        mid = 0.5 * (self.worm_curv[0] + self.worm_curv[2])
        while mid - 2.0 * PI >= self.worm_curv[0]:
            mid -= 2.0 * PI
        self.worm_curv[1] = mid
        self.widt_angl = np.arcsin(self.whee_widt / 2.0 / self.R_f[1])
        self.toot_thic = [
            self.toot_thic_coef[0] * PI * self.m_t,
            self.toot_thic_coef[1] * PI * self.m_t,
        ]
        self.toot_thic_angl = [t / (self.d[1] / 2.0) for t in self.toot_thic]
        self.back_angl = [
            2.0 * self.alph + self.toot_thic_angl[0],
            2.0 * self.alph - self.toot_thic_angl[1],
        ]


def fsme(p: DehwParams, thet_1, thet_h):
    """First+second meshing equations -> generating-plane coordinates
    (x_d, y_d); batched (DEHWSURF.h:270-291)."""
    thet_1 = np.asarray(thet_1, dtype=np.float64)
    thet_h = np.asarray(thet_h, dtype=np.float64)
    tc = p.i_c1 * thet_1
    sb, cb = np.sin(p.beta_c), np.cos(p.beta_c)
    st, ct = np.sin(tc), np.cos(tc)
    sh = np.sin(thet_h - thet_1)
    ch = np.cos(thet_h - thet_1)
    A11 = -sb * ct - p.i_c1 * cb
    A12 = st
    A21 = sb * ct + p.i_2h * cb * ch - p.i_2h * sb * st * sh
    A22 = -st - p.i_2h * ct * sh
    B1 = -p.r_b2 * sb * st + p.a_1c * sb
    B2 = (
        p.r_b2 * sb * st
        + p.i_2h * p.r_b2 * sb * ct * sh
        - p.a_1c * sb
        - p.i_2h * p.a_1c * cb * ct * ch
        + p.i_2h * p.a_h2 * cb * ct
    )
    det = A11 * A22 - A12 * A21
    x_d = (-B1 * A22 + A12 * B2) / det
    y_d = (-A11 * B2 + A21 * B1) / det
    return x_d, y_d


def _rot_z(th):
    """Batched rotation R_z(th) applied as matrix with columns convention of
    the reference's R_oc,c etc."""
    c, s = np.cos(th), np.sin(th)
    return c, s


def worm_dc2r(p: DehwParams, x_d, y_d, thet_c):
    """Generating-plane point -> worm frame coordinates (DEHWSURF.h:349-372).
    Batched; returns (...,3)."""
    thet_1 = p.i_1c * np.asarray(thet_c)
    sb, cb = np.sin(p.beta_c), np.cos(p.beta_c)
    x = np.stack(
        [-np.asarray(x_d),
         p.r_b2 - np.asarray(y_d) * sb,
         np.asarray(y_d) * cb], axis=-1
    )
    c, s = np.cos(thet_c), np.sin(thet_c)
    x = np.stack(
        [c * x[..., 0] - s * x[..., 1],
         s * x[..., 0] + c * x[..., 1],
         x[..., 2]], axis=-1
    )
    # R_o1,oc: (x, y, z) -> (x, -z, y)
    x = np.stack([x[..., 0], -x[..., 2], x[..., 1]], axis=-1)
    x = x.copy()
    x[..., 0] += p.a_1c
    c, s = np.cos(thet_1), np.sin(thet_1)
    return np.stack(
        [c * x[..., 0] + s * x[..., 1],
         -s * x[..., 0] + c * x[..., 1],
         x[..., 2]], axis=-1
    )


def whee_1h2r(p: DehwParams, x_d, y_d, thet_1, thet_h):
    """Worm-frame meshing point -> wheel frame (DEHWSURF.h:374-401)."""
    thet_c = p.i_c1 * np.asarray(thet_1)
    thet_2 = p.i_2h * np.asarray(thet_h)
    x = worm_dc2r(p, x_d, y_d, thet_c)
    c, s = np.cos(thet_h), np.sin(thet_h)
    x = np.stack(
        [c * x[..., 0] - s * x[..., 1],
         s * x[..., 0] + c * x[..., 1],
         x[..., 2]], axis=-1
    )
    # R_o2,oh: (x,y,z) -> (x, z, -y)
    x = np.stack([x[..., 0], x[..., 2], -x[..., 1]], axis=-1)
    x = x.copy()
    x[..., 0] -= p.a_h2
    c, s = np.cos(thet_2), np.sin(thet_2)
    return np.stack(
        [c * x[..., 0] + s * x[..., 1],
         -s * x[..., 0] + c * x[..., 1],
         x[..., 2]], axis=-1
    )


def worm_curv_to_cart(p: DehwParams, xi_11, xi_12, iters: int = 80):
    """Batched Newton inversion of the worm-flank parameterization
    (DEHWSURF.h:593-673): xi_11 = angular position of the point about the
    worm axis (relative to the thread), xi_12 = distance from the gorge
    center circle in the axial section.  Returns points (...,3) in the worm
    frame and thet_c."""
    xi_11 = np.asarray(xi_11, dtype=np.float64)
    xi_12 = np.asarray(xi_12, dtype=np.float64)
    sb, cb = np.sin(p.beta_c), np.cos(p.beta_c)
    tc = p.i_c1 * xi_11.copy()
    x_d = np.full_like(xi_11, p.d[1] / 2.0)

    def geometry(tc, x_d):
        st, ct = np.sin(tc), np.cos(tc)
        y_d = -(( -sb * ct - p.i_c1 * cb) * x_d
                + (-p.r_b2 * sb * st + p.a_1c * sb)) / st
        th1 = p.i_1c * tc
        r_c = np.stack([-x_d, p.r_b2 - y_d * sb, y_d * cb], axis=-1)
        # to o1 frame (before the final worm rotation)
        xo = ct * r_c[..., 0] - st * r_c[..., 1]
        yo = st * r_c[..., 0] + ct * r_c[..., 1]
        zo = r_c[..., 2]
        r_o1 = np.stack([xo + 0, -zo, yo], axis=-1)
        r_o1 = r_o1.copy()
        r_o1[..., 0] += p.a_1c
        c1, s1 = np.cos(th1), np.sin(th1)
        r_1 = np.stack(
            [c1 * r_o1[..., 0] + s1 * r_o1[..., 1],
             -s1 * r_o1[..., 0] + c1 * r_o1[..., 1],
             r_o1[..., 2]], axis=-1
        )
        return y_d, th1, r_o1, r_1

    h = 1e-8
    for _ in range(iters):
        y_d, th1, r_o1, r_1 = geometry(tc, x_d)
        rad = np.hypot(r_1[..., 0], r_1[..., 1])
        f1 = th1 - np.arctan2(r_o1[..., 1], r_o1[..., 0]) - xi_11
        f2 = r_1[..., 2] ** 2 + (p.a_h2 - rad) ** 2 - xi_12**2
        # numerical Jacobian (central differences; the reference's closed
        # forms are equivalent — finite differences keep the code compact)
        out = []
        for dtc, dxd in ((h, 0.0), (0.0, h)):
            _, th1p, r_o1p, r_1p = geometry(tc + dtc, x_d + dxd)
            radp = np.hypot(r_1p[..., 0], r_1p[..., 1])
            f1p = th1p - np.arctan2(r_o1p[..., 1], r_o1p[..., 0]) - xi_11
            f2p = r_1p[..., 2] ** 2 + (p.a_h2 - radp) ** 2 - xi_12**2
            _, th1m, r_o1m, r_1m = geometry(tc - dtc, x_d - dxd)
            radm = np.hypot(r_1m[..., 0], r_1m[..., 1])
            f1m = th1m - np.arctan2(r_o1m[..., 1], r_o1m[..., 0]) - xi_11
            f2m = r_1m[..., 2] ** 2 + (p.a_h2 - radm) ** 2 - xi_12**2
            out.append(((f1p - f1m) / (2 * h), (f2p - f2m) / (2 * h)))
        J11, J21 = out[0]
        J12, J22 = out[1]
        det = J11 * J22 - J12 * J21
        det = np.where(np.abs(det) < 1e-300, 1.0, det)
        dtc = -(J22 * f1 - J12 * f2) / det
        dxd = -(J11 * f2 - J21 * f1) / det
        if max(np.abs(dtc).max(), np.abs(dxd).max()) < 1e-13:
            break
        tc = tc + dtc
        x_d = x_d + dxd
    y_d, th1, r_o1, r_1 = geometry(tc, x_d)
    return r_1, tc


def worm_flank_grid(
    p: DehwParams,
    n_u: int,
    n_v: int,
    u_range: tuple[float, float] | None = None,
    flank: int = 0,
) -> np.ndarray:
    """Exact worm working-flank grid (n_u+1, n_v+1, 3) in the worm frame.

    u = xi_11 sweep along the thread (default: the working range
    worm_curv[0]..worm_curv[2]); v = xi_12 in [R_a[0], R_f[0]] (tip to root
    of the worm, measured from the gorge circle).  flank=0 gives the surface
    of the enveloping side; flank=1 mirrors by the tooth-back angle
    (backAngl, DEHWSURF.h:246-247: z -> -z with azimuth offset)."""
    u0, u1 = u_range if u_range is not None else (p.worm_curv[0], p.worm_curv[2])
    u = np.linspace(u0, u1, n_u + 1)
    v = np.linspace(p.R_a[0], p.R_f[0], n_v + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    pts, _ = worm_curv_to_cart(p, uu, vv)
    if flank == 1:
        # tooth back: reflect z and rotate by the back angle (rigid relation
        # between surface and back frames, DEHWSURF.h:60-62)
        ang = p.back_angl[0] * p.i_1c / p.i_h2  # worm azimuth offset
        c, s = np.cos(ang), np.sin(ang)
        pts = np.stack(
            [c * pts[..., 0] - s * pts[..., 1],
             s * pts[..., 0] + c * pts[..., 1],
             -pts[..., 2]], axis=-1
        )
    return pts


def wheel_local(p: DehwParams, r2: np.ndarray):
    """Wheel-flank curvilinear coordinates (WHEE_G2L, DEHWSURF.h:675-685):
    angle/radius in the axial section, measured from the gorge circle."""
    radi_xi = p.a_h2 - np.hypot(r2[..., 0], r2[..., 1])
    angl_f = np.arctan2(r2[..., 2], radi_xi)
    radi_f = np.hypot(radi_xi, r2[..., 2])
    return angl_f, radi_f


def _damped_newton_2(resid, init, in_box, iters: int = 200):
    """Shared damped 2-var Newton with box-constrained line search (the
    solver scheme of WHEE_CURV_2_CART_1/2/3, DEHWSURF.h:687-909): finite-
    difference Jacobian, halving line search accepting only residual
    decrease inside the box.  resid(a,b) -> (f(2,), payload); returns
    (payload, (a,b), f) or None on a singular Jacobian."""
    a, b = init
    f, r2 = resid(a, b)
    h = 1e-8
    for _ in range(iters):
        f1p, _ = resid(a + h, b)
        f2p, _ = resid(a, b + h)
        J = np.stack([(f1p - f) / h, (f2p - f) / h], axis=1)
        det = J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0]
        if abs(det) < 1e-300:
            return None
        step = -np.linalg.solve(J, f)
        if np.linalg.norm(step) < 1e-13:
            break
        rfac, ok = 1.0, False
        while rfac > 1e-10:
            at, bt = a + rfac * step[0], b + rfac * step[1]
            if in_box(at, bt):
                ft, r2t = resid(at, bt)
                if np.linalg.norm(ft) < np.linalg.norm(f):
                    a, b, f, r2 = at, bt, ft, r2t
                    ok = True
                    break
            rfac /= 2.0
        if not ok:
            break
    return r2, (a, b), f


def wheel_point(p: DehwParams, xi_21: float, xi_22: float,
                init: tuple[float, float], iters: int = 200, f_lr: int = 1):
    """One wheel new-contact-zone point by damped Newton on (thet_c, thet_h)
    within the singular bounds (WHEE_CURV_2_CART_1, DEHWSURF.h:687-764).
    f_lr=1: left branch thet_h in (thet_hs, thet_hm); f_lr=2: right branch
    (thet_hm, thet_hs + 2*pi) (DEHWSURF.h:735-740).
    Returns (point (3,), (thet_c, thet_h)) or None."""

    def resid(tc, th):
        th1 = p.i_1c * tc
        x_d, y_d = fsme(p, th1, th)
        r2 = whee_1h2r(p, x_d, y_d, th1, th)
        a, rr = wheel_local(p, r2)
        return np.array([a - xi_21, rr * rr - xi_22 * xi_22]), r2

    def in_box(tct, tht):
        if not (0.01 * PI < tct < 0.49 * PI):
            return False
        ths, thm = singular_c2h(p, tct)
        if f_lr == 1:
            return ths + 1e-12 < tht < thm - 1e-12
        return thm + 1e-12 < tht < ths + 2.0 * PI - 1e-12

    out = _damped_newton_2(resid, init, in_box, iters)
    if out is None:
        return None
    r2, sol, f = out
    if _zone_dist(f, xi_22, np.hypot(p.a_h2 - np.hypot(r2[..., 0], r2[..., 1]),
                                     r2[..., 2])) > 1e-9:
        return None
    return r2, sol


def _zone_dist(f: np.ndarray, xi_22: float, radi: float) -> float:
    """Reference convergence measure (DEHWSURF.h:1219-1221): absolute
    radi*|d angle| + |d radius| in meters, from the residual
    f = [angle - xi_21, r^2 - xi_22^2]."""
    return float(radi * abs(f[0]) + abs(f[1]) / (radi + xi_22))


def former_point(p: DehwParams, xi_21: float, xi_22: float,
                 init: tuple[float, float], iters: int = 200):
    """One former-contact-zone point by damped Newton on (thet_c, x_d): the
    wheel surface region coinciding with the generating plane itself, which
    exists only for unmodified drives (WHEE_CURV_2_CART_2,
    DEHWSURF.h:766-845).  Returns (point (3,), (thet_c, x_d)) or None."""

    def resid(tc, xd):
        r_c, _ = plane_point_c(p, tc, xd)
        return _local_resid(p, r_c, xi_21, xi_22), r_c

    out = _damped_newton_2(
        resid, init, lambda tc, xd: 0.01 * PI < tc < 0.49 * PI, iters
    )
    if out is None:
        return None
    r2, sol, f = out
    if _zone_dist(f, xi_22, np.hypot(p.a_h2 - np.hypot(r2[..., 0], r2[..., 1]),
                                     r2[..., 2])) > 1e-9:
        return None
    return r2, sol


def transition_point(p: DehwParams, xi_21: float, xi_22: float, xi_11: float,
                     init: tuple[float, float], iters: int = 200):
    """One head/rear transition-zone point by damped Newton on
    (thet_c, thet_h): the wheel region cut by the worm thread end edge at
    thread azimuth xi_11 (WHEE_CURV_2_CART_3 + WHEE_TRAN,
    DEHWSURF.h:846-978).  Returns (point (3,), (thet_c, thet_h)) or None."""

    def resid(tc, th):
        r2 = worm_edge_point(p, tc, th, xi_11)
        return _local_resid(p, r2, xi_21, xi_22), r2

    out = _damped_newton_2(
        resid, init, lambda tc, th: 0.01 * PI < tc < 0.49 * PI, iters
    )
    if out is None:
        return None
    r2, sol, f = out
    if _zone_dist(f, xi_22, np.hypot(p.a_h2 - np.hypot(r2[..., 0], r2[..., 1]),
                                     r2[..., 2])) > 1e-9:
        return None
    return r2, sol


def wheel_flank_grid(
    p: DehwParams,
    n_u: int,
    n_v: int,
    u_box: tuple[float, float] | None = None,
    v_box: tuple[float, float] | None = None,
):
    """Exact wheel working-flank grid (n_u+1, n_v+1, 3) in the wheel frame.

    u = xi_21 (face-width angle), v = xi_22 (profile radius from the gorge
    circle, tip -> root).  Newton marches across the grid using neighbor
    solutions as initial guesses (the reference's WHEE_PHAS bookkeeping);
    returns (points, solved_mask)."""
    ua, ub = u_box if u_box else (-0.6 * p.widt_angl, 0.6 * p.widt_angl)
    va, vb = v_box if v_box else (p.a_h2 - 0.5 * p.d_a[1], p.R_f[1])
    us = np.linspace(ua, ub, n_u + 1)
    vs = np.linspace(va, vb, n_v + 1)
    pts = np.zeros((n_u + 1, n_v + 1, 3))
    ok = np.zeros((n_u + 1, n_v + 1), dtype=bool)
    tc_mid = 0.5 * (p.i_c1 * p.worm_curv[0] + p.i_c1 * p.worm_curv[2])
    ths, thm = singular_c2h(p, tc_mid)
    init0 = (tc_mid, 0.5 * (ths + thm))
    inits = {}
    for i, u in enumerate(us):
        for j, v in enumerate(vs):
            cand = []
            if (i, j - 1) in inits:
                cand.append(inits[(i, j - 1)])
            if (i - 1, j) in inits:
                cand.append(inits[(i - 1, j)])
            cand.append(init0)
            for init in cand:
                res = wheel_point(p, u, v, init)
                if res is not None:
                    pts[i, j] = res[0]
                    inits[(i, j)] = res[1]
                    ok[i, j] = True
                    break
    return pts, ok


def singular_c2h(p: DehwParams, thet_c: float) -> tuple[float, float]:
    """Singular thet_h bounds for a given thet_c (DEHWSURF.h:251-268)."""
    thet_1 = p.i_1c * thet_c
    cb, sb = np.cos(p.beta_c), np.sin(p.beta_c)
    C11 = -p.i_2h * cb * np.sin(thet_c)
    C12 = p.i_c1 * p.i_2h * cb * np.cos(thet_c) + p.i_2h * sb
    C13 = p.i_c1 * cb * np.sin(thet_c)
    a2 = np.arctan2(C11, C12)
    mag = np.hypot(C11, C12)
    if C13 > mag:
        ths = thet_1 - a2 - PI / 2.0
        return ths, ths
    ths = thet_1 - PI - a2 + np.arcsin(C13 / mag)
    thm = thet_1 - a2 - np.arcsin(C13 / mag)
    return ths, thm


# ---------------------------------------------------------------------------
# Wheel-flank zones beyond the zone-1 working patch (DEHWSURF.h:980-1509):
# the full wheel tooth surface is pieced together from five generator zones
#   1 left new contact, 2 right new contact (second envelope, the two
#     branches of the singular thet_h interval),
#   3 former contact (the planar region traced by the generating plane
#     itself — exists only for unmodified drives, DEHWSURF.h:1772),
#   4 head / 5 rear transition (envelope of the worm thread's end edges),
# merged per grid point by azimuth-phase priority (WHEE_PHAS,
# DEHWSURF.h:980-1001).
# ---------------------------------------------------------------------------


def wheel_bounds(p: DehwParams, angl_f):
    """(R_fmini, R_fmaxi) profile-radius box at face-width angle angl_f
    (WHEE_G2L, DEHWSURF.h:675-685)."""
    angl_f = np.asarray(angl_f, dtype=np.float64)
    angl_ai = angl_f - np.arcsin(p.offs_R_a * np.sin(angl_f) / p.R_a[1])
    r_min = (p.R_a[1] * np.cos(angl_ai) - p.offs_R_a) / np.cos(angl_f)
    return r_min, np.full_like(angl_f, p.R_t[1])


def _local_resid(p: DehwParams, r2, xi_21, xi_22):
    """Residual of the wheel-local box equations (shared by all zone
    solvers): [angle - xi_21, radius^2 - xi_22^2]."""
    coor_x = p.a_h2 - np.hypot(r2[..., 0], r2[..., 1])
    return np.stack(
        [np.arctan2(r2[..., 2], coor_x) - xi_21,
         r2[..., 2] ** 2 + coor_x**2 - xi_22**2], axis=-1,
    )


def plane_point_c(p: DehwParams, thet_c, x_d):
    """Generating-plane point in frame c with y_d eliminated by the first
    meshing equation (DEHWSURF.h:776-780); batched."""
    thet_c = np.asarray(thet_c, dtype=np.float64)
    x_d = np.asarray(x_d, dtype=np.float64)
    sb, cb = np.sin(p.beta_c), np.cos(p.beta_c)
    st, ct = np.sin(thet_c), np.cos(thet_c)
    y_d = -(((-sb * ct - p.i_c1 * cb) * x_d - p.r_b2 * sb * st
             + p.a_1c * sb) / st)
    r_c = np.stack([-x_d, p.r_b2 - y_d * sb, y_d * cb], axis=-1)
    return r_c, y_d


def worm_azimuth(p: DehwParams, r_c, thet_c):
    """Worm-thread azimuth coordinate xi_11 of a frame-c point
    (DEHWSURF.h:1356-1372): the angle about the worm axis measured from the
    rotating thread reference."""
    thet_c = np.asarray(thet_c, dtype=np.float64)
    thet_1 = p.i_1c * thet_c
    c, s = np.cos(thet_c), np.sin(thet_c)
    xo = c * r_c[..., 0] - s * r_c[..., 1]
    yo = s * r_c[..., 0] + c * r_c[..., 1]
    zo = r_c[..., 2]
    # R_o1,oc: (x, y, z) -> (x, -z, y), then translate by a_1c
    r_o1 = np.stack([xo + p.a_1c, -zo, yo], axis=-1)
    return thet_1 - np.arctan2(r_o1[..., 1], r_o1[..., 0])


def worm_frame_to_wheel(p: DehwParams, pts, thet_h):
    """Worm-frame points -> wheel frame at worm rotation thet_h
    (the R_oh,h / R_o2,oh / T / R_2,o2 chain of WHEE_1H2R without the
    generating-plane part, DEHWSURF.h:925-947)."""
    pts = np.asarray(pts, dtype=np.float64)
    thet_2 = p.i_2h * thet_h
    c, s = np.cos(thet_h), np.sin(thet_h)
    x = np.stack(
        [c * pts[..., 0] - s * pts[..., 1],
         s * pts[..., 0] + c * pts[..., 1],
         pts[..., 2]], axis=-1,
    )
    x = np.stack([x[..., 0] - p.a_h2, x[..., 2], -x[..., 1]], axis=-1)
    c, s = np.cos(thet_2), np.sin(thet_2)
    return np.stack(
        [c * x[..., 0] + s * x[..., 1],
         -s * x[..., 0] + c * x[..., 1],
         x[..., 2]], axis=-1,
    )


def worm_edge_curve(p: DehwParams, thet_c, xi_11):
    """Worm-frame point of the thread end-edge curve at thread azimuth
    xi_11, parameterized by thet_c (the edge part of WHEE_TRAN,
    DEHWSURF.h:915-926); batched."""
    thet_c = np.asarray(thet_c, dtype=np.float64)
    thet_1 = p.i_1c * thet_c
    tb = np.tan(p.beta_c)
    st, ct = np.sin(thet_c), np.cos(thet_c)
    d1 = thet_1 - xi_11
    c1 = ((tb * ct + p.i_c1) * np.cos(d1)
          + p.i_c1 * tb * st * np.sin(d1) - ct * st * np.sin(d1))
    c2 = p.i_c1 * p.r_b2 * st - p.i_c1 * p.a_1c
    x_a = -c2 / c1
    z_a = ((tb * np.sin(d1) + st * np.cos(d1)) * x_a
           + p.r_b2 - p.a_1c * st) / ct
    return np.stack(
        [x_a * np.cos(xi_11), -x_a * np.sin(xi_11),
         np.broadcast_to(z_a, x_a.shape)], axis=-1,
    )


def worm_radial(p: DehwParams, r_1):
    """Worm profile coordinate xi_12 of a worm-frame point: distance from
    the gorge center circle in the axial section (DEHWSURF.h:625-627)."""
    rad = np.hypot(r_1[..., 0], r_1[..., 1])
    return np.hypot(p.a_h2 - rad, r_1[..., 2])


def worm_edge_point(p: DehwParams, thet_c, thet_h, xi_11):
    """Point of the worm thread end-edge (at thread azimuth xi_11) in the
    wheel frame at meshing configuration thet_h (WHEE_TRAN,
    DEHWSURF.h:911-978); batched.  Returns wheel-frame points (...,3)."""
    thet_h = np.asarray(thet_h, dtype=np.float64)
    r_1 = worm_edge_curve(p, thet_c, xi_11)
    return worm_frame_to_wheel(p, r_1, thet_h)


def cilfofe(p: DehwParams, thet_1, x_d, y_d):
    """First-envelope curvature functions of the worm flank at a meshing
    point (CILFOFE, DEHWSURF.h:483-523); batched.  Returns
    (Psi_1, kappa_1x, kappa_1y, tau_1x)."""
    thet_1 = np.asarray(thet_1, dtype=np.float64)
    x_d = np.asarray(x_d, dtype=np.float64)
    y_d = np.asarray(y_d, dtype=np.float64)
    thet_c = thet_1 / p.i_1c
    sb, cb = np.sin(p.beta_c), np.cos(p.beta_c)
    st, ct = np.sin(thet_c), np.cos(thet_c)
    # plane frame directions rotated into frame oc
    i_d = np.stack([-ct, -st, np.zeros_like(ct)], axis=-1)
    j_d = np.stack([st * sb, -ct * sb, np.full_like(ct, cb)], axis=-1)
    omeg = np.stack(
        [np.zeros_like(ct), np.full_like(ct, -1.0),
         np.full_like(ct, p.i_c1)], axis=-1,
    )
    v = np.stack(
        [-y_d * cb - p.i_c1 * (-x_d * st + ct * (p.r_b2 - y_d * sb)),
         p.i_c1 * (-x_d * ct - st * (p.r_b2 - y_d * sb)),
         -x_d * ct - st * (p.r_b2 - y_d * sb) + p.a_1c], axis=-1,
    )
    v_i = (v * i_d).sum(-1)
    v_j = (v * j_d).sum(-1)
    n1x = (omeg * j_d).sum(-1)              # plane has zero curvature
    n1y = -(omeg * i_d).sum(-1)
    dphi = (x_d * sb * st + y_d * ct - p.r_b2 * sb * ct) / p.i_1c
    n_vec = n1x[..., None] * i_d + n1y[..., None] * j_d
    psi_1 = (n_vec * v).sum(-1) + dphi
    return psi_1, -n1x * n1x / psi_1, -n1y * n1y / psi_1, -n1x * n1y / psi_1


def curvature_interference(p: DehwParams, thet_1, thet_h):
    """Second-envelope curvature-interference function Psi_2 and induced
    normal curvature kappa_h2N (CILFOSE_NI, DEHWSURF.h:524-592); batched.
    Psi_2 > 0 means no curvature interference at this meshing point."""
    thet_1 = np.asarray(thet_1, dtype=np.float64)
    thet_h = np.asarray(thet_h, dtype=np.float64)
    thet_c = thet_1 / p.i_1c
    x_d, y_d = fsme(p, thet_1, thet_h)
    _, kx, ky, tx = cilfofe(p, thet_1, x_d, y_d)
    sb, cb = np.sin(p.beta_c), np.cos(p.beta_c)

    def chain(vec3):
        """frame c -> frame h at the meshing configuration (rotations only
        for directions; the caller adds the a_1c offset for positions)."""
        c, s = np.cos(thet_c), np.sin(thet_c)
        x = np.stack(
            [c * vec3[..., 0] - s * vec3[..., 1],
             s * vec3[..., 0] + c * vec3[..., 1], vec3[..., 2]], axis=-1)
        x = np.stack([x[..., 0], -x[..., 2], x[..., 1]], axis=-1)
        return x

    def rot1h(vec3, offset=0.0):
        x = vec3.copy()
        x[..., 0] += offset
        c, s = np.cos(thet_1), np.sin(thet_1)
        x = np.stack(
            [c * x[..., 0] + s * x[..., 1],
             -s * x[..., 0] + c * x[..., 1], x[..., 2]], axis=-1)
        c, s = np.cos(thet_h), np.sin(thet_h)
        return np.stack(
            [c * x[..., 0] - s * x[..., 1],
             s * x[..., 0] + c * x[..., 1], x[..., 2]], axis=-1)

    zer = np.zeros_like(thet_c)
    i_d = rot1h(chain(np.stack([-np.ones_like(thet_c), zer, zer], axis=-1)))
    j_d = rot1h(chain(np.stack([zer, np.full_like(thet_c, -sb),
                                np.full_like(thet_c, cb)], axis=-1)))
    r_c = np.stack([-x_d, p.r_b2 - y_d * sb, y_d * cb], axis=-1)
    r_h = rot1h(chain(r_c), offset=p.a_1c)
    omeg_h2 = np.stack([zer, np.full_like(thet_c, p.i_2h),
                        np.ones_like(thet_c)], axis=-1)
    omeg_2 = np.stack([zer, np.full_like(thet_c, -p.i_2h), zer], axis=-1)
    o_h2 = np.stack([np.full_like(thet_c, -p.a_h2), zer, zer], axis=-1)
    v_h2 = np.cross(omeg_h2, r_h) - np.cross(omeg_2, o_h2)
    v_i = (v_h2 * i_d).sum(-1)
    v_j = (v_h2 * j_d).sum(-1)
    n2x = kx * v_i + tx * v_j + (omeg_h2 * j_d).sum(-1)
    n2y = tx * v_i + ky * v_j - (omeg_h2 * i_d).sum(-1)
    n_vec = n2x[..., None] * i_d + n2y[..., None] * j_d
    b11 = p.i_2h * x_d * cb - p.i_2h * p.a_1c * cb * np.cos(thet_c)
    b12 = (-p.i_2h * x_d * sb * np.sin(thet_c) - p.i_2h * y_d * np.cos(thet_c)
           + p.i_2h * p.r_b2 * sb * np.cos(thet_c))
    dphi2 = -b11 * np.sin(thet_h - thet_1) + b12 * np.cos(thet_h - thet_1)
    psi_2 = (n_vec * v_h2).sum(-1) + dphi2
    kapp = (n2x * n2x + n2y * n2y) / psi_2
    return psi_2, kapp


# ---------------------------------------------------------------------------
# Flank relief (WORM_RELI / WHEE_RELI, DEHWSURF.h:1002-1116) and tooth-back
# transforms (TOOT_SURF_GRID, DEHWSURF.h:1812-1846)
# ---------------------------------------------------------------------------


def _relief_field(n_u: int, n_v: int, L, amounts, expo: float,
                  tip_at_j0: bool) -> np.ndarray:
    """Relief magnitude per grid index (n_u, n_v): cubic-law ramps of depth
    ``amounts[0]`` at the tooth tip border (j) and ``amounts[1]`` at both
    face-width ends (i), blended around the corners by the reference's
    cosine rule (DEHWSURF.h:1016-1034).  ``L`` is the ramp length in grid
    indices — a scalar or a per-axis (L_i, L_j) pair (the reference uses 40
    on both axes at its full resolution; reduced grids scale per axis)."""
    a_tip, a_end = amounts
    L_i, L_j = (L, L) if np.isscalar(L) else L
    ti = np.arange(n_u, dtype=np.float64)[:, None]
    tj = np.arange(n_v, dtype=np.float64)[None, :]
    # normalized border distances (units of the ramp length); the index
    # arithmetic matches WORM_RELI/WHEE_RELI exactly (which measure against
    # the grid SIZE, not size-1: ti < L and ti > n - L, DEHWSURF.h:1004-1005)
    d_tip = np.maximum(L_j - tj if tip_at_j0 else tj - (n_v - L_j), 0.0) / L_j
    d_end = np.maximum(np.maximum(L_i - ti, ti - (n_u - L_i)), 0.0) / L_i
    only_tip = (d_tip > 0) & (d_end == 0)
    only_end = (d_end > 0) & (d_tip == 0)
    corner = (d_tip > 0) & (d_end > 0)
    rel = np.zeros((n_u, n_v))
    rel = np.where(only_tip, d_tip**expo * a_tip, rel)
    rel = np.where(only_end, d_end**expo * a_end, rel)
    with np.errstate(divide="ignore", invalid="ignore"):
        rati = np.arctan2(d_tip, d_end) / (PI / 2.0)
        maxi = a_end + (np.cos(rati * PI) - 1.0) * (a_end - a_tip) / 2.0
        rad = np.hypot(d_tip, d_end)
        rel = np.where(corner, rad**expo * maxi, rel)
    return rel


def worm_relief_grid(p: DehwParams, pts: np.ndarray, L: int = 40,
                     amounts=(14.0e-6, 18.0e-6), expo: float = 3.0,
                     tip_at_j0: bool = True) -> np.ndarray:
    """Apply worm flank relief (WORM_RELI, DEHWSURF.h:1002-1060): each
    border point is rotated by relief/R within its axial-section circle
    about the gorge-center circle (radius a_h2 from the worm axis)."""
    n_u, n_v, _ = pts.shape
    rel = _relief_field(n_u, n_v, L, amounts, expo, tip_at_j0)
    out = pts.copy()
    mask = rel > 1e-12
    x, y, z = pts[..., 0][mask], pts[..., 1][mask], pts[..., 2][mask]
    radi_0 = np.hypot(x, y)
    radi = np.hypot(p.a_h2 - radi_0, z)
    th0 = np.arcsin(z / radi)
    th1 = th0 + rel[mask] / radi
    fact = (p.a_h2 - radi * np.cos(th1)) / radi_0
    out[..., 0][mask] = fact * x
    out[..., 1][mask] = fact * y
    out[..., 2][mask] = z + radi * (np.sin(th1) - np.sin(th0))
    return out


def wheel_relief_grid(p: DehwParams, pts: np.ndarray, L: int = 40,
                      amounts=(12.0e-6, 16.0e-6), expo: float = 3.0,
                      tip_at_j0: bool = True) -> np.ndarray:
    """Apply wheel flank relief (WHEE_RELI, DEHWSURF.h:1062-1116): border
    points rotate about the wheel axis by relief/radius."""
    n_u, n_v, _ = pts.shape
    rel = _relief_field(n_u, n_v, L, amounts, expo, tip_at_j0)
    out = pts.copy()
    mask = rel > 1e-12
    x, y = pts[..., 0][mask], pts[..., 1][mask]
    ang = rel[mask] / np.hypot(x, y)
    c, s = np.cos(ang), np.sin(ang)
    out[..., 0][mask] = c * x - s * y
    out[..., 1][mask] = s * x + c * y
    return out


def worm_back_grid(p: DehwParams, pts: np.ndarray) -> np.ndarray:
    """Worm tooth-back surface from the working flank (TOOT_SURF_GRID,
    DEHWSURF.h:1815-1830): conjugate reflection about the mid-thread
    azimuth worm_curv[1], thread-direction index reversed."""
    phi = p.worm_curv[1]
    c, s = np.cos(phi), np.sin(phi)
    x = c * pts[..., 0] - s * pts[..., 1]
    y = s * pts[..., 0] + c * pts[..., 1]
    y, z = -y, -pts[..., 2]
    out = np.stack([c * x + s * y, -s * x + c * y, z], axis=-1)
    return out[::-1]


def wheel_back_grid(p: DehwParams, pts: np.ndarray) -> np.ndarray:
    """Wheel tooth-back surface (TOOT_SURF_GRID, DEHWSURF.h:1832-1846):
    half-turn about the in-plane axis at half the tooth back angle, both
    indices reversed."""
    c, s = np.cos(p.back_angl[1]), np.sin(p.back_angl[1])
    out = np.stack(
        [c * pts[..., 0] - s * pts[..., 1],
         -s * pts[..., 0] - c * pts[..., 1],
         -pts[..., 2]], axis=-1,
    )
    return out[::-1, ::-1]


# ---------------------------------------------------------------------------
# Zoned full wheel-flank grid (WHEE_TS_GRID, DEHWSURF.h:1751-1788)
# ---------------------------------------------------------------------------


def _seed_new_zone(p: DehwParams, f_lr: int, n_c: int = 1000,
                   n_h: int = 10000):
    """NEW_CONT_ZONE seed scan (DEHWSURF.h:1117-1165): the FIRST
    (thet_c-major, thet_h-minor) scan point of branch ``f_lr`` that lies in
    the wheel (angle, radius) box and is free of curvature interference.
    The thet_h scan runs high->low for the left branch and low->high for
    the right one (the reference's "choosing order of thet_h").
    Returns (angl, radi, thet_c, thet_h) or None."""
    eps = 1.0e-8
    tcs = 0.01 * PI + (0.49 - 0.01) * PI * np.arange(n_c + 1) / n_c
    frac = np.arange(n_h + 1) / n_h
    for s in range(0, n_c + 1, 50):
        tc = tcs[s : s + 50]
        bounds = np.array([singular_c2h(p, t) for t in tc])
        if f_lr == 1:
            lo, hi = bounds[:, 0] + eps, bounds[:, 1] - eps
            TH = hi[:, None] - (hi - lo)[:, None] * frac[None, :]
        else:
            lo, hi = bounds[:, 1] + eps, bounds[:, 0] + 2.0 * PI - eps
            TH = lo[:, None] + (hi - lo)[:, None] * frac[None, :]
        TC = np.broadcast_to(tc[:, None], TH.shape)
        ok = np.broadcast_to((hi > lo)[:, None], TH.shape).copy()
        th1 = p.i_1c * TC
        x_d, y_d = fsme(p, th1, TH)
        r2 = whee_1h2r(p, x_d, y_d, th1, TH)
        a, r = wheel_local(p, r2)
        rmin, rmax = wheel_bounds(p, a)
        psi, _ = curvature_interference(p, th1, TH)
        ok &= (psi > 0.0)
        ok &= (-p.widt_angl <= a) & (a <= p.widt_angl)
        ok &= (rmin <= r) & (r <= rmax)
        if ok.any():
            i = int(np.argmax(ok.reshape(-1)))
            return (a.reshape(-1)[i], r.reshape(-1)[i],
                    TC.reshape(-1)[i], TH.reshape(-1)[i])
    return None


def _seed_former_zone(p: DehwParams, n_c: int = 1000, n_d: int = 10000):
    """FORMER_CONT_ZONE seed scan (DEHWSURF.h:1272-1301): first
    generating-plane point (thet_c-major, x_d-minor) inside the wheel box.
    Returns (angl, radi, thet_c, x_d) or None."""
    tcs = 0.01 * PI + (0.49 - 0.01) * PI * np.arange(n_c + 1) / n_c
    xds = -10.0 * p.a_1c + 20.0 * p.a_1c * np.arange(1, n_d) / n_d
    for s in range(0, n_c + 1, 50):
        tc = tcs[s : s + 50]
        TC, XD = np.meshgrid(tc, xds, indexing="ij")
        r_c, _ = plane_point_c(p, TC, XD)
        a, r = wheel_local(p, r_c)
        rmin, rmax = wheel_bounds(p, a)
        ok = (-p.widt_angl <= a) & (a <= p.widt_angl)
        ok &= (rmin <= r) & (r <= rmax)
        if ok.any():
            i = int(np.argmax(ok.reshape(-1)))
            return (a.reshape(-1)[i], r.reshape(-1)[i],
                    TC.reshape(-1)[i], XD.reshape(-1)[i])
    return None


def _seed_tran_zone(p: DehwParams, xi_11: float, n_c: int = 1000):
    """TRANSITION_ZONE seed scan (DEHWSURF.h:1401-1428): the worm end-edge
    family at thet_h = xi_11, thet_c scanned between the configurations
    that generate the worm root / wheel root radii at this azimuth.
    Returns (angl, radi, thet_c, thet_h) or None."""
    _, tcL = worm_curv_to_cart(p, np.array(xi_11), np.array(p.a_h2 - p.d_f[0] / 2.0))
    _, tcH = worm_curv_to_cart(p, np.array(xi_11), np.array(p.d_f[1] / 2.0))
    tcL, tcH = float(tcL), float(tcH)
    tcs = tcL + (tcH - tcL) * np.arange(n_c + 1) / n_c
    r2 = worm_edge_point(p, tcs, np.full_like(tcs, xi_11), xi_11)
    a, r = wheel_local(p, r2)
    rmin, rmax = wheel_bounds(p, a)
    ok = (-p.widt_angl <= a) & (a <= p.widt_angl) & (rmin <= r) & (r <= rmax)
    ok &= np.isfinite(a) & np.isfinite(r)
    if not ok.any():
        return None
    i = int(np.argmax(ok))
    return (a[i], r[i], tcs[i], xi_11)


def wheel_surface_grid(p: DehwParams, n_u: int, n_v: int,
                       worm_window: tuple[float, float] | None = None,
                       relief: bool = False, modified: bool | None = None):
    """Full zoned wheel tooth-surface grid (WHEE_TS_GRID,
    DEHWSURF.h:1751-1788): rows sweep the face width (angl from +widt_angl
    down to -widt_angl), columns the profile radius from the row's tip
    radius R_fmini(angl) to R_t[1].  Each point is generated by every zone
    whose solver converges and whose generator lies in the worm window, and
    the candidates are merged by azimuth-phase priority (WHEE_PHAS,
    DEHWSURF.h:980-1001).  Returns (points (n_u+1, n_v+1, 3), fpha flags:
    1 left new / 2 right new / 3 former / 4 head / 5 rear / 0 unsolved)."""
    window = worm_window if worm_window else (p.worm_curv[0], p.worm_curv[2])
    if modified is None:
        modified = not (p.modi_tran == 0.0 and p.modi_cent == 0.0)
    us = p.widt_angl - 2.0 * p.widt_angl * np.arange(n_u + 1) / n_u
    rmin, _ = wheel_bounds(p, us)
    vs = rmin[:, None] + (p.R_t[1] - rmin)[:, None] * (
        np.arange(n_v + 1) / n_v
    )[None, :]
    pts = np.zeros((n_u + 1, n_v + 1, 3))
    fpha = np.zeros((n_u + 1, n_v + 1), dtype=np.int64)
    phase = np.full((n_u + 1, n_v + 1), -np.inf)

    def nearest_cell(a, r):
        ti = int(np.clip(round((p.widt_angl - a) / (2 * p.widt_angl) * n_u),
                         0, n_u))
        tj = int(np.clip(
            round((r - vs[ti, 0]) / (vs[ti, -1] - vs[ti, 0]) * n_v), 0, n_v
        ))
        return ti, tj

    def merge(ti, tj, r2, z):
        ph = np.arctan2(r2[1], r2[0]) % (2.0 * PI)
        if ph > phase[ti, tj]:
            pts[ti, tj] = r2
            fpha[ti, tj] = z
            phase[ti, tj] = ph

    def accept(sol, z):
        """Merge gate (NOT a search gate — the BFS keeps flooding through
        converged-but-rejected cells, DEHWSURF.h:1222-1266): zones 1-3 must
        be generated by a point inside the thread azimuth window
        (woxi_11 check, DEHWSURF.h:1240-1244); zones 4/5 merge every
        converged point unconditionally (DEHWSURF.h:1478-1480) — the
        azimuth-phase priority handles sheet selection."""
        tc = sol[0]
        if z in (4, 5):
            return True
        if z in (1, 2):
            x_d, y_d = fsme(p, p.i_1c * tc, sol[1])
        else:
            x_d, y_d = sol[1], plane_point_c(p, tc, sol[1])[1]
        sb, cb = np.sin(p.beta_c), np.cos(p.beta_c)
        r_c = np.array([-x_d, p.r_b2 - y_d * sb, y_d * cb])
        w = worm_azimuth(p, r_c, tc)
        return window[0] - 1e-12 <= w <= window[1] + 1e-12

    zones: list[tuple[int, "tuple | None"]] = [
        (1, _seed_new_zone(p, 1)),
        (2, _seed_new_zone(p, 2)),
    ]
    if not modified:
        zones.append((3, _seed_former_zone(p)))
    zones.append((4, _seed_tran_zone(p, window[0])))
    zones.append((5, _seed_tran_zone(p, window[1])))

    from collections import deque

    solvers = {
        1: lambda u, v, init: wheel_point(p, u, v, init, f_lr=1),
        2: lambda u, v, init: wheel_point(p, u, v, init, f_lr=2),
        3: lambda u, v, init: former_point(p, u, v, init),
        4: lambda u, v, init: transition_point(p, u, v, window[0], init),
        5: lambda u, v, init: transition_point(p, u, v, window[1], init),
    }
    for z, seed in zones:
        if seed is None:
            continue
        a, r, s0, s1 = seed
        seen = np.zeros((n_u + 1, n_v + 1), dtype=bool)
        q = deque()
        # locate every cell whose +-quarter-step box contains the seed
        # point (DEHWSURF.h:1176-1192) and enqueue its 4 corners
        eps_x = (us[:-1] - us[1:]) / 4.0
        eps_y = (vs[:-1, 1:] - vs[:-1, :-1]) / 4.0
        hit = (
            (us[1:, None] - eps_x[:, None] <= a)
            & (a <= us[:-1, None] + eps_x[:, None])
            & (vs[:-1, :-1] - eps_y <= r)
            & (r <= vs[:-1, 1:] + eps_y)
        )
        for ci, cj in zip(*np.nonzero(hit)):
            for di, dj in ((0, 0), (1, 0), (0, 1), (1, 1)):
                ti, tj = int(ci) + di, int(cj) + dj
                if not seen[ti, tj]:
                    seen[ti, tj] = True
                    q.append((ti, tj, (s0, s1)))
        while q:
            ti, tj, init = q.popleft()
            res = solvers[z](us[ti], vs[ti, tj], init)
            if res is None:
                continue
            r2, sol = res
            if accept(sol, z):
                merge(ti, tj, r2, z)
            # spread on convergence regardless of the merge gate (the
            # reference's 8-neighbor flood, DEHWSURF.h:1247-1262)
            for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1),
                           (-1, -1), (-1, 1), (1, -1), (1, 1)):
                ni, nj = ti + di, tj + dj
                if 0 <= ni <= n_u and 0 <= nj <= n_v and not seen[ni, nj]:
                    seen[ni, nj] = True
                    q.append((ni, nj, sol))
    if relief:
        pts = wheel_relief_grid(p, pts)
    return pts, fpha


# ---------------------------------------------------------------------------
# Full surface set at reference grid conventions (DEHWSURF::ESTABLISH,
# DEHWSURF.h:1913-1921): the 8 CURVEDS grids the DEHW mesh generators consume
# (worm/wheel tooth flank + back + root transition front/back), with the
# reference's index conventions:
#   * worm flank rows ti: thread coordinate xi_11 = real_star + ti*dt_fine,
#     cols tj: profile coordinate xi_12 from R_t[0] (root) to R_a[0] (tip);
#   * wheel flank rows: face angle from -widt_angl to +widt_angl, cols from
#     the root-transition radius R_t[1] to the tip (the reference stores the
#     wheel grids flipped in both indices, DEHWSURF.h:1806-1808 — these
#     arrays ARE the stored orientation);
#   * root grids at reduced resolution (no loca_leve rows, glob_homo cols),
#     DEHWSURF.h:1850-1886.
# ---------------------------------------------------------------------------


@dataclass
class DehwGrid:
    """Mesh-grid settings (DEHWSURF ctor, DEHWSURF.h:185-196).

    grid_numb[body] = [hub width (even), hub height, half tooth width,
    tooth height, xi_11 per block / facewidth divisions, computed ending
    blocks / tooth count, computed block count / blocks along facewidth].
    """

    worm_numb: tuple = (4, 2, 2, 4, 4)     # gridNumb[0][0..4]
    whee_numb: tuple = (4, 4, 2, 4, 8)     # gridNumb[1][0..4]
    whee_teeth: int = 9                    # gridNumb[1][5] = 8 + z[0]
    glob_inho: int = 1
    glob_homo: int = 2
    loca_leve: int = 3
    reli_swit: int = 1
    circ_numb: int = 8
    # relief ramp length in grid indices; None = the reference's 40 scaled
    # per axis to the grid resolution (exactly 40 at the reference config)
    reli_leng: float | None = None

    @property
    def fact_i(self) -> int:
        """Thread/facewidth-direction fine factor (full refinement)."""
        return 1 << (self.glob_inho + self.glob_homo + self.loca_leve)

    @property
    def fact_j(self) -> int:
        """Profile-direction fine factor."""
        return 1 << (self.glob_homo + self.loca_leve)


def worm_layout(p: DehwParams, g: DehwGrid):
    """Worm thread partition into circumferential domains
    (WORM_TS_GRID, DEHWSURF.h:1706-1718).  Returns (n_end, n_doma,
    real_star, delt_tang): xi_11 steps of the two ending blocks, total
    domain count (34 at reference parameters), grid start coordinate, and
    the base xi_11 step."""
    doma_circ = 2.0 * PI / g.circ_numb
    delt_tang = doma_circ / g.worm_numb[4]
    inte_star = p.worm_curv[1]
    while inte_star - doma_circ >= p.worm_curv[0]:
        inte_star -= doma_circ
    n_end = int(np.ceil((inte_star - p.worm_curv[0]) / delt_tang - 1e-12))
    real_star = inte_star - n_end * delt_tang
    inte_endi = p.worm_curv[1]
    while inte_endi + doma_circ <= p.worm_curv[2]:
        inte_endi += doma_circ
    n_doma = int(np.floor((inte_endi - inte_star) / doma_circ + 1.0e-10)) + 2
    return n_end, n_doma, real_star, delt_tang


def _relief_L(g: DehwGrid) -> tuple[float, float]:
    """Reference relief ramp length 40 at full resolution
    (fact_i, fact_j) = (64, 32); scaled per axis for reduced grids (the
    reference hard-codes 40 indices, which only makes sense at its full
    resolution — scaling keeps the physical relief zone invariant)."""
    if g.reli_leng is not None:
        return (float(g.reli_leng), float(g.reli_leng))
    return (max(1.0, 40.0 * g.fact_i / 64.0), max(1.0, 40.0 * g.fact_j / 32.0))


def worm_ts_grid(p: DehwParams, g: DehwGrid, chunk: int = 200_000):
    """Full worm working-flank grid (WORM_TS_GRID, DEHWSURF.h:1703-1748).
    Returns (pts (n0, n1, 3), xi11 (n0,), xi12 (n1,))."""
    n_end, n_doma, real_star, delt_tang = worm_layout(p, g)
    n0 = (g.worm_numb[4] * (n_doma - 2) + n_end * 2) * g.fact_i + 1
    n1 = g.worm_numb[3] * g.fact_j + 1
    xi11 = real_star + np.arange(n0) * (delt_tang / g.fact_i)
    xi12 = p.R_t[0] + (p.R_a[0] - p.R_t[0]) * np.arange(n1) / (n1 - 1)
    XI11, XI12 = np.meshgrid(xi11, xi12, indexing="ij")
    flat1, flat2 = XI11.ravel(), XI12.ravel()
    outs = []
    for s in range(0, flat1.size, chunk):
        pts, _ = worm_curv_to_cart(p, flat1[s : s + chunk], flat2[s : s + chunk])
        outs.append(pts)
    pts = np.concatenate(outs).reshape(n0, n1, 3)
    if g.reli_swit:
        # tip at high j (xi12 runs root -> tip), both thread ends relieved
        pts = worm_relief_grid(p, pts, L=_relief_L(g), tip_at_j0=False)
    return pts, xi11, xi12


def whee_ts_grid(p: DehwParams, g: DehwGrid):
    """Full zoned wheel flank grid in the reference's STORED orientation
    (WHEE_TS_GRID + the flipped INSERT of TOOT_SURF_GRID,
    DEHWSURF.h:1751-1810): rows = face angle -widt_angl .. +widt_angl, cols
    = profile R_t[1] (root transition) .. tip.  Returns (pts, fpha, alph3
    (n0,) face angles of the stored rows)."""
    n_u = g.whee_numb[4] * g.fact_i
    n_v = g.whee_numb[3] * g.fact_j
    # generator window = the FULL worm grid range (curvCoor[0] first..last
    # row, DEHWSURF.h:1240-1244), slightly wider than worm_curv[0..2]
    n_end, n_doma, real_star, delt_tang = worm_layout(p, g)
    n0_worm = (g.worm_numb[4] * (n_doma - 2) + n_end * 2) * g.fact_i
    window = (real_star, real_star + n0_worm * delt_tang / g.fact_i)
    pts, fpha = wheel_surface_grid(p, n_u, n_v, worm_window=window,
                                   relief=False)
    if g.reli_swit:
        # relief is applied in the cartCoor orientation (tip at j=0,
        # DEHWSURF.h:1777-1784) BEFORE the stored-orientation flip, so the
        # reference's asymmetric index arithmetic is reproduced exactly
        pts = wheel_relief_grid(
            p, pts, L=_relief_L(g), amounts=(12.0e-6, 16.0e-6), tip_at_j0=True
        )
    pts = pts[::-1, ::-1]
    fpha = fpha[::-1, ::-1]
    alph3 = -p.widt_angl + 2.0 * p.widt_angl * np.arange(n_u + 1) / n_u
    return pts, fpha, alph3


def whee_toba_from_tosu(p: DehwParams, tosu: np.ndarray) -> np.ndarray:
    """Wheel tooth-back grid from the stored flank grid (TOOT_SURF_GRID,
    DEHWSURF.h:1828-1841): row-reversed mirror by the tooth-back angle."""
    c, s = np.cos(p.back_angl[1]), np.sin(p.back_angl[1])
    src = tosu[::-1, :]
    return np.stack(
        [c * src[..., 0] - s * src[..., 1],
         -s * src[..., 0] - c * src[..., 1],
         -src[..., 2]], axis=-1,
    )


def _worm_axial_frame(xi11: np.ndarray):
    """Axial-section 2D frame at worm azimuth -xi11 (WORM_ROOT,
    DEHWSURF.h:1544-1556): 3D point -> (u, v) = (z, a_h2 - r) with the
    section's tangential coordinate dropped."""
    t = -np.asarray(xi11)
    c, s = np.cos(t), np.sin(t)

    def to2d(pts):
        u = pts[..., 2]
        v = (pts[..., 0] * c + pts[..., 1] * s)
        return u, -v  # second coord is -(r) before the +a_h2 shift

    def to3d(u, v):
        # 2D (u, v_raw) with v_raw measured like the reference's poin_i
        # (radius from the WORM AXIS in the section plane handled by caller)
        return u, v

    return t, c, s, to2d


def worm_root_grids(p: DehwParams, g: DehwGrid, tosu: np.ndarray,
                    toba: np.ndarray, xi11: np.ndarray):
    """Worm root-transition grids wormRtsu/wormRtba (WORM_ROOT +
    ROOT_TRAN_GRID, DEHWSURF.h:1510-1596,1850-1867): per axial section, the
    root profile runs from the mid-gap point on the root circle R_f[0]
    (about the gorge center) along the circle, then along a tangent fillet
    arc up to the flank's root end.  Rows subsample the flank rows by
    (1 << loca_leve); columns = (worm_numb[0]/2) * 2^glob_homo + 1."""
    step = 1 << g.loca_leve
    rows = np.arange(0, tosu.shape[0], step)
    n_cols = (g.worm_numb[0] // 2) * (1 << g.glob_homo) + 1
    out = []
    for flag, flank in ((1, tosu), (-1, toba)):
        P0 = flank[rows, 0]                      # (R, 3) flank root points
        P1 = flank[rows, 1]
        t = -xi11[rows]
        c, s = np.cos(t), np.sin(t)
        # axial-section coords (u, v) about the gorge center
        def sec(Pt):
            u = Pt[..., 2]
            v = -(Pt[..., 0] * c + Pt[..., 1] * s) + p.a_h2
            return np.stack([u, v], axis=-1)
        q0, q1 = sec(P0), sec(P1)
        v1 = q1 - q0
        v1 /= np.linalg.norm(v1, axis=-1, keepdims=True)
        v2 = -q0
        L1 = (v2 * v1).sum(-1)
        L2 = np.sqrt(np.maximum((v2 * v2).sum(-1) - L1 * L1, 0.0))
        targ = L1 / (p.R_f[0] - L2)
        midd = np.arcsin(targ / np.sqrt(1.0 + targ * targ)) - np.arctan(1.0 / targ)
        radi = p.R_f[0] - L1 / np.cos(midd)
        tvec = np.stack([flag * v1[..., 1], -flag * v1[..., 0]], axis=-1)
        cent = q0 + radi[..., None] * tvec
        a0 = np.arctan2(-tvec[..., 1], -tvec[..., 0])
        a1 = a0 + flag * (PI / 2.0 - midd)
        arce = cent + radi[..., None] * np.stack([np.cos(a1), np.sin(a1)], axis=-1)
        angl_arce = np.arctan2(arce[..., 1], arce[..., 0])
        angl_star = (np.arccos(p.r_b2 / (p.d[1] / 2.0)) - p.i_2h * t
                     - p.toot_thic_angl[0] / 2.0)
        angl_root = angl_star + flag * p.pitc_angl / 2.0
        leng_circ = flag * p.R_f[0] * (angl_root - angl_arce)
        leng_arc = flag * radi * (a1 - a0)
        sum_leng = leng_circ + leng_arc
        grid = np.zeros((rows.size, n_cols, 3))
        for tj in range(n_cols):
            leng = sum_leng * tj / (n_cols - 1)
            on_circ = leng <= leng_circ
            ang_c = angl_root - flag * leng / p.R_f[0]
            u_c = p.R_f[0] * np.cos(ang_c)
            v_c = p.R_f[0] * np.sin(ang_c)
            la = leng - leng_circ
            ang_a = a1 - flag * la / radi
            u_a = cent[..., 0] + radi * np.cos(ang_a)
            v_a = cent[..., 1] + radi * np.sin(ang_a)
            u = np.where(on_circ, u_c, u_a)
            v = np.where(on_circ, v_c, v_a)
            # section (u, v) -> 3D: radius (a_h2 - v) at azimuth t, z = u
            grid[:, tj, 0] = (p.a_h2 - v) * c
            grid[:, tj, 1] = (p.a_h2 - v) * s
            grid[:, tj, 2] = u
        out.append(grid)
    return out[0], out[1]


def whee_uncone(p: DehwParams, pts: np.ndarray, alph3) -> np.ndarray:
    """WHEE_UNCONE (DEHWSURF.h:1598-1606), batched: 3D -> unfolded-cone 2D."""
    r2 = np.hypot(pts[..., 0], pts[..., 1])
    r1 = r2 / np.cos(alph3)
    a1 = np.arctan2(pts[..., 1], pts[..., 0]) * np.cos(alph3)
    return np.stack([r1 * np.cos(a1), r1 * np.sin(a1)], axis=-1)


def whee_cone(p: DehwParams, xy: np.ndarray, alph3) -> np.ndarray:
    """WHEE_CONE (DEHWSURF.h:1608-1617), batched: unfolded-cone 2D -> 3D."""
    r1 = np.hypot(xy[..., 0], xy[..., 1])
    a1 = np.arctan2(xy[..., 1], xy[..., 0])
    r2 = r1 * np.cos(alph3)
    a2 = a1 / np.cos(alph3)
    r3 = p.a_h2 / np.cos(alph3) - r1
    return np.stack(
        [r2 * np.cos(a2), r2 * np.sin(a2),
         np.broadcast_to(r3 * np.sin(alph3), r2.shape)], axis=-1,
    )


def whee_root_grids(p: DehwParams, g: DehwGrid, tosu: np.ndarray,
                    toba: np.ndarray, alph3: np.ndarray):
    """Wheel root-transition grids wheeRtsu/wheeRtba (WHEE_ROOT +
    ROOT_TRAN_GRID, DEHWSURF.h:1619-1701,1868-1884), in the unfolded-cone
    plane per face-width section: root circle r_f about the cone apex ring,
    tangent fillet arc up to the flank root.  flag 0 = flank (Rtsu),
    1 = back (Rtba)."""
    step = 1 << g.loca_leve
    rows = np.arange(0, tosu.shape[0], step)
    n_cols = (g.whee_numb[0] // 2) * (1 << g.glob_homo) + 1
    m = tosu.shape[1]
    a3 = alph3[rows]
    angl_ai = a3 - np.arcsin(p.offs_R_a * np.sin(a3) / p.R_a[1])
    R_lo = np.full_like(a3, p.R_t[1])                       # stored col 0
    R_hi = (p.R_a[1] * np.cos(angl_ai) - p.offs_R_a) / np.cos(a3)   # tip

    def prof_pt(flank, tj):
        """Flank col tj mapped into the cone plane with the CURV radius
        (WHEE_ROOT's own cone transform, DEHWSURF.h:1627-1646)."""
        pt = flank[rows, tj]
        a2 = np.arctan2(pt[..., 1], pt[..., 0])
        r2 = np.hypot(pt[..., 0], pt[..., 1])
        r3 = R_lo + (R_hi - R_lo) * tj / (m - 1)
        r1 = p.a_h2 / np.cos(a3) - r3
        a1 = r2 * a2 / r1
        return np.stack([r1 * np.cos(a1), r1 * np.sin(a1)], axis=-1)

    r_f = p.a_h2 / np.cos(a3) - (p.a_h2 - p.d_f[1] / 2.0)
    pitc = p.pitc_angl * np.cos(a3)
    out = []
    for flag in (0, 1):
        this = tosu if flag == 0 else toba
        other = toba if flag == 0 else tosu
        q0 = prof_pt(this, 0)
        q1 = prof_pt(this, 1)
        v1 = q0 - q1
        v1 /= np.linalg.norm(v1, axis=-1, keepdims=True)
        v2 = -q0
        L1 = (v2 * v1).sum(-1)
        L2 = np.sqrt(np.maximum((v2 * v2).sum(-1) - L1 * L1, 0.0))
        targ = L1 / (r_f - L2)
        midd = np.arcsin(targ / np.sqrt(1.0 + targ * targ)) - np.arctan(1.0 / targ)
        radi = L1 / np.cos(midd) - r_f
        sign = 1.0 if flag == 0 else -1.0
        tvec = np.stack([-sign * v1[..., 1], sign * v1[..., 0]], axis=-1)
        cent = q0 + radi[..., None] * tvec
        a0 = np.arctan2(-tvec[..., 1], -tvec[..., 0])
        a1a = a0 + sign * (PI / 2.0 - midd)
        arce = cent + radi[..., None] * np.stack(
            [np.cos(a1a), np.sin(a1a)], axis=-1
        )
        angl_arce = np.arctan2(arce[..., 1], arce[..., 0])
        qo = prof_pt(other, 0)
        angl_root = 0.5 * (np.arctan2(qo[..., 1], qo[..., 0])
                           + np.arctan2(q0[..., 1], q0[..., 0]))
        angl_root -= sign * pitc / 2.0
        leng_circ = r_f * sign * (angl_arce - angl_root)
        leng_arc = radi * sign * (a1a - a0)
        sum_leng = leng_circ + leng_arc
        grid = np.zeros((rows.size, n_cols, 3))
        for tj in range(n_cols):
            leng = sum_leng * tj / (n_cols - 1)
            on_circ = leng <= leng_circ
            ang_c = angl_root + sign * leng / r_f
            xy_c = np.stack([r_f * np.cos(ang_c), r_f * np.sin(ang_c)], axis=-1)
            la = leng - leng_circ
            ang_a = a1a - sign * la / radi
            xy_a = cent + radi[..., None] * np.stack(
                [np.cos(ang_a), np.sin(ang_a)], axis=-1
            )
            xy = np.where(on_circ[..., None], xy_c, xy_a)
            grid[:, tj] = whee_cone(p, xy, a3)
        out.append(grid)
    return out[0], out[1]


@dataclass
class DehwSurfaces:
    """The 8 exact-surface grids + layout (DEHWSURF::ESTABLISH output)."""

    p: DehwParams
    g: DehwGrid
    worm_tosu: np.ndarray
    worm_toba: np.ndarray
    worm_rtsu: np.ndarray
    worm_rtba: np.ndarray
    whee_tosu: np.ndarray
    whee_toba: np.ndarray
    whee_rtsu: np.ndarray
    whee_rtba: np.ndarray
    xi11: np.ndarray          # worm flank row coordinates
    alph3: np.ndarray         # wheel flank row face angles (stored rows)
    fpha: np.ndarray          # wheel zone flags (stored orientation)
    worm_ends: int            # gridNumb[0][5]
    worm_domains: int         # gridNumb[0][6]
    real_star: float
    delt_tang: float


def build_surfaces(p: DehwParams, g: DehwGrid, cache: bool = True) -> DehwSurfaces:
    """DEHWSURF::ESTABLISH (DEHWSURF.h:1913-1921): all 8 grids.

    The grids are a pure function of (p, g); since the wheel zone solvers
    are Newton-per-point host code, results are cached on disk keyed by the
    parameter set (override dir with DDPCA_SURF_CACHE, disable with
    cache=False or DDPCA_SURF_CACHE=0)."""
    import hashlib
    import os

    n_end, n_doma, real_star, delt_tang = worm_layout(p, g)
    cdir = os.environ.get("DDPCA_SURF_CACHE", "")
    if cdir == "0":
        cache = False
    key = hashlib.sha1(
        repr((sorted(p.__dict__.items(), key=lambda kv: kv[0]),
              sorted(g.__dict__.items()), 3)).encode()
    ).hexdigest()[:16]
    path = os.path.join(
        cdir or os.path.expanduser("~/.cache/ddpca_dehw_torch"), f"surf_{key}.npz"
    )
    names = ["worm_tosu", "worm_toba", "worm_rtsu", "worm_rtba",
             "whee_tosu", "whee_toba", "whee_rtsu", "whee_rtba",
             "xi11", "alph3", "fpha"]
    if cache and os.path.exists(path):
        z = np.load(path)
        data = {n: z[n] for n in names}
    else:
        worm_tosu, xi11, _ = worm_ts_grid(p, g)
        worm_toba = worm_back_grid(p, worm_tosu)
        worm_rtsu, worm_rtba = worm_root_grids(p, g, worm_tosu, worm_toba, xi11)
        whee_tosu, fpha, alph3 = whee_ts_grid(p, g)
        whee_toba = whee_toba_from_tosu(p, whee_tosu)
        whee_rtsu, whee_rtba = whee_root_grids(p, g, whee_tosu, whee_toba, alph3)
        data = dict(
            worm_tosu=worm_tosu, worm_toba=worm_toba, worm_rtsu=worm_rtsu,
            worm_rtba=worm_rtba, whee_tosu=whee_tosu, whee_toba=whee_toba,
            whee_rtsu=whee_rtsu, whee_rtba=whee_rtba, xi11=xi11, alph3=alph3,
            fpha=fpha,
        )
        if cache:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.savez_compressed(path, **data)
    return DehwSurfaces(
        p=p, g=g, worm_ends=n_end, worm_domains=n_doma,
        real_star=real_star, delt_tang=delt_tang, **data,
    )
