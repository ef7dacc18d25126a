"""APPS: automatic-penalty-parameter eigen-analysis (MCONTACT.h:2343-2476).

The reference runs a Spectra Lanczos solver for the 10 smallest-magnitude
eigenpairs of the interface-eliminated global coarse operator globCoup_1
(tolerance 1e-6, MCONTACT.h:2350-2365), writes eigenvalue +
force-correlation pairs to resuFreq.txt, and prolongates every mode to each
body as a resuDisp-style file named ``resuDisp_<mode>-<body>.txt``
(MCONTACT.h:2378-2400).

The port of the JAX package's ``admm/eigen.py``, host code only (numpy
and scipy; nothing runs on a device).  The same matrix comes from
:func:`multiscale.glob_coup_1`; below ``DENSE_EIGH_MAXI`` rows a dense host
eigendecomposition is exact, above it ``scipy.sparse.linalg.eigsh`` in
shift-invert mode plays Spectra's role (the analysis runs once, not per
iteration).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import scipy.linalg
import scipy.sparse.linalg as spla

from ..fem.constraints import ConstrainedSystem
from ..utils import io as rio
from .multiscale import glob_coup_1, glob_coup_a, glob_forc_1
from .operators import RegionOps

DENSE_EIGH_MAXI = 3000


@dataclass
class AppsResult:
    vals: np.ndarray          # (n_freq,) smallest-|.| eigenvalues
    corr: np.ndarray          # (n_freq,) correlation with normalized force
    modes: np.ndarray         # (Nc, n_freq) coarse eigenvectors
    body_modes: list          # per mode: list of per-body FULL displacements


def run_apps(
    systems: Sequence[ConstrainedSystem],
    regions: Sequence[RegionOps],
    dole: Sequence[int],
    n_freq: int = 10,
) -> AppsResult:
    """The APPS pipeline on globCoup_1 (MCONTACT.h:2343-2412)."""
    G, F, base, XF = glob_coup_1(systems, regions, list(dole))
    forc = glob_forc_1(systems, regions, F, base, XF)
    return _apps(G, F, base, systems, forc, n_freq)


def _smallest_eigs(G, n_freq: int):
    """The ``n_freq`` smallest-|.| eigenpairs of G, in that order."""
    if G.shape[0] <= DENSE_EIGH_MAXI:
        w, V = scipy.linalg.eigh(G.toarray())
        order = np.argsort(np.abs(w))[:n_freq]
        return w[order], V[:, order]
    # Spectra SmallestMagn equivalent: shift-invert Lanczos about 0
    # (sigma=0 factorizes G once; LM in shift-invert = smallest |w|).
    # A singular/semi-definite G (weakly constrained body) makes the
    # sigma=0 factorization fail where Spectra's plain Lanczos would
    # tolerate it — retry with a tiny diagonal-relative shift.
    Gc = G.tocsc()
    try:
        w, V = spla.eigsh(Gc, k=n_freq, sigma=0.0, which="LM", tol=1.0e-6)
    except RuntimeError:
        sigma = -1.0e-12 * float(np.abs(Gc.diagonal()).max())
        w, V = spla.eigsh(Gc, k=n_freq, sigma=sigma, which="LM",
                          tol=1.0e-6)
    order = np.argsort(np.abs(w))
    return w[order], V[:, order]


def _apps(G, F, base, systems, forc, n_freq: int) -> AppsResult:
    """Eigenpairs of G, their correlation with the normalized coarse force
    ``forc``, and every mode prolongated to each body's full 3N DOFs (body
    blocks only, no lift)."""
    n_freq = min(n_freq, G.shape[0] - 1)
    vals, modes = _smallest_eigs(G, n_freq)
    fn = forc / (np.linalg.norm(forc) + 1e-300)
    corr = modes.T @ fn

    body_modes = []
    for f in range(n_freq):
        per_body = []
        for v, s in enumerate(systems):
            blk = modes[base[v] : base[v + 1], f]
            per_body.append(s.expand @ (F[v] @ blk))
        body_modes.append(per_body)
    return AppsResult(vals=vals, corr=corr, modes=modes,
                      body_modes=body_modes)


def run_apps_mpl(
    systems: Sequence[ConstrainedSystem],
    regions: Sequence[RegionOps],
    meshes: Sequence,
    dole: Sequence[int],
    n_freq: int = 10,
) -> AppsResult:
    """APPS_MPL (MCONTACT.h:2405-2474): the same smallest-|.| eigen-analysis
    on the variant-A coarse operator globCoup (body coarse DOFs + macroscopic
    interface unknowns); mode shapes prolongate the body blocks only."""
    G, F, base, *_ = glob_coup_a(systems, regions, meshes, list(dole))
    # force correlation against the body-block coarse force
    forc = np.zeros(G.shape[0])
    for v, s in enumerate(systems):
        forc[base[v] : base[v + 1]] = F[v].T @ s.cons_forc
    return _apps(G, F, base, systems, forc, n_freq)


def write_freq(outdir: str, vals: np.ndarray, corr: np.ndarray) -> None:
    """resuFreq.txt (MCONTACT.h:2368-2376)."""
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "resuFreq.txt"), "w") as f:
        for v, c in zip(vals, corr):
            f.write(f"{v:>30.20e}{c:>30.20e}\n")


def write_modes(outdir: str, res: AppsResult, bodies) -> None:
    """Per-body mode-shape files ``resuDisp_<mode>-<body>.txt``
    (MCONTACT.h:2378-2400 OUTP_SUB2 with the "<tf+1>-<tv>" ident)."""
    for f, per_body in enumerate(res.body_modes):
        for v, (body, disp) in enumerate(zip(bodies, per_body)):
            rio.write_displacement(
                outdir, disp, f"{f + 1}-{v}", body.node_rota
            )
