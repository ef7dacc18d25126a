"""Postprocessor: renders the framework's result files (Postprocess.m:1-71).

Reads the same text-file contract the reference's MATLAB script consumes
(resuNode_/resuElem_/resuDisp_/resuStre_/resuInpo_/resuCont_<id>.txt, written
by utils/io.py) and produces three figures, saved as PNGs:

  * displacement magnitude |u| on hex faces   (Postprocess.m:3-28)
  * von Mises stress (resuStre column 7)      (Postprocess.m:31-56)
  * contact pressure scatter at integral points with positive pressure
                                              (Postprocess.m:59-71)

Headless by construction (Agg backend) — figures go to <outdir>/plots/.

The port of the JAX package's ``utils/postprocess.py``, host code only.
matplotlib is imported inside the functions, so the module imports where
matplotlib is absent (the card's machine has none); there
:func:`postprocess` raises an ImportError that names matplotlib.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

# face connectivity of a hex8 cell, matching Postprocess.m:11-16 (0-based)
HEX_FACES = np.array(
    [
        [0, 1, 2, 3],
        [4, 5, 6, 7],
        [0, 3, 7, 4],
        [1, 2, 6, 5],
        [0, 4, 5, 1],
        [3, 7, 6, 2],
    ]
)


def _idents(outdir: str, prefix: str) -> list[str]:
    pat = re.compile(rf"{prefix}_(.+)\.txt$")
    out = []
    for f in sorted(glob.glob(os.path.join(outdir, f"{prefix}_*.txt"))):
        m = pat.search(os.path.basename(f))
        if m:
            out.append(m.group(1))
    return out


def _load_body(outdir: str, ident: str):
    node = np.loadtxt(os.path.join(outdir, f"resuNode_{ident}.txt"), ndmin=2)
    elem = np.loadtxt(
        os.path.join(outdir, f"resuElem_{ident}.txt"), ndmin=2
    ).astype(int)
    return node, elem


def _boundary_faces(elem: np.ndarray) -> np.ndarray:
    """All 6 faces per element, keeping only faces that appear once (the
    visible surface) — a cheap improvement over the reference's draw-all."""
    faces = elem[:, HEX_FACES].reshape(-1, 4)
    key = np.sort(faces, axis=1)
    _, inv, cnt = np.unique(
        key, axis=0, return_inverse=True, return_counts=True
    )
    return faces[cnt[inv] == 1]


def _patch_plot(ax, node, faces, vals, cmap="jet"):
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    polys = node[faces]  # (F, 4, 3)
    coll = Poly3DCollection(polys, edgecolor="none")
    coll.set_array(vals[faces].mean(axis=1))
    coll.set_cmap(cmap)
    ax.add_collection3d(coll)
    return coll


def _finish(ax, node_all):
    lo = node_all.min(axis=0)
    hi = node_all.max(axis=0)
    c = 0.5 * (lo + hi)
    r = 0.5 * (hi - lo).max() + 1e-30
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.view_init(elev=40, azim=30)  # view(30,40) (Postprocess.m:25)


def _field_figure(outdir: str, field_file: str, field_col, title: str,
                  png: str) -> str | None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    idents = _idents(outdir, "resuNode")
    if not idents:
        return None
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(111, projection="3d")
    colls, all_nodes = [], []
    for ident in idents:
        fpath = os.path.join(outdir, f"{field_file}_{ident}.txt")
        if not os.path.exists(fpath):
            continue
        node, elem = _load_body(outdir, ident)
        data = np.loadtxt(fpath, ndmin=2)
        vals = field_col(data)
        faces = _boundary_faces(elem)
        colls.append(_patch_plot(ax, node, faces, vals))
        all_nodes.append(node)
    if not colls:
        plt.close(fig)
        return None
    vmin = min(c.get_array().min() for c in colls)
    vmax = max(c.get_array().max() for c in colls)
    for c in colls:
        c.set_clim(vmin, vmax)
    _finish(ax, np.concatenate(all_nodes))
    fig.colorbar(colls[0], ax=ax, shrink=0.7)
    ax.set_title(title)
    path = os.path.join(outdir, "plots", png)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def plot_displacement(outdir: str) -> str | None:
    """|u| patch plot (Postprocess.m:3-28)."""
    return _field_figure(
        outdir, "resuDisp", lambda d: np.linalg.norm(d[:, :3], axis=1),
        "displacement magnitude [m]", "displacement.png",
    )


def plot_von_mises(outdir: str) -> str | None:
    """von Mises patch plot — column 7 of resuStre (Postprocess.m:31-56)."""
    return _field_figure(
        outdir, "resuStre", lambda d: d[:, 6],
        "von Mises stress [Pa]", "von_mises.png",
    )


def plot_contact_pressure(outdir: str) -> str | None:
    """Positive-pressure integral-point scatter (Postprocess.m:59-71)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    idents = _idents(outdir, "resuInpo")
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(111, projection="3d")
    pts_all, sc = [], None
    for ident in idents:
        cpath = os.path.join(outdir, f"resuCont_{ident}.txt")
        if not os.path.exists(cpath):
            continue
        ip = np.loadtxt(
            os.path.join(outdir, f"resuInpo_{ident}.txt"), ndmin=2
        )
        cf = np.loadtxt(cpath, ndmin=2)
        n = min(len(ip), len(cf))
        ip, cf = ip[:n], cf[:n]
        pos = cf[:, 0] > 0.0
        if not pos.any():
            continue
        sc = ax.scatter(
            ip[pos, 0], ip[pos, 1], ip[pos, 2], c=cf[pos, 0], s=25,
            cmap="jet",
        )
        pts_all.append(ip[pos, :3])
    if sc is None:
        plt.close(fig)
        return None
    _finish(ax, np.concatenate(pts_all))
    fig.colorbar(sc, ax=ax, shrink=0.7)
    ax.set_title("contact pressure [Pa]")
    path = os.path.join(outdir, "plots", "contact_pressure.png")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def postprocess(outdir: str) -> list[str]:
    """Render every figure the result directory supports; returns paths."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "postprocess renders with matplotlib, which is not installed"
        ) from e
    out = []
    for fn in (plot_displacement, plot_von_mises, plot_contact_pressure):
        p = fn(outdir)
        if p:
            out.append(p)
    return out
