"""The port's APPS eigen-analysis (``admm/eigen.py``: ``run_apps`` on
globCoup_1 and ``run_apps_mpl`` on the variant-A coarse operator) against
the JAX package's, on TORSION at the JAX CLI's small configuration.

Below ``DENSE_EIGH_MAXI`` rows both take the dense ``eigh``: eigenvalues
within 1e-10 relative, correlations within 1e-8 and modes equal up to sign
(up to an orthogonal map within the eigenspace of a repeated eigenvalue:
the TORSION shaft's symmetry gives pairs).  With ``DENSE_EIGH_MAXI``
lowered in both modules alike both take the shift-invert ``eigsh``; see ``EIGSH_*`` for its tolerances.
"""

import numpy as np
import pytest
import torch

import ddpca_admm_tpu.admm.eigen as jeig
import ddpca_admm_tpu_torch.admm.eigen as teig
from ddpca_admm_tpu.models.torsion import TorsionConfig as JCfg
from ddpca_admm_tpu.models.torsion import build_torsion_model as jbuild
from ddpca_admm_tpu_torch.cli import SMALL_TORSION
from ddpca_admm_tpu_torch.models.torsion import TorsionConfig, \
    build_torsion_model

torch.set_num_threads(1)

# ARPACK draws a fresh random start vector on every call, so the two
# packages' eigsh runs do not start from the same vector and stop at
# different points inside eigsh's tol=1e-6: eigenvalues are held within
# 1e-5 relative and modes within 1e-4 (three eigsh runs against the dense
# eigh on this fixture: eigenvalues within 2e-13, modes within 2e-7, but
# the Ritz vectors only converge to tol, so the margin is kept)
EIGSH_VAL_TOL = 1e-5
EIGSH_MODE_TOL = 1e-4


@pytest.fixture(scope="module")
def torsion():
    """Per package: (systems, regions, meshes, dole), and its bodies under
    "<package> bodies"."""
    out = {}
    for name, build, cfg in (
        ("jax", jbuild, JCfg(**SMALL_TORSION)),
        ("torch", lambda c: build_torsion_model(c, device="cpu"),
         TorsionConfig(**SMALL_TORSION)),
    ):
        _, meta, bodies, _ = build(cfg)
        systems = meta.systems
        dole = [min(1, s.n_levels - 1) for s in systems]
        out[name] = (systems, meta.regions, [b.mesh for b in bodies], dole)
        out[f"{name} bodies"] = bodies
    return out


def _run(mod, kind, systems, regions, meshes, dole):
    if kind == "apps":
        return mod.run_apps(systems, regions, dole)
    return mod.run_apps_mpl(systems, regions, meshes, dole)


def _clusters(vals, rel=1e-6):
    """Index groups of equal eigenvalues: TORSION is axisymmetric, so its
    spectrum holds pairs that agree to rounding."""
    groups = [[0]]
    for i in range(1, len(vals)):
        if abs(vals[i] - vals[groups[-1][0]]) <= rel * abs(vals[i]):
            groups[-1].append(i)
        else:
            groups.append([i])
    return groups


def _assert_match(res, ref, val_tol, corr_tol, mode_tol):
    """Eigenvalues within ``val_tol`` relative; modes, their per-body
    prolongations and correlations within ``mode_tol`` / ``corr_tol`` up to
    sign, or, where an eigenvalue repeats, up to the orthogonal map
    (Procrustes) that best aligns the two bases of its eigenspace."""
    assert res.vals.shape == ref.vals.shape == (10,)
    assert np.all(np.abs(res.vals - ref.vals) <= val_tol * np.abs(ref.vals))
    for idx in _clusters(ref.vals):
        A, B = res.modes[:, idx], ref.modes[:, idx]
        u, _, vt = np.linalg.svd(B.T @ A)
        Q = u @ vt                       # +-1 for a single eigenvalue
        scale = np.abs(B).max()
        assert np.abs(A - B @ Q).max() <= mode_tol * scale, idx
        assert np.abs(res.corr[idx] - Q.T @ ref.corr[idx]).max() <= \
            corr_tol * max(1.0, np.abs(ref.corr).max()), idx
        for v in range(len(ref.body_modes[0])):
            pa = np.stack([res.body_modes[f][v] for f in idx], axis=1)
            pb = np.stack([ref.body_modes[f][v] for f in idx], axis=1)
            assert np.abs(pa - pb @ Q).max() <= \
                mode_tol * max(np.abs(pb).max(), scale), (idx, v)


@pytest.mark.parametrize("kind", ["apps", "apps_mpl"])
def test_apps_dense_matches_jax(torsion, kind):
    res = _run(teig, kind, *torsion["torch"])
    ref = _run(jeig, kind, *torsion["jax"])
    assert res.modes.shape[0] <= teig.DENSE_EIGH_MAXI
    _assert_match(res, ref, 1e-10, 1e-8, 1e-8)
    # finite eigenvalues in ascending magnitude, strictly between the
    # clusters (a repeated pair may agree to the last bit)
    assert np.all(np.isfinite(res.vals))
    assert np.all(np.diff(np.abs(res.vals)) >= 0)
    heads = np.abs(res.vals[[idx[0] for idx in _clusters(res.vals)]])
    assert np.all(np.diff(heads) > 0)


@pytest.mark.parametrize("kind", ["apps", "apps_mpl"])
def test_apps_eigsh_matches_jax(torsion, kind, monkeypatch):
    n = _run(teig, kind, *torsion["torch"]).modes.shape[0]
    for mod in (teig, jeig):
        monkeypatch.setattr(mod, "DENSE_EIGH_MAXI", n // 2)
    res = _run(teig, kind, *torsion["torch"])
    ref = _run(jeig, kind, *torsion["jax"])
    _assert_match(res, ref, EIGSH_VAL_TOL, EIGSH_MODE_TOL, EIGSH_MODE_TOL)


def test_write_freq_and_modes_match_jax(torsion, tmp_path):
    """resuFreq.txt and the per-body mode files, written by both packages'
    writers from the same result, are the same files."""
    res = teig.run_apps(*[torsion["torch"][i] for i in (0, 1, 3)])
    for mod, d, pkg in ((teig, tmp_path / "t", "torch"),
                        (jeig, tmp_path / "j", "jax")):
        mod.write_freq(str(d), res.vals, res.corr)
        mod.write_modes(str(d), res, torsion[f"{pkg} bodies"])
    bodies = torsion["torch bodies"]
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == 1 + 10 * len(bodies)
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n
