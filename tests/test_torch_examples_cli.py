"""The port's command line (``python -m ddpca_admm_tpu_torch.cli``) against
the JAX package's: ``torsion --scale small`` and ``boxes`` run through both
into two directories, the port's with ``--device cpu``.  Every result file
agrees within 1e-8 of its largest entry (integer files exactly), the JSON
summaries carry the same keys, and the TORSION twist meets its analytic
value.  The TORSION solve is held here: its iteration count, displacements
(resuDisp), z and lambda (resuAula) and tractions (resuCont)."""

import contextlib
import glob
import io
import json
import os

import numpy as np
import pytest
import torch

from ddpca_admm_tpu import cli as jax_cli
from ddpca_admm_tpu_torch import cli

torch.set_num_threads(1)

TOL = 1e-8
TIMINGS = {"solve_seconds", "total_seconds", "setup_phases", "outdir"}
INT_FILES = ("resuElem", "resuSegm")


def _run_both(tmp_path_factory, argv):
    """Run ``argv`` through both CLIs (the port's on the CPU); returns
    {package: (outdir, JSON summary)}."""
    out = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("torch", cli.main, ["--device", "cpu"])):
        d = str(tmp_path_factory.mktemp(f"{argv[0]}_{name}"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv + ["--outdir", d, "--moni"] + extra)
        out[name] = (d, json.loads(buf.getvalue().strip().splitlines()[-1]))
    return out


@pytest.fixture(scope="module")
def torsion_runs(tmp_path_factory):
    return _run_both(tmp_path_factory, ["torsion", "--scale", "small"])


def _assert_files_match(d_port, d_ref):
    names = sorted(os.path.basename(f)
                   for f in glob.glob(os.path.join(d_ref, "resu*.txt")))
    assert names
    assert names == sorted(os.path.basename(f) for f in
                           glob.glob(os.path.join(d_port, "resu*.txt")))
    for n in names:
        a = np.loadtxt(os.path.join(d_port, n), ndmin=2)
        b = np.loadtxt(os.path.join(d_ref, n), ndmin=2)
        assert a.shape == b.shape, n
        if n.startswith(INT_FILES):
            np.testing.assert_array_equal(a, b, err_msg=n)
            continue
        # resuMoni's first row holds a 0/0 ratio in both packages
        nan = np.isnan(b)
        np.testing.assert_array_equal(np.isnan(a), nan, err_msg=n)
        a, b = np.where(nan, 0.0, a), np.where(nan, 0.0, b)
        scale = float(np.abs(b).max()) if b.size else 0.0
        assert float(np.abs(a - b).max(initial=0.0)) <= TOL * scale, n
    return names


def _assert_summaries_match(s_port, s_ref):
    assert s_port.keys() == s_ref.keys()
    assert s_port["setup_phases"].keys() == s_ref["setup_phases"].keys()
    for k in s_ref.keys() - TIMINGS - {"inner_cg_iterations"}:
        assert s_port[k] == s_ref[k], k
    # inner CG counts may drift by rounding (float32 V-cycle): 1%
    assert abs(s_port["inner_cg_iterations"]
               - s_ref["inner_cg_iterations"]) <= \
        0.01 * s_ref["inner_cg_iterations"]


def test_torsion_cli_files_match_jax(torsion_runs):
    (d_ref, s_ref), (d_port, s_port) = torsion_runs["jax"], \
        torsion_runs["torch"]
    _assert_summaries_match(s_port, s_ref)
    assert s_port["converged"] and s_port["iterations"] == s_ref["iterations"]
    names = _assert_files_match(d_port, d_ref)
    kinds = {n.split("_")[0].removesuffix(".txt") for n in names}
    assert {"resuDisp", "resuAula", "resuCont", "resuStre", "resuMoni",
            "resuNode", "resuElem", "resuInpo", "resuSegm"} <= kinds


def test_torsion_cli_twist_meets_analytic(torsion_runs):
    """Tangential displacement at the outer radius of the loaded end face
    against T l R / (G I_p): within 1e-5 relative at the small scale (the
    applied traction is the exact torsion shear; measured 0.99999903)."""
    d, s = torsion_runs["torch"]
    ut = []
    for f in glob.glob(os.path.join(d, "resuNode_*.txt")):
        b = f.rsplit("_", 1)[1][:-4]
        X = np.loadtxt(f)
        U = np.loadtxt(os.path.join(d, f"resuDisp_{b}.txt"))
        r = np.hypot(X[:, 0], X[:, 1])
        sel = (np.abs(r - 0.025) < 1e-9) & (np.abs(X[:, 2] - 0.1) < 1e-9)
        ut.append((-X[sel, 1] * U[sel, 0] + X[sel, 0] * U[sel, 1]) / r[sel])
    ut = np.concatenate(ut)
    assert ut.size > 0
    assert abs(ut.mean() / s["analytic_twist"] - 1.0) < 1e-5


def test_boxes_cli_files_match_jax(tmp_path_factory):
    runs = _run_both(tmp_path_factory, ["boxes"])
    (d_ref, s_ref), (d_port, s_port) = runs["jax"], runs["torch"]
    _assert_summaries_match(s_port, s_ref)
    assert s_port["converged"]
    _assert_files_match(d_port, d_ref)


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["boxes", "--outdir", str(tmp_path)])


def test_cli_leaves_out_what_is_not_ported(capsys):
    """``dehw --apps``, ``boxes --lagrange`` and ``postprocess`` wait for a
    later slice: the parser does not offer them."""
    for argv in (["dehw", "--apps", "global"], ["boxes", "--lagrange"],
                 ["postprocess", "x"]):
        with pytest.raises(SystemExit):
            cli.main(argv)
    capsys.readouterr()
