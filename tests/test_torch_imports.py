"""The port imports neither JAX nor the JAX package: in a fresh interpreter
whose import system refuses ``jax``, ``jaxlib`` and ``ddpca_admm_tpu`` (and
its submodules, not ``ddpca_admm_tpu_torch``), every module of the port
imports (the LAGRANGE, APPS, checkpoint and postprocess modules among
them), the small BLOCK builds and solves on the CPU, and the port's command
line runs TORSION at its small scale and the boxes' LAGRANGE solve on the
CPU."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import importlib.abc
import json
import sys

REFUSED = ("jax", "jaxlib", "ddpca_admm_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == r or name.startswith(r + ".") for r in REFUSED):
            raise ImportError(f"import of {name} refused")
        return None


assert not any(m.split(".")[0] in REFUSED for m in sys.modules)
sys.meta_path.insert(0, Refuse())

import importlib
import pkgutil

import torch

torch.set_num_threads(1)
import ddpca_admm_tpu_torch as pkg

mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)

from ddpca_admm_tpu_torch.admm.loop import contact_analysis
from ddpca_admm_tpu_torch.admm.problem import build_problem
from ddpca_admm_tpu_torch.models.block import BlockConfig, build_block_model

cfg = BlockConfig(divi=(2, 2, 2), glob_leve=1, doma_numb=(1, 1, 1))
model = build_block_model(cfg)
prob, meta = build_problem(model.systems, model.regions,
                           dole=[1] * len(model.systems), device="cpu")
st = contact_analysis(prob, tuple(meta.group_modes), max_iter=800,
                      device="cpu")
u = st.u.numpy()
E, p = cfg.e_mod, cfg.pressure
err = max(
    float(abs(s.full_displacement(u[b, : s.n_dof])[2::3]
              - p * body.mesh.coords[:, 2] / E).max())
    for b, (body, s) in enumerate(zip(model.bodies, meta.systems))
)
# the port's command line on the CPU: TORSION at the JAX CLI's small scale
import contextlib
import io
import tempfile

from ddpca_admm_tpu_torch import cli

buf = io.StringIO()
with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(buf):
    cli.main(["torsion", "--scale", "small", "--device", "cpu",
              "--outdir", d])
torsion = json.loads(buf.getvalue().strip().splitlines()[-1])
# the dual-mortar LAGRANGE solve through the CLI: BiCGSTAB under the
# restricted-GMG V-cycle
buf = io.StringIO()
with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(buf):
    cli.main(["boxes", "--lagrange", "--prec-type", "1", "--levels", "1",
              "--device", "cpu", "--outdir", d])
lagrange = json.loads(buf.getvalue().strip().splitlines()[-1])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
print(json.dumps({"modules": mods, "it": st.it, "converged": st.converged,
                  "patch_err_rel": err / (abs(p) * sum(cfg.leng) / E),
                  "torsion": torsion, "lagrange": lagrange,
                  "loaded": loaded}))
'''


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    expected = {
        "ddpca_admm_tpu_torch.admm.convert", "ddpca_admm_tpu_torch.admm.loop",
        "ddpca_admm_tpu_torch.sparse.plane_dia_kernel",
        "ddpca_admm_tpu_torch.utils.cuda_lib",
        "ddpca_admm_tpu_torch.models.block",
        "ddpca_admm_tpu_torch.cli", "ddpca_admm_tpu_torch.utils.io",
        "ddpca_admm_tpu_torch.mesh.curveds",
        "ddpca_admm_tpu_torch.contact.adaptive",
        "ddpca_admm_tpu_torch.models.torsion",
        "ddpca_admm_tpu_torch.models.beam",
        "ddpca_admm_tpu_torch.models.cylinder",
        "ddpca_admm_tpu_torch.models.dehw_surf",
        "ddpca_admm_tpu_torch.models.dehw_assembly",
        "ddpca_admm_tpu_torch.solvers.krylov",
        "ddpca_admm_tpu_torch.admm.lagrange",
        "ddpca_admm_tpu_torch.admm.eigen",
        "ddpca_admm_tpu_torch.utils.checkpoint",
        "ddpca_admm_tpu_torch.utils.postprocess",
    }
    assert expected <= set(out["modules"])
    assert out["converged"] and out["it"] == 3
    # the BLOCK patch test: u_z = p z / E in every body
    assert out["patch_err_rel"] <= 1e-6
    # the CLI's TORSION run (81 iterations, as the JAX CLI's)
    assert out["torsion"]["converged"]
    assert out["torsion"]["iterations"] == 81
    # the LAGRANGE patch test changes no contact state: one Newton pass
    assert out["lagrange"]["solver"] == "lagrange"
    assert out["lagrange"]["newton_iterations"] == 0


def test_refusing_hook_refuses():
    """The hook itself: under it, the JAX package cannot be imported."""
    script = SCRIPT.split("import importlib\nimport pkgutil")[0] + \
        "import ddpca_admm_tpu\n"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "import of ddpca_admm_tpu refused" in proc.stderr
