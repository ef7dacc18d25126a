"""Helpers shared by the port's parity tests (``test_torch_examples_*``):
comparing a port state with a JAX state, and host objects of the two
packages bit for bit."""

import dataclasses

import numpy as np
import scipy.sparse as sp

# u, z and lambda of the port within TOL of the largest entry of the JAX
# package's on the same problem
TOL = 1e-8


def assert_states_match(st, ref, tol=TOL, converged=True,
                        across_groups=False):
    """Port state ``st`` against JAX state ``ref``: the same iteration count
    and u, z, lambda, gamma within ``tol`` of their largest entries.
    ``converged=None`` skips the convergence check (fixed-iteration runs).
    ``across_groups=True`` takes the largest entry of z, lambda and gamma
    over all region groups, for problems where a group of open contacts
    holds only rounding noise in lambda."""
    if converged is not None:
        assert bool(ref.converged) is converged
        assert st.converged is converged
    assert st.it == int(ref.it)
    pairs = [("u", st.u, ref.u)]
    for g, (gs, gr) in enumerate(zip(st.groups, ref.groups)):
        pairs += [(f"z[{g}]", gs.z, gr.z), (f"lam[{g}]", gs.lam, gr.lam),
                  (f"gamma[{g}]", gs.gamma, gr.gamma)]
    pairs = [(n, a.cpu().numpy(), np.asarray(b)) for n, a, b in pairs]
    scales = {}
    for name, _, b in pairs:
        key = name.split("[")[0] if across_groups else name
        scales[key] = max(scales.get(key, 0.0), float(np.abs(b).max()))
    for name, a, b in pairs:
        assert a.shape == b.shape, name
        scale = scales[name.split("[")[0] if across_groups else name]
        err = float(np.abs(a - b).max())
        assert err <= tol * scale, (name, err, scale)


def assert_same(a, b, path="model"):
    """Exact equality of two host objects of the two packages."""
    if sp.issparse(a):
        assert sp.issparse(b) and a.shape == b.shape, path
        a, b = a.tocsr(), b.tocsr()
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a.indptr, b.indptr, err_msg=path)
        np.testing.assert_array_equal(a.indices, b.indices, err_msg=path)
        np.testing.assert_array_equal(a.data, b.data, err_msg=path)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif callable(a):
        return
    elif hasattr(a, "__dict__") and type(a).__module__.startswith("ddpca"):
        assert type(a).__name__ == type(b).__name__, path
        assert_same(vars(a), vars(b), path)
    else:
        assert a == b or (a != a and b != b), path


def format_signature(prob) -> list:
    """(operator, format) of every operator of a problem's body and coarse
    hierarchies, by class name (the two packages name them alike)."""
    out = []

    def visit(op, label):
        name = type(op).__name__
        if name == "BatchBlocks":
            for g, sub in enumerate(op.ops):
                visit(sub, f"{label}[{g}]")
            return
        if name in ("StructuredProl", "StructuredRest"):
            visit(op.S if name == "StructuredProl" else op.St, label)
        out.append((label, name))

    hier = [("body", prob.mg)] + [(f"coarse {c}", co.mg)
                                  for c, co in enumerate(prob.coarse or ())
                                  if co.mg is not None]
    for tag, mg in hier:
        visit(mg.A_top, f"{tag} A_top")
        for lv_i, lv in enumerate(mg.levels):
            visit(lv.A, f"{tag} A level {lv_i}")
            if lv.P is not None:
                visit(lv.P, f"{tag} P level {lv_i}")
                visit(lv.Pt, f"{tag} Pt level {lv_i}")
        out.append((f"{tag} coarse inverse", mg.coarse_inv is not None))
    return out


def assert_models_same(port_meta, ref_meta, port_bodies, ref_bodies):
    """Constrained systems, region operators and bodies of two builds."""
    assert len(port_meta.systems) == len(ref_meta.systems)
    for b, (s_port, s_ref) in enumerate(zip(port_meta.systems,
                                            ref_meta.systems)):
        assert_same(s_port, s_ref, f"systems[{b}]")
    assert len(port_meta.regions) == len(ref_meta.regions)
    for r, (r_port, r_ref) in enumerate(zip(port_meta.regions,
                                            ref_meta.regions)):
        assert_same(r_port, r_ref, f"regions[{r}]")
    assert port_meta.group_modes == ref_meta.group_modes
    assert_same(port_meta.group_region_idx, ref_meta.group_region_idx,
                "group_region_idx")
    assert_bodies_same(port_bodies, ref_bodies)


def assert_bodies_same(port_bodies, ref_bodies):
    assert len(port_bodies) == len(ref_bodies)
    for b, (bp, br) in enumerate(zip(port_bodies, ref_bodies)):
        np.testing.assert_array_equal(bp.mesh.coords, br.mesh.coords)
        np.testing.assert_array_equal(bp.mesh.elem_corn, br.mesh.elem_corn)
        assert bp.cons_dofv == br.cons_dofv, f"bodies[{b}].cons_dofv"
        assert bp.exte_forc == br.exte_forc, f"bodies[{b}].exte_forc"
        assert bp.node_rota.keys() == br.node_rota.keys()
        for i in bp.node_rota:
            np.testing.assert_array_equal(bp.node_rota[i], br.node_rota[i])
