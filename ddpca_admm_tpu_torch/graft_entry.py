"""Entry points of the port: one ADMM step on the flagship contact model,
and the multi-rank dry run (the port's counterpart of the JAX package's
``__graft_entry__.py``)."""

from __future__ import annotations

import time
from functools import partial


def entry(device="cuda"):
    """(fn, example_args): one ADMM iteration ``fn(prob, state)`` on the
    flagship contact model (the two-body stacked-box patch test, the
    minimal BLOCK), on ``device`` (default the card)."""
    from .admm.loop import admm_step, init_state
    from .models.simple import stacked_boxes_problem

    prob, meta, _ = stacked_boxes_problem(div_bot=3, div_top=2, levels=0,
                                          device=device)
    state = init_state(prob)
    step = partial(admm_step, modes=tuple(meta.group_modes))
    return step, (prob, state)


# the dry run's two problem configurations (__graft_entry__.py:52-55)
DRYRUN_CONFIGS = (
    dict(div=2, levels=0),
    dict(div=2, levels=1, fric_mid=0.2, structured=True),
)


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 600.0):
    """Split a chain of ``n_devices`` bodies over ``n_devices`` ranks (one
    body each), run the full ``contact_analysis`` to convergence, and require
    the sharded solution to match a single-device solve: converged, the same
    ADMM iteration count, and u within 1e-9 of max|u|.  A mismatch raises.

    Two configurations, each over ``domain_mesh(n)`` and, when n is even and
    at least 4, over ``host_domain_mesh(2, n // 2)``:

      1. the frictionless chain (levels=0);
      2. two multigrid levels with structured transfers, a Coulomb friction
         region under a tangential load (the cone projection active), and
         the structured PlaneDia/Dia hierarchy forced (Block-ELL budget 0)
         with its heterogeneous body-shape groups.

    Returns one dict per sharded run (its configuration, mesh, backend,
    iteration counts, error and the ranks' figures)."""
    import numpy as np

    from .admm.loop import contact_analysis
    from .models.simple import chain_problem
    from .parallel.sharding import solve_sharded
    from .solvers.mg import BatchBlocks
    from .sparse import bell

    rows = []
    for ci, cfg in enumerate(DRYRUN_CONFIGS):
        force_dia = bool(cfg.get("structured"))
        saved_budget = bell.BELL_MAX_BYTES
        if force_dia:
            bell.BELL_MAX_BYTES = 0
        try:
            prob, meta, _ = chain_problem(n_bodies=n_devices, device=device,
                                          **cfg)
        finally:
            bell.BELL_MAX_BYTES = saved_budget
        if force_dia and not isinstance(prob.mg.levels[-1].A, BatchBlocks):
            raise AssertionError(
                "structured config did not produce the DIA/PlaneDia hierarchy"
            )
        modes = tuple(meta.group_modes)

        t = time.perf_counter()
        ref = contact_analysis(prob, modes, max_iter=600, device=device)
        u_ref = ref.u.cpu().numpy()
        solve_s_single = time.perf_counter() - t
        if not ref.converged:
            raise AssertionError(
                f"config {ci}: single-device reference did not converge")
        scale = float(np.abs(u_ref).max()) or 1.0

        shapes = [(n_devices,)]
        if n_devices % 2 == 0 and n_devices >= 4:
            shapes.append((2, n_devices // 2))
        for shape in shapes:
            run = solve_sharded(prob, modes, n_devices, mesh_shape=shape,
                                max_iter=600, device=device, timeout=timeout)
            st = run.state
            name = "x".join(map(str, shape))
            if not st.converged:
                raise AssertionError(
                    f"config {ci} {name}: sharded solve did not converge")
            if st.it != ref.it:
                raise AssertionError(
                    f"config {ci} {name}: iteration mismatch: sharded "
                    f"{st.it} vs single {ref.it}")
            err = float(np.abs(st.u.numpy() - u_ref).max()) / scale
            if not err < 1e-9:
                raise AssertionError(
                    f"config {ci} {name} sharded/unsharded solution "
                    f"mismatch: rel {err:.3e}")
            rows.append(dict(config=ci, mesh=list(shape),
                             backend=run.backend, it=st.it,
                             inner_iters=st.inner_iters,
                             inner_iters_single=ref.inner_iters,
                             solve_s_single=solve_s_single,
                             max_rel_du=err, prepare_s=run.prepare_s,
                             joined_s=run.joined_s, ranks=run.ranks))
    return rows
