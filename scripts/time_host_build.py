#!/usr/bin/env python3
"""Time the port's BLOCK menu-1 host build, phase by phase.

    python3 scripts/time_host_build.py [--glob-leve 3] [--workers N]

Builds ``BlockConfig(divi=(6,6,6), glob_leve=L, doma_numb=(2,2,2))`` with
``build_block_model`` and ``build_problem(dole=[1]*30, musc_sett=2)`` (the
problem of ``chip_smoke.py``'s ``slice`` and ``full`` phases) and prints one
JSON line: the seconds of each phase the build records
(``BlockModel.phases`` and ``utils/timing.PHASES``), the whole build's
seconds, the build pool's worker count, the DOF count, the peak resident
memory of this process through ``build_block_model`` and through the
whole build, that of its largest worker, and the machine's ``MemTotal``.
The problem is built on the CPU.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def mem_total() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    return -1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--glob-leve", type=int, default=3)
    ap.add_argument("--workers", type=int, default=None,
                    help="build pool size (default: from the cores and "
                         "the available memory)")
    args = ap.parse_args()

    from ddpca_admm_tpu_torch.admm.problem import build_problem
    from ddpca_admm_tpu_torch.models.block import BlockConfig, build_block_model
    from ddpca_admm_tpu_torch.utils import timing

    timing.reset()
    t = time.perf_counter()
    cfg = BlockConfig(divi=(6, 6, 6), glob_leve=args.glob_leve,
                      doma_numb=(2, 2, 2))
    kw = {} if args.workers is None else dict(workers=args.workers)
    model = build_block_model(cfg, **kw)
    # a tree from before the build pool builds in one process
    workers = getattr(model, "workers", 1)
    t_model = time.perf_counter() - t
    own_model = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    prob, meta = build_problem(model.systems, model.regions,
                               dole=[1] * len(model.systems), musc_sett=2,
                               device="cpu")
    total = time.perf_counter() - t
    own = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    kids = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss * 1024
    print(json.dumps(dict(
        glob_leve=args.glob_leve, workers=workers,
        dof=int(sum(s.n_dof for s in meta.systems)),
        bodies=len(meta.systems), n_pad=meta.n_pad,
        build_block_model_s=t_model, setup_s=total,
        phases=[[tag, dt] for tag, dt in
                getattr(model, "phases", []) + timing.reset()],
        peak_rss_model=own_model, peak_rss=own, peak_rss_worker=kids,
        mem_total=mem_total(),
        cpus=len(os.sched_getaffinity(0)),
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
