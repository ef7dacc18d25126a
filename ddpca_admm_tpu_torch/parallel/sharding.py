"""Split the ADMM body axis over ``torch.distributed`` ranks (the port of
the JAX package's ``parallel/sharding.py``).

The reference parallelizes the ADMM x-update with OpenMP over subdomains
(MCONTACT.h:2511-2538).  The JAX package shards the batched body axis B of
every solver array over a device mesh and lets GSPMD insert the
collectives.  Here each rank is a process with its own device, host thread
and stream, and owns ``B / world`` consecutive bodies: it runs their body
PCG (V-cycle and K1 included) on its own slice of every body-batched
operator.  The region groups and the coarse correction are replicated, as
in the JAX placement tables below: a contact region couples two bodies
that may live on different ranks, and the coarse problem couples all
bodies.  ``admm/loop.py::make_admm_step`` takes a :class:`Shard` and
all-gathers the body vectors where a replicated operator reads them, over
the axes of the rank layout (:func:`domain_mesh`, :func:`host_domain_mesh`).

Placement is by *field*, not by shape: every ``AdmmProblem`` / ``AdmmState``
field is named below as body-batched or replicated, and the hierarchy is
placed by operator type (``_slice_op``).

Ranks are started by :func:`solve_sharded`, forked from a fork server
(``forkserver``: a clean process that never initializes CUDA, as the
CUDA runtime requires).  It hands each rank its problem through files
(``torch.save`` of the rank's slice), joins them with a timeout of its own
and raises when a rank fails or the timeout passes.  The backend is NCCL when every rank has a card of its own, gloo
when ranks share a card (NCCL refuses two ranks on one device) and on the
CPU; the choice is printed and never changed after a failure.
"""

from __future__ import annotations

import atexit
import datetime
import multiprocessing
import os
import shutil
import tempfile
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException

from ..admm.loop import AdmmState, contact_analysis, init_state
from ..admm.multiscale import ComposedAccu, ComposedTranD
from ..admm.problem import AdmmProblem
from ..solvers.mg import (
    BatchBlocks,
    MgHierarchy,
    MgLevel,
    StructuredProl,
    StructuredRest,
)
from ..sparse.bell import RB as BELL_RB
from ..sparse.bell import BlockEll
from ..sparse.dia import Dia, PlaneDia
from ..sparse.ell import Ell
from ..utils.constants import ADMM_MAX_ITER
from ..utils.device import resolve_device, to_device

# AdmmProblem fields whose every tensor is batched over bodies (axis 0 = B).
# The hierarchy ("mg") is placed by operator type (_slice_op): PlaneDia
# class tables are shared, not body-batched.
_PROBLEM_DOMAIN_FIELDS = frozenset(
    {"cons_forc", "gram", "gram_lin", "gram_const", "u_mask"}
)
# AdmmProblem fields replicated on every rank (each materialized accu of
# ``coarse`` keeps only the rank's rows).
_PROBLEM_REPLICATED_FIELDS = frozenset({"groups", "coarse"})
# AdmmState: only u is body-batched; z/lambda/gamma lead with R (regions),
# monitors and scalars are global.
_STATE_DOMAIN_FIELDS = frozenset({"u"})
_STATE_REPLICATED_FIELDS = frozenset(
    {"groups", "it", "converged", "moni", "mult_frozen", "inner_iters",
     "coarse_x", "moni_hist"}
)

DOMAIN_AXES = ("domain",)
HOST_DOMAIN_AXES = ("host", "domain")


def domain_mesh(n_devices: int | None = None, device_type: str = "cuda"):
    """The 1-axis ``("domain",)`` rank layout over ranks 0..n-1.  Called
    inside a rank, after its process group is initialized."""
    from torch.distributed.device_mesh import DeviceMesh

    n = n_devices or dist.get_world_size()
    return DeviceMesh(device_type, torch.arange(n),
                      mesh_dim_names=DOMAIN_AXES)


def host_domain_mesh(n_hosts: int, n_per_host: int | None = None,
                     device_type: str = "cuda"):
    """The 2-axis ``("host", "domain")`` rank layout: the outer axis maps
    to hosts, the inner to cards within a host.  Bodies are split over both
    axes in row-major order (rank r owns the r-th block), as JAX's
    ``P(("host", "domain"))`` splits them, and a :class:`Shard` on it
    gathers within a host before it gathers across hosts.  Called inside a
    rank."""
    from torch.distributed.device_mesh import DeviceMesh

    n_per_host = n_per_host or dist.get_world_size() // n_hosts
    ranks = torch.arange(n_hosts * n_per_host).reshape(n_hosts, n_per_host)
    return DeviceMesh(device_type, ranks, mesh_dim_names=HOST_DOMAIN_AXES)


def _check_divisible(B: int, mesh_shape: tuple[int, ...],
                     axis_names: tuple[str, ...] = DOMAIN_AXES) -> None:
    n_dev = 1
    for s in mesh_shape:
        n_dev *= int(s)
    if B % n_dev != 0:
        raise ValueError(
            f"body count B={B} is not divisible by the {n_dev}-rank "
            f"{'x'.join(map(str, mesh_shape))} mesh {axis_names}: every "
            f"rank must own the same number of subdomains (SPMD).  Pad the "
            f"body list (add empty bodies) or use a mesh size dividing {B}."
        )


def _bounds(B: int, rank: int, world: int) -> tuple[int, int]:
    _check_divisible(B, (world,))
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    per = B // world
    return rank * per, (rank + 1) * per


class Shard:
    """One rank's share of the body axis: bodies [lo, hi) of ``n_bodies``
    on ``device``, and the collectives the ADMM step calls.

    With a ``mesh`` (:func:`domain_mesh`, :func:`host_domain_mesh`) the
    rank owns the block at its mesh coordinate flattened in row-major
    order, as JAX's ``P(("host", "domain"))`` splits the bodies, and every
    collective runs over the mesh's axes, innermost first: on a
    ``("host", "domain")`` mesh an all-gather within a host, then one
    across hosts.  Without a mesh it is the whole problem on one device and
    the collectives are the identity."""

    def __init__(self, n_bodies: int, device, mesh=None):
        self.rank = dist.get_rank() if mesh is not None else 0
        if mesh is None:
            block, world, self.groups = 0, 1, ()
        else:
            block = 0
            for c, size in zip(mesh.get_coordinate(), mesh.mesh.shape):
                block = block * int(size) + int(c)
            world = mesh.size()
            self.groups = tuple(mesh.get_group(name)
                                for name in reversed(mesh.mesh_dim_names))
        self.lo, self.hi = _bounds(n_bodies, block, world)
        self.block, self.world, self.n_bodies = block, world, n_bodies
        self.device = torch.device(device)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of every rank's ``x``, in block order (all-gathers:
        each sum stays in its single-device order)."""
        for group in self.groups:
            x = x.contiguous()
            parts = [torch.empty_like(x)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, x, group=group)
            x = torch.cat(parts, dim=0)
        return x

    def max_ints(self, values: list[int]) -> list[int]:
        """Elementwise maximum over ranks of small integers."""
        if not self.groups:
            return list(values)
        t = torch.tensor(values, dtype=torch.int64, device=self.device)
        for group in self.groups:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return [int(v) for v in t.tolist()]


def _rows(t: torch.Tensor, lo: int, hi: int, n: int) -> torch.Tensor:
    """Rows [lo, hi) of a tensor batched over n bodies, as a copy (a view
    would carry the whole storage into the rank's file)."""
    if t.ndim == 0 or t.shape[0] != n:
        raise ValueError(f"expected a leading body axis of {n}, got shape "
                         f"{tuple(t.shape)}")
    return t[lo:hi].clone()


def _slice_op(op, lo: int, hi: int, n: int):
    """Bodies [lo, hi) of a body-batched operator over n bodies.

    * Ell, BlockEll, Dia, tensors: slice the leading body axis.
    * PlaneDia: keep the shared class table ``vals`` whole and slice ``kz``;
      the operator is built again, since its constructor makes K1's plan
      from ``kz``.
    * StructuredProl / StructuredRest: slice the inner stencil.
    * BatchBlocks: a rank computes only its own bodies, so each group's
      bounds are intersected with [lo, hi), its operator sliced, the bounds
      rebased, and empty groups dropped (the JAX package replicates a
      several-group BatchBlocks and lets GSPMD keep the solve sharded).

    An operator whose whole range is kept comes back unchanged (a group of
    one body stores no body axis)."""
    if op is None:
        return None
    if lo == 0 and hi == n:
        return op
    if isinstance(op, BatchBlocks):
        ops, bounds = [], []
        for sub, (a, b) in zip(op.ops, op.bounds):
            a2, b2 = max(a, lo), min(b, hi)
            if a2 < b2:
                ops.append(_slice_op(sub, a2 - a, b2 - a, b - a))
                bounds.append((a2 - lo, b2 - lo))
        return BatchBlocks(tuple(ops), tuple(bounds))
    if isinstance(op, StructuredProl):
        return StructuredProl(_slice_op(op.S, lo, hi, n), op.fshape,
                              op.cshape, op.strides, op.n_c_pad)
    if isinstance(op, StructuredRest):
        return StructuredRest(_slice_op(op.St, lo, hi, n), op.fshape,
                              op.cshape, op.strides, op.n_c_pad)
    if isinstance(op, PlaneDia):
        return PlaneDia(op.vals, _rows(op.kz, lo, hi, n), op.offsets,
                        op.n_rows, op.plane, op.tail_identity)
    if isinstance(op, Dia):
        return Dia(_rows(op.vals, lo, hi, n), op.offsets, op.n_rows,
                   op.tail_identity)
    if isinstance(op, Ell):
        return Ell(_rows(op.vals, lo, hi, n), _rows(op.cols, lo, hi, n),
                   op.n_cols)
    if isinstance(op, BlockEll):
        return BlockEll(_rows(op.tiles, lo, hi, n),
                        _rows(op.cblk, lo, hi, n), op.n_cols)
    if isinstance(op, torch.Tensor):
        return _rows(op, lo, hi, n)
    raise TypeError(f"no body-axis placement for {type(op).__name__}")


def _slice_mg(mg: MgHierarchy, lo: int, hi: int, n: int) -> MgHierarchy:
    levels = tuple(
        MgLevel(
            A=_slice_op(lv.A, lo, hi, n),
            inv_diag=_rows(lv.inv_diag, lo, hi, n),
            lmax=_rows(lv.lmax, lo, hi, n),
            P=_slice_op(lv.P, lo, hi, n),
            Pt=_slice_op(lv.Pt, lo, hi, n),
        )
        for lv in mg.levels
    )
    return MgHierarchy(
        levels=levels,
        coarse_inv=(None if mg.coarse_inv is None
                    else _rows(mg.coarse_inv, lo, hi, n)),
        # A_top aliases the finest-level A when the dtypes match
        # (solvers/mg.py): keep the alias
        A_top=(levels[-1].A if mg.A_top is mg.levels[-1].A
               else _slice_op(mg.A_top, lo, hi, n)),
    )


def _slice_coarse(co, lo: int, hi: int, n_pad: int, n: int,
                  mg: MgHierarchy, local_mg: MgHierarchy):
    """A coarse correction, replicated, whose materialized accu keeps only
    the rows of bodies [lo, hi) of n; the composed operators keep their
    layouts (the loop takes the rank's rows) and run their chains and their
    float64 operator on the rank's bodies (``local_mg``'s A_top where the
    operator is ``mg``'s)."""
    if isinstance(co.accu, ComposedAccu):
        tranD, accu = co.tranD, co.accu
        if isinstance(tranD, ComposedTranD):
            tranD = ComposedTranD(
                tranD.reg, tranD.idx, tranD.mask, tranD.level,
                tuple(_slice_op(op, lo, hi, n) for op in tranD.chain),
                (local_mg.A_top if tranD.A is mg.A_top
                 else _slice_op(tranD.A, lo, hi, n)))
        accu = ComposedAccu(
            accu.idx, accu.mask, accu.level, accu.n_dole_pad, accu.n_bodies,
            tuple(_slice_op(op, lo, hi, n) for op in accu.chain))
        return co._replace(tranD=tranD, accu=accu)
    a = co.accu
    if isinstance(a, BlockEll):
        # row blocks of 8: n_pad is a multiple of 128
        r0, r1 = lo * n_pad // BELL_RB, hi * n_pad // BELL_RB
        return co._replace(accu=BlockEll(a.tiles[r0:r1].clone(),
                                         a.cblk[r0:r1].clone(), a.n_cols))
    return co._replace(accu=Ell(a.vals[lo * n_pad:hi * n_pad].clone(),
                                a.cols[lo * n_pad:hi * n_pad].clone(),
                                a.n_cols))


def shard_problem(prob: AdmmProblem, rank: int, world: int) -> AdmmProblem:
    """Rank ``rank``'s local problem: every field placed by the tables
    above, the hierarchy by operator type."""
    B, n_pad = prob.cons_forc.shape
    lo, hi = _bounds(B, rank, world)
    parts = {}
    for name in AdmmProblem._fields:
        sub = getattr(prob, name)
        if name == "mg":
            parts[name] = _slice_mg(sub, lo, hi, B)
        elif name in _PROBLEM_DOMAIN_FIELDS:
            parts[name] = _slice_op(sub, lo, hi, B)
        elif name == "coarse":
            parts[name] = (None if sub is None else
                           tuple(_slice_coarse(co, lo, hi, n_pad, B,
                                               prob.mg, parts["mg"])
                                 for co in sub))
        elif name in _PROBLEM_REPLICATED_FIELDS:
            parts[name] = sub
        else:  # pragma: no cover - a new field added without a placement
            raise KeyError(f"field {name!r} has no placement; add it to the "
                           "field tables in parallel/sharding.py")
    return AdmmProblem(**parts)


def shard_state(state: AdmmState, rank: int, world: int) -> AdmmState:
    """Rank ``rank``'s share of a full state: u sliced, the rest
    replicated."""
    B = state.u.shape[0]
    lo, hi = _bounds(B, rank, world)
    parts = {}
    for name in AdmmState._fields:
        sub = getattr(state, name)
        if name in _STATE_DOMAIN_FIELDS:
            parts[name] = _rows(sub, lo, hi, B)
        elif name in _STATE_REPLICATED_FIELDS:
            parts[name] = sub
        else:  # pragma: no cover - a new field added without a placement
            raise KeyError(f"field {name!r} has no placement; add it to the "
                           "field tables in parallel/sharding.py")
    return AdmmState(**parts)


def assert_state_sharding(state: AdmmState, shard: Shard) -> None:
    """The designed placement of the big loop-carried array: the rank's u
    holds its B / world bodies and lies on the rank's device."""
    rows = shard.hi - shard.lo
    if state.u.shape[0] != rows or state.u.device != shard.device:
        raise AssertionError(
            f"block {shard.block}: state.u has {state.u.shape[0]} rows on "
            f"{state.u.device}, expected {rows} on {shard.device}"
        )


# ------------------------------------------------------------- launcher

class ShardedRun(NamedTuple):
    state: AdmmState      # block 0's state, u gathered over ranks, on the CPU
    backend: str
    mesh_shape: tuple[int, ...]
    ranks: list[dict]     # per rank: device, bodies, setup_s, solve_s,
    # k1_launches, max_memory_allocated, hook, timeline
    prepare_s: float      # the parent's slicing and saving, host clock
    joined_s: float       # from the spawn until every rank has exited


def choose_backend(world: int, device) -> str:
    """NCCL when every rank has a card of its own; gloo when ranks share a
    card and on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(rank, workdir, *args):
    """One rank; a failure leaves its traceback in the work directory for
    the launcher's error message, and re-raises."""
    try:
        _rank_solve(rank, workdir, *args)
    except BaseException:
        with open(os.path.join(workdir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _rank_errors(workdir: str, world: int) -> str:
    parts = []
    for r in range(world):
        path = os.path.join(workdir, f"error{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                parts.append(f"-- rank {r}:\n{f.read()}")
    return "\n".join(parts) or "(no rank left a traceback)"


def _rank_solve(rank, workdir, world, mesh_shape, n_bodies, backend,
                device_type, modes, max_iter, rank_hook, timeout, spawn_t):
    """One rank: join the group, build its mesh and shard, load its slice,
    solve, write its result.  ``timeline``: seconds from the launcher's
    spawn (host clock) to each stage."""
    from ..sparse import plane_dia_kernel as K

    timeline = {"entered": time.time() - spawn_t}

    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout),
        # NCCL binds the rank to its card (gloo takes no device)
        device_id=device if backend == "nccl" else None,
    )
    try:
        if len(mesh_shape) == 1:
            mesh = domain_mesh(world, device_type)
        else:
            mesh = host_domain_mesh(*mesh_shape, device_type=device_type)
        shard = Shard(n_bodies, device, mesh)
        timeline["group_ready"] = time.time() - spawn_t
        t = time.perf_counter()
        data = torch.load(os.path.join(workdir, f"block{shard.block}.pt"),
                          weights_only=False)
        prob = to_device(data["prob"], device)
        state0 = to_device(data["state0"], device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t
        hook = None if rank_hook is None else rank_hook(prob, shard)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        K.LAUNCHES = 0
        timeline["loaded"] = time.time() - spawn_t
        dist.barrier()
        t = time.perf_counter()
        st = contact_analysis(prob, modes, max_iter=max_iter, device=device,
                              state0=state0, shard=shard)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        solve_s = time.perf_counter() - t
        launches = K.LAUNCHES
        timeline["solved"] = time.time() - spawn_t
        assert_state_sharding(st, shard)
        u_full = shard.gather(st.u)
        torch.save(dict(
            rank=rank, device=str(device),
            device_name=(torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
            mesh=list(mesh.mesh.shape), bodies=[shard.lo, shard.hi],
            setup_s=setup_s, solve_s=solve_s, k1_launches=launches,
            max_memory_allocated=(torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None),
            hook=hook, timeline=timeline,
        ), os.path.join(workdir, f"stats{rank}.pt"))
        if shard.block == 0:
            torch.save(to_device(st._replace(u=u_full), "cpu"),
                       os.path.join(workdir, "result.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


@atexit.register
def _stop_fork_server() -> None:
    """At exit, stop the ranks' fork server if this process started one,
    and wait for it, so that no process outlives the one that started it
    (the server would otherwise end on its own a moment after)."""
    from multiprocessing import forkserver

    server = getattr(forkserver, "_forkserver", None)
    if getattr(server, "_forkserver_pid", None) is not None:
        server._stop()


def solve_sharded(
    prob: AdmmProblem,
    modes: tuple[str, ...],
    world: int,
    mesh_shape: tuple[int, ...] | None = None,
    max_iter: int = ADMM_MAX_ITER,
    device="cuda",
    timeout: float = 600.0,
    rank_hook=None,
) -> ShardedRun:
    """Solve ``prob`` over ``world`` new ranks, bodies split over the
    ``mesh_shape`` layout (``(world,)``: :func:`domain_mesh`; ``(h, d)``:
    :func:`host_domain_mesh`), from the zero state.

    Rank r runs on ``cuda:{r % device_count}`` (``device="cuda"``, the
    default; raises without a card) or on the CPU.  The parent builds each
    rank's slice on the CPU and saves it to a temporary directory, which
    also holds the group's ``file://`` store; each rank loads its own.
    ``rank_hook(prob, shard)``, a picklable function, runs in every rank on
    its local problem before the solve (its K1 launches are not counted)
    and its return value comes back in ``ranks``.  Raises when a rank fails
    or when ``timeout`` seconds pass, after killing the ranks."""
    dev = resolve_device(device)
    mesh_shape = tuple(int(s) for s in (mesh_shape or (world,)))
    n_mesh = 1
    for s in mesh_shape:
        n_mesh *= s
    if n_mesh != world or len(mesh_shape) not in (1, 2):
        raise ValueError(f"mesh shape {mesh_shape} does not lay out "
                         f"{world} ranks on 1 or 2 axes")
    B = prob.cons_forc.shape[0]
    axes = DOMAIN_AXES if len(mesh_shape) == 1 else HOST_DOMAIN_AXES
    _check_divisible(B, mesh_shape, axes)
    backend = choose_backend(world, dev)
    if dev.type == "cuda":
        from ..utils import cuda_lib

        cuda_lib.load()      # build once here; the ranks load the library
        n_cards = torch.cuda.device_count()
        devices = sorted({f"cuda:{r % n_cards}" for r in range(world)})
    else:
        devices = ["cpu"]
    print(f"sharding: world={world} mesh={'x'.join(map(str, mesh_shape))} "
          f"backend={backend} devices={','.join(devices)}", flush=True)

    t_start = time.time()
    prob_cpu = to_device(prob, "cpu")
    state_cpu = init_state(prob_cpu)
    workdir = tempfile.mkdtemp(prefix="ddpca_shard_")
    ctx = None
    try:
        for b in range(world):
            torch.save(dict(prob=shard_problem(prob_cpu, b, world),
                            state0=shard_state(state_cpu, b, world)),
                       os.path.join(workdir, f"block{b}.pt"))
        del prob_cpu, state_cpu
        spawn_t = time.time()
        prepare_s = spawn_t - t_start
        # the ranks fork from a server process that has imported torch and
        # this package once (and never touches CUDA), so a later spawn of
        # ranks in this process skips the imports; the server is stopped
        # when this process exits
        multiprocessing.set_forkserver_preload(["__main__", __name__])
        ctx = torch.multiprocessing.start_processes(
            _rank_main,
            args=(workdir, world, mesh_shape, B, backend, dev.type,
                  tuple(modes), max_iter, rank_hook, timeout, spawn_t),
            nprocs=world, join=False, start_method="forkserver",
        )
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"solve_sharded: {world} ranks passed the timeout "
                        f"of {timeout} s; killed"
                    )
        except ProcessException as exc:
            raise RuntimeError(
                f"solve_sharded: rank {exc.error_index} failed; every "
                f"rank's traceback:\n{_rank_errors(workdir, world)}"
            ) from exc
        joined_s = time.time() - spawn_t
        ranks = [torch.load(os.path.join(workdir, f"stats{r}.pt"),
                            weights_only=False) for r in range(world)]
        state = torch.load(os.path.join(workdir, "result.pt"),
                           weights_only=False)
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        shutil.rmtree(workdir, ignore_errors=True)
    return ShardedRun(state=state, backend=backend, mesh_shape=mesh_shape,
                      ranks=ranks, prepare_s=prepare_s, joined_s=joined_s)
