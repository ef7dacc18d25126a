"""Process and thread pools for the host build.

The host setup of a large model (meshes, contact search, element stiffness,
constraints, the hierarchy's tables) is numpy/scipy work that splits into
independent tasks, one per body or per region.  ``HostPool.map`` runs them
in spawned worker processes, or in this process with one worker;
``thread_imap`` runs tasks whose time goes to numpy and scipy loops that
release the interpreter lock (sparse products, sorts, counts) in threads of
this process, on data too large to send to a worker.  Every task is a pure
function of its arguments, so the results are the same bits whatever the
worker count; a task that fails or a worker that dies makes the call
raise.

``host_workers`` and ``thread_imap`` size themselves from the process's
allowance of cores, ``host_threads()``: the environment value ``DDPCA_HOST_THREADS`` where it
is set, else the cores this process may run on.  ``HostPool``'s workers
run with an allowance of 1, so a task's own ``thread_imap`` runs inline; a
caller that runs other processes beside the build lowers its allowance.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

# the allowance of cores of this process's host build (unset: all of them)
THREADS_ENV = "DDPCA_HOST_THREADS"
# one BLAS/OpenMP thread and an allowance of one per worker: the pool
# already fills the cores
_WORKER_ENV = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
               "MKL_NUM_THREADS": "1", THREADS_ENV: "1"}


def host_threads() -> int:
    """The cores this process's host build may use: ``DDPCA_HOST_THREADS``
    where it is set, else the cores this process may run on."""
    value = os.environ.get(THREADS_ENV)
    if value:
        return max(1, int(value))
    return len(os.sched_getaffinity(0))


def mem_available() -> int:
    """``MemAvailable`` of /proc/meminfo in bytes (0 where it is absent)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def host_workers(task_bytes: int, n_tasks: int, parent_bytes: int) -> int:
    """Workers for ``n_tasks`` tasks of about ``task_bytes`` peak memory
    each: ``host_threads()``, capped by the task count and by what the
    machine's available memory holds once this process has grown by
    ``parent_bytes`` (what it gathers of the tasks' results)."""
    cores = host_threads()
    avail = mem_available()
    by_mem = ((avail - int(parent_bytes)) // max(int(task_bytes), 1)
              if avail else cores)
    return max(1, min(cores, int(by_mem), int(n_tasks)))


@contextlib.contextmanager
def _env(values: dict):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class HostPool:
    """``with HostPool(workers) as pool: pool.map(fn, [args, ...])`` —
    ``fn(*args)`` for each tuple, results in order.  ``fn`` must be a
    module-level function (it is pickled by name into spawned workers)."""

    def __init__(self, workers: int):
        self.workers = max(1, int(workers))
        self._ex = None

    def __enter__(self) -> "HostPool":
        if self.workers > 1:
            self._ex = ProcessPoolExecutor(
                self.workers, mp_context=multiprocessing.get_context("spawn"))
        return self

    def __exit__(self, *exc) -> None:
        if self._ex is not None:
            self._ex.shutdown(wait=True, cancel_futures=True)
            self._ex = None

    def map(self, fn, arg_tuples) -> list:
        """``fn(*args)`` for each tuple, results in order; with one worker,
        here and now."""
        if self._ex is None:
            return [fn(*a) for a in arg_tuples]
        # workers start at a submit, with the environment of that moment
        with _env(_WORKER_ENV):
            futures = [self._ex.submit(fn, *a) for a in arg_tuples]
        return [f.result() for f in futures]


def thread_imap(fn, items):
    """``fn(x)`` for each of ``items``, yielded in order, computed by
    ``host_threads()`` threads with at most that many results ahead of the
    consumer."""
    items = list(items)
    workers = host_threads()
    if workers <= 1 or len(items) <= 1:
        for x in items:
            yield fn(x)
        return
    with ThreadPoolExecutor(workers) as ex:
        rest = iter(items)
        ahead = collections.deque(
            ex.submit(fn, x) for x in itertools.islice(rest, workers))
        while ahead:
            y = ahead.popleft().result()
            for x in itertools.islice(rest, 1):
                ahead.append(ex.submit(fn, x))
            yield y
