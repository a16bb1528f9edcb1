"""Start the ranks of a sharded deployment on one host, one process each.

    results = run_ranks(fn, 4, backend="gloo", workdir=tmp, args=(...))

runs ``fn(rank, world_size, *args)`` in ``world_size`` processes started
with the ``spawn`` method, each after it has joined the default process
group (``backend``, rendezvous through a ``FileStore`` under
``workdir``, so concurrent launches with different ``workdir``s never
collide), and returns their return values in rank order. ``fn`` must be
importable by name (a module-level function) and its arguments and result
picklable. A rank that raises, dies or outlives ``timeout`` makes the call
raise ``RuntimeError`` with the rank's traceback; every process is gone
when the call returns.

Across hosts, or under ``torchrun``, the ranks join the group from the
environment instead (``init_process_group(backend)`` reads
``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``) and need none of this.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as _queue
import time
import traceback


def _rank_entry(fn, rank: int, world_size: int, backend: str,
                store_path: str, args: tuple, results) -> None:
    import torch.distributed as dist

    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size),
            rank=rank, world_size=world_size)
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # the parent raises it; the rank exits with it
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world_size: int, *, backend: str, workdir: str,
              args: tuple = (), timeout: float = 600.0) -> list:
    """``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks of
    a ``backend`` process group; their results in rank order (the module
    docstring)."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, f"store-{os.getpid()}-{time.time_ns()}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world_size, backend, store, args,
                               results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < world_size:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if not dead:
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"ranks {sorted(set(range(world_size)) - set(got))}"
                            f" did not finish within {timeout} s") from None
                    continue
                try:  # a dead rank's report, if it sent one, is queued
                    rank, ok, out = results.get(timeout=5.0)
                except _queue.Empty:
                    raise RuntimeError(
                        f"rank(s) {dead} exited with codes "
                        f"{[procs[r].exitcode for r in dead]}") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world_size)]
