"""Start a group of ranks on this machine, for the tests and the smoke run.

:func:`run_ranks` spawns ``world`` processes that rendezvous through a
``file://`` store in a directory of the caller's (no port to collide
with other groups), exports torch's launcher variables to each, and joins
them with a deadline: a hung rank fails the call instead of blocking it.
Each rank calls ``fn(init_method, *args)``, which calls
``distributed.initialize(init_method, ...)`` itself with the backend it
wants; what ``fn`` returns comes back through a file per rank. Across
machines, start one process per rank with ``torchrun`` and call
``distributed.initialize()`` instead.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank: int, fn, world: int, local_world: int, init_method: str,
           args: tuple, out_dir: str, threads: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank % local_world),
                      LOCAL_WORLD_SIZE=str(local_world))
    torch.set_num_threads(threads)
    try:
        result = fn(init_method, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, args: tuple = (), *, work_dir: str,
              timeout: float, local_world: int | None = None,
              threads: int = 1) -> list:
    """Run ``fn(init_method, *args)`` in ``world`` spawned ranks; returns
    their results in rank order. ``fn`` must be importable by name (a
    module-level function); ``work_dir`` must be empty and private to this
    group. ``local_world`` is the ranks per node the ranks are told
    (default all). Raises when a rank fails or the group outlasts
    ``timeout`` seconds (the ranks are then killed)."""
    init = "file://" + os.path.join(work_dir, "store")
    ctx = mp.start_processes(
        _entry, args=(fn, world, local_world or world, init, args, work_dir,
                      threads),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    return [torch.load(os.path.join(work_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
