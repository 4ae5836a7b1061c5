"""Start the ranks of one job as processes on one host.

    results = run_ranks(fn, world, *args, workdir=DIR)

The port's counterpart of the reference's
``--xla_force_host_platform_device_count``: where the reference makes N
placeholder devices in one process, the port runs N processes, each one
rank of a ``torch.distributed`` group.  Each is started with ``spawn``,
joins a ``gloo`` group through a ``FileStore`` under ``workdir`` (on a
machine with one card the ranks share it, and the mesh's collectives
stage CUDA tensors through host memory, ``launch.mesh``), runs torch on
its share of the caller's threads (``torch.get_num_threads() // world``),
runs
``fn(rank, world, *args)`` and saves its return value with
``torch.save``; the caller gets the values rank by rank.  ``fn`` must be
importable by the child (a module's top-level function).  The ranks
are joined within ``join_s`` seconds together; a rank still running then
is killed, as are the others, and a rank that raised or was killed makes
the call raise with its traceback.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import time
import traceback

__all__ = ["run_ranks", "GROUP_TIMEOUT_S"]

GROUP_TIMEOUT_S = 120


def run_ranks(fn, world: int, *args, workdir: str, join_s: float = 600.0) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks of one process
    group; returns each rank's result in rank order."""
    import torch

    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, f"store-{os.getpid()}-{time.monotonic_ns()}")
    threads = max(1, torch.get_num_threads() // world)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(fn, r, world, store, workdir, threads, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + join_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)
    if os.path.exists(store):
        os.remove(store)
    out, errors = [], []
    for r, p in enumerate(procs):
        path = os.path.join(workdir, f"rank-{r}.pt")
        err = os.path.join(workdir, f"rank-{r}.err")
        if p.exitcode != 0 or not os.path.exists(path):
            why = open(err).read() if os.path.exists(err) else ""
            errors.append(f"rank {r} exited with {p.exitcode}\n{why}")
            continue
        out.append(torch.load(path, weights_only=False))
        os.remove(path)
    if late:
        raise TimeoutError(f"ranks {late} of {world} did not finish within {join_s} s\n"
                           + "\n".join(errors))
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def _child(fn, rank: int, world: int, store: str, workdir: str, threads: int,
           args: tuple) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(workdir, f"rank-{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"rank-{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
