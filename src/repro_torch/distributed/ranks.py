"""Run a function on several ranks of a fresh process group, one process
a rank: the launcher of the port's multi-process smokes and tests (the
reference runs one process over many jax devices instead).

`run_ranks(fn, world)` spawns ``world`` processes (``spawn``, never
``fork``); each joins a ``backend`` group that rendezvouses through a
``file://`` store in a new temporary directory (no port is bound), calls
``fn(rank, world, *args)`` and pickles its result.  Results come back in
rank order.  A rank that raises, exits otherwise than 0, or is still
running ``timeout`` seconds after the start fails the call, and every
rank still alive is killed: a hung rank never holds the caller.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable, List

RANK_TIMEOUT_S = 300


def _entry(rank: int, world: int, backend: str, root: str, fn: Callable,
           args: tuple, timeout: float) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(root, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn: Callable, world: int, *, backend: str = "gloo",
              args: tuple = (), timeout: float = RANK_TIMEOUT_S) -> List[Any]:
    """``[fn(r, world, *args) for r in range(world)]``, each on its own
    process and rank.  ``fn`` must be a module-level function (it is
    pickled by name)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as root:
        procs = [ctx.Process(target=_entry, args=(r, world, backend, root,
                                                  fn, args, timeout))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for r, p in enumerate(procs):
                p.join(max(0.0, deadline - time.monotonic()))
                if p.is_alive():
                    raise TimeoutError(f"rank {r} of {world} still running "
                                       f"after {timeout} s")
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {r} of {world} exited with "
                                       f"{p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(world):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
