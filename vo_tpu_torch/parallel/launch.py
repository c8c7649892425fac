"""Run a function in N processes, one rank each, with a deadline.

`spawn(fn, world, args, device=...)` starts `world` processes through
`torch.multiprocessing.start_processes` ("spawn" start method), each of
which joins one process group (`mesh.init_process_group`, rendezvous
through a file in a temporary directory, so concurrent jobs never collide
on a port), calls ``fn(rank, world, *args)`` and hands its result back
through a file. When any rank fails, torch's process context stops the
others and raises; past the deadline `spawn` kills them and raises, so a
rank that dies in a collective cannot leave its peers hanging.

`fn` travels by its module and qualified name, so it must be importable
from the parent's `sys.path`: the rank makes jax unimportable before it
imports `fn`'s module. As with any "spawn" start method, each rank first
imports the parent's main module, so a script that calls `spawn` keeps
its work under ``if __name__ == "__main__":``. On the CPU each rank runs
one PyTorch thread at the lowest priority (nice 19).
"""

from __future__ import annotations

import importlib
import os
import pickle
import sys
import tempfile
import time

DEADLINE_S = 300.0


def spawn(fn, world: int, args: tuple = (), device="cuda",
          timeout_s: float = DEADLINE_S) -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each in its
    own process and process group rank, on `device` (``cuda``: NCCL, one
    rank per card, raising without a card; ``cpu``: gloo). Raises torch's
    ProcessException when a rank fails and TimeoutError past
    `timeout_s`."""
    import torch.multiprocessing as mp

    from .. import resolve_device

    device = resolve_device(device).type

    module = fn.__module__
    if module == "__main__":  # a module run with -m has its import name
        spec = getattr(sys.modules["__main__"], "__spec__", None)
        module = spec.name if spec is not None else module
    name = f"{module}:{fn.__qualname__}"
    if module == "__main__" or "<locals>" in name:
        raise ValueError(f"spawn: {name} cannot be imported by the ranks")
    with tempfile.TemporaryDirectory(prefix="vo_spawn_") as tmp:
        ctx = mp.start_processes(
            _rank_main, (name, world, args, device, tmp), nprocs=world,
            join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"spawn: {world} ranks still running "
                                       f"after {timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"out{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _rank_main(rank: int, name: str, world: int, args: tuple, device: str,
               tmp: str) -> None:
    sys.modules["jax"] = None  # a rank never imports jax: make it fail
    import torch
    import torch.distributed as dist

    from .mesh import init_process_group

    if device == "cpu":
        torch.set_num_threads(1)
        os.nice(19)
    module, qualname = name.split(":")
    fn = importlib.import_module(module)
    for part in qualname.split("."):
        fn = getattr(fn, part)
    init_process_group(rank, world, f"file://{tmp}/store", device)
    result = fn(rank, world, *args)
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    # no rank tears its group down while a peer may still talk to it
    dist.barrier()
    dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    # the result is on disk and the group is gone: skip the interpreter's
    # finalization, where a gloo thread's destructor has aborted a rank
    # (SIGABRT, "terminate called without an active exception") in a
    # loaded test run
    os._exit(0)
