"""Run one function on W spawned ranks of a fresh process group, with a
deadline (no counterpart in the reference, whose mesh is one process).

    results = run_ranks(fn, 4, args=(...), backend="gloo", timeout=120)

Rank r calls ``torch.distributed.init_process_group(backend, init_method,
world_size=W, rank=r)`` and then ``fn(r, *args)``; what fn returns comes
back to the caller, a list indexed by rank (tensors should be on the CPU:
the results travel through `torch.save` files). The group rendezvouses
through a file, so parallel runs never contend for a port. A rank that
raises fails the call with its traceback; ranks still running when the
deadline passes are killed and the call raises TimeoutError, so a hung
collective cannot outlive its caller's budget.

On the card, load the kernels' libraries (`kernels/build.py::load`) in
the caller before spawning: the ranks then find them built and never
race one another into nvcc.
"""
from __future__ import annotations

import os
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, args: Sequence[Any], world: int,
               backend: str, init_file: str, out_dir: str) -> None:
    # ranks share the host's cores: one intra-op thread each
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        result = fn(rank, *args)
        tmp = Path(out_dir) / f"rank{rank}.pt.tmp"
        torch.save(result, tmp)
        os.replace(tmp, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence[Any] = (), *,
              backend: str = "gloo", timeout: float = 300.0,
              workdir: Optional[str] = None) -> List[Any]:
    """fn(rank, *args) on `world` spawned ranks → their results by rank.
    ``workdir``: where the rendezvous file and the results go (a fresh
    temporary directory by default)."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        init_file = str(Path(tmp) / "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(fn, tuple(args), world, backend, init_file,
                              tmp),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, min(
                    1.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(5.0)
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
