"""Run a function on every rank of a fresh process group (port-only: the
launchers' and the tests' multi-process entry).

``spawn_ranks(fn, world, store_dir, args, backend=...)`` starts ``world``
processes from the ``spawn`` context, joins them into one group through a
``FileStore`` in ``store_dir`` (no TCP port) with a timeout on every
collective, runs ``fn(rank, world, *args)`` in each (``fn`` importable by
name: a module-level function) and returns the ranks' results in rank
order. A rank that raises fails the call with its traceback; if the ranks
have not all answered by the deadline, every live rank is killed and the
call raises. Every process is joined before it returns.
"""
from __future__ import annotations

import os
import queue
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

__all__ = ["DEADLINE_S", "spawn_ranks"]

DEADLINE_S = 1800.0


def _entry(fn, rank, world, store_path, backend, timeout_s, threads, args, out):
    try:
        import torch

        if threads:
            torch.set_num_threads(threads)
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        from .meshes import init_process

        init_process(rank, world, store_path, backend, timeout_s=timeout_s)
        out.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # every failure goes to the parent, which raises it
        out.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable[..., Any], world: int, store_dir: str, args: Sequence = (), *,
                backend: str = "gloo", timeout_s: float = 120.0,
                deadline_s: float = DEADLINE_S, threads: Optional[int] = None) -> List[Any]:
    """``[fn(rank, world, *args) for each rank]``, each in its own process
    (see the module docstring). ``timeout_s`` bounds a collective's wait,
    ``deadline_s`` the whole run; ``threads`` sets each rank's torch
    threads. Under NCCL rank r takes card r mod the card count."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(store_dir, f"store-{os.getpid()}-{time.monotonic_ns()}")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, store, backend, timeout_s, threads,
                                              tuple(args), out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    end = time.monotonic() + deadline_s
    try:
        while len(results) + len(errors) < world:
            try:
                rank, ok, value = out.get(timeout=max(0.1, end - time.monotonic()))
            except queue.Empty:
                missing = sorted(set(range(world)) - set(results))
                raise TimeoutError(f"ranks {missing} gave no result within {deadline_s} s; "
                                   f"killed") from None
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=max(0.1, end - time.monotonic()) if not errors else 30.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=30.0)
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with codes {[p.exitcode for p in procs]}")
    return [results[r] for r in range(world)]
