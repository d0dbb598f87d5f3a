"""Start a ``torch.distributed`` world of processes on this host.

:func:`spawn_world` runs ``target(rank, world_size, *args)`` in
``world_size`` fresh processes (``spawn``), each first joined to one gloo
process group through a ``FileStore`` in a new temporary directory, so
worlds started side by side never share a port or a store. Every result
comes back to the caller (pickled: return numpy arrays and plain Python
values, not tensors). A rank that raises, exits or hangs fails the whole
world: the caller waits at most ``timeout`` seconds, then every process
still running is killed and :class:`WorldError` names the ranks at fault.

``target`` must be importable by name (a module-level function).

:func:`process_world` is a launcher's own world: the one ``torchrun``
gives it, or a world of one rank.
"""
from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List

#: What each CPU rank may use of the host's threads (several ranks share
#: the host's cores).
RANK_THREADS = 1


class WorldError(RuntimeError):
    pass


def _rank_main(target, rank: int, world: int, store_path: str, args: tuple,
               results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(RANK_THREADS)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path,
                                                             world),
                                rank=rank, world_size=world)
        try:
            out = target(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn_world(target: Callable[..., Any], world_size: int, *args,
                timeout: float = 120.0) -> List[Any]:
    """``[target(r, world_size, *args) for r in range(world_size)]``, each
    in its own process of one gloo world. Raises
    :class:`WorldError` if a rank fails or the world outlives
    ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="spkadd_world_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(target, r, world_size, store, args,
                                   results), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        got, errors = {}, {}
        try:
            while len(got) + len(errors) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        # a rank died without reporting: wait no longer
                        # than it takes the others to report their errors
                        deadline = min(deadline, time.monotonic() + 5.0)
                    continue
                (got if ok else errors)[rank] = out
                if not ok:
                    # the other ranks may wait on it in a collective
                    deadline = min(deadline, time.monotonic() + 5.0)
        finally:
            for p in procs:
                p.join(timeout=max(0.0, min(5.0, deadline
                                            - time.monotonic())))
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
    missing = [r for r in range(world_size) if r not in got]
    if missing:
        detail = "".join(f"\n--- rank {r} ---\n{tb}"
                         for r, tb in sorted(errors.items()))
        silent = [r for r in missing if r not in errors]
        raise WorldError(
            f"world of {world_size} ({getattr(target, '__name__', target)}):"
            f" ranks {missing} failed"
            + (f"; ranks {silent} did not report within {timeout:.0f} s"
               if silent else "") + detail)
    return [got[r] for r in range(world_size)]


@contextlib.contextmanager
def process_world(device: str):
    """The ``torch.distributed`` world a launcher runs in: under
    ``torchrun`` (``RANK`` and ``WORLD_SIZE`` in the environment) the one
    it is given, joined through ``env://``; otherwise a world of size 1
    over an in-process ``HashStore``. NCCL when ``device`` is ``"cuda"``
    (each rank on the card of its ``LOCAL_RANK``), gloo on the CPU. Yields
    ``(rank, world_size, torch.device)``; the group is destroyed at exit."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.sparse import resolve_device

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield dist.get_rank(), dist.get_world_size(), dev
    finally:
        dist.destroy_process_group()
