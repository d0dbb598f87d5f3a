"""Crash-atomic checkpoints of parameter trees, in the reference's layout.

The port of ``src/repro/checkpoint/checkpoint.py``. Layout:
``<dir>/step_XXXXXXXX/{manifest.json, leaf_00000.npy, ..., .complete}``,
written into ``step_XXXXXXXX.tmp`` and ``os.replace``d into place as the
last act, so a crash mid-write leaves only a ``.tmp`` dir that
:func:`latest_step` ignores. Leaves are numbered in JAX's leaf order
(:mod:`repro_torch.tree`), so a checkpoint written by either package
restores in the other.

The manifest's ``treedef`` field holds the writer's description of the
tree: JAX's ``PyTreeDef`` string from the reference, the port's
:func:`repro_torch.tree.describe` here. Restore never reads it; the
structure comes from the ``like`` tree.

Leaves are written as *global* arrays, so a checkpoint taken on one mesh
restores onto any other (elastic restore). A tree of DTensors
(``repro_torch.sharding``) is saved by every rank of its world together,
leaf by leaf: each rank takes part in the leaf's gather, rank 0 alone
copies it to the host and writes it, and the others wait at a barrier.
:func:`restore_checkpoint` places each leaf on the given shardings, each
rank reading only its own slice of the file, so a smaller or larger mesh,
or plain tensors, pick up where the saving mesh stopped.

``AsyncCheckpointer`` overlaps the host write with training (one
background thread, latest-wins queue of depth 1; the gathers run on the
calling thread, never on the writer's); ``save_on_signal`` installs a
SIGTERM hook for preemption checkpoints (a sharded tree's is skipped:
see :func:`preemption_save`).
"""
from __future__ import annotations

import json
import logging
import os
import queue
import shutil
import signal
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import tree as _tree
from repro_torch.sharding.params import from_global, sharding_of

log = logging.getLogger("repro_torch.checkpoint")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _host_leaves(leaves, keep: bool):
    """Each leaf's global value on the host, one leaf at a time: a
    DTensor's is gathered (every rank of its mesh must run this to its
    end) and copied to the host only where ``keep`` (else ``None``), then
    dropped before the next leaf's gather."""
    for leaf in leaves:
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        yield _to_numpy(leaf) if keep else None


def _is_sharded(tree) -> bool:
    return any(isinstance(x, DTensor) for x in _tree.leaves(tree))


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Crash-atomic save: everything is written into ``step_XXXXXXXX.tmp``
    and ``os.replace``d into place as the last act. A crash mid-write
    leaves only a ``.tmp`` dir (invisible to :func:`latest_step`, replaced
    wholesale by the next attempt). A tree with DTensor leaves is a
    collective call, leaf by leaf: every rank takes part in the leaf's
    gather, rank 0 alone copies it to the host and writes it, and the rest
    wait for the whole at a barrier."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    leaves, treedef = _tree.flatten(tree)
    if not _is_sharded(tree):
        return _write(final, step, treedef, map(_to_numpy, leaves))
    writer = dist.get_rank() == 0
    arrays = _host_leaves(leaves, keep=writer)
    try:
        if writer:
            _write(final, step, treedef, arrays)
    finally:
        for _ in arrays:  # the gathers a failed write left, or all of them
            pass
        dist.barrier()
    return final


def _write(final: str, step: int, treedef, arrays) -> str:
    """Write the leaves ``arrays`` yields (host arrays in leaf order)."""
    tmp = final + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)  # leftover from a crashed attempt
    os.makedirs(tmp)
    manifest = {"step": step, "treedef": _tree.describe(treedef),
                "n_leaves": 0, "dtypes": [], "shapes": []}
    for i, arr in enumerate(arrays):
        manifest["dtypes"].append(str(arr.dtype))
        manifest["shapes"].append(list(arr.shape))
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest["n_leaves"] = i + 1
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, ".complete"), "w") as f:
        f.write("ok")
    if os.path.isdir(final):
        shutil.rmtree(final)  # re-save replaces; it must never merge
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        try:
            step = int(name.split("_")[1])
        except ValueError:
            continue  # foreign step_* entry, not ours
        if os.path.exists(os.path.join(ckpt_dir, name, ".complete")):
            steps.append(step)
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Any,
                       shardings: Any = None) -> Any:
    """Restore into the structure of ``like``, re-sharded onto
    ``shardings`` when given: a tree matching ``like`` of
    :class:`~repro_torch.sharding.api.NamedSharding` on a ``DeviceMesh``,
    ``None`` at a leaf that has none. This is the elastic path: the stored
    global arrays do not care about the saving mesh. A leaf with no
    sharding becomes a DTensor placed as ``like``'s leaf where that is
    one, else a tensor on its device (the CPU where it is not a tensor).
    Every rank maps each file and reads only its own slice of it: no
    collective."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    leaves, treedef = _tree.flatten(like)
    shard_leaves = (_tree.flatten_up_to(treedef, shardings)
                    if shardings is not None else [None] * len(leaves))
    out = []
    for i, (leaf, sh) in enumerate(zip(leaves, shard_leaves)):
        file = os.path.join(path, f"leaf_{i:05d}.npy")
        sh = sh if sh is not None else sharding_of(leaf)
        if sh is not None:
            out.append(from_global(np.load(file, mmap_mode="r"), sh))
        else:
            arr = np.load(file)
            dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            out.append(torch.as_tensor(arr, device=dev))
    return _tree.unflatten(treedef, out)


class AsyncCheckpointer:
    """Depth-1 latest-wins async writer; ``save`` returns immediately."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, treedef, arrays = item
            try:
                _write(os.path.join(self.ckpt_dir, f"step_{step:08d}"),
                       step, treedef, arrays)
            except BaseException as e:  # surfaced on next save/close
                self._err = e

    def save(self, step: int, tree: Any) -> None:
        """Queue ``tree`` for writing. A tree with DTensor leaves is a
        collective call: every rank takes part in each leaf's gather here,
        on the calling thread, and only rank 0 copies the leaves to the
        host and queues the write (no barrier: the save returns before the
        write ends)."""
        if self._err:
            raise self._err
        leaves, treedef = _tree.flatten(tree)
        keep = not _is_sharded(tree) or dist.get_rank() == 0
        # copy to the host NOW so training can mutate buffers afterwards
        host = list(_host_leaves(leaves, keep))
        if not keep:
            return
        item = (step, treedef, host)
        try:
            self._q.put_nowait(item)
        except queue.Full:
            try:
                _ = self._q.get_nowait()  # drop the stale pending save
            except queue.Empty:
                pass  # worker dequeued between the two calls — queue free now
            self._q.put_nowait(item)

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err:
            raise self._err


def preemption_save(ckpt_dir: str, get_state) -> Optional[str]:
    """What :func:`save_on_signal`'s handler writes: the state
    ``get_state()`` gives, as :func:`save_checkpoint` would. A tree with
    DTensor leaves is not saved (``None``): its gathers are collectives,
    and a signal handler may run while this rank waits inside another
    collective, or before the other ranks have had their signal, so a
    collective there can hang the world. A sharded run resumes from the
    last checkpoint its ranks wrote together (``Supervisor``'s
    ``ckpt_every``)."""
    step, tree = get_state()
    if _is_sharded(tree):
        log.warning("preemption at step %d: a sharded state is not saved "
                    "from a signal handler; the restart resumes from the "
                    "latest periodic checkpoint", step)
        return None
    return save_checkpoint(ckpt_dir, step, tree)


def save_on_signal(ckpt_dir: str, get_state, signum=signal.SIGTERM):
    """Preemption hook: on ``signum`` write a final checkpoint
    (:func:`preemption_save`) then re-raise the default behaviour.
    ``get_state`` -> (step, tree)."""
    def handler(sig, frame):
        preemption_save(ckpt_dir, get_state)
        signal.signal(sig, signal.SIG_DFL)
        os.kill(os.getpid(), sig)

    signal.signal(signum, handler)
