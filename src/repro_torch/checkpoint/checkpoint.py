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
structure comes from the ``like`` tree. Restoring onto a sharding waits
for the port's sharding.

``AsyncCheckpointer`` overlaps the host write with training (one
background thread, latest-wins queue of depth 1); ``save_on_signal``
installs a SIGTERM hook for preemption checkpoints.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import signal
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as _tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Crash-atomic save: everything is written into ``step_XXXXXXXX.tmp``
    and ``os.replace``d into place as the last act. A crash mid-write
    leaves only a ``.tmp`` dir (invisible to :func:`latest_step`, replaced
    wholesale by the next attempt)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)  # leftover from a crashed attempt
    os.makedirs(tmp)
    leaves, treedef = _tree.flatten(tree)
    manifest = {"step": step, "treedef": _tree.describe(treedef),
                "n_leaves": len(leaves), "dtypes": [], "shapes": []}
    for i, leaf in enumerate(leaves):
        arr = _to_numpy(leaf)
        manifest["dtypes"].append(str(arr.dtype))
        manifest["shapes"].append(list(arr.shape))
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
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


def restore_checkpoint(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``. Each leaf becomes a tensor
    on the device of ``like``'s leaf in its place (the CPU where that leaf
    is not a tensor)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    leaves, treedef = _tree.flatten(like)
    out = []
    for i, leaf in enumerate(leaves):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
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
            step, tree = item
            try:
                save_checkpoint(self.ckpt_dir, step, tree)
            except BaseException as e:  # surfaced on next save/close
                self._err = e

    def save(self, step: int, tree: Any) -> None:
        if self._err:
            raise self._err
        # copy to the host NOW so training can mutate buffers afterwards
        host_tree = _tree.tree_map(_to_numpy, tree)
        try:
            self._q.put_nowait((step, host_tree))
        except queue.Full:
            try:
                _ = self._q.get_nowait()  # drop the stale pending save
            except queue.Empty:
                pass  # worker dequeued between the two calls — queue free now
            self._q.put_nowait((step, host_tree))

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err:
            raise self._err


def save_on_signal(ckpt_dir: str, get_state, signum=signal.SIGTERM):
    """Preemption hook: on ``signum`` write a final checkpoint then re-raise
    the default behaviour. ``get_state`` -> (step, tree)."""
    def handler(sig, frame):
        step, tree = get_state()
        save_checkpoint(ckpt_dir, step, tree)
        signal.signal(sig, signal.SIG_DFL)
        os.kill(os.getpid(), sig)

    signal.signal(signum, handler)
