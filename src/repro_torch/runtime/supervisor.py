"""Fault-tolerant training runtime: restart-from-latest supervision and
straggler detection.

The port of ``src/repro/runtime/supervisor.py``. The Supervisor wraps a
step loop: any step exception (device loss, preemption, injected fault)
falls back to the latest complete checkpoint (the port's
``checkpoint``, the reference's on-disk layout) and replays, after a capped
exponential backoff with jitter (:func:`~repro_torch.runtime.faults.backoff_delay`).
The StragglerMonitor flags steps slower than a multiple of the rolling
median.
"""
from __future__ import annotations

import collections
import logging
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.runtime.faults import FailureInjector, backoff_delay

log = logging.getLogger("repro_torch.runtime")

__all__ = ["Supervisor", "StragglerMonitor", "FailureInjector"]


class StragglerMonitor:
    """Flags steps slower than ``threshold`` × rolling median."""

    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.times = collections.deque(maxlen=window)
        self.threshold = threshold
        self.flagged = []

    def record(self, step: int, seconds: float) -> bool:
        is_straggler = False
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            if seconds > self.threshold * med:
                is_straggler = True
                self.flagged.append((step, seconds, med))
                log.warning("straggler: step %d took %.3fs (median %.3fs)",
                            step, seconds, med)
        self.times.append(seconds)
        return is_straggler


class Supervisor:
    """Run ``n_steps`` of ``step_fn`` with checkpoint/restart fault tolerance.

    step_fn: (state, step:int) -> state
    state:   a tree of tensors (nested dicts, lists, tuples; ``repro_torch.tree``)
    """

    def __init__(self, ckpt_dir: str, *, ckpt_every: int = 50,
                 max_restarts: int = 10, async_ckpt: bool = False,
                 injector: Optional[FailureInjector] = None,
                 restart_backoff_base: float = 0.05,
                 restart_backoff_cap: float = 5.0,
                 restart_backoff_jitter: float = 0.5,
                 seed: int = 0, sleep_fn: Callable[[float], None] = time.sleep):
        if restart_backoff_base < 0 or restart_backoff_cap < 0:
            raise ValueError("restart backoff base/cap must be >= 0")
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.injector = injector
        self.monitor = StragglerMonitor()
        self.async_ckpt = AsyncCheckpointer(ckpt_dir) if async_ckpt else None
        self.restarts = 0
        self.restart_backoff_base = restart_backoff_base
        self.restart_backoff_cap = restart_backoff_cap
        self.restart_backoff_jitter = restart_backoff_jitter
        self.backoff_slept = 0.0  # cumulative restart backoff (observable)
        self._rng = np.random.default_rng(seed)
        self._sleep_fn = sleep_fn

    def _save(self, step: int, state):
        if self.async_ckpt:
            self.async_ckpt.save(step, state)
        else:
            save_checkpoint(self.ckpt_dir, step, state)

    def run(self, init_state, step_fn: Callable, n_steps: int,
            shardings=None):
        """``(state, steps run to)``; a restore places the checkpoint on
        ``shardings`` (a tree of ``NamedSharding`` matching
        ``init_state``; ``None``: as ``init_state``'s leaves lie), which
        may be another mesh than the one that saved it."""
        state = init_state
        start = 0
        last = latest_step(self.ckpt_dir)
        if last is not None:
            state = restore_checkpoint(self.ckpt_dir, last, init_state,
                                       shardings)
            start = last
            log.info("resumed from checkpoint step %d", last)
        step = start
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                if self.injector:
                    self.injector.maybe_fail(step)
                state = step_fn(state, step)
                self.monitor.record(step, time.perf_counter() - t0)
                step += 1
                if step % self.ckpt_every == 0 or step == n_steps:
                    self._save(step, state)
            except Exception as e:  # node failure path
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                # capped exponential backoff + jitter before the replay: a
                # persistent fault must not spin the restart loop hot, and
                # jitter decorrelates hosts that tripped on the same step
                delay = backoff_delay(self.restarts - 1,
                                      base=self.restart_backoff_base,
                                      cap=self.restart_backoff_cap,
                                      jitter=self.restart_backoff_jitter,
                                      rng=self._rng)
                self.backoff_slept += delay
                if delay > 0:
                    self._sleep_fn(delay)
                log.warning("step %d failed (%s); restarting from latest "
                            "checkpoint (restart %d, backoff %.3fs)",
                            step, e, self.restarts, delay)
                last = latest_step(self.ckpt_dir)
                if last is None:
                    state, step = init_state, 0
                else:
                    state = restore_checkpoint(self.ckpt_dir, last,
                                               init_state, shardings)
                    step = last
        if self.async_ckpt:
            self.async_ckpt.close()
        return state, step
