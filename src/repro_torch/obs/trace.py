"""Trace spans: host and device time, JSONL export, gated by ``SPKADD_OBS``.

A span is a context manager that records a start time, a duration, a
nesting depth/parent, and free-form key/value attributes:

    with obs.span("engine.spkadd_auto", k=8, selected="vec") as sp:
        ...
        sp.set_attr("parts", geom.parts)

Spans are recorded **only while observability is enabled**: the
``SPKADD_OBS`` env var, read once when this module is imported and again by
``set_enabled(None)``, or :func:`set_enabled`. Disabled, :func:`span`
returns a shared no-op context: no record, no CUDA event, no profiler
range.

**Host time.** ``t_ns`` is ``time.time_ns()`` at entry, the wall clock
``torch.profiler`` puts its events on (``trace_start_ns()`` plus each
event's offset); ``dur_ns`` is a ``time.monotonic_ns()`` difference. An
enabled span also enters a ``torch.profiler.record_function`` of its name,
around the host interval, so spans show up on a profiler's timeline.

**Device time.** Where CUDA is initialised, an enabled span records a pair
of timing ``torch.cuda.Event`` s on the current stream, at entry and at
exit, and never waits for them. :func:`spans` and :func:`export_jsonl`
resolve the pairs that have completed into ``dev_start_ns`` (on the same
wall clock) and ``dev_ns``; a pair not yet complete, and every span on the
CPU, reads null. ``dev_start_ns`` is placed through an *anchor*: one event
recorded after a synchronise, whose ``time_ns`` is noted, taken when spans
are switched on (or, if CUDA starts later, by the first span after, once).
Events are reused from a pool once resolved, so a long window holds only
the pairs still in flight.

Export: :func:`export_jsonl` writes one JSON object per finished span —
``{"name", "t_ns", "dur_ns", "depth", "parent", "attrs", "dev_start_ns",
"dev_ns"}`` — and :func:`read_jsonl` reads it back. Setting
``SPKADD_OBS_JSONL=<path>`` exports whatever was recorded at exit.

The finished-span list and the event pools are guarded by a lock; the
nesting stack is thread-local.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

#: Master switch: any value other than ""/"0"/"false"/"off" enables spans.
OBS_ENV = "SPKADD_OBS"

#: When set (and observability is enabled), finished spans are exported to
#: this path at interpreter exit.
OBS_JSONL_ENV = "SPKADD_OBS_JSONL"


def _env_on() -> bool:
    return os.environ.get(OBS_ENV, "").lower() not in ("", "0", "false", "off")


_on: bool = _env_on()
_lock = threading.Lock()
_finished: List[Dict[str, Any]] = []
_tls = threading.local()
#: Per CUDA device: ``(anchor event, its time_ns)``.
_anchors: Dict[int, Tuple[Any, int]] = {}
#: Per CUDA device: timing events free for reuse.
_pools: Dict[int, List[Any]] = {}
#: ``(record, enter event, exit event, anchor, device)`` in finish order,
#: device times not yet resolved.
_pending: Deque[tuple] = collections.deque()


def enabled() -> bool:
    """Is span recording on?"""
    return _on


def set_enabled(on: Optional[bool]) -> None:
    """Switch spans on/off for this process; ``None`` reads ``SPKADD_OBS``
    again. Switching on where CUDA is initialised anchors the device clock
    (one synchronise)."""
    global _on
    _on = _env_on() if on is None else bool(on)
    if _on and torch.cuda.is_initialized():
        dev = torch.cuda.current_device()
        _anchors[dev] = _take_anchor()


def _take_anchor() -> Tuple[Any, int]:
    torch.cuda.synchronize()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    t_ns = time.time_ns()
    ev.synchronize()
    return ev, t_ns


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _resolve(item: tuple) -> bool:
    """Fill a pending record's device times if both its events completed,
    and return them to the pool. Called under ``_lock``."""
    rec, e0, e1, (anchor, anchor_ns), dev = item
    if not (e1.query() and e0.query()):
        return False
    rec["dev_start_ns"] = anchor_ns + round(anchor.elapsed_time(e0) * 1e6)
    rec["dev_ns"] = round(e0.elapsed_time(e1) * 1e6)
    _pools.setdefault(dev, []).extend((e0, e1))
    return True


def _event_pair(dev: int) -> Tuple[Any, Any]:
    """Two timing events for ``dev``: from its pool, after resolving the
    oldest pending pairs that completed, else new ones."""
    with _lock:
        pool = _pools.setdefault(dev, [])
        while len(pool) < 2 and _pending and _resolve(_pending[0]):
            _pending.popleft()
        if len(pool) >= 2:
            return pool.pop(), pool.pop()
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


class Span:
    """A live span. ``set_attr`` adds/overwrites attributes until exit."""

    __slots__ = ("name", "attrs", "_t_ns", "_t0", "_depth", "_parent",
                 "_ann", "_dev")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self._t_ns = 0
        self._t0 = 0
        self._depth = 0
        self._parent: Optional[str] = None
        self._ann = None
        self._dev: Optional[tuple] = None

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        st = _stack()
        self._depth = len(st)
        self._parent = st[-1].name if st else None
        st.append(self)
        ann = record_function(self.name)
        ann.__enter__()
        self._ann = ann
        self._t_ns = time.time_ns()
        self._t0 = time.monotonic_ns()
        if torch.cuda.is_initialized():
            dev = torch.cuda.current_device()
            anchor = _anchors.get(dev)
            if anchor is None:
                anchor = _anchors[dev] = _take_anchor()
            e0, e1 = _event_pair(dev)
            e0.record()
            self._dev = (e0, e1, anchor, dev)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._dev is not None:
            self._dev[1].record()
        dur = time.monotonic_ns() - self._t0
        self._ann.__exit__(exc_type, exc, tb)
        self._ann = None
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        rec = {"name": self.name, "t_ns": self._t_ns, "dur_ns": dur,
               "depth": self._depth, "parent": self._parent,
               "attrs": dict(self.attrs), "dev_start_ns": None,
               "dev_ns": None}
        with _lock:
            _finished.append(rec)
            if self._dev is not None:
                _pending.append((rec,) + self._dev)
        self._dev = None


class _NullSpan:
    """Shared no-op span for the disabled path."""

    __slots__ = ()
    name = ""
    attrs: Dict[str, Any] = {}

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NULL = _NullSpan()


def span(name: str, **attrs: Any):
    """Open a span (context manager). No-op (shared instance) when disabled.

    Attribute values should be JSON-representable scalars; anything else is
    stringified at export.
    """
    if not _on:
        return _NULL
    return Span(name, dict(attrs))


def spans() -> List[Dict[str, Any]]:
    """Copies of every finished span so far (record order), with the device
    times of the pairs that have completed."""
    with _lock:
        for _ in range(len(_pending)):
            item = _pending.popleft()
            if not _resolve(item):
                _pending.append(item)
        return [dict(s) for s in _finished]


def clear() -> None:
    """Drop all finished spans and their unresolved events (the nesting
    stack is untouched)."""
    with _lock:
        _finished.clear()
        _pending.clear()


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    try:  # numpy / torch scalars
        return v.item()
    except Exception:
        return str(v)


def export_jsonl(path: str) -> int:
    """Write finished spans as JSONL; returns the number written."""
    recs = spans()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(_jsonable(r), sort_keys=True) + "\n")
    return len(recs)


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Round-trip reader for :func:`export_jsonl` output."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _atexit_export() -> None:
    path = os.environ.get(OBS_JSONL_ENV)
    if path and _on and _finished:
        try:
            n = export_jsonl(path)
            print(f"[obs] exported {n} spans to {path}", flush=True)
        except OSError:
            pass


atexit.register(_atexit_export)
