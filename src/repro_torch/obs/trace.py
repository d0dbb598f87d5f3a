"""Trace spans: host-side, JSONL-exportable, gated by ``SPKADD_OBS``.

A span is a context manager that records a monotonic start time, a
duration, a nesting depth/parent, and free-form key/value attributes:

    with obs.span("engine.spkadd_auto", k=8, selected="vec") as sp:
        ...
        sp.set_attr("parts", geom.parts)

Spans are recorded **only while observability is enabled** (the
``SPKADD_OBS`` env var, overridable per-process via :func:`set_enabled`).
Disabled, :func:`span` returns a shared no-op context. Spans live on the
host at launch boundaries; the duration is host time (enqueue time for
device work, which PyTorch runs asynchronously), not device time.

An enabled span also enters a ``torch.profiler.record_function`` of the
same name, so engine and kernel spans show up on the host timeline of a
``torch.profiler`` trace beside the kernels they launch.

Export: :func:`export_jsonl` writes one JSON object per finished span —
``{"name", "t_ns", "dur_ns", "depth", "parent", "attrs"}``, the reference
package's schema — and :func:`read_jsonl` reads it back. Setting
``SPKADD_OBS_JSONL=<path>`` exports whatever was recorded at exit.

The finished-span list is append-only under a lock; the nesting stack is
thread-local.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

#: Master switch: any value other than ""/"0"/"false"/"off" enables spans.
OBS_ENV = "SPKADD_OBS"

#: When set (and observability is enabled), finished spans are exported to
#: this path at interpreter exit.
OBS_JSONL_ENV = "SPKADD_OBS_JSONL"

_override: Optional[bool] = None
_lock = threading.Lock()
_finished: List[Dict[str, Any]] = []
_tls = threading.local()


def enabled() -> bool:
    """Is span recording on? Process override beats the env var."""
    if _override is not None:
        return _override
    return os.environ.get(OBS_ENV, "").lower() not in ("", "0", "false", "off")


def set_enabled(on: Optional[bool]) -> None:
    """Force spans on/off for this process; ``None`` defers to the env."""
    global _override
    _override = on


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class Span:
    """A live span. ``set_attr`` adds/overwrites attributes until exit."""

    __slots__ = ("name", "attrs", "_t0", "_depth", "_parent", "_ann")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self._t0 = 0
        self._depth = 0
        self._parent: Optional[str] = None
        self._ann = None

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        st = _stack()
        self._depth = len(st)
        self._parent = st[-1].name if st else None
        st.append(self)
        self._t0 = time.monotonic_ns()
        from torch.profiler import record_function

        ann = record_function(self.name)
        ann.__enter__()
        self._ann = ann
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = time.monotonic_ns() - self._t0
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
            self._ann = None
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        with _lock:
            _finished.append({
                "name": self.name,
                "t_ns": self._t0,
                "dur_ns": dur,
                "depth": self._depth,
                "parent": self._parent,
                "attrs": dict(self.attrs),
            })


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
    if not enabled():
        return _NULL
    return Span(name, dict(attrs))


def spans() -> List[Dict[str, Any]]:
    """Copies of every finished span so far (record order)."""
    with _lock:
        return [dict(s) for s in _finished]


def clear() -> None:
    """Drop all finished spans (the nesting stack is untouched)."""
    with _lock:
        _finished.clear()


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
    if path and enabled() and _finished:
        try:
            n = export_jsonl(path)
            print(f"[obs] exported {n} spans to {path}", flush=True)
        except OSError:
            pass


atexit.register(_atexit_export)
