"""Named counters / gauges / histograms with snapshot + reset semantics.

The port's copy of the reference registry, with the same metric names
(``sparse.stable_argsort.calls``, ``engine.dispatch.<regime>``, the
sliding-hash launch geometry gauges), so a reading from either package
means the same thing.
Metrics are **always on** — they are plain host-side integer/float updates
issued at launch boundaries (never per element, never on the device), so
they cost nothing measurable and counters like ``sparse.sort_calls()`` keep
working whether or not span tracing (``SPKADD_OBS``) is enabled.

Semantics
---------
- ``counter(name)``: monotone ``.inc(n)``; ``.value``.
- ``gauge(name)``: last-write-wins ``.set(v)``; ``.value``.
- ``histogram(name)``: ``.observe(v)`` keeps count/total/min/max (scalar
  summaries, not buckets — enough for flush-size / occupancy telemetry
  without unbounded memory).
- :func:`snapshot` returns a plain ``{name: {"type", ...}}`` dict (deep
  copy — later updates don't mutate it).
- :func:`reset` zeroes values, optionally only under a name prefix.
  Registered objects survive a reset, so modules may cache handles.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

_lock = threading.Lock()
_REGISTRY: Dict[str, "_Metric"] = {}


class _Metric:
    kind = "metric"

    def _zero(self) -> None:
        raise NotImplementedError

    def _snap(self) -> Dict[str, Any]:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with _lock:
            self.value += n

    def _zero(self) -> None:
        self.value = 0

    def _snap(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self) -> None:
        self.value: float = 0.0

    def set(self, v: float) -> None:
        with _lock:
            self.value = v

    def _zero(self) -> None:
        self.value = 0.0

    def _snap(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self) -> None:
        self._zero()

    def observe(self, v: float) -> None:
        with _lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def _zero(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def _snap(self) -> Dict[str, Any]:
        return {"type": "histogram", "count": self.count, "total": self.total,
                "min": self.min, "max": self.max}


def _get(name: str, cls) -> _Metric:
    with _lock:
        m = _REGISTRY.get(name)
        if m is None:
            m = _REGISTRY[name] = cls()
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as {m.kind}")
        return m


def counter(name: str) -> Counter:
    return _get(name, Counter)


def gauge(name: str) -> Gauge:
    return _get(name, Gauge)


def histogram(name: str) -> Histogram:
    return _get(name, Histogram)


def snapshot(prefix: str = "") -> Dict[str, Dict[str, Any]]:
    """Plain-dict copy of every metric (optionally prefix-filtered)."""
    with _lock:
        return {name: m._snap() for name, m in sorted(_REGISTRY.items())
                if name.startswith(prefix)}


def reset(prefix: str = "") -> None:
    """Zero all metrics under ``prefix`` (default: everything). Handles
    cached by modules stay registered and valid."""
    with _lock:
        for name, m in _REGISTRY.items():
            if name.startswith(prefix):
                m._zero()
