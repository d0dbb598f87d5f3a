"""One run of one cell: find it by name, set it up, measure it for a fixed
window, check what it produced against the plain reference, print the
result line.

The cell's configuration names its ``system``; ``cells/<system>.py`` drives
it through four functions:

* ``setup(cfg, traffic, seed, device)`` makes the inputs from the seed,
  sets the port up and warms up every shape the traffic uses; returns the
  cell's state;
* ``window(state, seconds, spans)`` drives the port for ``seconds`` and
  returns a :class:`Window`; with ``spans`` on it also keeps the harness's
  own spans around its calls into the port's layers;
* ``traced(state, trace)`` drives a short run of further units under
  ``torch.profiler`` (``--trace 1`` only), and notes in ``trace.work`` the
  operations and bytes of what it ran;
* ``check(state)`` frees the port's state, runs the plain reference and
  returns each number compared with its limit.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, NamedTuple, Optional

from spkbench import HERE, ROOT

#: Top-level module names that may not be loaded once the window has closed.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
#: The profiler loses what is launched in its first milliseconds: wait
#: this long after it starts before the traced units.
SETTLE_S = 0.05


class Window(NamedTuple):
    """What a measured window gives: end-to-end values by metric name,
    units attempted and failed, the harness's spans (name: list of
    readings) when they were on, and counts for the result line's
    ``info``."""
    e2e: Dict[str, float]
    attempted: int
    failed: int
    spans: Dict[str, List[float]]
    info: Dict[str, float] = {}


class Check(NamedTuple):
    """One number compared and its limit: correct while ``value <= limit``."""
    value: float
    limit: float


class CellError(Exception):
    """A run that cannot give a result (no card, an unknown cell)."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench() -> dict:
    """``BENCHMARK.json``."""
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def find_cell(name: str, bench: Optional[dict] = None) -> tuple:
    """``(bench, cell, cfg, traffic)`` of the cell ``name`` of ``bench``
    (``BENCHMARK.json`` unless given), with its configuration and traffic
    files."""
    bench = load_bench() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no cell {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     cell["traffic"] + ".json"))
    return bench, cell, cfg, traffic


def driver(cfg: dict):
    """The module ``cells/<system>.py`` that runs ``cfg``."""
    return importlib.import_module(f"spkbench.cells.{cfg['system']}")


def metric_reader(name: str):
    """The ``read(trace)`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "spkbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports.
    An end-to-end metric without ``workloads`` is reported everywhere; a
    per-layer one without it wherever the metric it moves is."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved
                             else [])]


def forbidden_loaded() -> List[str]:
    """The forbidden top-level modules in ``sys.modules``, compared by their
    whole top-level name (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def sync(device) -> None:
    """Wait for the card, where ``device`` is one."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile (linear between closest ranks)."""
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


# ---------------------------------------------------------------------------
# the traced run
# ---------------------------------------------------------------------------

class Trace:
    """What a ``--trace 1`` run hands the per-layer metrics' readers:
    the harness's spans over the measured window, the operations and bytes
    of the traced units (``work``), and from the profile of the traced
    units the device time by kernel name (``kernels``: name -> seconds),
    the device time that falls inside each of the harness's ranges
    (``ranges``: name -> [seconds, calls]; a range that ends in a
    synchronize holds all it launched), the device's busy seconds and the
    traced window's length."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = {}
        self.work: Dict[str, float] = {}
        self.kernels: Dict[str, float] = {}
        self.ranges: Dict[str, list] = {}
        self.busy_s = 0.0
        self.window_s = 0.0
        self.breakdown: Optional[dict] = None

    def range(self, name: str):
        """A ``torch.profiler.record_function`` range named ``name``
        (``spkbench.*``), read into ``ranges``."""
        import torch

        return torch.profiler.record_function(name)

    def profile(self):
        """The profiler around the traced units."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def settle(self):
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        time.sleep(SETTLE_S)

    def read(self, prof, window_range: str) -> None:
        """Fill the device readings from ``prof``, the traced units lying
        inside the range ``window_range``. The profiler mirrors each range
        on the device's timeline under the range's own name: those mirrors
        are not device operations and are left out."""
        import bisect

        import torch

        cuda = torch.autograd.DeviceType.CUDA
        events = list(prof.events())
        cpu = [e for e in events if e.device_type != cuda]
        names = {e.name for e in cpu}
        win = [e for e in cpu if e.name == window_range]
        if len(win) != 1:
            raise RuntimeError(f"the traced window {window_range!r} was "
                               f"recorded {len(win)} times")
        lo, hi = win[0].time_range.start, win[0].time_range.end
        self.window_s = (hi - lo) / 1e6
        dev = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi),
                      e.name) for e in events if e.device_type == cuda
                     and e.name not in names
                     and e.time_range.end > lo and e.time_range.start < hi)
        busy, gaps, reach = 0.0, [], lo
        for start, end, name in dev:
            if start > reach:
                gaps.append((reach, start))
            if end > reach:
                busy += end - max(start, reach)
                reach = end
            self.kernels[name] = (self.kernels.get(name, 0.0)
                                  + (end - start) / 1e6)
        if hi > reach:
            gaps.append((reach, hi))
        self.busy_s = busy / 1e6
        starts = [d[0] for d in dev]
        for e in cpu:
            if not e.name.startswith("spkbench.") or e.name == window_range:
                continue
            a, b = e.time_range.start, e.time_range.end
            took = 0.0
            for start, end, _ in dev[max(0, bisect.bisect_left(starts, a) - 1):
                                     bisect.bisect_left(starts, b)]:
                took += max(0.0, min(end, b) - max(start, a))
            r = self.ranges.setdefault(e.name, [0.0, 0])
            r[0] += took / 1e6
            r[1] += 1
        host = sorted(((e.time_range.start, e.time_range.end, e.name)
                       for e in cpu if e.name != window_range),
                      key=lambda r: r[0])
        self.breakdown = {
            "device_ops": sorted(([n[:200], s] for n, s in
                                  self.kernels.items()),
                                 key=lambda r: -r[1])[:10],
            "idle_gaps": _gaps_by_host(gaps, host)}

    def kernel_s(self, *parts: str) -> float:
        """Device seconds of the kernels whose names hold any of ``parts``."""
        return sum(s for name, s in self.kernels.items()
                   if any(p in name for p in parts))


def _gaps_by_host(gaps: List[tuple], cpu: List[tuple],
                  longest: int = 200) -> List[list]:
    """Idle seconds of the ``longest`` gaps, summed by what the host was
    doing at each gap's middle: the harness's innermost range and the
    innermost operation in it (the latest to start of those that span the
    middle)."""
    import bisect

    own = [c for c in cpu if c[2].startswith("spkbench.")]
    ops = [c for c in cpu if not c[2].startswith("spkbench.")]
    starts = [c[0] for c in ops]
    by: Dict[str, float] = {}
    for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:longest]:
        mid = (lo + hi) / 2
        spans = [c for c in own if c[0] <= mid <= c[1]]
        rng = max(spans, key=lambda c: c[0]) if spans else None
        label = rng[2] if rng else "outside the harness's ranges"
        j = bisect.bisect_right(starts, mid) - 1
        for c in reversed(ops[max(0, j - 5000):j + 1]):
            if rng and c[0] < rng[0]:
                break
            if c[1] >= mid:
                label += "/" + c[2][:80]
                break
        by[label] = by.get(label, 0.0) + (hi - lo) / 1e6
    return sorted(([k, v] for k, v in by.items()), key=lambda r: -r[1])[:10]


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", chips_check: bool = True,
        cfg_override: Optional[dict] = None,
        traffic_override: Optional[dict] = None,
        bench: Optional[dict] = None) -> dict:
    """One run of cell ``workload``; returns the result line's object.
    ``t_start`` is when the process started (set-up counts from there).
    The tests pass ``device="cpu"``, ``chips_check=False``, small
    configurations through the overrides, and the entries of a cell that
    ``BENCHMARK.json`` does not list as ``bench``; the command line never
    does."""
    import torch

    bench, cell, cfg, traffic = find_cell(workload, bench)
    cfg = dict(cfg, **(cfg_override or {}))
    traffic = dict(traffic, **(traffic_override or {}))
    if chips_check:
        if not torch.cuda.is_available():
            raise CellError("torch.cuda.is_available() is false: this "
                            "benchmark runs on a CUDA card only")
        if torch.cuda.device_count() < cell["chips"]:
            raise CellError(f"cell {workload} needs {cell['chips']} cards, "
                            f"{torch.cuda.device_count()} are visible")
    mod = driver(cfg)
    setup_parts = {"imports_s": time.perf_counter() - t_start}
    if device == "cuda":
        from repro_torch.kernels import _build

        setup_parts["build_s"] = _build.build_all()
        torch.cuda.reset_peak_memory_stats()
    state = mod.setup(cfg, traffic, seed, device)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    setup_parts.update(state.get("setup_parts", {}), setup_s=setup_s)
    win = mod.window(state, seconds, spans=trace)
    tr = None
    if trace:
        tr = Trace()
        tr.spans = win.spans
        mod.traced(state, tr)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    checks = mod.check(state)
    del state
    correct = all(c.value <= c.limit for c in checks.values())
    if trace:
        metrics = {}
        for m in cell_metrics(bench, workload, "per_layer"):
            value = metric_reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(win.e2e, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, workload, "end_to_end")}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    out = {"correct": correct, "attempted": win.attempted,
           "failed": win.failed, "metrics": metrics, "device": dev}
    if trace and tr.breakdown is not None:
        out["breakdown"] = tr.breakdown
    out["setup_parts"] = setup_parts
    out["info"] = dict(win.info, **({"trace_ranges": tr.ranges,
                                     "trace_work": tr.work} if trace else {}))
    out["checks"] = {k: {"value": c.value, "limit": c.limit}
                     for k, c in checks.items()}
    return out
