"""Perf-history ledger: committed cross-run memory for ``BENCH_*.json``.

The port of ``src/repro/obs/ledger.py``, line for line in what it writes:
:func:`append_bench` folds a ``BENCH_*.json`` payload into a JSONL ledger
keyed by ``(commit, backend, suite, geometry)``, and
:func:`check_regressions` gates the newest entry of each series against a
rolling baseline of its predecessors. The same payloads give the same
bytes in either package's ledger, so one ledger (and
``scripts/bench_report.py``) reads both. The port's payloads name their
backend ``torch-cpu`` or ``torch-cuda`` (:func:`backend`) in their
``meta``, which keeps its series apart from the reference's. Nothing here
picks a directory: the caller passes ``history_dir`` (the reference's
runs use ``results/history/``).

Ledger format — one JSON object per line, append-ordered (append order is
the trajectory order; timestamps ride along in ``meta``):

    {"key": {"commit", "backend", "suite", "geometry"},
     "meta": {... the BENCH artifact's meta ...},
     "records": [{"name", "value", "derived"}, ...]}

Appending an entry whose key already exists **replaces** it (dedup): re-runs
at the same commit update in place instead of double-counting a trajectory
point.

Regression gate
---------------
:data:`TRACKED_ORACLES` names the metric families whose value is a *claim*
(all lower-is-better), the reference's list: the one-pass grid's modeled
chunk loads, the vec fold's serial-store counts, the sparse-allreduce
collective bytes, the delta-sync chaos soak's wire bytes per sync epoch +
worst catch-up SpKAdd window, the sliding-hash regime's modeled table
touches + probe-chain lengths, and the stream-service chaos cells' p99
flush latency + shed rate. For each tracked series — same (backend, suite,
geometry, record name) — the rolling baseline is the median of up to
``window`` prior values; the newest value regresses when it exceeds
``baseline * (1 + rel_tol)``. A series with no prior entries passes (first
observation seeds the baseline).

Zero-dependency on purpose: it imports neither torch nor the rest of the
port.
"""
from __future__ import annotations

import fnmatch
import json
import os
import statistics
import subprocess
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

LEDGER_NAME = "ledger.jsonl"


def backend(device) -> str:
    """The ``meta["backend"]`` of a port payload measured on ``device`` (a
    ``torch.device`` or its name): ``torch-cpu`` or ``torch-cuda``."""
    kind = str(getattr(device, "type", device)).split(":")[0]
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no ledger backend for device {device!r}")
    return f"torch-{kind}"

#: fnmatch patterns over record names -> tracked (lower-is-better) oracles.
TRACKED_ORACLES: Tuple[str, ...] = (
    "io/*/onepass_loads",       # spkadd_io: modeled one-pass chunk loads
    "smoke/serial_stores",      # table34: serial-fold store count
    "smoke/sort_fold_stores",   # table34: vec sort-fold store count
    "allreduce*coll_bytes",     # sparse_allreduce: per-step collective bytes
    "chaos/*/bytes_per_sync",       # delta_sync: wire bytes per sync epoch
    "chaos/*/catchup_window_max",   # delta_sync: worst catch-up SpKAdd k
    "hash/*/insert_loads",          # hash_accum: modeled table touches
    "hash/*/probes_per_insert",     # hash_accum: probe-chain length
    "stream/*/p99_flush_latency",   # stream_service: simulated p99 flush
    "stream/*/shed_rate",           # stream_service: evicted/admitted nnz
)


def git_commit(repo_dir: Optional[str] = None) -> str:
    """Best-effort commit id: ``$GITHUB_SHA`` (CI), then ``git rev-parse``,
    then ``"unknown"`` — the ledger must stay writable outside a checkout."""
    sha = os.environ.get("GITHUB_SHA")
    if sha:
        return sha[:12]
    try:
        out = subprocess.run(["git", "rev-parse", "--short=12", "HEAD"],
                             cwd=repo_dir, capture_output=True, text=True,
                             timeout=10)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def _ledger_path(history_dir: str) -> str:
    return os.path.join(history_dir, LEDGER_NAME)


def load(history_dir: str) -> List[Dict[str, Any]]:
    """All ledger entries in append (trajectory) order; [] when absent."""
    path = _ledger_path(history_dir)
    if not os.path.exists(path):
        return []
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                entries.append(json.loads(line))
    return entries


def _write(history_dir: str, entries: Sequence[Dict[str, Any]]) -> str:
    os.makedirs(history_dir, exist_ok=True)
    path = _ledger_path(history_dir)
    with open(path, "w") as f:
        for e in entries:
            f.write(json.dumps(e, sort_keys=True) + "\n")
    return path


def entry_key(entry: Dict[str, Any]) -> Tuple[str, str, str, str]:
    k = entry.get("key", {})
    return (str(k.get("commit", "")), str(k.get("backend", "")),
            str(k.get("suite", "")), str(k.get("geometry", "")))


def append_bench(history_dir: str, payload: Dict[str, Any], *,
                 commit: Optional[str] = None,
                 geometry: str = "") -> Dict[str, Any]:
    """Fold one BENCH artifact payload (``{"meta", "records"}``) into the
    ledger. Same-key re-appends replace the prior entry. Returns the entry."""
    meta = dict(payload.get("meta", {}))
    entry = {
        "key": {
            "commit": commit or git_commit(),
            "backend": str(meta.get("backend", "unknown")),
            "suite": str(meta.get("suite", "unknown")),
            "geometry": geometry,
        },
        "meta": meta,
        "records": list(payload.get("records", [])),
    }
    entries = [e for e in load(history_dir) if entry_key(e) != entry_key(entry)]
    entries.append(entry)
    _write(history_dir, entries)
    return entry


def append_bench_file(history_dir: str, bench_json: str,
                      **kw) -> Dict[str, Any]:
    """:func:`append_bench` for an on-disk ``BENCH_*.json`` artifact."""
    with open(bench_json) as f:
        payload = json.load(f)
    return append_bench(history_dir, payload, **kw)


# ---------------------------------------------------------------------------
# series extraction + regression gate
# ---------------------------------------------------------------------------

def series(entries: Iterable[Dict[str, Any]]
           ) -> Dict[Tuple[str, str, str, str], List[Tuple[str, float]]]:
    """``{(backend, suite, geometry, record_name): [(commit, value), ...]}``
    in trajectory order."""
    out: Dict[Tuple[str, str, str, str], List[Tuple[str, float]]] = {}
    for e in entries:
        commit, backend, suite, geometry = entry_key(e)
        for r in e.get("records", []):
            key = (backend, suite, geometry, str(r.get("name", "")))
            out.setdefault(key, []).append((commit, float(r.get("value", 0))))
    return out


def tracked_names(names: Iterable[str],
                  tracked: Sequence[str] = TRACKED_ORACLES) -> List[str]:
    return [n for n in names
            if any(fnmatch.fnmatchcase(n, pat) for pat in tracked)]


def missing_baselines(entries: Sequence[Dict[str, Any]], *,
                      tracked: Sequence[str] = TRACKED_ORACLES) -> List[str]:
    """Tracked oracle patterns with no matching ledger series at all.

    The regression gate silently passes a series it has never seen; a gate
    run against a ledger that lacks a whole tracked family is vouching for
    a claim it cannot check. Returns one human-readable line per missing
    pattern ([] == every tracked family has at least one observation).
    """
    names = {name for (_, _, _, name) in series(entries)}
    return [
        f"NO BASELINE {pat}: no ledger series matches this tracked oracle "
        f"— run scripts/perf_fleet.py to seed results/history/"
        for pat in tracked
        if not any(fnmatch.fnmatchcase(n, pat) for n in names)
    ]


def check_regressions(entries: Sequence[Dict[str, Any]], *,
                      tracked: Sequence[str] = TRACKED_ORACLES,
                      rel_tol: float = 0.05,
                      window: int = 5) -> List[str]:
    """Gate the newest point of every tracked series against its rolling
    baseline. Returns human-readable failure lines ([] == pass)."""
    failures = []
    for (backend, suite, geometry, name), pts in sorted(series(entries).items()):
        if not tracked_names([name], tracked) or len(pts) < 2:
            continue
        *prior, (commit, latest) = pts
        baseline = statistics.median(v for _, v in prior[-window:])
        limit = baseline * (1.0 + rel_tol)
        if latest > limit:
            failures.append(
                f"REGRESSION {backend}/{suite}/{name}"
                f"{('/' + geometry) if geometry else ''}: {latest:g} at "
                f"{commit} exceeds rolling baseline {baseline:g} "
                f"(+{rel_tol:.0%} tolerance -> limit {limit:g})")
    return failures
