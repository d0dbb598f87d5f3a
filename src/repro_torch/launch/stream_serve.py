"""Open-loop load generator for the multi-tenant stream service.

The port of ``src/repro/launch/stream_serve.py``. Arrivals are drawn
*open-loop* (exponential interarrivals per tenant, seeded) — the offered
load never waits for the service, which is what makes overload,
backpressure, and shedding observable instead of being absorbed by a
closed-loop client. The event stream (arrivals + scheduler ticks) is fully
materialized up front, so a chaos run is replayable: the same seed and
:class:`~repro_torch.runtime.faults.ServiceFaultSpec` produce the same
pushes, the same flush groupings, and — with a journal — a crash/recovery
that is bitwise identical to the uninterrupted run. The events and every
pushed matrix are the reference's, draw for draw.

CLI::

    python -m repro_torch.launch.stream_serve --tenants 64 --duration 20 \\
        --rate 4 --overload 1.0 --device cuda --json results/BENCH_stream_service.json

emits ``streams/sec`` and p50/p99 flush latency (simulated seconds: counts
of the model's clock, not times of the device), shed rate, and
recovery-replay counts. ``--device`` defaults to the CUDA card;
``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.sparse import PaddedCOO, resolve_device, sentinel_key
from repro_torch.core.stream_service import (AdmissionVerdict, StreamService,
                                             latency_percentiles)
from repro_torch.kernels import xla_float
from repro_torch.runtime.faults import InjectedCrash, ServiceFaultSpec


class Arrival(NamedTuple):
    t: float
    tenant: str
    mat_seed: int


class Event(NamedTuple):
    """One load-generator event: ``kind`` is "push" or "tick"."""
    t: float
    kind: str
    arrival: Optional[Arrival] = None


def tenant_name(i: int) -> str:
    return f"tenant{i:04d}"


def build_workload(*, n_tenants: int, duration: float, rate: float,
                   tick_every: float, seed: int = 0,
                   cold_tenants: Sequence[str] = (),
                   cold_until: float = 0.0,
                   faults: Optional[ServiceFaultSpec] = None) -> List[Event]:
    """Materialize the merged (arrival, tick) event stream.

    ``cold_tenants`` stop pushing after ``cold_until`` (they go cold and
    become the eviction victims under overload). A fault spec's
    ``stall_tenants`` are additionally silenced inside their stall window
    (the slow-tenant stall), and its ``burst_at`` times compress every
    arrival within ``burst_factor`` seconds into one instant (the burst).
    """
    if n_tenants < 1 or duration <= 0 or rate <= 0 or tick_every <= 0:
        raise ValueError("need n_tenants >= 1 and positive duration/rate/"
                         "tick_every")
    rng = np.random.default_rng(seed)
    cold = set(cold_tenants)
    arrivals: List[Arrival] = []
    for i in range(n_tenants):
        name = tenant_name(i)
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rate))
            if t >= duration:
                break
            if name in cold and t > cold_until:
                continue
            arrivals.append(Arrival(t, name, int(rng.integers(1 << 30))))
    if faults is not None:
        stalled = set(faults.stall_tenants)
        if stalled:
            arrivals = [a for a in arrivals
                        if not (a.tenant in stalled
                                and faults.stall_from <= a.t
                                < faults.stall_until)]
        for b in faults.burst_at:
            arrivals = [a._replace(t=b)
                        if b <= a.t < b + faults.burst_factor else a
                        for a in arrivals]
    events = [Event(a.t, "push", a) for a in arrivals]
    n_ticks = int(math.ceil(duration / tick_every))
    events += [Event(k * tick_every, "tick") for k in range(1, n_ticks + 1)]
    # pushes before ticks at equal times, then stable by construction order
    events.sort(key=lambda e: (e.t, 0 if e.kind == "push" else 1))
    return events


def make_matrix(shape: Tuple[int, int], nnz: int, mat_seed: int,
                dtype=torch.float32, device=None) -> PaddedCOO:
    """Deterministic sparse matrix from an event's seed — both the
    reference and the crash/recovery run regenerate identical pushes.

    The reference draws ``rng.choice``/``standard_normal`` into a dense
    ``m × n`` array and calls ``from_dense(dense, cap=nnz)``. The same
    draws give the same PaddedCOO here without the dense array (67 MB and a
    sort of 16.8 M keys a push at 65,536 × 256): keys ``col * m + row``
    (column-major, as ``from_dense`` keys), values rounded to f32 (then to
    ``dtype``), sorted by key, a value that XLA's compare takes for zero
    dropped, padded to ``cap = nnz`` with sentinels."""
    dev = resolve_device(device)
    rng = np.random.default_rng(mat_seed)
    m, n = shape
    idx = rng.choice(m * n, size=min(nnz, m * n), replace=False)
    vals = rng.standard_normal(len(idx)).astype(np.float32)
    keys = (idx % n) * m + idx // n
    order = np.argsort(keys, kind="stable")
    v = torch.from_numpy(vals[order]).to(dtype)
    keep = (xla_float.flush(v) != 0.0).numpy()
    count = int(keep.sum())
    out_keys = np.full(nnz, sentinel_key(shape), np.int32)
    out_keys[:count] = keys[order][keep]
    out_vals = torch.zeros(nnz, dtype=dtype)
    out_vals[:count] = v[torch.from_numpy(keep)]
    return PaddedCOO(keys=torch.from_numpy(out_keys).to(dev),
                     vals=out_vals.to(dev),
                     nnz=torch.tensor(count, dtype=torch.int32, device=dev),
                     shape=(m, n))


class DriveResult(NamedTuple):
    completed: bool      # False = an InjectedCrash stopped the run
    next_index: int      # first event NOT fully processed (resume point)
    offered: int
    admitted: int
    deferred: int
    rate_limited: int
    verdicts: Tuple[AdmissionVerdict, ...]


def drive(service: StreamService, events: Sequence[Event], *,
          make_mat: Callable[[Arrival], PaddedCOO],
          start_index: int = 0, keep_verdicts: bool = False) -> DriveResult:
    """Feed the event stream into the service from ``start_index``.

    Open-loop: a deferred/rate-limited push is counted and dropped (the
    modeled client retries on its own clock). On :class:`InjectedCrash`
    the result's ``next_index`` points at the crashed event — a recovered
    service resumes by re-running exactly that event."""
    offered = admitted = deferred = rate_limited = 0
    verdicts: List[AdmissionVerdict] = []
    for i in range(start_index, len(events)):
        ev = events[i]
        try:
            if ev.kind == "tick":
                service.tick(ev.t)
            else:
                offered += 1
                v = service.push(ev.arrival.tenant, make_mat(ev.arrival),
                                 ev.t)
                if keep_verdicts:
                    verdicts.append(v)
                if v.admitted:
                    admitted += 1
                elif v.reason == "deferred":
                    deferred += 1
                else:
                    rate_limited += 1
        except InjectedCrash:
            return DriveResult(False, i, offered, admitted, deferred,
                               rate_limited, tuple(verdicts))
    return DriveResult(True, len(events), offered, admitted, deferred,
                       rate_limited, tuple(verdicts))


def summarize(service: StreamService, result: DriveResult, *,
              duration: float, replayed: int = 0) -> dict:
    """The serving numbers: streams/sec, latency percentiles, shed rate."""
    stats = service.stats()
    evicted_nnz = sum(t["evicted_nnz"] for t in stats["tenants"].values())
    admitted_nnz = sum(t["admitted_nnz"] for t in stats["tenants"].values())
    p50, p99 = latency_percentiles(service.flush_latencies)
    return {
        "streams_per_sec": result.admitted / duration,
        "offered": result.offered,
        "admitted": result.admitted,
        "deferred": result.deferred,
        "rate_limited": result.rate_limited,
        "p50_flush_latency": p50,
        "p99_flush_latency": p99,
        "flushes": stats["flushes"],
        "shed_rate": (evicted_nnz / admitted_nnz) if admitted_nnz else 0.0,
        "evicted_nnz": evicted_nnz,
        "admitted_nnz": admitted_nnz,
        "pending_nnz": stats["pending_nnz"],
        "replayed_records": replayed,
    }


def _write_bench_json(path: str, records: List[dict], **meta) -> None:
    """BENCH_*.json in the benchmarks/common schema, without importing the
    benchmarks package (the launcher must run with only ``src`` on path)."""
    payload = {"meta": {"timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                   time.gmtime()), **meta},
               "records": records}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {len(records)} records to {path}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tenants", type=int, default=32)
    ap.add_argument("--duration", type=float, default=10.0,
                    help="simulated seconds of open-loop arrivals")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="per-tenant arrivals/sec")
    ap.add_argument("--shape", type=int, nargs=2, default=(64, 16))
    ap.add_argument("--nnz", type=int, default=32, help="nnz per push")
    ap.add_argument("--batch-k", type=int, default=4)
    ap.add_argument("--cap", type=int, default=1024,
                    help="per-tenant running-sum budget")
    ap.add_argument("--deadline", type=float, default=0.5)
    ap.add_argument("--tick-every", type=float, default=0.25)
    ap.add_argument("--overload", type=float, default=0.0,
                    help="0 = watermarks sized to fit the offered load; "
                         "x>0 = soft watermark at offered/(1+x) (overload)")
    ap.add_argument("--journal", default=None, metavar="DIR")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device of the service (default: the CUDA card)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write BENCH_stream_service.json records")
    args = ap.parse_args(argv)

    shape = tuple(args.shape)
    # offered pending-nnz scale: what one deadline's worth of arrivals pins
    offered_nnz = args.tenants * args.rate * args.nnz * args.deadline
    soft = int(offered_nnz / (1.0 + args.overload)) + args.nnz \
        if args.overload > 0 else int(4 * offered_nnz) + args.nnz
    service = StreamService(soft_pending_nnz=soft,
                            hard_pending_nnz=2 * soft,
                            flush_deadline=args.deadline,
                            journal_root=args.journal,
                            device=args.device)
    replayed = 0
    for i in range(args.tenants):
        replayed += service.register_tenant(
            tenant_name(i), shape, cap_budget=args.cap,
            batch_k=args.batch_k)
    events = build_workload(n_tenants=args.tenants, duration=args.duration,
                            rate=args.rate, tick_every=args.tick_every,
                            seed=args.seed)
    result = drive(service, events,
                   make_mat=lambda a: make_matrix(shape, args.nnz,
                                                  a.mat_seed,
                                                  device=service.device))
    service.drain(args.duration)
    s = summarize(service, result, duration=args.duration,
                  replayed=replayed)
    records = [{"name": f"stream/loadgen/{k}", "value": float(v),
                "derived": ""}
               for k, v in s.items() if isinstance(v, (int, float))]
    for r in records:
        print(f"{r['name']},{r['value']:.3f},", flush=True)
    if args.json:
        _write_bench_json(args.json, records, suite="stream_serve",
                          tenants=args.tenants, duration=args.duration,
                          rate=args.rate, seed=args.seed,
                          device=str(service.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
