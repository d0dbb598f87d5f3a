"""``system: stream_service``: the multi-tenant stream service
(``repro_torch.core.stream_service.StreamService``, arXiv:2112.10223 §I's
streaming accumulation of graphs), its events replayed back to back.

The traffic's events (arrivals and scheduler ticks, ``reference/
generators.stream_events``) are drawn at set-up, and so is every push, as
COO on the device. The loop is closed: each event is handed to the service
(``push`` or ``tick``) as soon as the one before has returned, with the
event's simulated time as the service's clock, so flush groupings follow
the simulated clock and not the speed of the card. A tick that co-flushes
ends in a synchronize. The journal, when the configuration has it, lies in
a fresh directory under ``TMPDIR`` and is removed at the end.

``correct``: once the window has closed the service is drained, and every
tenant's running sum (keys and values) and counts are compared with the
plain replay of the same events (``reference/stream.py``).
"""
from __future__ import annotations

import contextlib
import shutil
import tempfile
import time

import numpy as np
import torch

from spkbench.harness import Check, Window, percentile, sync
from spkbench.reference import generators as gens
from spkbench.reference import stream as ref


def tenant_name(i: int) -> str:
    return f"tenant{i:04d}"


def setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    from repro_torch.core.stream_service import StreamService

    m, n = cfg["shape"]
    t0 = time.perf_counter()
    events = gens.stream_events(
        seed, tenants=cfg["tenants"], rate=traffic["rate_per_tenant"],
        sim_seconds=traffic["sim_seconds"], tick_every=traffic["tick_every"])
    count = int((events.tenant >= 0).sum())
    pushes = gens.coo_pushes(
        gens.torch_generator(seed, (1,), device), count, m=m, n=n,
        nnz=cfg["nnz_per_push"], law=traffic["positions"], device=device)
    journal = (tempfile.mkdtemp(prefix="spkbench-journal-")
               if cfg["journal"] else None)
    svc = StreamService(soft_pending_nnz=cfg["soft_pending_nnz"],
                        hard_pending_nnz=cfg["hard_pending_nnz"],
                        flush_deadline=cfg["flush_deadline"],
                        max_coflush_windows=cfg["max_coflush_windows"],
                        journal_root=journal, algorithm=cfg["algorithm"],
                        device=device)
    names = [tenant_name(i) for i in range(cfg["tenants"])]
    for name in names:
        svc.register_tenant(name, (m, n), cap_budget=cfg["cap_budget"],
                            batch_k=cfg["batch_k"])
    st = {"cfg": cfg, "traffic": traffic, "device": device, "svc": svc,
          "events": events, "pushes": pushes, "names": names,
          "journal": journal, "next": 0,
          "nnz": torch.full((count,), cfg["nnz_per_push"], dtype=torch.int32,
                            device=device)}
    sync(device)
    t1 = time.perf_counter()
    run_events(st, until_t=traffic["warmup_sim_seconds"])
    st["setup_parts"] = {"inputs_s": t1 - t0,
                         "warmup_s": time.perf_counter() - t1}
    return st


def _push_matrix(st: dict, k: int):
    from repro_torch.core.sparse import PaddedCOO

    return PaddedCOO(keys=st["pushes"].keys[k], vals=st["pushes"].vals[k],
                     nnz=st["nnz"][k], shape=tuple(st["cfg"]["shape"]))


def run_events(st: dict, *, deadline: float = float("inf"),
               coflushes: int = 0, until_t: float = float("inf"),
               spans: bool = False, trace=None) -> dict:
    """Hand events to the service until the clock passes ``deadline``, the
    simulated clock reaches ``until_t`` or, with ``coflushes``, that many
    ticks have co-flushed. Returns the
    pushes offered and admitted, each co-flushing tick's wall ms (from the
    tick to the synchronize after it), the nonzeros those co-flushes
    folded, and with ``spans`` each push call's host microseconds. With
    ``trace``, each push and each tick lies in a range of its own."""
    svc, ev, device = st["svc"], st["events"], st["device"]
    out = {"offered": 0, "admitted": 0, "flush_ms": [], "folded": 0,
           "push_us": []}
    i = st["next"]
    while True:
        if i >= ev.t.size:
            raise RuntimeError("the traffic's events ran out before the run "
                               "ended: raise its sim_seconds")
        tenant, t = int(ev.tenant[i]), float(ev.t[i])
        rng = (trace.range("spkbench.tick" if tenant < 0 else "spkbench.push")
               if trace is not None else contextlib.nullcontext())
        if tenant < 0:
            with rng:
                t0 = time.perf_counter()
                reports = svc.tick(t)
                if reports:
                    sync(device)
                    out["flush_ms"].append((time.perf_counter() - t0) * 1e3)
                    out["folded"] += sum(r.nnz for r in reports)
        else:
            a = _push_matrix(st, int(ev.push[i]))
            with rng:
                t0 = time.perf_counter()
                verdict = svc.push(st["names"][tenant], a, t)
            if spans:
                out["push_us"].append((time.perf_counter() - t0) * 1e6)
            out["offered"] += 1
            out["admitted"] += int(verdict.admitted)
        i += 1
        st["next"] = i
        if coflushes and len(out["flush_ms"]) >= coflushes:
            return out
        if time.perf_counter() >= deadline or t >= until_t:
            return out


def window(st: dict, seconds: float, spans: bool) -> Window:
    sync(st["device"])
    t_begin = time.perf_counter()
    got = run_events(st, deadline=t_begin + seconds, spans=spans)
    window_s = time.perf_counter() - t_begin
    e2e = {"updates_per_s": got["folded"] / window_s,
           "flush_p95_ms": (percentile(got["flush_ms"], 95)
                            if got["flush_ms"] else float("inf"))}
    return Window(e2e=e2e, attempted=got["offered"],
                  failed=got["offered"] - got["admitted"],
                  spans={"push_us": got["push_us"],
                         "flush_ms": got["flush_ms"]} if spans else {},
                  info={"coflushes": len(got["flush_ms"]), "window_s": window_s,
                        "events_done": st["next"],
                        "sim_t": float(st["events"].t[st["next"] - 1]),
                        "flush_ms_median": (percentile(got["flush_ms"], 50)
                                            if got["flush_ms"] else None)})


def traced(st: dict, tr) -> None:
    """Events up to ``trace_coflushes`` more co-flushes under the profiler,
    each push and tick in a range of its own; the sliding-hash launches
    note their bytes."""
    from repro_torch.kernels import hash_slide

    launch = hash_slide.hash_slide_raw
    valid, distinct = [], []

    def counted(keys, vals, *, mn, **kw):
        tkeys, tvals = launch(keys, vals, mn=mn, **kw)
        valid.append((keys < mn).sum())
        distinct.append((tkeys >= 0).sum())
        return tkeys, tvals

    counted.launches = launch.launches  # the port counts its launches
    hash_slide.hash_slide_raw = counted
    try:
        with tr.profile() as prof:
            tr.settle()
            with tr.range("spkbench.traced_window"):
                got = run_events(st, trace=tr,
                                 coflushes=st["traffic"]["trace_coflushes"])
    finally:
        hash_slide.hash_slide_raw = launch
        launch.launches = counted.launches
    tr.read(prof, "spkbench.traced_window")
    tr.work["coflushes"] = len(got["flush_ms"])
    tr.work["hash_slide.bytes"] = 8 * (sum(int(v) for v in valid)
                                       + sum(int(d) for d in distinct))


def state_of(st: dict) -> tuple:
    """Every tenant's (keys, vals) host arrays and counts, after a drain."""
    svc = st["svc"]
    last_t = float(st["events"].t[st["next"] - 1])
    svc.drain(last_t)
    sync(st["device"])
    values, counts = {}, {}
    stats = svc.stats()["tenants"]
    for i, name in enumerate(st["names"]):
        v = svc.value(name)
        k = int(v.nnz)
        values[i] = (v.keys[:k].cpu().numpy().astype(np.int64),
                     v.vals[:k].float().cpu().numpy())
        counts[i] = {c: stats[name][c] for c in ("admitted", "deferred",
                                                 "flushed_windows",
                                                 "flushes")}
    return values, counts, last_t


def check(st: dict) -> dict:
    """The drained service against the plain replay of the same events."""
    values, counts, last_t = state_of(st)
    del st["svc"]
    if st["journal"]:
        shutil.rmtree(st["journal"], ignore_errors=True)
    ev, upto = st["events"], st["next"]
    used = int(ev.push[:upto].max()) + 1
    keys = st["pushes"].keys[:used].cpu().numpy().astype(np.int64)
    vals = st["pushes"].vals[:used].cpu().numpy()
    want = ref.replay(st["cfg"], ev, upto, keys, vals, last_t)
    lim = st["cfg"]["limits"]
    return {"value_gap": Check(ref.value_gap(values, want), lim["value_gap"]),
            "count_gap": Check(ref.count_gap(counts, want), 0)}


def control(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The control's readings on ``seed``'s events up to the traffic's
    ``control_sim_seconds``:
    the reference computed in bfloat16 (``reference/stream.py``) in the
    port's place, against the float32 reference, by the numbers ``check``
    compares."""
    m, n = cfg["shape"]
    events = gens.stream_events(
        seed, tenants=cfg["tenants"], rate=traffic["rate_per_tenant"],
        sim_seconds=traffic["sim_seconds"], tick_every=traffic["tick_every"])
    upto = int(np.searchsorted(events.t, traffic["control_sim_seconds"],
                               side="right"))
    used = int(events.push[:upto].max()) + 1
    pushes = gens.coo_pushes(
        gens.torch_generator(seed, (1,), device), int((events.tenant >= 0)
                                                      .sum()),
        m=m, n=n, nnz=cfg["nnz_per_push"], law=traffic["positions"],
        device=device)
    keys = pushes.keys[:used].cpu().numpy().astype(np.int64)
    vals = pushes.vals[:used].cpu().numpy()
    last_t = float(events.t[upto - 1])
    want = ref.replay(cfg, events, upto, keys, vals, last_t)
    low = ref.replay(cfg, events, upto, keys, vals, last_t, "bfloat16")
    values = {i: (t.keys, t.vals) for i, t in enumerate(low.tenants)}
    counts = {i: dict(t.counts) for i, t in enumerate(low.tenants)}
    return {"value_gap": ref.value_gap(values, want),
            "count_gap": ref.count_gap(counts, want)}
