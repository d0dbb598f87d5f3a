"""The port's multi-tenant stream service and load generator against the
reference, on the CPU.

- ``core/stream_service``: a twin of every service test of
  ``tests/test_stream_service.py``; the scenarios that drive a service run
  in both packages (one parametrised test) and must end in equal stats
  dicts, verdicts and running sums (keys, value bytes, nnz, flush counts);
  the journal codec byte for byte (f32 and bf16), and journals crossing
  between the packages in both directions;
- ``runtime/faults``: ``ServiceFaultInjector``'s cuts and crash ordinals;
- ``launch/stream_serve``: ``build_workload``'s events and ``make_matrix``
  (20 seeds at 32 x 8, one at 65,536 x 256); the three chaos cells of
  ``benchmarks/stream_service.py --smoke`` (the benchmark itself is not
  imported) with its counts (replayed 10, bitwise; shed rate 0.09701 with
  2 evicted windows and 23 deferred; 4 quarantined of 14 torn, 11
  replayed), crash_replay's final sums against the reference's own run.

Inputs are made with numpy from a seed and fed to both packages.
Tolerance: bitwise, except where a reference test compares a dense sum
with a float32 numpy sum (rtol 1e-5).
"""
import os
import tempfile
from typing import Any, Callable, NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import stream_service as JSS
from repro.launch import stream_serve as JSV
from repro.runtime import faults as JF
from repro_torch import obs
from repro_torch.core import sparse as TS
from repro_torch.core import stream_service as TSS
from repro_torch.launch import stream_serve as TSV
from repro_torch.runtime import faults as TF

from _torch_parity import jax_from_dense, np_of

CPU = "cpu"


class Side(NamedTuple):
    """One package's service, load generator and faults."""
    name: str
    svc: Any
    serve: Any
    faults: Any
    kw: dict                                # device of a service
    mat: Callable                           # (dense numpy, cap) -> COO


REF = Side("reference", JSS, JSV, JF, {},
           lambda d, cap: jax_from_dense(jnp.asarray(d), cap=cap))
PORT = Side("port", TSS, TSV, TF, {"device": CPU},
            lambda d, cap: TS.from_dense(torch.from_numpy(d), cap=cap))


def sprand(rng, m, n, nnz):
    d = np.zeros((m, n), np.float32)
    idx = rng.choice(m * n, nnz, replace=False)
    d.flat[idx] = rng.standard_normal(nnz)
    return d


def mat(side, rng, shape=(16, 4), nnz=8):
    return side.mat(sprand(rng, *shape, nnz), nnz)


def fingerprint(svc, tenants):
    """Per tenant: (keys, value bytes, nnz, flushes) of the flushed sum."""
    out = {}
    for t in tenants:
        s = svc.value(t)
        out[t] = (np_of(s.keys).tolist(), np_of(s.vals).tobytes(),
                  int(s.nnz), svc.stats()["tenants"][t]["flushes"])
    return out


def service(side, root=None, **kw):
    kw.setdefault("flush_deadline", 0.5)
    return side.svc.StreamService(journal_root=root, **side.kw, **kw)


# ---------------------------------------------------------------------------
# scenarios run in both packages: twins of tests/test_stream_service.py
# ---------------------------------------------------------------------------
# Each returns a comparable outcome; CHECKS hold the reference test's own
# assertions on the port's outcome.

def token_bucket(side, root):
    svc = side.svc.StreamService(**side.kw)
    svc.register_tenant("a", (16, 4), cap_budget=64, rate=2.0, burst=1.0)
    rng = np.random.default_rng(5)
    verdicts = [tuple(svc.push("a", mat(side, rng), now=t))
                for t in (0.0, 0.1, 0.6)]
    return {"verdicts": verdicts, "stats": svc.stats()}


def soft_watermark(side, root):
    svc = side.svc.StreamService(soft_pending_nnz=20, hard_pending_nnz=200,
                                 backoff_base=0.05, backoff_cap=2.0,
                                 backoff_jitter=0.0, **side.kw)
    svc.register_tenant("a", (16, 4), cap_budget=64, batch_k=8)
    svc.register_tenant("b", (16, 4), cap_budget=64, batch_k=8)
    rng = np.random.default_rng(6)
    verdicts = [tuple(svc.push("a", mat(side, rng), now=float(t)))
                for t in range(4)]
    verdicts += [tuple(svc.push("b", mat(side, rng), now=4.0 + i))
                 for i in range(3)]
    return {"verdicts": verdicts, "stats": svc.stats()}


def hard_watermark(side, root):
    svc = side.svc.StreamService(soft_pending_nnz=48, hard_pending_nnz=48,
                                 **side.kw)
    for t in ("cold", "warm", "hot"):
        svc.register_tenant(t, (16, 4), cap_budget=64, batch_k=8)
    rng = np.random.default_rng(7)
    verdicts = [tuple(svc.push("cold", mat(side, rng), now=0.0)),
                tuple(svc.push("warm", mat(side, rng), now=1.0))]
    verdicts += [tuple(svc.push("hot", mat(side, rng), now=2.0 + t))
                 for t in range(4)]
    verdicts.append(tuple(svc.push("hot", mat(side, rng), now=9.0)))
    return {"verdicts": verdicts, "stats": svc.stats(),
            "pending": svc.pending_nnz}


def shed_keeps_flushed(side, root):
    svc = side.svc.StreamService(soft_pending_nnz=24, hard_pending_nnz=32,
                                 **side.kw)
    svc.register_tenant("cold", (16, 4), cap_budget=64, batch_k=2)
    svc.register_tenant("hot", (16, 4), cap_budget=64, batch_k=8)
    rng = np.random.default_rng(8)
    d1, d2 = sprand(rng, 16, 4, 8), sprand(rng, 16, 4, 8)
    svc.push("cold", side.mat(d1, 8), now=0.0)
    svc.push("cold", side.mat(d2, 8), now=0.1)
    svc.drain(0.2)
    svc.push("cold", mat(side, rng), now=0.3)
    for t in range(3):
        svc.push("hot", mat(side, rng), now=1.0 + t)
    svc.push("hot", mat(side, rng), now=4.0)
    return {"stats": svc.stats(), "dense": np_of(svc.dense("cold")),
            "want": d1 + d2, "sums": fingerprint(svc, ["cold", "hot"])}


def coflush(side, root):
    svc = side.svc.StreamService(flush_deadline=0.5, **side.kw)
    for t in ("a", "b"):
        svc.register_tenant(t, (16, 4), cap_budget=60 if t == "a" else 64,
                            batch_k=2)
    buckets = len(svc.stats()["buckets"])
    rng = np.random.default_rng(9)
    totals = {t: np.zeros((16, 4), np.float32) for t in ("a", "b")}
    for t in ("a", "b"):
        for i in range(2):
            d = sprand(rng, 16, 4, 8)
            totals[t] += d
            svc.push(t, side.mat(d, 8), now=0.1 * i)
    metrics = jobs.metrics if side is REF else obs.metrics
    before = metrics.counter("engine.ragged.calls").value
    reports = [tuple(r) for r in svc.tick(now=1.0)]
    return {"buckets": buckets, "reports": reports,
            "ragged_calls": metrics.counter("engine.ragged.calls").value
            - before, "sums": fingerprint(svc, ["a", "b"]),
            "dense": {t: np_of(svc.dense(t)) for t in totals},
            "want": totals}


def deadline_and_full(side, root):
    svc = side.svc.StreamService(flush_deadline=1.0, max_coflush_windows=2,
                                 **side.kw)
    svc.register_tenant("a", (16, 4), cap_budget=64, batch_k=1)
    rng = np.random.default_rng(10)
    svc.push("a", mat(side, rng), now=0.0)
    ticks = [svc.tick(now=0.5)]
    svc.push("a", mat(side, rng), now=0.6)
    ticks.append(svc.tick(now=0.7))
    svc.push("a", mat(side, rng), now=1.0)
    ticks += [svc.tick(now=1.5), svc.tick(now=2.1)]
    return {"ticks": [[tuple(r) for r in t] for t in ticks],
            "latencies": list(svc.flush_latencies),
            "sums": fingerprint(svc, ["a"])}


def flushed_only(side, root):
    svc = side.svc.StreamService(**side.kw)
    svc.register_tenant("a", (16, 4), cap_budget=64, batch_k=8)
    rng = np.random.default_rng(11)
    d = sprand(rng, 16, 4, 8)
    svc.push("a", side.mat(d, 8), now=0.0)
    before = int(svc.value("a").nnz)
    svc.drain(1.0)
    return {"before": before, "dense": np_of(svc.dense("a")), "want": d,
            "sums": fingerprint(svc, ["a"])}


def replay_unflushed(side, root):
    svc = service(side, root)
    svc.register_tenant("a", (16, 4), cap_budget=64, batch_k=2)
    rng = np.random.default_rng(12)
    ds = [sprand(rng, 16, 4, 8) for _ in range(3)]
    for i, d in enumerate(ds):
        svc.push("a", side.mat(d, 8), now=0.1 * i)
    fresh = service(side, root)
    replayed = fresh.register_tenant("a", (16, 4), cap_budget=64, batch_k=2)
    pending = (fresh.pending_nnz, svc.pending_nnz)
    fresh.drain(1.0)
    return {"replayed": replayed, "pending": pending,
            "dense": np_of(fresh.dense("a")), "want": sum(ds),
            "sums": fingerprint(fresh, ["a"]), "stats": fresh.stats()}


def never_twice(side, root):
    svc = service(side, root)
    svc.register_tenant("a", (16, 4), cap_budget=64, batch_k=2)
    rng = np.random.default_rng(13)
    for i in range(2):
        svc.push("a", mat(side, rng), now=0.1 * i)
    svc.drain(1.0)
    fresh = service(side, root)
    replayed = fresh.register_tenant("a", (16, 4), cap_budget=64, batch_k=2)
    return {"replayed": replayed, "before": fingerprint(svc, ["a"]),
            "sums": fingerprint(fresh, ["a"]),
            "stats": fresh.stats()["tenants"]["a"],
            "recs": sorted(f for f in os.listdir(os.path.join(root, "a"))
                           if f.startswith("rec_"))}


def torn_record(side, root):
    svc = service(side, root)
    svc.register_tenant("a", (16, 4), cap_budget=64, batch_k=4)
    rng = np.random.default_rng(14)
    for i in range(3):
        svc.push("a", mat(side, rng), now=0.1 * i)
    victim = os.path.join(root, "a", "rec_00000001.bin")
    with open(victim, "rb") as f:
        buf = f.read()
    with open(victim + ".tmp", "wb") as f:
        f.write(buf[:len(buf) // 2])
    os.replace(victim + ".tmp", victim)
    fresh = service(side, root)
    replayed = fresh.register_tenant("a", (16, 4), cap_budget=64, batch_k=4)
    stats = fresh.stats()["tenants"]["a"]
    quarantine = os.listdir(os.path.join(root, "a", "quarantine"))
    fresh.drain(1.0)
    return {"replayed": replayed, "stats": stats, "quarantine": quarantine,
            "sums": fingerprint(fresh, ["a"])}


def mid_flush_crash(side, root):
    shape, cap, batch_k = (16, 4), 64, 2

    def feed(svc):
        rng = np.random.default_rng(15)
        for i in range(4):
            svc.push("a", mat(side, rng), now=0.1 * i)

    ref = service(side, os.path.join(root, "ref"))
    ref.register_tenant("a", shape, cap_budget=cap, batch_k=batch_k)
    feed(ref)
    ref.drain(1.0)
    inj = side.faults.ServiceFaultInjector(
        side.faults.ServiceFaultSpec(crash_at_flush=(1,)))
    crash = service(side, os.path.join(root, "crash"), fault_injector=inj)
    crash.register_tenant("a", shape, cap_budget=cap, batch_k=batch_k)
    feed(crash)
    with pytest.raises(side.faults.InjectedCrash):
        crash.drain(1.0)
    rec = service(side, os.path.join(root, "crash"))
    replayed = rec.register_tenant("a", shape, cap_budget=cap,
                                   batch_k=batch_k)
    rec.drain(1.0)
    return {"replayed": replayed, "ref": fingerprint(ref, ["a"]),
            "sums": fingerprint(rec, ["a"])}


def eviction_journal(side, root):
    svc = service(side, root, soft_pending_nnz=24, hard_pending_nnz=32)
    svc.register_tenant("cold", (16, 4), cap_budget=64, batch_k=8)
    svc.register_tenant("hot", (16, 4), cap_budget=64, batch_k=8)
    rng = np.random.default_rng(16)
    svc.push("cold", mat(side, rng), now=0.0)
    for t in range(3):
        svc.push("hot", mat(side, rng), now=1.0 + t)
    svc.push("hot", mat(side, rng), now=4.0)
    evicted = svc.stats()["tenants"]["cold"]["evicted_windows"]
    fresh = service(side, root)
    return {"evicted": evicted,
            "replayed": [fresh.register_tenant(t, (16, 4), cap_budget=64,
                                               batch_k=8)
                         for t in ("cold", "hot")]}


def check_token_bucket(o):
    v = o["verdicts"]
    assert v[0][1] and not v[1][1] and v[1][2] == "rate_limited"
    assert v[1][3] == pytest.approx((1.0 - 0.2) / 2.0)
    assert v[2][1]
    st = o["stats"]["tenants"]["a"]
    assert st["admitted"] == 2 and st["rate_limited"] == 1


def check_soft_watermark(o):
    assert all(v[1] for v in o["verdicts"][:4])
    assert [v[3] for v in o["verdicts"][4:]] == [
        pytest.approx(0.05), pytest.approx(0.1), pytest.approx(0.2)]
    assert o["stats"]["tenants"]["b"]["deferred"] == 3


def check_hard_watermark(o):
    st = o["stats"]["tenants"]
    assert st["cold"]["evicted_windows"] == 1
    assert st["cold"]["evicted_nnz"] == 8 and st["cold"]["buffered_nnz"] == 0
    assert st["warm"]["evicted_windows"] == 0
    assert st["hot"]["evicted_windows"] == 0
    assert o["verdicts"][-1][1] and o["pending"] == 48


def check_shed_keeps_flushed(o):
    st = o["stats"]["tenants"]["cold"]
    assert st["evicted_nnz"] == 8 and st["buffered_nnz"] == 0
    np.testing.assert_allclose(o["dense"], o["want"], rtol=1e-5, atol=1e-6)


def check_coflush(o):
    assert o["buckets"] == 1 and o["ragged_calls"] == 1
    assert len(o["reports"]) == 1 and o["reports"][0][2] == 2
    for t in ("a", "b"):
        np.testing.assert_allclose(o["dense"][t], o["want"][t], rtol=1e-5,
                                   atol=1e-6)


def check_deadline_and_full(o):
    t = o["ticks"]
    assert t[0] == [] and len(t[1]) == 1 and t[1][0][3] == 2
    assert t[2] == [] and len(t[3]) == 1
    assert o["latencies"][-1] == pytest.approx(1.1)


def check_flushed_only(o):
    assert o["before"] == 0
    np.testing.assert_allclose(o["dense"], o["want"], rtol=1e-6, atol=1e-7)


def check_replay_unflushed(o):
    assert o["replayed"] == 3 and o["pending"] == (24, 24)
    np.testing.assert_allclose(o["dense"], o["want"], rtol=1e-5, atol=1e-6)


def check_never_twice(o):
    assert o["replayed"] == 0 and o["sums"] == o["before"]
    assert o["stats"]["flushes"] == 1 and o["stats"]["seen"] == 2
    assert o["recs"] == []


def check_torn_record(o):
    assert o["replayed"] == 2 and o["stats"]["quarantined_records"] == 1
    assert o["quarantine"] == ["rec_00000001.bin"]


def check_mid_flush_crash(o):
    assert o["replayed"] == 4 and o["sums"] == o["ref"]


def check_eviction_journal(o):
    assert o["evicted"] == 1 and o["replayed"] == [0, 4]


SCENARIOS = {
    "token_bucket_rate_limits_and_refills": (token_bucket,
                                             check_token_bucket),
    "soft_watermark_defers_new_windows": (soft_watermark,
                                          check_soft_watermark),
    "hard_watermark_sheds_coldest_unflushed_only": (hard_watermark,
                                                    check_hard_watermark),
    "shed_never_touches_flushed_state": (shed_keeps_flushed,
                                         check_shed_keeps_flushed),
    "bucket_coflush_single_engine_call": (coflush, check_coflush),
    "tick_respects_deadline_and_bucket_full": (deadline_and_full,
                                               check_deadline_and_full),
    "value_reads_flushed_state_only": (flushed_only, check_flushed_only),
    "journal_replay_restores_unflushed_windows": (replay_unflushed,
                                                  check_replay_unflushed),
    "flushed_records_never_replay_twice": (never_twice, check_never_twice),
    "torn_journal_record_quarantined": (torn_record, check_torn_record),
    "mid_flush_crash_recovers_bitwise": (mid_flush_crash,
                                         check_mid_flush_crash),
    "eviction_removes_journal_records": (eviction_journal,
                                         check_eviction_journal),
}


def same_outcome(a, b, path="outcome"):
    """Equal outcomes; arrays by bytes."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            same_outcome(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name, tmp_path):
    run, check = SCENARIOS[name]
    outcomes = {}
    for side in (REF, PORT):
        root = tmp_path / side.name
        root.mkdir()
        outcomes[side.name] = run(side, str(root))
    check(outcomes["port"])
    same_outcome(outcomes["reference"], outcomes["port"])


# ---------------------------------------------------------------------------
# port-only twins
# ---------------------------------------------------------------------------

def test_journal_codec_roundtrip_and_torn_rejection():
    keys = np.arange(6, dtype=np.int32)
    vals = np.linspace(-1, 1, 6).astype(np.float32)
    buf = TSS.encode_journal(TSS.REC_MAGIC, {"seq": 7, "t": 1.5}, keys, vals)
    hdr, k2, v2 = TSS.decode_journal(buf, TSS.REC_MAGIC)
    assert hdr["seq"] == 7 and hdr["t"] == 1.5
    np.testing.assert_array_equal(k2, keys)
    assert v2.tobytes() == vals.tobytes()
    for damage in (buf[:3], buf[:-2], b"XXXX" + buf[4:],
                   buf[:-1] + bytes([buf[-1] ^ 0xFF])):
        with pytest.raises(TSS.TornRecordError):
            TSS.decode_journal(damage, TSS.REC_MAGIC)
    with pytest.raises(TSS.TornRecordError):
        TSS.decode_journal(buf, TSS.SNAP_MAGIC)


def test_pow2_bucket():
    assert [TSS.pow2_bucket(c) for c in (1, 2, 3, 64, 65)] == \
        [1, 2, 4, 64, 128]
    with pytest.raises(ValueError):
        TSS.pow2_bucket(0)


def test_push_validates_tenant_shape_dtype_device():
    svc = TSS.StreamService(device=CPU)
    svc.register_tenant("a", (16, 4), cap_budget=64)
    rng = np.random.default_rng(4)
    with pytest.raises(ValueError, match="unknown tenant"):
        svc.push("ghost", mat(PORT, rng), 0.0)
    with pytest.raises(ValueError, match="streams"):
        svc.push("a", mat(PORT, rng, shape=(8, 8)), 0.0)
    a = mat(PORT, rng)
    with pytest.raises(ValueError, match="float"):
        svc.push("a", a._replace(vals=a.vals.to(torch.bfloat16)), 0.0)
    with pytest.raises(ValueError, match="lives on"):
        svc.push("a", a._replace(keys=a.keys.to("meta")), 0.0)
    with pytest.raises(ValueError, match="already registered"):
        svc.register_tenant("a", (16, 4), cap_budget=64)


def test_buffer_pool_shares_empties_across_tenants():
    svc = TSS.StreamService(device=CPU)
    obs.metrics.reset("stream_service.pool.")
    svc.register_tenant("a", (16, 4), cap_budget=64)
    svc.register_tenant("b", (16, 4), cap_budget=64)
    svc.register_tenant("c", (32, 4), cap_budget=64)
    assert obs.metrics.counter("stream_service.pool.hit").value == 1
    assert obs.metrics.counter("stream_service.pool.miss").value == 2
    assert svc.value("a") is svc.value("b")


def test_shared_empty_survives_a_coflush():
    """Two tenants start from one pooled empty; flushing one leaves the
    other's (and the pool's) buffer all-sentinel zeros."""
    svc = TSS.StreamService(device=CPU)
    for t in ("a", "b"):
        svc.register_tenant(t, (16, 4), cap_budget=64, batch_k=1)
    empty = svc.value("b")
    keys0, vals0 = empty.keys.clone(), empty.vals.clone()
    svc.push("a", mat(PORT, np.random.default_rng(17)), now=0.0)
    svc.drain(1.0)
    assert svc.value("b") is empty
    assert torch.equal(empty.keys, keys0) and torch.equal(empty.vals, vals0)
    assert int(svc.value("a").nnz) == 8


def test_register_validates_arguments():
    svc = TSS.StreamService(device=CPU)
    with pytest.raises(ValueError, match="tenant id"):
        svc.register_tenant("bad/../name", (16, 4), cap_budget=64)
    with pytest.raises(ValueError, match="batch_k"):
        svc.register_tenant("a", (16, 4), cap_budget=64, batch_k=0)
    with pytest.raises(ValueError, match="rate"):
        svc.register_tenant("a", (16, 4), cap_budget=64, rate=0.0)
    with pytest.raises(ValueError, match="watermarks"):
        TSS.StreamService(soft_pending_nnz=10, hard_pending_nnz=5,
                          device=CPU)
    with pytest.raises(ValueError, match="flush_deadline"):
        TSS.StreamService(flush_deadline=0.0, device=CPU)


def test_latency_percentiles_match_reference():
    lat = list(np.random.default_rng(18).exponential(0.3, 101))
    assert TSS.latency_percentiles(lat) == JSS.latency_percentiles(lat)
    assert TSS.latency_percentiles([]) == (0.0, 0.0)


# ---------------------------------------------------------------------------
# journal bytes across the packages
# ---------------------------------------------------------------------------

def test_encode_journal_is_byte_identical_to_reference():
    rng = np.random.default_rng(19)
    keys = rng.integers(0, 512, 9).astype(np.int32)
    vals = rng.standard_normal(9).astype(np.float32)
    vals[2], vals[5] = -0.0, np.nan
    hdr = {"tenant": "t-1", "seq": 3, "shape": [16, 32], "nnz": 9,
           "t": 0.30000000000000004}
    for magic in (TSS.REC_MAGIC, TSS.SNAP_MAGIC):
        want = JSS.encode_journal(magic, hdr, keys, vals)
        assert TSS.encode_journal(magic, hdr, keys, vals) == want
        assert TSS.encode_journal(magic, hdr, torch.from_numpy(keys),
                                  torch.from_numpy(vals)) == want
    bf = np.asarray(jnp.asarray(vals, jnp.bfloat16))
    want = JSS.encode_journal(TSS.REC_MAGIC, hdr, keys, bf)
    got = TSS.encode_journal(
        TSS.REC_MAGIC, hdr, torch.from_numpy(keys),
        torch.from_numpy(bf.view(np.int16).copy()).view(torch.bfloat16))
    assert got == want
    hdr2, _, v2 = TSS.decode_journal(got, TSS.REC_MAGIC)
    assert hdr2["dtype"] == "bfloat16" and v2.tobytes() == bf.tobytes()
    coo = TSS._coo_from_record(hdr2, keys, v2, CPU)
    assert coo.vals.dtype == torch.bfloat16
    assert coo.vals.view(torch.int16).numpy().tobytes() == bf.tobytes()


def journal_run(side, root, events, *, crash_at=None):
    """Four tenants of the crash_replay cell's size through ``events``; a
    crash stops the run (the journal is left as the crash left it)."""
    inj = side.faults.ServiceFaultInjector(side.faults.ServiceFaultSpec(
        crash_at_flush=(crash_at,) if crash_at else ()))
    svc = service(side, root, fault_injector=inj)
    for i in range(4):
        svc.register_tenant(side.serve.tenant_name(i), (32, 8),
                            cap_budget=64, batch_k=3)
    res = side.serve.drive(svc, events, make_mat=lambda a: cell_matrix(
        side, a))
    return svc, res


def cell_matrix(side, arrival):
    if side is REF:
        return JSV.make_matrix((32, 8), 16, arrival.mat_seed)
    return TSV.make_matrix((32, 8), 16, arrival.mat_seed, device=CPU)


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["reference_to_port", "port_to_reference"])
def test_journal_recovers_across_packages(tmp_path, writer, reader):
    """A service crashes mid-flush with snapshots (capacity 64: truncated
    sums) and unflushed records on disk; the other package recovers it,
    resumes at the crashed event and ends with the writer's own
    uninterrupted bits."""
    events = TSV.build_workload(n_tenants=4, duration=4.0, rate=3.0,
                                tick_every=0.25, seed=33)
    names = [TSV.tenant_name(i) for i in range(4)]
    whole, _ = journal_run(writer, str(tmp_path / "whole"), events)
    whole.drain(4.0)
    root = str(tmp_path / "crash")
    _, res = journal_run(writer, root, events, crash_at=4)
    assert not res.completed
    rec = service(reader, root)
    replayed = sum(rec.register_tenant(n, (32, 8), cap_budget=64, batch_k=3)
                   for n in names)
    assert replayed > 0
    reader.serve.drive(rec, events, make_mat=lambda a: cell_matrix(reader, a),
                       start_index=res.next_index)
    rec.drain(4.0)
    assert fingerprint(rec, names) == fingerprint(whole, names)
    assert any(int(whole.value(n).nnz) == 64 for n in names)  # truncated


# ---------------------------------------------------------------------------
# faults and the load generator
# ---------------------------------------------------------------------------

def test_service_fault_injector_cuts_match_reference():
    spec = dict(torn_write_p=0.4, crash_at_flush=(2, 5), seed=23)
    ji = JF.ServiceFaultInjector(JF.ServiceFaultSpec(**spec))
    ti = TF.ServiceFaultInjector(TF.ServiceFaultSpec(**spec))
    rng = np.random.default_rng(24)
    for size in rng.integers(1, 200, 60):
        buf = rng.bytes(int(size))
        assert ti.mangle_record(buf) == ji.mangle_record(buf)
    crashes = []
    for flush in range(1, 7):
        for inj, exc in ((ji, JF.InjectedCrash), (ti, TF.InjectedCrash)):
            try:
                inj.maybe_crash_flush()
            except exc:
                crashes.append((inj is ti, flush))
    assert crashes == [(False, 2), (True, 2), (False, 5), (True, 5)]
    assert dict(ti.injected) == dict(ji.injected)
    assert ti.injected["torn_write"] > 0


@pytest.mark.parametrize("bad", [dict(torn_write_p=1.5),
                                 dict(crash_at_flush=(0,)),
                                 dict(burst_factor=0),
                                 dict(stall_from=2.0, stall_until=1.0)])
def test_service_fault_spec_validates(bad):
    with pytest.raises(ValueError):
        TF.ServiceFaultSpec(**bad).validate()


@pytest.mark.parametrize("kw", [
    dict(n_tenants=4, duration=6.0, rate=2.0, tick_every=0.25, seed=17),
    dict(n_tenants=8, duration=4.0, rate=10.0, tick_every=0.25, seed=25,
         cold_tenants=("tenant0000", "tenant0001"), cold_until=0.5,
         faults="stall"),
    dict(n_tenants=3, duration=3.0, rate=5.0, tick_every=0.5, seed=8,
         faults="burst"),
])
def test_build_workload_matches_reference(kw):
    kw = dict(kw)
    fault = kw.pop("faults", None)
    spec = {"stall": dict(stall_tenants=("tenant0003", "tenant0005"),
                          stall_from=0.2, stall_until=1.5),
            "burst": dict(burst_at=(1.0,), burst_factor=1)}.get(fault)
    ref = JSV.build_workload(
        **kw, faults=JF.ServiceFaultSpec(**spec) if spec else None)
    port = TSV.build_workload(
        **kw, faults=TF.ServiceFaultSpec(**spec) if spec else None)
    assert [tuple(e) for e in port] == [tuple(e) for e in ref]
    assert any(e.kind == "tick" for e in port)


def assert_same_matrix(ref, port):
    np.testing.assert_array_equal(np_of(port.keys), np.asarray(ref.keys))
    assert np_of(port.vals).tobytes() == np.asarray(ref.vals).tobytes()
    assert int(port.nnz) == int(ref.nnz) and tuple(port.shape) == ref.shape


def test_make_matrix_matches_reference_at_cell_size():
    for seed in range(20):
        assert_same_matrix(JSV.make_matrix((32, 8), 16, seed),
                           TSV.make_matrix((32, 8), 16, seed, device=CPU))
    # more nonzeros asked than the matrix holds: capacity still nnz
    assert_same_matrix(JSV.make_matrix((4, 2), 12, 5),
                       TSV.make_matrix((4, 2), 12, 5, device=CPU))


def test_make_matrix_matches_reference_at_full_width():
    seed = 1 << 29
    assert_same_matrix(JSV.make_matrix((65536, 256), 512, seed),
                       TSV.make_matrix((65536, 256), 512, seed, device=CPU))


# ---------------------------------------------------------------------------
# the three chaos cells of benchmarks/stream_service.py --smoke
# ---------------------------------------------------------------------------

SHAPE, NNZ, CAP = (32, 8), 16, 256


def smoke_matrix(side):
    if side is REF:
        return lambda a: JSV.make_matrix(SHAPE, NNZ, a.mat_seed)
    return lambda a: TSV.make_matrix(SHAPE, NNZ, a.mat_seed, device=CPU)


def steady(side, root, fault_injector=None):
    return side.svc.StreamService(soft_pending_nnz=1 << 20,
                                  hard_pending_nnz=1 << 21,
                                  flush_deadline=0.5, journal_root=root,
                                  fault_injector=fault_injector, **side.kw)


def test_crash_replay_cell_matches_reference():
    names = [TSV.tenant_name(i) for i in range(4)]
    events = TSV.build_workload(n_tenants=4, duration=6.0, rate=2.0,
                                tick_every=0.25, seed=17)
    mk = smoke_matrix(PORT)
    states = {}
    with tempfile.TemporaryDirectory() as ref_dir, \
            tempfile.TemporaryDirectory() as crash_dir, \
            tempfile.TemporaryDirectory() as jax_dir:
        for side, root in ((REF, jax_dir), (PORT, ref_dir)):
            svc = steady(side, root)
            for n in names:
                svc.register_tenant(n, SHAPE, cap_budget=CAP, batch_k=3)
            res = side.serve.drive(svc, events, make_mat=smoke_matrix(side))
            svc.drain(6.0)
            states[side.name] = fingerprint(svc, names)
        assert res.admitted == 57 and svc.flush_ordinal == 6
        inj = TF.ServiceFaultInjector(TF.ServiceFaultSpec(
            crash_at_flush=(3,), seed=17))
        svc = steady(PORT, crash_dir, inj)
        for n in names:
            svc.register_tenant(n, SHAPE, cap_budget=CAP, batch_k=3)
        res = TSV.drive(svc, events, make_mat=mk)
        assert not res.completed and inj.injected["crash"] == 1
        rec = steady(PORT, crash_dir)
        replayed = sum(rec.register_tenant(n, SHAPE, cap_budget=CAP,
                                           batch_k=3) for n in names)
        res2 = TSV.drive(rec, events, make_mat=mk, start_index=res.next_index)
        rec.drain(6.0)
        assert res2.completed and replayed == 10
        assert sum(t["quarantined_records"]
                   for t in rec.stats()["tenants"].values()) == 0
        assert fingerprint(rec, names) == states["port"] == \
            states["reference"]


def test_overload_shed_cell_counts():
    cold = [TSV.tenant_name(i) for i in range(4)]
    hot = [TSV.tenant_name(4 + i) for i in range(4)]
    svc = TSS.StreamService(soft_pending_nnz=512, hard_pending_nnz=576,
                            flush_deadline=0.5, device=CPU)
    for n in cold:
        svc.register_tenant(n, SHAPE, cap_budget=CAP, batch_k=16)
    for n in hot:
        svc.register_tenant(n, SHAPE, cap_budget=CAP, batch_k=4)
    events = TSV.build_workload(
        n_tenants=8, duration=4.0, rate=10.0, tick_every=0.25, seed=25,
        cold_tenants=cold, cold_until=0.5,
        faults=TF.ServiceFaultSpec(stall_tenants=tuple(hot), stall_from=0.0,
                                   stall_until=0.5))
    res = TSV.drive(svc, events, make_mat=smoke_matrix(PORT))
    s = TSV.summarize(svc, res, duration=4.0)
    st = svc.stats()["tenants"]
    assert s["shed_rate"] == pytest.approx(0.09701, abs=5e-6)
    assert sum(t["evicted_windows"] for t in st.values()) == 2
    assert res.deferred == 23 and res.admitted == 134
    assert sum(st[n]["flushes"] for n in hot) == 16
    assert sum(st[n]["evicted_nnz"] for n in hot) == 0
    assert all(t["admitted_nnz"] == t["evicted_nnz"] + t["buffered_nnz"]
               + t["flushed_nnz"] for t in st.values())
    assert 0.0 < s["p99_flush_latency"] <= 1.5


def test_torn_journal_cell_counts():
    names = [TSV.tenant_name(i) for i in range(3)]
    events = TSV.build_workload(n_tenants=3, duration=4.0, rate=4.0,
                                tick_every=0.25, seed=31)
    with tempfile.TemporaryDirectory() as root:
        inj = TF.ServiceFaultInjector(TF.ServiceFaultSpec(torn_write_p=0.3,
                                                          seed=31))
        svc = steady(PORT, root, inj)
        for n in names:
            svc.register_tenant(n, SHAPE, cap_budget=CAP, batch_k=4)
        TSV.drive(svc, events, make_mat=smoke_matrix(PORT))
        expected_torn = expected_good = 0
        for n in names:
            for fn in sorted(os.listdir(os.path.join(root, n))):
                if not fn.startswith("rec_"):
                    continue
                with open(os.path.join(root, n, fn), "rb") as f:
                    buf = f.read()
                try:
                    TSS.decode_journal(buf, TSS.REC_MAGIC)
                    expected_good += 1
                except TSS.TornRecordError:
                    expected_torn += 1
        rec = steady(PORT, root)
        replayed = sum(rec.register_tenant(n, SHAPE, cap_budget=CAP,
                                           batch_k=4) for n in names)
        quarantined = sum(t["quarantined_records"]
                          for t in rec.stats()["tenants"].values())
        files = sum(len(os.listdir(os.path.join(root, n, "quarantine")))
                    for n in names)
        rec.drain(4.0)
        assert inj.injected["torn_write"] == 14
        assert quarantined == files == expected_torn == 4
        assert replayed == expected_good == 11
        assert rec.flush_ordinal >= 1
