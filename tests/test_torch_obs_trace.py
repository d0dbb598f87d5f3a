"""The port's spans (``repro_torch.obs.trace``): host time on the profiler's
wall clock, device time from CUDA events placed on the same clock through
an anchor, the switch read once, the JSONL export; the SUMMA block's span
tree; the benchmark's readers of those spans (``spkbench/program_spans.py``
and ``spkbench/metrics``) on synthetic records; the lint's span rule.

The CPU cases drive the device path with stand-in CUDA events. The cases
marked ``cuda`` check on a card that each leaf span's device interval holds
the kernels the profiler records for it (run with
``python -m pytest -m cuda tests/test_torch_obs_trace.py``).
"""
import json
import os
import sys
import time

import pytest
import torch

from repro_torch import obs
from repro_torch.analysis import ast_rules
from repro_torch.core import spgemm
from repro_torch.core.engine import COST_MODEL_ENV
from repro_torch.obs import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from spkbench import harness, program_spans  # noqa: E402

#: The cost model that makes the engine take the ``vec`` regime (the
#: partitioned launch) at any size.
VEC = {"tree_max_k": 0, "spa_max_accum_elems": 1.0,
       "hash_min_total_nnz": 1e18, "vec_min_density": 0.0,
       "vec_max_accum_elems": float(1 << 40)}

#: The leaves a SUMMA block of ``stages`` stages gives, in finish order,
#: and their enclosing spans, as ``(name, depth)``.
def block_tree(stages):
    return ([("spgemm.stage_matmul", 1), ("spgemm.from_dense", 1)] * stages
            + [("engine.concat", 2), ("engine.plan", 3),
               ("engine.accumulate", 3), ("engine.partitioned_launch", 2),
               ("engine.canonical_gather", 2), ("engine.spkadd_auto", 1),
               ("spgemm.to_dense", 1), ("spgemm.summa_block", 0)])


@pytest.fixture
def spans_on():
    obs.clear()
    obs.set_enabled(True)
    try:
        yield
    finally:
        obs.set_enabled(None)
        obs.clear()


@pytest.fixture
def vec_model(tmp_path, monkeypatch):
    path = tmp_path / "vec.json"
    path.write_text(json.dumps(VEC))
    monkeypatch.setenv(COST_MODEL_ENV, str(path))


def stripes(seed, m, k, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.rand(m, k, generator=g, device=device)
    a = torch.where(torch.rand(m, k, generator=g, device=device) < 0.1, a, 0.0)
    b = torch.rand(k, m, generator=g, device=device)
    b = torch.where(torch.rand(k, m, generator=g, device=device) < 0.1, b, 0.0)
    return a, b


# ---------------------------------------------------------------------------
# stand-in CUDA events: a device clock the test moves by hand
# ---------------------------------------------------------------------------

class FakeDevice:
    """``now``: the device clock in ns; events recorded at or before
    ``done`` have completed."""

    def __init__(self):
        self.now = 1_000_000
        self.done = float("inf")
        self.created = 0
        self.records = 0
        self.syncs = 0


def fake_cuda(monkeypatch, dev: FakeDevice):
    """Make ``trace`` see an initialised card whose events are stand-ins."""

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            dev.created += 1
            self.t = None

        def record(self):
            dev.records += 1
            self.t = dev.now

        def query(self):
            return self.t is not None and self.t <= dev.done

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            assert self.query() and other.query()
            return (other.t - self.t) / 1e6

    def synchronize():
        dev.syncs += 1

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(trace, "_anchors", {})
    monkeypatch.setattr(trace, "_pools", {})


# ---------------------------------------------------------------------------
# the switch, host time, export
# ---------------------------------------------------------------------------

def test_spans_off_make_no_record_event_or_profiler_range(monkeypatch):
    dev = FakeDevice()
    fake_cuda(monkeypatch, dev)

    def no_range(name):
        raise AssertionError(f"record_function({name!r}) with spans off")

    monkeypatch.setattr(trace, "record_function", no_range)
    obs.clear()
    obs.set_enabled(False)
    try:
        sp = obs.span("off", k=1)
        assert sp is trace._NULL
        with sp as s:
            s.set_attr("x", 2)
        a, b = stripes(0, 8, 32)
        spgemm.summa_block(a, b, 4)
        assert obs.spans() == []
    finally:
        obs.set_enabled(None)
    assert dev.created == 0 and dev.records == 0 and dev.syncs == 0


def test_switch_is_read_once_and_again_by_set_enabled_none(monkeypatch):
    monkeypatch.setenv(trace.OBS_ENV, "1")
    obs.set_enabled(None)
    try:
        assert obs.enabled()
        monkeypatch.setenv(trace.OBS_ENV, "0")
        assert obs.enabled()  # not read again on its own
        assert obs.span("x") is not trace._NULL
        obs.set_enabled(None)
        assert not obs.enabled()
        monkeypatch.setenv(trace.OBS_ENV, "yes")
        assert not obs.enabled()
        obs.set_enabled(None)
        assert obs.enabled()
        obs.set_enabled(False)
        assert not obs.enabled()
        assert obs.span("x") is trace._NULL  # the override beats the env
    finally:
        monkeypatch.delenv(trace.OBS_ENV, raising=False)
        obs.set_enabled(None)
        obs.clear()
    assert not obs.enabled()


def profiler_ranges(prof):
    """``{name: [(start_ns, end_ns)]}`` of the profiler's host events on
    its absolute clock (``trace_start_ns()`` + each event's offset)."""
    t0 = prof.profiler.kineto_results.trace_start_ns()
    out = {}
    for e in prof.events():
        out.setdefault(e.name, []).append(
            (t0 + e.time_range.start * 1000, t0 + e.time_range.end * 1000))
    return out


def test_host_interval_lies_in_its_profiler_range_on_the_wall_clock(spans_on):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("outer"):
            time.sleep(0.004)
            with obs.span("inner"):
                time.sleep(0.006)
    ranges = profiler_ranges(prof)
    recs = {r["name"]: r for r in obs.spans()}
    slack = 1_000_000  # 1 ms
    for name in ("outer", "inner"):
        (lo, hi), = ranges[name]
        r = recs[name]
        assert lo - slack <= r["t_ns"]
        assert r["t_ns"] + r["dur_ns"] <= hi + slack
        assert r["dev_start_ns"] is None and r["dev_ns"] is None
    assert recs["inner"]["dur_ns"] >= 6_000_000
    assert recs["outer"]["dur_ns"] >= recs["inner"]["dur_ns"] + 4_000_000
    assert abs(recs["outer"]["t_ns"] - time.time_ns()) < 60 * 10**9


def test_jsonl_round_trip_with_null_device_fields_on_the_cpu(tmp_path,
                                                             spans_on):
    with obs.span("outer", k=2):
        with obs.span("inner") as sp:
            sp.set_attr("n", torch.tensor(3))
    path = tmp_path / "spans.jsonl"
    assert obs.export_jsonl(str(path)) == 2
    inner, outer = obs.read_jsonl(str(path))
    keys = {"name", "t_ns", "dur_ns", "depth", "parent", "attrs",
            "dev_start_ns", "dev_ns"}
    assert set(inner) == keys and set(outer) == keys
    assert inner["dev_start_ns"] is None and inner["dev_ns"] is None
    assert inner["attrs"] == {"n": 3} and inner["parent"] == "outer"
    assert outer == {k: v for k, v in obs.spans()[1].items()}


# ---------------------------------------------------------------------------
# device time through stand-in events
# ---------------------------------------------------------------------------

def test_device_times_on_the_anchor_clock(monkeypatch, spans_on):
    dev = FakeDevice()
    fake_cuda(monkeypatch, dev)
    t_before = time.time_ns()
    obs.set_enabled(True)  # anchors: one synchronize, one event
    t_after = time.time_ns()
    assert dev.syncs == 1 and dev.created == 1
    anchor_t = dev.now
    dev.now += 5_000  # the card reaches the span 5 us after the anchor
    with obs.span("a"):
        dev.now += 250_000
        with obs.span("b"):
            dev.now += 40_000
    assert dev.syncs == 1  # spans never synchronize
    b, a = obs.spans()
    assert a["dev_ns"] == 290_000 and b["dev_ns"] == 40_000
    assert b["dev_start_ns"] - a["dev_start_ns"] == 250_000
    start = a["dev_start_ns"] - (dev.now - 290_000 - anchor_t)
    assert t_before <= start <= t_after  # the anchor's time_ns


def test_incomplete_pairs_read_null_until_they_complete(monkeypatch,
                                                        spans_on):
    dev = FakeDevice()
    fake_cuda(monkeypatch, dev)
    obs.set_enabled(True)
    dev.done = dev.now
    dev.now += 10
    with obs.span("late"):
        dev.now += 1_000
    rec, = obs.spans()
    assert rec["dev_ns"] is None and rec["dev_start_ns"] is None
    dev.done = float("inf")
    rec, = obs.spans()
    assert rec["dev_ns"] == 1_000


def test_events_are_reused_from_a_pool(monkeypatch, spans_on):
    dev = FakeDevice()
    fake_cuda(monkeypatch, dev)
    obs.set_enabled(True)
    for i in range(500):
        with obs.span("outer", i=i):
            dev.now += 100
            with obs.span("inner"):
                dev.now += 100
    # the anchor, and the pairs of at most two spans in flight and two
    # finished before they are resolved
    assert dev.created <= 1 + 2 * 4
    assert dev.records == 1 + 4 * 500
    recs = obs.spans()
    assert len(recs) == 1000
    assert all(r["dev_ns"] == (100 if r["name"] == "inner" else 200)
               for r in recs)


def test_clear_drops_unresolved_pairs(monkeypatch, spans_on):
    dev = FakeDevice()
    fake_cuda(monkeypatch, dev)
    obs.set_enabled(True)
    dev.done = 0
    with obs.span("never"):
        pass
    assert len(trace._pending) == 1
    obs.clear()
    assert obs.spans() == [] and len(trace._pending) == 0


def test_first_span_after_cuda_starts_anchors_once(monkeypatch, spans_on):
    dev = FakeDevice()
    fake_cuda(monkeypatch, dev)  # spans were switched on before the card
    for _ in range(3):
        with obs.span("x"):
            dev.now += 7
    assert dev.syncs == 1
    assert [r["dev_ns"] for r in obs.spans()] == [7, 7, 7]


# ---------------------------------------------------------------------------
# the SUMMA block's spans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stages", [2, 4])
def test_summa_block_span_tree_and_bits(stages, vec_model, spans_on):
    a, b = stripes(stages, 16, 16 * stages)
    obs.clear()
    c_on = spgemm.summa_block(a, b, stages, partial_cap_per_stage=128)
    recs = obs.spans()
    obs.set_enabled(False)
    c_off = spgemm.summa_block(a, b, stages, partial_cap_per_stage=128)
    assert c_on.numpy().tobytes() == c_off.numpy().tobytes()
    assert [(r["name"], r["depth"]) for r in recs] == block_tree(stages)
    assert [r["attrs"]["stage"] for r in recs
            if r["name"] == "spgemm.from_dense"] == list(range(stages))
    # each leaf lies inside its block's host interval, in order, no overlap
    block = recs[-1]
    leaves = [r for r in recs if r["name"] in program_spans.LEAVES]
    assert len(leaves) == 2 * stages + 5
    end = block["t_ns"]
    for r in leaves:
        assert r["t_ns"] >= end
        end = r["t_ns"] + r["dur_ns"]
    assert end <= block["t_ns"] + block["dur_ns"] + 1_000


def test_summa_block_parents(vec_model, spans_on):
    a, b = stripes(7, 16, 32)
    spgemm.summa_block(a, b, 2, partial_cap_per_stage=64)
    parent = {r["name"]: r["parent"] for r in obs.spans()}
    assert parent["spgemm.stage_matmul"] == "spgemm.summa_block"
    assert parent["engine.concat"] == "engine.spkadd_auto"
    assert parent["engine.plan"] == "engine.partitioned_launch"
    assert parent["engine.accumulate"] == "engine.partitioned_launch"
    assert parent["engine.canonical_gather"] == "engine.spkadd_auto"
    assert parent["spgemm.to_dense"] == "spgemm.summa_block"
    assert parent["spgemm.summa_block"] is None


# ---------------------------------------------------------------------------
# the benchmark's readers, on synthetic records
# ---------------------------------------------------------------------------

def rec(name, depth, t, dur, d0=None, dn=None):
    return {"name": name, "t_ns": t, "dur_ns": dur, "depth": depth,
            "parent": None, "attrs": {}, "dev_start_ns": d0, "dev_ns": dn}


def synthetic_block(t0, *, timed=True):
    """One block in finish order. Device (ns from ``t0``): stage_matmul
    0-1,000, gap 1,000-1,100 (the card waits, the host in from_dense),
    from_dense 1,100-1,600, concat 1,600-1,650, plan 1,650-1,950, gap
    1,950-2,010 (accumulate entered on the host at 1,900: queued),
    accumulate 2,010-2,100, gather 2,100-2,130, gap 2,130-2,150 (the card
    waits, the host in spkadd_auto), to_dense 2,150-2,400."""
    def r(name, depth, h0, h1, d0, d1):
        return rec(name, depth, t0 + h0, h1 - h0,
                   t0 + d0 if timed else None, d1 - d0 if timed else None)
    return [
        r("spgemm.stage_matmul", 1, 0, 50, 0, 1_000),
        r("spgemm.from_dense", 1, 1_050, 1_200, 1_100, 1_600),
        r("engine.concat", 2, 1_210, 1_250, 1_600, 1_650),
        r("engine.plan", 3, 1_260, 1_400, 1_650, 1_950),
        r("engine.accumulate", 3, 1_900, 2_050, 2_010, 2_100),
        r("engine.partitioned_launch", 2, 1_255, 2_055, 1_640, 2_100),
        r("engine.canonical_gather", 2, 2_060, 2_100, 2_100, 2_130),
        r("engine.spkadd_auto", 1, 1_205, 2_145, 1_600, 2_130),
        r("spgemm.to_dense", 1, 2_145, 2_200, 2_150, 2_400),
        r("spgemm.summa_block", 0, -10, 2_210, -5, 2_400),
    ]


class FakeTrace:
    def __init__(self, records):
        self.program_spans = records


SYNTH = synthetic_block(10**12) + synthetic_block(2 * 10**12)

#: ms a block of each leaf reader on :data:`SYNTH`.
LEAF_WANT = {
    "stage_matmul_ms.summa": 1_000e-6,
    "from_dense_ms.summa": 500e-6,
    "plan_ms.summa": 350e-6,
    "accumulate_ms.summa": 90e-6,
    "gather_ms.summa": 30e-6,
    "to_dense_ms.summa": 250e-6,
    "span_gap_ms.summa": 180e-6,
}


@pytest.mark.parametrize("name", sorted(LEAF_WANT))
def test_reader_on_synthetic_spans(name):
    got = harness.metric_reader(name)(FakeTrace(SYNTH))
    assert got == pytest.approx(LEAF_WANT[name], rel=1e-9)


def test_readers_and_gaps_add_up_to_the_blocks_leaf_span():
    total = sum(LEAF_WANT.values())
    # the first leaf's start to the last leaf's end: 2,400 ns a block
    assert total == pytest.approx(2_400e-6, rel=1e-9)


@pytest.mark.parametrize("name", sorted(LEAF_WANT))
def test_reader_reads_nothing_without_device_time(name):
    reader = harness.metric_reader(name)
    assert reader(FakeTrace(synthetic_block(0, timed=False))) is None
    assert reader(FakeTrace([])) is None
    assert reader(object()) is None  # a Trace without program spans


def test_gaps_are_put_down_to_the_innermost_host_span():
    by = dict(program_spans.gaps_by_host(SYNTH))
    # gap 1,000-1,100: midpoint 1,050 lies in from_dense's host interval;
    # 1,950-2,010: accumulate was entered on the host at 1,900, before the
    # gap opened, so the card was not waiting for the host;
    # 2,130-2,150: 2,140 in spkadd_auto only
    assert by == pytest.approx({"spgemm.from_dense": 100e-6,
                                program_spans.QUEUED: 60e-6,
                                "engine.spkadd_auto": 20e-6}, rel=1e-9)
    assert sum(by.values()) == pytest.approx(
        LEAF_WANT["span_gap_ms.summa"], rel=1e-9)


def test_gap_outside_every_span_is_named_so():
    block = synthetic_block(0)
    block[1]["t_ns"] += 10**6  # from_dense's host interval moved away
    block[-1]["t_ns"] += 10**6  # and the block's
    by = dict(program_spans.gaps_by_host(block))
    assert by[program_spans.OUTSIDE] == pytest.approx(100e-6, rel=1e-9)


def test_untimed_or_partial_blocks_are_left_out():
    timed = synthetic_block(0)
    partial = synthetic_block(10**9)
    partial[3]["dev_ns"] = None  # one leaf not resolved
    assert len(program_spans.blocks(timed + partial)) == 1
    assert program_spans.blocks(synthetic_block(0, timed=False)) == []


# ---------------------------------------------------------------------------
# the lint's span rule
# ---------------------------------------------------------------------------

def test_spk104_accepts_spgemm_and_still_flags_sparse():
    good = "from repro_torch import obs\nwith obs.span('x'):\n    pass\n"
    assert ast_rules.scan_source(good, "core/spgemm.py") == []
    fs = ast_rules.scan_source(good, "core/sparse.py")
    assert [f.rule for f in fs] == ["SPK104"]
    with open(os.path.join(REPO, "src", "repro_torch", "core",
                           "spgemm.py")) as f:
        assert ast_rules.scan_source(f.read(), "core/spgemm.py") == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False


def profile_block(a, b, stages, cap):
    """One SUMMA block under the profiler with spans on: ``(records,
    device operations as (start_ns, end_ns, name) on the wall clock)``."""
    from torch.profiler import ProfilerActivity, profile

    spgemm.summa_block(a, b, stages, partial_cap_per_stage=cap)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.05)  # the profiler loses its first milliseconds
        program_spans.switch_on()
        spgemm.summa_block(a, b, stages, partial_cap_per_stage=cap)
        recs = program_spans.switch_off()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    cudat = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    host = {e.name for e in events if e.device_type != cudat}
    ops = sorted((t0 + e.time_range.start * 1000, t0 + e.time_range.end * 1000,
                  e.name) for e in events
                 if e.device_type == cudat and e.name not in host)
    return recs, ops


@pytest.mark.cuda
def test_leaf_device_intervals_hold_their_kernels(cuda):
    """At the benchmark cell's shapes (worker (0, 0) of 16 x 16 on 2^16
    vertices, partials padded to 2^21): every device operation of the block
    lies in one leaf's device interval; each leaf's last operation ends
    within 50 us of its exit event; a leaf the host entered while the card
    was still on an earlier leaf (queued) starts its first operation
    within 50 us of its enter event, and any other leaf no earlier than
    50 us before it (its interval holds the card's wait for its first
    launch)."""
    a, b = stripes(3, 4096, 65536, device="cuda")
    a, b = a * (a > 0.97), b * (b > 0.97)  # about 0.3 % of a stripe
    recs, ops = profile_block(a, b, 16, 1 << 21)
    (block, _, leaves), = program_spans.blocks(recs)
    assert [r["name"] for r in leaves] == [
        n for n, _ in block_tree(16) if n in program_spans.LEAVES]
    slack = 50_000
    lo, hi = block["dev_start_ns"], block["dev_start_ns"] + block["dev_ns"]
    inside = [o for o in ops if o[1] >= lo - slack and o[0] <= hi + slack]
    assert len(inside) > 100
    rows, prev_end = [], None
    for r in leaves:
        s, e = r["dev_start_ns"], r["dev_start_ns"] + r["dev_ns"]
        mine = [o for o in inside if s <= (o[0] + o[1]) / 2 <= e]
        assert mine, r["name"]
        queued = prev_end is not None and r["t_ns"] < prev_end
        rows.append((r["name"], queued, mine[0][0] - s, e - mine[-1][1]))
        prev_end = e
    print("leaves (name, queued, first op start - enter ns, exit - last op "
          "end ns):", json.dumps(rows))
    for name, queued, head, tail in rows:
        assert abs(tail) <= slack, (name, tail)
        assert -slack <= head and (head <= slack or not queued), (name, head)
    assert sum(q for _, q, _, _ in rows) >= len(rows) - 1  # the card is busy
    for o in inside:
        mid = (o[0] + o[1]) / 2
        assert any(r["dev_start_ns"] <= mid <= r["dev_start_ns"] + r["dev_ns"]
                   for r in leaves), o


@pytest.mark.cuda
def test_spans_leave_the_block_bitwise_on_the_card(cuda):
    a, b = stripes(5, 1024, 16384, device="cuda")
    a, b = a * (a > 0.9), b * (b > 0.9)
    obs.set_enabled(False)
    off = spgemm.summa_block(a, b, 16, partial_cap_per_stage=1 << 18)
    program_spans.switch_on()
    on = spgemm.summa_block(a, b, 16, partial_cap_per_stage=1 << 18)
    recs = program_spans.switch_off()
    assert torch.equal(off.view(torch.int32), on.view(torch.int32))
    assert all(r["dev_ns"] is not None and r["dev_ns"] >= 0 for r in recs)
    assert len(program_spans.blocks(recs)) == 1
