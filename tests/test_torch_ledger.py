"""The port's perf-history ledger (``repro_torch.obs.ledger``) against the
reference's (``repro.obs.ledger``).

- Every ledger test of ``tests/test_obs.py`` (append and dedup by key, the
  file round trip, the rolling-baseline regression gate, the tracked
  oracle patterns) and the two ``missing_baselines`` tests of
  ``tests/test_analysis.py``, replayed on the port.
- Both packages' ``append_bench`` on the same payloads give byte-identical
  ledger files, and ``check_regressions`` / ``missing_baselines`` give the
  same lines on them.
- The port's backends (``torch-cpu``, ``torch-cuda``) keep its series apart
  from the reference's in one ledger.
"""
import json

import pytest

from repro.obs import ledger as ref_ledger
from repro_torch.obs import ledger


def payload(suite, names_vals, backend="cpu"):
    return {"meta": {"suite": suite, "backend": backend,
                     "timestamp": "2026-08-08T00:00:00Z"},
            "records": [{"name": n, "value": v, "derived": ""}
                        for n, v in names_vals]}


def test_ledger_append_and_dedup_by_key(tmp_path):
    hist = str(tmp_path / "history")
    ledger.append_bench(hist, payload("s1", [("io/x/onepass_loads", 4)]),
                        commit="aaa")
    ledger.append_bench(hist, payload("s1", [("io/x/onepass_loads", 5)]),
                        commit="bbb")
    assert len(ledger.load(hist)) == 2
    # same key (commit, backend, suite, geometry) -> replace, not duplicate
    ledger.append_bench(hist, payload("s1", [("io/x/onepass_loads", 6)]),
                        commit="bbb")
    entries = ledger.load(hist)
    assert len(entries) == 2
    assert entries[-1]["records"][0]["value"] == 6
    # a different geometry under the same commit is a distinct key
    ledger.append_bench(hist, payload("s1", [("io/x/onepass_loads", 9)]),
                        commit="bbb", geometry="h100")
    assert len(ledger.load(hist)) == 3


def test_ledger_file_round_trip(tmp_path):
    hist = str(tmp_path / "history")
    bench = tmp_path / "BENCH_x.json"
    bench.write_text(json.dumps(payload("sx", [("smoke/serial_stores", 128)])))
    entry = ledger.append_bench_file(hist, str(bench), commit="ccc")
    assert entry["key"]["suite"] == "sx"
    loaded = ledger.load(hist)
    assert loaded == [entry]


def test_regression_gate_pass_and_fail_on_synthetic_history(tmp_path):
    hist = str(tmp_path / "history")
    for i, commit in enumerate(["c1", "c2", "c3"]):
        ledger.append_bench(
            hist, payload("spkadd_io_smoke", [("io/a/onepass_loads", 10),
                                              ("untracked/metric", 100 * i)]),
            commit=commit)
    # flat trajectory (and a wildly-moving untracked series): clean
    assert ledger.check_regressions(ledger.load(hist)) == []
    # within tolerance: clean
    ledger.append_bench(hist, payload("spkadd_io_smoke",
                                      [("io/a/onepass_loads", 10.4)]),
                        commit="c4")
    assert ledger.check_regressions(ledger.load(hist), rel_tol=0.05) == []
    # injected synthetic regression: the gate trips with a readable message
    ledger.append_bench(hist, payload("spkadd_io_smoke",
                                      [("io/a/onepass_loads", 20)]),
                        commit="c5")
    problems = ledger.check_regressions(ledger.load(hist), rel_tol=0.05)
    assert len(problems) == 1
    assert "io/a/onepass_loads" in problems[0] and "c5" in problems[0]
    # improvements never trip (lower is better)
    ledger.append_bench(hist, payload("spkadd_io_smoke",
                                      [("io/a/onepass_loads", 3)]),
                        commit="c6")
    assert ledger.check_regressions(ledger.load(hist), rel_tol=0.05) == []


def test_tracked_oracle_patterns():
    names = ["io/two_parts/onepass_loads", "smoke/serial_stores",
             "smoke/sort_fold_stores", "allreduce/dense/coll_bytes",
             "allreduce_4x2/topk0.05/gather_kway/coll_bytes",
             "table_er/auto/k=4/d=4", "io/two_parts/read_amplification"]
    tracked = ledger.tracked_names(names)
    assert "io/two_parts/onepass_loads" in tracked
    assert "smoke/serial_stores" in tracked
    assert "allreduce/dense/coll_bytes" in tracked
    assert "allreduce_4x2/topk0.05/gather_kway/coll_bytes" in tracked
    assert "table_er/auto/k=4/d=4" not in tracked
    assert "io/two_parts/read_amplification" not in tracked
    assert ledger.TRACKED_ORACLES == ref_ledger.TRACKED_ORACLES


def test_missing_baselines_reports_every_tracked_family():
    lines = ledger.missing_baselines([])
    assert len(lines) == len(ledger.TRACKED_ORACLES)
    assert all(line.startswith("NO BASELINE ") for line in lines)


def test_missing_baselines_empty_once_families_observed():
    entries = [{
        "key": {"commit": "c0", "backend": "cpu", "suite": "s",
                "geometry": ""},
        "records": [{"name": "io/64x8/onepass_loads", "value": 3.0},
                    {"name": "smoke/serial_stores", "value": 10.0},
                    {"name": "smoke/sort_fold_stores", "value": 4.0},
                    {"name": "allreduce/p4/coll_bytes", "value": 128.0},
                    {"name": "chaos/ef/bytes_per_sync", "value": 700.0},
                    {"name": "chaos/ef/catchup_window_max", "value": 4.0},
                    {"name": "hash/er_small/insert_loads", "value": 512.0},
                    {"name": "hash/er_small/probes_per_insert",
                     "value": 1.0},
                    {"name": "stream/steady/p99_flush_latency", "value": 0.7},
                    {"name": "stream/overload/shed_rate", "value": 0.1}],
    }]
    assert ledger.missing_baselines(entries) == []


#: One trajectory of payloads in both packages' hands: a dedup, a second
#: geometry, a regression, an untracked series, and the port's backends.
TRAJECTORY = [
    ("c1", "", payload("spkadd_io_smoke", [("io/a/onepass_loads", 10),
                                           ("untracked/metric", 1.5)])),
    ("c2", "", payload("spkadd_io_smoke", [("io/a/onepass_loads", 10.2)])),
    ("c2", "", payload("spkadd_io_smoke", [("io/a/onepass_loads", 10.1)])),
    ("c2", "h100", payload("table34_smoke", [("smoke/serial_stores", 64)],
                           backend="torch-cuda")),
    ("c3", "", payload("spkadd_io_smoke", [("io/a/onepass_loads", 30)])),
    ("c3", "", payload("spkadd_io_smoke", [("io/a/onepass_loads", 9)],
                       backend="torch-cpu")),
    ("c4", "h100", payload("table34_smoke", [("smoke/serial_stores", 99)],
                           backend="torch-cuda")),
]


def test_ledger_files_are_byte_identical_across_packages(tmp_path):
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    for commit, geometry, p in TRAJECTORY:
        want = ref_ledger.append_bench(ref_dir, p, commit=commit,
                                       geometry=geometry)
        got = ledger.append_bench(port_dir, p, commit=commit,
                                  geometry=geometry)
        assert got == want
    with open(f"{ref_dir}/{ref_ledger.LEDGER_NAME}", "rb") as f:
        ref_bytes = f.read()
    with open(f"{port_dir}/{ledger.LEDGER_NAME}", "rb") as f:
        assert f.read() == ref_bytes
    ref_entries, entries = ref_ledger.load(ref_dir), ledger.load(port_dir)
    assert entries == ref_entries and len(entries) == 6
    for tol in (0.05, 0.5, 2.0):
        assert ledger.check_regressions(entries, rel_tol=tol) \
            == ref_ledger.check_regressions(ref_entries, rel_tol=tol)
    assert len(ledger.check_regressions(entries)) == 2
    assert ledger.missing_baselines(entries) \
        == ref_ledger.missing_baselines(ref_entries)
    assert ledger.series(entries) == ref_ledger.series(ref_entries)


def test_port_backends_keep_their_series_apart(tmp_path):
    """A reference run and a port run of one suite at one commit are two
    keys and two series; the port's CPU and card runs are two more."""
    assert ledger.backend("cpu") == "torch-cpu"
    assert ledger.backend("cuda:0") == "torch-cuda"
    with pytest.raises(ValueError, match="no ledger backend"):
        ledger.backend("meta")
    hist = str(tmp_path / "history")
    for backend in ("cpu", ledger.backend("cpu"), ledger.backend("cuda")):
        ledger.append_bench(hist, payload("s", [("smoke/serial_stores", 1)],
                                          backend=backend), commit="c")
    entries = ledger.load(hist)
    assert [e["key"]["backend"] for e in entries] == [
        "cpu", "torch-cpu", "torch-cuda"]
    assert sorted(k[0] for k in ledger.series(entries)) == [
        "cpu", "torch-cpu", "torch-cuda"]
