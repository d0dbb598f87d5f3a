"""``BENCHMARK.json`` against the benchmark's contract, and every file a
cell names found by its name."""
import json
import os
import re

import pytest

from spkbench import HERE, ROOT
from spkbench import harness

BENCH_PATH = os.path.join(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(BENCH_PATH) as f:
        return json.load(f)


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert line(word) and not word.startswith("/") and ".." not in word
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word.startswith(p + "/") for p in bench["paths"])


def test_names_units_and_entry_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(("config", c["name"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        names.append(("cell", w["name"]))
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            allowed = {"name", "unit", "better", "source", "workloads"}
            allowed |= ({"bound"} if kind == "end_to_end"
                        else {"layer", "moves"})
            assert set(m) <= allowed and set(m) >= allowed - {"workloads"}
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            names.append(("metric", m["name"]))
    assert len(names) == len(set(names))


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_configs_are_files_under_paths(bench):
    files = set()
    for c in bench["configs"]:
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
        assert os.path.exists(os.path.join(HERE, "cells",
                                           cfg["system"] + ".py"))
        files.add(c["file"])
    assert len(files) == len(bench["configs"])


def test_every_cell_finds_its_files_by_name(bench):
    configs = {c["name"] for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        found, cell, cfg, traffic = harness.find_cell(w["name"])
        assert found == bench
        assert cell == w and harness.driver(cfg) is not None
        for spec in _laws(cfg) + _laws(traffic):
            assert os.path.exists(os.path.join(HERE, "reference", "laws",
                                               spec["law"] + ".py"))
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and line(m["layer"])
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))
        harness.metric_reader(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in bench["workloads"]:
        ends = harness.cell_metrics(bench, w["name"], "end_to_end")
        layers = harness.cell_metrics(bench, w["name"], "per_layer")
        names = {m["name"] for m in ends}
        assert "setup_s" in names and len(names) >= 2
        assert layers and all(m["moves"] in names for m in layers)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_gitignore_lists_what_runs_leave():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = f.read().split()
    assert "chiprun_out/" in ignored
    assert "src/repro_torch/kernels/_build/" in ignored


def _laws(entry):
    """Every ``{"law": ...}`` object inside a configuration or traffic
    file."""
    if isinstance(entry, dict):
        own = [entry] if "law" in entry else []
        return own + [x for v in entry.values() for x in _laws(v)]
    if isinstance(entry, list):
        return [x for v in entry for x in _laws(v)]
    return []


def test_the_stream_service_s_files_are_found_by_name():
    """The stream cell ``BENCHMARK.json`` does not list yet: its
    configuration, traffic, law and metric readers are there for the entries
    a later benchmark adds."""
    from spkbench.tests import tiny

    _, cell, cfg, traffic = harness.find_cell(tiny.STREAM, tiny.STREAM_BENCH)
    assert harness.driver(cfg).__name__.endswith(cfg["system"])
    assert [s["law"] for s in _laws(traffic)] == ["uniform"]
    for m in tiny.STREAM_BENCH["per_layer"]:
        harness.metric_reader(m["name"])


def test_an_unknown_cell_is_an_error():
    with pytest.raises(harness.CellError):
        harness.find_cell("no_such.cell")
