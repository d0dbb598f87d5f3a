"""The result line of a run, driven through the harness on the CPU at each
cell's tiny size, and the command's refusals."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from spkbench import ROOT
from spkbench.tests import tiny

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]
#: Keys the driver ignores; ``checks`` (each compared number beside its
#: limit) comes last.
EXTRA = ["setup_parts", "info", "checks"]


@pytest.mark.parametrize("cell", [tiny.SUMMA, tiny.STREAM])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(cell, trace):
    out = tiny.run(cell, trace=trace)
    want = REQUIRED + (["breakdown"] if trace else []) + EXTRA
    assert list(out) == want
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(out["breakdown"]["idle_gaps"]) <= 10
    else:
        assert "setup_s" in out["metrics"]
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.dumps(out)


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3])
def test_same_seed_same_answer(seed):
    a = tiny.run(tiny.STREAM, seed=seed)
    b = tiny.run(tiny.STREAM, seed=seed)
    assert a["correct"] and b["correct"]
    assert a["checks"] == b["checks"]


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine "
                    "without one")
    r = subprocess.run([sys.executable, "spkbench/run.py", "--workload",
                        tiny.SUMMA, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_command_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "spkbench"), tmp_path / "spkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "spkbench/run.py", "--workload",
                        tiny.SUMMA, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""


def test_unknown_cell_is_refused():
    r = subprocess.run([sys.executable, "spkbench/run.py", "--workload",
                        "no_such.cell", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
