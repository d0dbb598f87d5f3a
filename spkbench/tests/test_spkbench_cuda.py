"""On a card: each cell of ``BENCHMARK.json`` runs through the command,
short, and comes out correct with its metrics (``python -m pytest -m cuda spkbench/tests``)."""
import json
import subprocess
import sys

import pytest
import torch

from spkbench import ROOT
from spkbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_bench()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "spkbench/run.py", "--workload",
                        cell, "--seed", "2147483659", "--seconds", "3",
                        "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    bench = harness.load_bench()
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.cell_metrics(bench, cell, kind)}
    assert set(out["metrics"]) == want
    assert out["device"]["platform"] == "gpu"
    assert r.stderr.strip().splitlines()[-1].startswith("check ")
