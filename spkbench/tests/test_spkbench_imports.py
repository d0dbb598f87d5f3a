"""Nothing of the benchmark imports JAX, the JAX package ``repro`` or the
old ``benchmarks`` folder, compared by whole top-level names, and a run
loads none of them."""
import ast
import glob
import os
import subprocess
import sys

from spkbench import HERE, ROOT
from spkbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
FILES = sorted(glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True))


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".", 1)[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".", 1)[0]


def test_scan_covers_the_benchmark():
    names = {os.path.relpath(p, HERE) for p in FILES}
    assert {"run.py", "harness.py", "cells/summa_worker.py",
            "cells/stream_service.py", "reference/stream.py",
            "metrics/hash_slide_roofline.py",
            "reference/laws/kronecker.py"} <= names


def test_no_file_imports_a_forbidden_module():
    bad = {os.path.relpath(p, ROOT): sorted(set(top_level_imports(p))
                                            & FORBIDDEN) for p in FILES}
    assert not {k: v for k, v in bad.items() if v}


def test_the_whole_name_is_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_loaded()


def test_a_run_loads_nothing_forbidden():
    code = ("import sys, time; sys.path[:0] = [{root!r}]\n"
            "from spkbench.tests import tiny\n"
            "from spkbench import harness\n"
            "assert tiny.run(tiny.SUMMA)['correct']\n"
            "assert tiny.run(tiny.STREAM)['correct']\n"
            "print(harness.forbidden_loaded())").format(root=ROOT)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
