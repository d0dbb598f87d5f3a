"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 spkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it: ``configs/<config>.json``, ``traffic/<mix>.json`` and
``metrics/<metric>.py``. A configuration names its ``system``, the driver
in ``cells/<system>.py`` that runs it. ``reference/`` holds the yardstick:
the generators, the laws that place nonzeros (``reference/laws/<law>.py``,
named by a configuration or traffic file), the roofline arithmetic and the
plain references that decide ``correct``. ``calibrate.py`` reads the
numbers the limits of ``correct`` are set from. Nothing here imports JAX
or the JAX package.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
HERE = os.path.dirname(os.path.abspath(__file__))


def add_src_path() -> None:
    """Put the checkout's ``src`` first on ``sys.path``, so the port is
    imported from the checkout the benchmark runs in."""
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
