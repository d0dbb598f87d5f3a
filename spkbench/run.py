"""Run one cell of the port's benchmark once and print its result line.

    python3 spkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m spkbench.run ...``) from the root of a checkout. With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device's busy time. The run
needs a CUDA card: without one it exits with 1 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from spkbench import add_src_path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    add_src_path()
    from spkbench import harness

    try:
        out = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), T_START)
    except harness.CellError as e:
        print(f"spkbench: {e}", file=sys.stderr)
        return 1
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"spkbench: the run loaded {loaded}, which the port's "
              f"benchmark may not load", file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(finite(out)), flush=True)
    return 0


def finite(x):
    """``x`` with every infinite or NaN number as null: the line is strict
    JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    raise SystemExit(main())
