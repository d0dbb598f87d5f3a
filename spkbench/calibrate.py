"""Readings that the limits of ``correct`` are set from, for one cell, in
one process: the port's compared numbers over many seeds (each a full
set-up and a short window), and the control's (the reference in the
precision below the configuration's, in the port's place) on a few.

    python3 spkbench/calibrate.py --workload <cell> --seconds 10 \\
        --seeds 1 2 3 ... --control-seeds 7 8 9 \\
        --out chiprun_out/calibrate.json

Needs a CUDA card, as a run does.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from spkbench import add_src_path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    add_src_path()
    import torch

    from spkbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 1
    _, _, cfg, traffic = harness.find_cell(args.workload)
    mod = harness.driver(cfg)
    out = {"workload": args.workload, "program": {}, "control": {}}
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = harness.run(args.workload, seed, args.seconds, False, t0)
        out["program"][seed] = {k: c["value"] for k, c in
                                res["checks"].items()}
        print(f"program seed {seed}: {out['program'][seed]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        out["control"][seed] = mod.control(cfg, traffic, seed, "cuda")
        print(f"control seed {seed}: {out['control'][seed]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
