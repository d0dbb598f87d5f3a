"""One run of a cell with the port's spans on in its measured window, and
the SUMMA block's device time split by stage.

    python3 spkbench/span_split.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a card. It runs ``harness.run`` as
``run.py`` does, but brackets the cell's ``window`` with the port's spans
(``program_spans.switch_on`` / ``switch_off``), and prints the result line
with the readings of :data:`METRICS` (``metrics/<name>.py``) under
``span_metrics``, the gaps by host span under ``info.span_gaps`` and the
shared clock's check under ``info.clock_lead_us``. The profiled units of
``--trace 1`` run with spans off, as in ``run.py``, and
``info.profiled_gemm_ms`` is the profiler's ``gemm`` device ms a traced
block. With ``--trace 0`` the line's ``block_ms`` is the window's with
spans on: against ``run.py``'s on the same seed, what spans cost.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from spkbench import add_src_path, program_spans  # noqa: E402

#: The per-layer readings of the port's spans, each ``metrics/<name>.py``.
METRICS = ("stage_matmul_ms.summa", "from_dense_ms.summa", "plan_ms.summa",
           "accumulate_ms.summa", "gather_ms.summa", "to_dense_ms.summa",
           "span_gap_ms.summa")


def spanned(mod, recs: list, traced: list):
    """``mod`` with its ``window`` run under the port's spans (their
    records into ``recs``) and its ``traced`` noting the Trace it fills."""
    def window(state, seconds, spans):
        program_spans.switch_on()
        try:
            return mod.window(state, seconds, spans)
        finally:
            recs.extend(program_spans.switch_off())

    def trace_units(state, tr):
        tr.program_spans = recs
        traced.append(tr)
        return mod.traced(state, tr)

    return types.SimpleNamespace(setup=mod.setup, window=window,
                                 traced=trace_units, check=mod.check)


def clock_lead_us(recs: list, parts: int = 10) -> list:
    """For each tenth of the window's blocks in turn, the least over their
    leaves of the enter event's time on the card less the leaf's host
    entry, in us. The host records the event after its entry, so on a true
    shared clock this is never below 0; where the card was idle it is the
    event's latency, plus the anchor's error."""
    leads = [min(r["dev_start_ns"] - r["t_ns"] for r in leaves)
             for _, _, leaves in program_spans.blocks(recs)]
    n = len(leads)
    return [min(leads[i * n // parts:(i + 1) * n // parts]) / 1e3
            for i in range(parts) if (i + 1) * n // parts > i * n // parts]


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, **kw) -> dict:
    """``harness.run`` with the port's spans on in the window, and the
    readings of :data:`METRICS` and the gaps by host span added."""
    from spkbench import harness

    recs, traced = [], []
    cell_module = harness.driver
    harness.driver = lambda cfg: spanned(cell_module(cfg), recs, traced)
    try:
        out = harness.run(workload, seed, seconds, trace, t_start, **kw)
    finally:
        harness.driver = cell_module
    got = types.SimpleNamespace(program_spans=recs)
    out["span_metrics"] = {name: harness.metric_reader(name)(got)
                           for name in METRICS}
    out["info"]["span_gaps"] = program_spans.gaps_by_host(recs)
    out["info"]["span_blocks"] = len(program_spans.blocks(recs))
    out["info"]["clock_lead_us"] = clock_lead_us(recs)
    if traced:
        tr = traced[0]
        units = tr.ranges.get("spkbench.block", [0.0, 0])[1]
        out["info"]["profiled_gemm_ms"] = (tr.kernel_s("gemm") * 1e3 / units
                                           if units else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    add_src_path()
    from spkbench import harness
    from spkbench.run import finite

    try:
        out = run(args.workload, args.seed, args.seconds, bool(args.trace),
                  T_START)
    except harness.CellError as e:
        print(f"spkbench: {e}", file=sys.stderr)
        return 1
    print(json.dumps(finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
