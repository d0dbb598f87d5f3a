"""Both systems at a size a CPU test run holds, through the harness's own
run, with the look for a card skipped."""
from __future__ import annotations

import time

from spkbench import add_src_path

add_src_path()

SUMMA = "summa_g500_s16_g16.auto"
STREAM = "stream_t64_w15.uniform"

#: The stream service's cell, which ``BENCHMARK.json`` does not list (its
#: runs spread too widely for a bound; see ``PERF.md``), in that file's
#: form: its configuration, traffic and metric readers are the files a
#: later benchmark would name.
STREAM_BENCH = {
    "configs": [{"name": "stream_t64_w15",
                 "file": "spkbench/configs/stream_t64_w15.json"}],
    "workloads": [{"name": STREAM, "config": "stream_t64_w15",
                   "traffic": "uniform", "chips": 1}],
    "end_to_end": [
        {"name": "updates_per_s", "unit": "nnz/s", "workloads": [STREAM]},
        {"name": "flush_p95_ms", "unit": "ms", "workloads": [STREAM]},
        {"name": "setup_s", "unit": "s"}],
    "per_layer": [
        {"name": "push_host_us.stream", "unit": "us",
         "moves": "updates_per_s", "workloads": [STREAM]},
        {"name": "coflush_device_ms.stream", "unit": "ms",
         "moves": "flush_p95_ms", "workloads": [STREAM]},
        {"name": "hash_slide_roofline", "unit": "%",
         "moves": "flush_p95_ms", "workloads": [STREAM]},
        {"name": "idle_share.stream", "unit": "%",
         "moves": "updates_per_s", "workloads": [STREAM]}],
}

#: Overrides of each cell's configuration and traffic: the same code paths
#: on a SCALE 10 graph (1,024 vertices) on an 8 x 8 grid, partials padded
#: to half the 128^2 tile (the largest drawn holds about 5,000), and 4
#: tenants of 64 x 16.
TINY = {
    SUMMA: ({"scale": 10, "grid": 8, "partial_cap": 8192},
            {"pool": 2, "warmup_rounds": 1, "sample_blocks": 3,
             "trace_blocks": 2}),
    STREAM: ({"tenants": 4, "shape": [64, 16], "nnz_per_push": 32,
              "batch_k": 4, "cap_budget": 256},
             {"sim_seconds": 2000.0, "warmup_sim_seconds": 20.0,
              "trace_coflushes": 3}),
}


def bench_of(cell: str):
    """The benchmark entries ``cell`` is found in: ``BENCHMARK.json``'s
    (None) or :data:`STREAM_BENCH`."""
    return STREAM_BENCH if cell == STREAM else None


def run(cell: str, seed: int = 1234, seconds: float = 0.3,
        trace: bool = False) -> dict:
    """One run of ``cell`` on the CPU at its tiny size; the result line's
    object."""
    from spkbench import harness

    cfg, traffic = TINY[cell]
    return harness.run(cell, seed, seconds, trace, time.perf_counter(),
                       device="cpu", chips_check=False, cfg_override=cfg,
                       traffic_override=traffic, bench=bench_of(cell))


def tiny_config(cell: str) -> tuple:
    """``(cfg, traffic)`` of ``cell`` at its tiny size."""
    from spkbench import harness

    _, _, cfg, traffic = harness.find_cell(cell, bench_of(cell))
    over_cfg, over_traffic = TINY[cell]
    return dict(cfg, **over_cfg), dict(traffic, **over_traffic)
