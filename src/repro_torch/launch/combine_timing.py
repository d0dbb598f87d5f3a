"""Time the MoE combine's kernel on a CUDA card, against its yardsticks.

Usage (from the repo root, on a machine with a card)::

    PYTHONPATH=src python src/repro_torch/launch/combine_timing.py [--seed 0]

Prints one JSON object. It imports ``repro_torch.kernels.moe_combine``
from whatever ``PYTHONPATH`` names, so pointing ``PYTHONPATH`` at another
checkout's ``src`` times that checkout's kernel on the same inputs: run
two checkouts in turns (A, B, B, A) in one call to compare two designs.

Shapes (T, K, d): the combine of ``chip_smoke.py`` phase ``families``
(Moonshot-16B-A3B's first layer on 8 x 2,048 tokens) in bf16 and f32,
its largest call in phase ``sharding`` part (f) (65,536 tokens) and
Llama4-Scout's at 4,096 tokens (K = 1, d = 5,120). Values are normals
drawn on the card from ``--seed``. For each: the kernel's result bitwise
against its plain version, then the kernel (``moe_combine_raw``),
``torch.sum`` over K (the same bytes moved by a library reduction, which
rounds once), and ``index_add_`` (the library's scatter-add, into a
zero-filled output), each as the device time a call of 50 queued back to
back (median of 5) and the kernel also as a median of 20 calls each
bracketed by CUDA events (host time before a launch included); the bound
is the bytes over 3.35 TB/s.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

#: Card memory rate (bytes/s) of the H100 SXM, as ``chip_smoke.py``.
HBM_BYTES_PER_S = 3.35e12
SHAPES = ((16384, 6, 2048, torch.bfloat16), (65536, 6, 2048, torch.bfloat16),
          (4096, 1, 5120, torch.bfloat16), (16384, 6, 2048, torch.float32))


def cuda_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, calls: int = 50, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_shape(MC, T: int, K: int, d: int, dtype, gen, dev) -> dict:
    contrib = torch.randn((T, K, d), generator=gen, device=dev).to(dtype)
    got = MC.moe_combine_raw(contrib)
    want = MC.moe_combine_plain(contrib)
    bitwise = torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                   else torch.int32),
                          want.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32))
    del got, want
    flat = contrib.reshape(T * K, d)
    tok = torch.arange(T, device=dev).repeat_interleave(K)

    def library():
        return torch.zeros((T, d), dtype=dtype,
                           device=dev).index_add_(0, tok, flat)

    nbytes = contrib.element_size() * (T * K * d + T * d)
    return {
        "shape": [T, K, d], "dtype": str(dtype).split(".")[-1],
        "bitwise_to_plain": bool(bitwise), "bytes": nbytes,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "queued_ms": queued_ms(lambda: MC.moe_combine_raw(contrib)),
        "ms": cuda_ms(lambda: MC.moe_combine_raw(contrib), 20),
        "sum_queued_ms": queued_ms(lambda: contrib.sum(1)),
        "index_add_queued_ms": queued_ms(library, 10),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("combine_timing: needs a CUDA card")
    from repro_torch.kernels import moe_combine as MC

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    report = {"card": smi("name,power.limit"), "kernel": MC.__file__,
              "shapes": [time_shape(MC, *s, gen, dev) for s in SHAPES]}
    print(json.dumps(report), flush=True)
    return 0 if all(s["bitwise_to_plain"] for s in report["shapes"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
