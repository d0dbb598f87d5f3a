"""Time the flushed f32 add (``csrc/xla_add.cu``) on a CUDA card, against
``torch.sub`` and ``torch.add``.

Usage (from the repo root, on a machine with a card)::

    PYTHONPATH=src python src/repro_torch/launch/xla_add_timing.py [--seed 0]

Prints one JSON object. It imports ``repro_torch.kernels.xla_add`` from
whatever ``PYTHONPATH`` names, so pointing ``PYTHONPATH`` at another
checkout's ``src`` times that checkout's kernel on the same inputs: run
several checkouts in turns (A, B, B, A) in one call to compare designs.

Sizes: the leaves of SmolLM-135M that the delta publisher adds (embed and
head 28,311,552 f32; w1-w3 26,542,080; wq and wo 9,953,280; wk and wv
3,317,760; ln1 and ln2 17,280; ``final_ln`` 576). At each, ``a`` and ``b``
are normals drawn on the card from ``--seed`` with subnormal pairs, NaNs
and infinities planted in a seeded sample; the kernel's ``a - b`` and
``a + b`` are checked bitwise against the plain version run on the card
(and, at 17,280, on a view one element off a 16-byte boundary), then the
kernel's subtract and add, ``torch.sub`` and ``torch.add`` are each timed
as the device time a call of 50 queued back to back (median of 5), and
the kernel's subtract also as a median of 20 calls each bracketed by CUDA
events (the host time before a launch included). The bound is 12 bytes
an element over 3.35 TB/s. ``host_us`` is the host time a call of 2,000
calls of the 576-element add enqueued back to back (median of 5): where
the card finishes a call sooner, it is what a bracketed time adds to the
kernel's.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch.launch.combine_timing import (HBM_BYTES_PER_S, cuda_ms,
                                               queued_ms, smi)

#: SmolLM-135M's leaf sizes (elements), largest first.
LEAF_SIZES = (28311552, 26542080, 9953280, 3317760, 17280, 576)
#: Subnormal pairs (each input and results that flush), signed zeros,
#: infinities and NaNs of both signs, planted in both operands.
EDGE_PAIRS = (
    (1e-40, 1e-40), (-1e-40, 0.0), (1.5e-38, 1.4e-38), (-1.4e-38, -1.5e-38),
    (-0.0, -1e-40), (2.0, 1e-40), (1.4e-38, -1.5e-38), (-3e-39, 3e-39),
    (float("inf"), 1.0), (-0.0, 0.0), (float("nan"), 1.0),
    (-float("nan"), -2.0), (float("inf"), float("inf")),
    (float("-inf"), float("inf")), (1.0, -float("nan")))


def host_us(fn, calls: int = 2000, reps: int = 5) -> float:
    """Host µs a call of ``calls`` calls of ``fn`` enqueued back to back
    (median of ``reps``; each run starts on an idle card)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def planted(n: int, gen, dev):
    """``a`` and ``b``: normals with :data:`EDGE_PAIRS` planted in a seeded
    sample of up to 4,096 slots."""
    ab = torch.randn((2, n), generator=gen, device=dev)
    slots = torch.randperm(n, generator=gen, device=dev)[:min(n, 4096)]
    edges = torch.tensor(EDGE_PAIRS, dtype=torch.float32, device=dev)
    pick = torch.randint(0, len(EDGE_PAIRS), (slots.numel(),),
                         generator=gen, device=dev)
    ab[:, slots] = edges[pick].T
    return ab[0].clone(), ab[1].clone()


def same_bits(x, y) -> bool:
    return torch.equal(x.view(torch.int32), y.view(torch.int32))


def time_size(XA, n: int, gen, dev) -> dict:
    a, b = planted(n, gen, dev)
    bitwise = all(
        same_bits(XA.xla_add_raw(a, b, subtract=sub),
                  XA.xla_add_plain(a, b, subtract=sub))
        for sub in (False, True))
    if n == 17280:  # the scalar route: a view one element off
        off = torch.cat([a.new_zeros(1), a])[1:]
        bitwise = bitwise and same_bits(
            XA.xla_add_raw(off, b, subtract=True),
            XA.xla_add_plain(off, b, subtract=True))
    out = {"elements": n, "bitwise_to_plain": bool(bitwise),
           "bytes": 12 * n, "bound_ms": 12 * n / HBM_BYTES_PER_S * 1e3,
           "sub_queued_ms": queued_ms(
               lambda: XA.xla_add_raw(a, b, subtract=True)),
           "add_queued_ms": queued_ms(lambda: XA.xla_add_raw(a, b)),
           "torch_sub_queued_ms": queued_ms(lambda: torch.sub(a, b)),
           "torch_add_queued_ms": queued_ms(lambda: torch.add(a, b)),
           "sub_ms": cuda_ms(lambda: XA.xla_add_raw(a, b, subtract=True),
                             20)}
    out["bound_share_queued"] = out["bound_ms"] / out["sub_queued_ms"]
    if n == min(LEAF_SIZES):
        out["host_us"] = host_us(lambda: XA.xla_add_raw(a, b))
        out["torch_add_host_us"] = host_us(lambda: torch.add(a, b))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="", help="a name for this turn, "
                    "copied into the output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("xla_add_timing: needs a CUDA card")
    from repro_torch.kernels import xla_add as XA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    XA.xla_add_raw(torch.ones(8, device=dev), torch.ones(8, device=dev))
    report = {"label": args.label, "card": smi("name,power.limit"),
              "kernel": XA.__file__,
              "sizes": [time_size(XA, n, gen, dev) for n in LEAF_SIZES]}
    report["routes"] = getattr(XA.xla_add_raw, "routes", None)
    print(json.dumps(report), flush=True)
    return 0 if all(s["bitwise_to_plain"] for s in report["sizes"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
