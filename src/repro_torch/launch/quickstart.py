"""Quickstart: SpKAdd in five minutes, on the port.

The twin of ``examples/quickstart.py``: builds k random sparse matrices
(the reference script's numpy draws), adds them with every algorithm in the
family, checks each against a dense oracle, and shows the symbolic phase
and compression factor — the paper's §II in executable form. Then the two
engine entry points most callers should use instead of hand-picking:
``spkadd_auto`` (regime-aware dispatch per the paper's Fig. 2 regions) and
``spkadd_batched`` (B independent collections summed in one call).

    PYTHONPATH=src python -m repro_torch.launch.quickstart            # the card
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.engine import (explain_dispatch, spkadd_auto,
                                     spkadd_batched, stack_collections,
                                     unstack_collection)
from repro_torch.core.sparse import from_dense, resolve_device
from repro_torch.core.spkadd import ALGORITHMS, spkadd, symbolic_nnz


def random_matrix(rng, m: int, n: int, nnz: int) -> np.ndarray:
    d = np.zeros((m, n), np.float32)
    idx = rng.choice(m * n, nnz, replace=False)
    d.flat[idx] = rng.standard_normal(nnz)
    return d


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    m, n, k, nnz = 256, 32, 8, 400

    mats, dense_sum = [], np.zeros((m, n), np.float32)
    for _ in range(k):
        d = random_matrix(rng, m, n, nnz)
        dense_sum += d
        mats.append(from_dense(torch.from_numpy(d).to(dev), cap=nnz))

    print(f"adding k={k} sparse {m}x{n} matrices, {nnz} nnz each "
          f"({dev.type})")
    nnz_b = int(symbolic_nnz(mats))
    cf = k * nnz / nnz_b
    print(f"symbolic phase: nnz(B) = {nnz_b}, compression factor cf = "
          f"{cf:.2f}")

    for alg in ALGORITHMS:
        out = spkadd(mats, algorithm=alg)
        err = float(np.abs(out.to_dense().cpu().numpy() - dense_sum).max())
        if not err < 1e-5:
            raise SystemExit(f"{alg}: max|err| {err:.2e} against the dense "
                             f"oracle")
        print(f"  {alg:12s}: nnz={int(out.nnz):6d}  max|err|={err:.2e}")
    print("all algorithms agree with the dense oracle ✓")

    # -- the engine: don't hand-pick, dispatch on the regime ----------------
    sig, picked = explain_dispatch(mats)
    auto = spkadd_auto(mats)
    ref = spkadd(mats, algorithm="sorted")
    print(f"\nspkadd_auto: k={sig.k} density={sig.density:.3f} "
          f"cf~{sig.compression:.2f} -> dispatched to {picked!r}")
    if not (torch.equal(auto.keys, ref.keys) and torch.equal(
            auto.vals.view(torch.int32), ref.vals.view(torch.int32))):
        raise SystemExit("spkadd_auto differs from the sorted reference")
    print("spkadd_auto output is bit-identical to the sorted reference ✓")

    # -- batched: B collections, one call -----------------------------------
    B = 4
    colls = [[from_dense(torch.from_numpy(random_matrix(rng, m, n, nnz)
                                          ).to(dev), cap=nnz)
              for _ in range(k)] for _ in range(B)]
    batched = spkadd_batched(stack_collections(colls))
    for b in range(B):
        got = unstack_collection([batched], b)[0]
        want = spkadd_auto(colls[b])
        if not torch.equal(got.vals.view(torch.int32),
                           want.vals.view(torch.int32)):
            raise SystemExit(f"spkadd_batched row {b} differs from the loop")
    print(f"spkadd_batched: {B} collections in one call match the loop ✓")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
