"""repro_torch.analysis — spkaddlint for the port: proofs of the engine's
contracts, the counterpart of ``repro.analysis``.

Two layers:

- :mod:`repro_torch.analysis.ast_rules` — stdlib-``ast`` source rules
  (SPK1xx) over ``src/repro_torch``: sort discipline, the import boundary
  (no jax, no ``repro``, private torch only in ``compat.py``), the
  obs.metrics registry monopoly, span placement, host nondeterminism,
  asserts, hash-table sizing, torn writes.
- :mod:`repro_torch.analysis.trace_rules` — rules over runs of the entry
  points (SPKJ2xx): the one-sort invariant across every regime x batch
  shape, int32 indices at kernel boundaries, step-table legality, and the
  shared-memory working-set budget (:mod:`repro_torch.analysis.smem`).

CLI: ``python -m repro_torch.analysis.cli --all --json PATH``.
"""
from repro_torch.analysis.findings import Finding, RULES, active, parse_waivers

__all__ = ["Finding", "RULES", "active", "parse_waivers"]
