"""spkaddlint for the port: prove the engine's kernel contracts.

    python -m repro_torch.analysis.cli --all --json PATH

The counterpart of ``src/repro/analysis/cli.py``. Two layers:

- ``--ast``   fast stdlib-only source rules (SPK101-108) over
  ``src/repro_torch``
- ``--trace`` trace rules (SPKJ201-204) over the port's engine entry
  points, run on ``--device`` (``cpu``, or ``cuda`` on a card)
- ``--all``   both (the default when neither is given)

Exit status is 0 iff no non-waived finding was produced; ``--json PATH``
writes the machine-readable findings.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from repro_torch.analysis.findings import Finding, RULES, active

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.cli",
        description="static analysis of the SpKAdd engine's kernel contracts")
    p.add_argument("--ast", action="store_true",
                   help="run the AST source rules (SPK1xx)")
    p.add_argument("--trace", action="store_true",
                   help="run the trace rules (SPKJ2xx)")
    p.add_argument("--device", default="cpu",
                   help="device the trace rules run on (cpu | cuda)")
    p.add_argument("--all", action="store_true",
                   help="run both layers (default)")
    p.add_argument("--json", metavar="PATH",
                   help="write findings as JSON to PATH")
    p.add_argument("--root", default=_REPO,
                   help="repo root (default: this checkout)")
    p.add_argument("--disable", default="",
                   help="comma-separated rule IDs to disable globally "
                        "(the waiver mechanism for trace rules)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    return p


def _rel_to_repo(findings: List[Finding], src_root: str,
                 root: str) -> List[Finding]:
    """Re-anchor AST finding paths from src/repro_torch-relative to repo-relative
    so editors and CI annotations can open them."""
    prefix = os.path.relpath(src_root, root).replace(os.sep, "/")
    return [f._replace(path=f"{prefix}/{f.path}")
            if not f.path.startswith("<") else f for f in findings]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for r in RULES.values():
            print(f"{r.rule:8s} {r.title:24s} {r.invariant}")
        return 0
    run_ast = args.ast or args.all or not (args.ast or args.trace)
    run_trace = args.trace or args.all or not (args.ast or args.trace)
    disabled = {r.strip() for r in args.disable.split(",") if r.strip()}

    findings: List[Finding] = []
    src_root = os.path.join(args.root, "src", "repro_torch")
    if run_ast:
        from repro_torch.analysis import ast_rules
        findings.extend(_rel_to_repo(ast_rules.scan_tree(src_root),
                                     src_root, args.root))
    if run_trace:
        from repro_torch.analysis import trace_rules
        findings.extend(trace_rules.run(args.device))

    findings = [f._replace(waived=True) if f.rule in disabled else f
                for f in findings]
    gating = active(findings)

    for f in findings:
        print(f.render())
    counts: dict = {}
    for f in gating:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    ok = not gating
    print(f"spkaddlint: {len(gating)} finding(s) "
          f"({len(findings) - len(gating)} waived) — "
          f"{'OK' if ok else 'FAIL'}")

    if args.json:
        payload = {
            "version": 1,
            "root": args.root,
            "layers": {"ast": run_ast, "trace": run_trace},
            "ok": ok,
            "counts": counts,
            "findings": [f.to_dict() for f in findings],
        }
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
