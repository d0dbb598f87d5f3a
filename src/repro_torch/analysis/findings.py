"""Finding model, rule registry, and waiver parsing for spkaddlint.

The port of ``src/repro/analysis/findings.py``: the same findings,
waivers and rule IDs where the invariant is the same; each rule's text
says what it means in the port.

A *finding* is one violated contract: rule ID, location, message, and a
fix-it the author can apply mechanically. Findings are plain data so the
CLI can render them for humans or dump JSON for the CI gate.

Waivers are inline comments::

    order = torch.argsort(keys)  # spkaddlint: disable=SPK101

A waiver on the flagged line (or the line directly above it) marks the
finding ``waived``: it still appears in reports but does not fail the
gate. Trace-layer rules have no source line to anchor to; they are
disabled globally via the CLI's ``--disable`` flag instead.
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Set


class Rule(NamedTuple):
    rule: str        # "SPK101"
    title: str       # short name
    invariant: str   # the contract the rule proves (DESIGN.md §10 table)


#: Every rule spkaddlint knows. SPK1xx are AST (source) rules over
#: ``src/repro_torch``; SPKJ2xx are trace rules over the port's entry points
#: (the reference's jaxpr rules). The invariant column states the
#: paper-level bound each rule protects.
RULES: Dict[str, Rule] = {r.rule: r for r in [
    Rule("SPK101", "direct-sort",
         "torch.sort/torch.argsort/Tensor.sort/Tensor.argsort only inside "
         "core/sparse.py — every sort must pass through "
         "sparse.stable_argsort/stable_sort (counted) or sparse.top_k (the "
         "reference's lax.top_k, uncounted) so the one-sort invariant stays "
         "countable"),
    Rule("SPK102", "private-import",
         "no jax or repro import anywhere in the port, and private torch "
         "modules (torch._*, torch.x._y) only inside compat.py — a torch "
         "release that moves one stays a one-file problem"),
    Rule("SPK103", "adhoc-counter",
         "no `global` state outside repro_torch.obs — counters go through "
         "the obs.metrics registry so observables cannot fork"),
    Rule("SPK104", "span-boundary",
         "obs.span only as a `with` context and only at launch boundaries "
         "(engine/streaming/allreduce/ops, obs/launch/runtime/serve/train) — "
         "spans inside a kernel's wrapper would time its enqueue, not its "
         "work"),
    Rule("SPK105", "traced-nondeterminism",
         "no host time/stdlib randomness in core/, kernels/, models/ — the "
         "engine and the models must be replay-deterministic (randomness "
         "comes from a seeded torch.Generator the caller threads)"),
    Rule("SPK106", "bare-assert",
         "no bare `assert` in src/repro_torch — asserts vanish under "
         "`python -O`, so argument validation must raise ValueError "
         "(internal invariants may carry an inline waiver; test files are "
         "not scanned)"),
    Rule("SPK107", "hash-table-discipline",
         "the hash kernels' wrappers (kernels/hash*.py) size tables only "
         "through hash_table_size (pow2, load factor <= 0.5 — no inline "
         "doubling loops). The reference's other half, a bounded guard on "
         "every probe while_loop, is not carried over: the port's probe "
         "loops are CUDA C++ in kernels/csrc, outside the Python AST"),
    Rule("SPK108", "torn-write",
         "no write-mode open() directly on a durable path (journal / spool "
         "/ checkpoint / snapshot tokens in the path expression) — durable "
         "bytes land on a `.tmp` sibling and arrive via os.replace, so a "
         "crash mid-write can never leave a torn record at the real path "
         "(the invariant the stream-service chaos cells exercise)"),
    Rule("SPKJ201", "one-sort",
         "each engine entry point issues its regime's exact stable-sort "
         "count (1 for the partitioned regimes; max(1, k-1) for tree), "
         "counted twice: by sparse.sort_calls() and by a dispatch mode that "
         "sees every ATen sort outside a kernel's plain twin and the top-k "
         "selection — the paper's one-shared-sort discipline over every "
         "regime x batch shape"),
    Rule("SPKJ202", "index-dtype",
         "no int64/uint64 index tensor reaches a kernel — index arithmetic "
         "stays int32 end to end (checked at each kernel wrapper's "
         "boundary, where the plain twins run on the CPU, and on the card "
         "at the C entry points the built libraries export)"),
    Rule("SPKJ203", "step-table",
         "partition_steps schedules every payload (chunk, part) pair "
         "exactly once with non-decreasing tables — consecutive output-tile "
         "revisits are what let one block own a tile and walk its chunks "
         "in order, and keep input loads I/O-optimal"),
    Rule("SPKJ204", "smem-budget",
         "the launch working set (tile + double-buffered inputs) fits the "
         "backend's cap — one thread block's opt-in shared memory on a "
         "CUDA card, the reference's 16 MiB VMEM on the CPU — proven "
         "before anything runs"),
]}


class Finding(NamedTuple):
    rule: str      # rule ID from RULES
    path: str      # repo-relative source path, or "<trace:...>" label
    line: int      # 1-based source line; 0 for trace findings
    message: str   # what is wrong, concretely
    fixit: str     # how to fix it, mechanically
    waived: bool = False

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        tag = " [waived]" if self.waived else ""
        return f"{loc}: {self.rule}{tag}: {self.message}\n    fix: {self.fixit}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "fixit": self.fixit,
                "waived": self.waived}


_WAIVER_RE = re.compile(r"#\s*spkaddlint:\s*disable=([A-Za-z0-9_,\s]+)")


def parse_waivers(source: str) -> Dict[int, Set[str]]:
    """Map of 1-based line number -> waived rule IDs on that line."""
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _WAIVER_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def is_waived(waivers: Dict[int, Set[str]], line: int, rule: str) -> bool:
    """A waiver applies on the flagged line or the line directly above."""
    for ln in (line, line - 1):
        rules = waivers.get(ln)
        if rules and (rule in rules or "all" in rules):
            return True
    return False


def active(findings: List[Finding]) -> List[Finding]:
    """Findings that gate (non-waived)."""
    return [f for f in findings if not f.waived]
