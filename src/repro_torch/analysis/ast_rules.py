"""Layer-2 spkaddlint rules: AST checks over ``src/repro_torch``.

The port of ``src/repro/analysis/ast_rules.py``. Pure stdlib ``ast`` — no
torch import, so this half runs anywhere (it is the fast half a
pre-commit hook runs). Each rule resolves import aliases to dotted names
(``from torch import argsort as a`` -> ``torch.argsort``) instead of string
matching, so renamed imports cannot dodge a rule.

Rule scoping is by repo-relative path under ``src/repro_torch``:

- SPK101 direct-sort: everywhere except ``core/sparse.py`` (the sanctioned
  sort home): ``torch.sort`` / ``torch.argsort`` / ``torch.msort`` and the
  ``.sort()`` / ``.argsort()`` / ``.msort()`` methods of anything that is
  not an imported module (a tensor), unless called with ``key=`` or
  ``reverse=`` (Python's ``list.sort``, which a tensor's sort never takes).
  numpy sorts are host-side and out of scope, as in the reference.
- SPK102 private-import: no ``jax`` (or ``jaxlib``, ``flax``, ``optax``) or
  ``repro`` import anywhere; a private torch module (any component of its
  dotted path after ``torch`` starting with ``_``, or a ``_`` name imported
  from a torch module) only in ``compat.py``.
- SPK103 adhoc-counter (``global``): everywhere except ``obs/``.
- SPK104 span-boundary: ``obs.span`` must be a ``with`` context expression
  and may only appear in :data:`SPAN_ALLOWED_FILES` /
  :data:`SPAN_ALLOWED_DIRS`.
- SPK105 traced-nondeterminism: host time / stdlib randomness calls inside
  :data:`TRACED_DIRS` (host-side packages — launch, runtime, serve, data,
  obs — time their own work legitimately).
- SPK106 bare-assert: no ``assert`` statements anywhere under
  ``src/repro_torch``.
- SPK107 hash-table-discipline: scoped to :data:`HASH_KERNEL_PREFIX`
  (``kernels/hash*.py``): no inline table-size doubling ``while``-loops
  outside the shared ``hash_table_size`` helper, so the pow2 / load-factor
  <= 0.5 sizing rule has exactly one implementation. The reference's other
  half (a bounded guard in every probe ``while_loop`` cond) has no Python
  counterpart: the port's probe loops are CUDA C++ (``kernels/csrc``).
- SPK108 torn-write: no write-mode ``open()`` directly on a durable path
  (one whose expression mentions a :data:`DURABLE_PATH_TOKENS` keyword)
  unless the expression also carries a temp-file token: durable bytes
  must land via the atomic ``tmp + os.replace`` discipline.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional

from repro_torch.analysis.findings import Finding, is_waived, parse_waivers

SORT_HOME = "core/sparse.py"
PRIVATE_HOME = "compat.py"

SPAN_ALLOWED_FILES = {"core/engine.py", "core/spgemm.py",
                      "core/streaming.py", "core/stream_service.py",
                      "core/allreduce.py", "kernels/ops.py"}
SPAN_ALLOWED_DIRS = ("obs/", "launch/", "runtime/", "serve/", "train/")

GLOBAL_ALLOWED_DIRS = ("obs/",)

TRACED_DIRS = ("core/", "kernels/", "models/")

#: dotted call names that are direct sorts (SPK101)
SORT_CALLS = {"torch.sort", "torch.argsort", "torch.msort"}
#: tensor methods that sort (SPK101)
SORT_METHODS = {"sort", "argsort", "msort"}
#: keywords of Python's ``list.sort``, which no tensor sort takes
LIST_SORT_KEYWORDS = {"key", "reverse"}

#: top-level modules the port must never import (SPK102)
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "repro"}

#: dotted call prefixes that are host-time / nondeterminism (SPK105)
NONDET_PREFIXES = ("time.", "datetime.", "random.", "numpy.random.")

SPAN_CALLS = {"repro_torch.obs.span", "repro_torch.obs.trace.span"}

#: SPK107 scope: the hash-kernel family
HASH_KERNEL_PREFIX = "kernels/hash"
#: SPK107: the one sanctioned home of the table-sizing doubling loop
HASH_SIZING_HELPER = "hash_table_size"

#: SPK108: path-expression tokens that mark a durable artifact
DURABLE_PATH_TOKENS = ("journal", "spool", "frame", "ckpt", "checkpoint",
                       "snapshot", "rec_")
#: SPK108: tokens that mark the sanctioned tmp+os.replace staging file
TMP_PATH_TOKENS = ("tmp",)


def _alias_map(tree: ast.AST) -> Dict[str, str]:
    """local name -> fully dotted name, from every import in the module
    (function-local imports included — the map is a per-file approximation,
    which is exact for this codebase's import style)."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                local = a.asname or a.name.split(".")[0]
                aliases[local] = a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.module is None or node.level:  # relative imports: skip
                continue
            for a in node.names:
                local = a.asname or a.name
                aliases[local] = f"{node.module}.{a.name}"
    return aliases


def _dotted(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Resolve an attribute chain / name to its dotted import path."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    root = aliases.get(node.id, node.id)
    return ".".join([root] + list(reversed(parts)))


def _is_private_torch(mod: str, names=()) -> bool:
    """A private torch module, or a ``_`` name imported from a torch
    module."""
    parts = mod.split(".")
    if parts[0] != "torch":
        return False
    return (any(p.startswith("_") for p in parts[1:])
            or any(n.startswith("_") for n in names))


def _in(rel: str, dirs) -> bool:
    return any(rel.startswith(d) for d in dirs)


def scan_source(source: str, rel: str) -> List[Finding]:
    """Run every AST rule over one file (``rel`` is the path under
    ``src/repro_torch``, posix-style)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:  # a broken file is its own finding
        return [Finding("SPK101", rel, e.lineno or 0,
                        f"file does not parse: {e.msg}", "fix the syntax")]
    waivers = parse_waivers(source)
    aliases = _alias_map(tree)
    findings: List[Finding] = []

    def emit(rule: str, node: ast.AST, message: str, fixit: str) -> None:
        line = getattr(node, "lineno", 0)
        findings.append(Finding(rule, rel, line, message, fixit,
                                waived=is_waived(waivers, line, rule)))

    # SPK102: jax / repro imports anywhere; private torch outside compat.py
    for node in ast.walk(tree):
        mods: List[tuple] = []
        if isinstance(node, ast.Import):
            mods = [(a.name, ()) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            mods = [(node.module, tuple(a.name for a in node.names))]
        for mod, names in mods:
            if mod.split(".")[0] in FORBIDDEN_ROOTS:
                emit("SPK102", node,
                     f"import of {mod!r}: the port imports neither jax nor "
                     "the reference package",
                     "keep the port's own copy of what it needs from the "
                     "reference")
            elif rel != PRIVATE_HOME and _is_private_torch(mod, names):
                emit("SPK102", node,
                     f"private torch import {mod!r} outside compat.py",
                     "re-export it from repro_torch.compat (with an "
                     "ImportError that names it) and import it from there")

    # SPK103: `global` outside obs/
    if not _in(rel, GLOBAL_ALLOWED_DIRS):
        for node in ast.walk(tree):
            if isinstance(node, ast.Global):
                emit("SPK103", node,
                     f"`global {', '.join(node.names)}` bypasses the "
                     "obs.metrics registry",
                     "use obs.counter(...)/obs.gauge(...) for mutable "
                     "process state")

    # SPK106: bare assert — stripped under `python -O`
    for node in ast.walk(tree):
        if isinstance(node, ast.Assert):
            emit("SPK106", node,
                 "bare `assert` — validation that vanishes under python -O",
                 "raise ValueError for argument validation; waive inline "
                 "(# spkaddlint: disable=SPK106) for internal invariants")

    # SPK107: hash-kernel table sizing (kernels/hash*.py only)
    if rel.startswith(HASH_KERNEL_PREFIX):
        local_defs = {n.name: n for n in ast.walk(tree)
                      if isinstance(n, ast.FunctionDef)}
        helper = local_defs.get(HASH_SIZING_HELPER)
        allowed_whiles = {id(n) for n in ast.walk(helper)
                         if isinstance(n, ast.While)} if helper else set()
        for node in ast.walk(tree):
            if isinstance(node, ast.While) and id(node) not in allowed_whiles:
                if any(isinstance(st, ast.AugAssign)
                       and isinstance(st.op, ast.Mult)
                       for st in ast.walk(node)):
                    emit("SPK107", node,
                         "inline table-size doubling loop — the pow2 / "
                         f"load-factor sizing rule must live only in "
                         f"{HASH_SIZING_HELPER}()",
                         f"call {HASH_SIZING_HELPER}(distinct_bound) "
                         "instead of sizing the table in place")

    # call-based rules share one walk
    with_context_calls = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if isinstance(item.context_expr, ast.Call):
                    with_context_calls.add(id(item.context_expr))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func, aliases)
        if name is None:
            if _is_sort_method(node, aliases) and rel != SORT_HOME:
                emit("SPK101", node,
                     f"direct .{node.func.attr}() outside {SORT_HOME}",
                     "route through repro_torch.core.sparse.stable_argsort /"
                     " stable_sort (the counted canonical sort) or "
                     "sparse.top_k (a top-k selection)")
            continue
        # SPK101: direct sorts outside the sort home
        if rel != SORT_HOME and (name in SORT_CALLS
                                 or _is_sort_method(node, aliases)):
            emit("SPK101", node,
                 f"direct {name}() outside {SORT_HOME}",
                 "route through repro_torch.core.sparse.stable_argsort / "
                 "stable_sort (the counted canonical sort) or sparse.top_k "
                 "(a top-k selection)")
        # SPK104: spans must be `with` contexts at launch boundaries
        if name in SPAN_CALLS:
            allowed = rel in SPAN_ALLOWED_FILES \
                or _in(rel, SPAN_ALLOWED_DIRS)
            if not allowed:
                emit("SPK104", node,
                     f"obs.span in {rel} — not a launch boundary",
                     "instrument the wrapper that launches this code "
                     "(engine/ops), not the traced body")
            elif id(node) not in with_context_calls:
                emit("SPK104", node,
                     "obs.span called outside a `with` statement",
                     "use `with obs.span(...):` so the span always closes")
        # SPK105: host time / stdlib randomness in traced packages
        if _in(rel, TRACED_DIRS) and name.startswith(NONDET_PREFIXES):
            emit("SPK105", node,
                 f"{name}() is host-nondeterministic inside traced code",
                 "hoist timing to the launch boundary (obs.span) and "
                 "randomness to a seeded torch.Generator threaded from the "
                 "caller")
        # SPK108: write-mode open() straight onto a durable path
        if name == "open" and _open_mode_writes(node):
            tokens = _path_tokens(node.args[0]) if node.args else set()
            durable = any(d in t for t in tokens
                          for d in DURABLE_PATH_TOKENS)
            staged = any(s in t for t in tokens for s in TMP_PATH_TOKENS)
            if durable and not staged:
                emit("SPK108", node,
                     "write-mode open() directly on a durable path "
                     "(journal/spool/checkpoint/snapshot) — a crash "
                     "mid-write leaves a torn record on the real path",
                     "write to a `.tmp` sibling and os.replace() it over "
                     "the destination (see stream_service._atomic_write)")
    return findings


def _is_sort_method(node: ast.Call, aliases: Dict[str, str]) -> bool:
    """``x.sort(...)`` / ``x.argsort(...)`` on something that is not an
    imported module (``numpy.sort`` is a module function), without the
    keywords of Python's ``list.sort``."""
    func = node.func
    if not isinstance(func, ast.Attribute) or func.attr not in SORT_METHODS:
        return False
    root = func.value
    while isinstance(root, ast.Attribute):
        root = root.value
    if isinstance(root, ast.Name) and root.id in aliases:
        return False
    return not any(kw.arg in LIST_SORT_KEYWORDS for kw in node.keywords)


def _open_mode_writes(node: ast.Call) -> bool:
    """Does this ``open(...)`` call write? Mode is the second positional or
    the ``mode=`` keyword; a non-constant mode counts as writing (the rule
    errs loud, with the inline waiver as the escape hatch)."""
    mode = None
    if len(node.args) >= 2:
        mode = node.args[1]
    else:
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
    if mode is None:
        return False  # default mode "r"
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return any(c in mode.value for c in "wax")
    return True


def _path_tokens(node: ast.AST) -> set:
    """The static identifier/string tokens of a path expression, lowered —
    what SPK108 matches durable/tmp keywords against."""
    tokens = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            tokens.add(n.id.lower())
        elif isinstance(n, ast.Attribute):
            tokens.add(n.attr.lower())
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            tokens.add(n.value.lower())
    return tokens


def scan_tree(src_root: str) -> List[Finding]:
    """Scan every ``.py`` file under ``src_root`` (the ``src/repro_torch``
    dir)."""
    findings: List[Finding] = []
    for dirpath, _, names in sorted(os.walk(src_root)):
        for name in sorted(names):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, src_root).replace(os.sep, "/")
            with open(path, "r", encoding="utf-8") as fh:
                findings.extend(scan_source(fh.read(), rel))
    return findings
