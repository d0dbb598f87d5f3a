"""Layer-1 spkaddlint rules: trace checks over the port's engine entry points.

The counterpart of ``src/repro/analysis/jaxpr_rules.py``. The reference
traces each entry point to a closed jaxpr and reads its primitives; the
port has no jaxpr, so it *runs* each entry point once on a tiny input (on
the CPU, or on the card with ``device="cuda"``) and watches what it does:

- SPKJ201 one-sort: over the reference's geometry matrix (regime × k ×
  batch shape, :func:`geometry_matrix`), each entry point's sorts are
  counted twice and both counts must equal :func:`expected_sorts` (copied):
  by ``sparse.sort_calls()`` (the counted ``stable_argsort`` /
  ``stable_sort``), and by a dispatch mode that sees every ATen sort
  (:class:`_SortCounter`) — except those issued under a plain twin named
  in :data:`PLAIN_TWIN_SORTS` (the reference's in-kernel work, one
  ``pallas_call`` in its jaxpr) and inside ``sparse.top_k`` (the
  reference's ``lax.top_k``, not a ``sort`` primitive). A sort that
  bypasses the counted home, a kernel wrapper's host code included, shows
  as a difference between the two.
- SPKJ202 index-dtype: no int64/uint64 index tensor reaches a kernel. At
  each kernel wrapper's boundary (every function of ``kernels/`` with a
  ``launches`` count), where the plain twins run on the CPU
  (:class:`_WrapperArgs`); on the card also at the C entry points of the
  libraries ``kernels/_build.py`` loads (:class:`_EntryRecorder`, which
  resolves each pointer argument to the tensor it came from).
- SPKJ203 step-table: :func:`validate_step_tables` (verbatim) on the port's
  ``partition_steps``.
- SPKJ204 smem-budget: see :mod:`repro_torch.analysis.smem`.

The matrix keeps shapes tiny, so a full run takes seconds.
"""
from __future__ import annotations

import ctypes
import os
import sys
from typing import Callable, Iterable, List, Tuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch.analysis.findings import Finding

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# SPKJ201: counting sorts
# ---------------------------------------------------------------------------

#: ATen ops that sort.
SORT_OPS = ("aten::sort", "aten::argsort", "aten::msort")


#: The plain twins whose sorts stand for work inside a kernel, as the
#: reference's ``pallas_call`` bodies do: a sort issued under one of them is
#: not counted.
PLAIN_TWIN_SORTS = ("vec_accum.apply_fold", "spa_accum.spa_bucket_plain")
#: The top-k selections, which select and do not sort keys: a sort issued
#: directly by one of them is not counted.
TOP_K_SITES = {("core/sparse.py", "top_k"), ("core/sparse.py", "top_k_abs")}


def _twin_codes() -> set:
    """The code objects of :data:`PLAIN_TWIN_SORTS`."""
    import importlib

    out = set()
    for qual in PLAIN_TWIN_SORTS:
        mod, fn = qual.split(".")
        out.add(getattr(importlib.import_module(f"repro_torch.kernels.{mod}"),
                        fn).__code__)
    return out


def _is_counted_sort_site(frame, twins: set) -> bool:
    """A sort issued under ``frame`` counts toward the one-sort invariant
    unless a plain twin is on the stack or the innermost frame of the
    port's code (outside this package) is a top-k selection."""
    innermost = None
    while frame is not None:
        code = frame.f_code
        if code in twins:
            return False
        if innermost is None:
            path = os.path.abspath(code.co_filename)
            if path.startswith(_PKG + os.sep):
                rel = os.path.relpath(path, _PKG).replace(os.sep, "/")
                if not rel.startswith("analysis/"):
                    innermost = (rel, code.co_name)
        frame = frame.f_back
    return innermost not in TOP_K_SITES


class _SortCounter(compat.torch_dispatch_mode()):
    """Counts the ATen sorts dispatched under it at counted sites."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.twins = _twin_codes()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in SORT_OPS \
                and _is_counted_sort_site(sys._getframe(1), self.twins):
            self.n += 1
        return func(*args, **(kwargs or {}))


def count_sorts(thunk: Callable[[], object]) -> Tuple[int, int]:
    """``(sparse.sort_calls() delta, ATen sorts at counted sites)`` of one
    call of ``thunk``."""
    from repro_torch.core import sparse

    before = sparse.sort_calls()
    counter = _SortCounter()
    with counter:
        thunk()
    return sparse.sort_calls() - before, counter.n


# ---------------------------------------------------------------------------
# SPKJ202: index dtypes at kernel boundaries
# ---------------------------------------------------------------------------

BAD_INDEX_DTYPES = (torch.int64, torch.uint64)
KERNEL_MODULES = ("partition", "hash_slide", "segment", "spa_accum",
                  "hash_accum", "topk_block", "xla_add", "moe_combine")


def kernel_wrappers() -> dict:
    """``{code object: "module.function"}`` of every kernel wrapper: the
    functions of the kernel modules that count their launches."""
    import importlib

    out = {}
    for name in KERNEL_MODULES:
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        for attr, fn in vars(mod).items():
            if callable(fn) and hasattr(fn, "launches") \
                    and hasattr(fn, "__code__"):
                out[fn.__code__] = f"{name}.{attr}"
    return out


def _bad_index(t) -> bool:
    return isinstance(t, torch.Tensor) and t.dtype in BAD_INDEX_DTYPES


class _WrapperArgs:
    """While open, records each kernel wrapper call whose arguments hold
    an int64/uint64 tensor (a profile hook: the wrappers are found by
    their code, however a caller imported them)."""

    def __init__(self):
        self.wrappers = kernel_wrappers()
        self.bad: List[str] = []
        self.calls = 0

    def _hook(self, frame, event, arg):
        if event != "call":
            return
        name = self.wrappers.get(frame.f_code)
        if name is None:
            return
        self.calls += 1
        code = frame.f_code
        n_args = code.co_argcount + code.co_kwonlyargcount
        for var in code.co_varnames[:n_args]:
            x = frame.f_locals.get(var)
            if _bad_index(x):
                self.bad.append(f"{name}({var}: {x.dtype}, shape "
                                f"{tuple(x.shape)})")

    def __enter__(self):
        self._prev = sys.getprofile()
        sys.setprofile(self._hook)
        return self

    def __exit__(self, *exc):
        sys.setprofile(self._prev)


class _EntryRecorder:
    """While open, every C entry point a kernel wrapper takes from
    ``kernels/_build.entry`` is a recording proxy, and ``Tensor.data_ptr``
    notes each pointer's dtype: a call whose pointer argument came from an
    int64/uint64 tensor is recorded (the card's own boundary)."""

    def __init__(self):
        self.bad: List[str] = []
        self.calls = 0
        self._ptrs: dict = {}

    def __enter__(self):
        from repro_torch.kernels import _build

        self._build = _build
        self._entry = _build.entry
        self._own = "data_ptr" in vars(torch.Tensor)
        self._data_ptr = torch.Tensor.data_ptr
        ptrs, data_ptr = self._ptrs, self._data_ptr

        def noting(t):
            p = data_ptr(t)
            ptrs[p] = (t.dtype, tuple(t.shape))
            return p

        def recording_entry(lib, symbol, argtypes):
            fn = self._entry(lib, symbol, argtypes)

            def call(*args):
                self.calls += 1
                for i, (a, ty) in enumerate(zip(args, argtypes)):
                    if ty is ctypes.c_void_p and a in ptrs:
                        dtype, shape = ptrs[a]
                        if dtype in BAD_INDEX_DTYPES:
                            self.bad.append(f"{lib}.{symbol} argument {i}: "
                                            f"{dtype}, shape {shape}")
                return fn(*args)

            return call

        torch.Tensor.data_ptr = noting
        _build.entry = recording_entry
        return self

    def __exit__(self, *exc):
        self._build.entry = self._entry
        if self._own:
            torch.Tensor.data_ptr = self._data_ptr
        else:
            del torch.Tensor.data_ptr


def index_dtype_findings(bad: Iterable[str], label: str) -> List[Finding]:
    return [Finding(
        "SPKJ202", f"<trace:{label}>", 0,
        f"int64 index reaches a kernel: {b}",
        "cast indices with .to(torch.int32) before the kernel wrapper; "
        "audit for implicit int64 promotion (.long(), arange, sort indices)")
        for b in bad]


# ---------------------------------------------------------------------------
# geometry matrix: entry points with expected sort counts
# ---------------------------------------------------------------------------

#: cost-model overrides that force each regime regardless of signals (the
#: reference's table, verbatim).
REGIME_FORCES = {
    "tree": {"tree_max_k": 1e9},
    "sorted": {"tree_max_k": 0, "spa_max_accum_elems": 0.0,
               "hash_min_total_nnz": 1e18,
               "vec_max_accum_elems": 0.0,
               "blocked_spa_max_accum_elems": 0.0},
    "spa": {"tree_max_k": 0, "spa_max_accum_elems": float(1 << 40),
            "spa_min_density": 0.0, "spa_min_compression": 0.0},
    "hash": {"tree_max_k": 0, "spa_max_accum_elems": 0.0,
             "hash_min_total_nnz": 0.0, "hash_max_compression": 1e9,
             "hash_max_table_elems": float(1 << 40)},
    "vec": {"tree_max_k": 0, "spa_max_accum_elems": 1.0,
            "hash_min_total_nnz": 1e18,
            "vec_min_density": 0.0, "vec_max_accum_elems": float(1 << 40)},
    "blocked_spa": {"tree_max_k": 0, "spa_max_accum_elems": 1.0,
                    "hash_min_total_nnz": 1e18,
                    "vec_max_accum_elems": 1.0,
                    "blocked_spa_min_density": 0.0,
                    "blocked_spa_max_accum_elems": float(1 << 40)},
}


def expected_sorts(regime: str, k: int) -> int:
    """The one-sort invariant, per regime: the partitioned/sorted/spa
    regimes share the single canonical-plan sort; the sort-free ``hash``
    regime pays zero sorts before accumulation and exactly one at
    compaction (so one total); the tree regime pays one compress per
    2-way add (k-1 of them, floored at the k=1 compress)."""
    if regime == "tree":
        return max(1, k - 1)
    return 1


def _collection(seed: int, k: int, m: int, n: int, nnz: int, device):
    """Deterministic tiny collection, built before any count starts (the
    reference's draws)."""
    from repro_torch.core import sparse as S

    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(k):
        d = np.zeros((m, n), np.float32)
        take = min(nnz, m * n)
        idx = rng.choice(m * n, take, replace=False)
        d.flat[idx] = rng.standard_normal(take)
        mats.append(S.from_dense(torch.from_numpy(d).to(device), cap=nnz))
    return mats


def geometry_matrix(device="cpu") -> Iterable[
        Tuple[str, Callable[[], object], int]]:
    """Yield (label, zero-arg thunk, expected sort count) for every public
    entry point x geometry cell, its inputs on ``device``."""
    from repro_torch.core import allreduce as AR
    from repro_torch.core import engine as E
    from repro_torch.core import streaming as STR
    from repro_torch.core.sparse import make_empty
    from repro_torch.core.topk import SparseUpdate

    shapes = [(16, 4), (64, 8)]
    ks = [1, 3, 5]
    for (m, n) in shapes:
        for k in ks:
            mats = _collection(7 * m + k, k, m, n, max(4, m * n // 8), device)
            for regime, force in REGIME_FORCES.items():
                if regime == "tree" and k > 3:
                    continue  # forced-tree beyond the canonical band is a
                    # left fold; covered at k<=3
                yield (f"spkadd_auto[{regime},k={k},{m}x{n}]",
                       lambda mats=mats, force=force:
                       E.spkadd_auto(mats, cost_model=dict(force)),
                       expected_sorts(regime, k))

    # batched: one sort for the whole stack (hash: the single batched
    # compaction sort — still one)
    colls = [_collection(100 + b, 4, 32, 8, 24, device) for b in range(3)]
    stacked = E.stack_collections(colls)
    for regime in ("vec", "blocked_spa", "hash"):
        force = REGIME_FORCES[regime]
        yield (f"spkadd_batched[{regime},B=3]",
               lambda stacked=stacked, force=force:
               E.spkadd_batched(stacked, cost_model=dict(force)),
               1)

    # ragged: one sort per capacity bucket
    ragged = [_collection(200, 3, 16, 4, 8, device),
              _collection(201, 3, 16, 4, 8, device),
              _collection(202, 3, 16, 4, 30, device)]  # 2 buckets
    force = REGIME_FORCES["vec"]
    yield ("spkadd_batched_ragged[vec,buckets=2]",
           lambda ragged=ragged, force=force:
           E.spkadd_batched_ragged(ragged, cost_model=dict(force)),
           2)

    # streaming flush (functional core): one engine sort + the
    # truncate-by-magnitude re-sort of the budgeted running state
    fmats = _collection(300, 4, 16, 4, 12, device)
    running = make_empty((16, 4), cap=8, device=device)
    yield ("streaming.flush[vec,k=4]",
           lambda fmats=fmats, running=running, force=force:
           STR.truncate_by_magnitude(
               E.spkadd_run([running] + fmats, cost_model=dict(force)),
               running.cap),
           2)

    # sparse allreduce, gather_kway with the vec accumulator: the local
    # k-way fold's single pre-sort (the default process group, or a world
    # of one made for it)
    u = SparseUpdate(idx=torch.arange(8, dtype=torch.int32, device=device),
                     val=torch.ones((8,), dtype=torch.float32,
                                    device=device), size=64)

    def _allreduce(u=u):
        with _world_of_one():
            return AR.sparse_allreduce(u, None, "gather_kway",
                                       accumulator="vec")

    yield ("sparse_allreduce[gather_kway,vec]", _allreduce, 1)


class _world_of_one:
    """The default process group as it is, or a gloo world of one rank for
    the duration (destroyed after)."""

    def __enter__(self):
        import torch.distributed as dist

        self.made = not dist.is_initialized()
        if self.made:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        if self.made:
            dist.destroy_process_group()


def trace_entry_points(device="cpu") -> List[dict]:
    """Each geometry-matrix cell run once on ``device``: its ``label``,
    ``expected`` sorts, ``counted`` (``sparse.sort_calls()``) and ``seen``
    (ATen sorts at counted sites), the kernel wrapper calls and, on a
    card, the C entry-point calls it made, the int64 indices that reached
    a kernel (``bad``), and the ``error`` that stopped it, if any."""
    on_card = torch.device(device).type == "cuda"
    out = []
    for label, thunk, expected in geometry_matrix(device):
        rec = {"label": label, "expected": expected, "error": None,
               "bad": [], "wrapper_calls": 0, "entry_calls": 0}
        wrappers = _WrapperArgs()
        entries = _EntryRecorder() if on_card else None
        try:
            with wrappers:
                if entries is None:
                    rec["counted"], rec["seen"] = count_sorts(thunk)
                else:
                    with entries:
                        rec["counted"], rec["seen"] = count_sorts(thunk)
        except Exception as e:  # an entry point that fails is a finding
            rec["error"] = f"{type(e).__name__}: {e}"
        rec["wrapper_calls"] = wrappers.calls
        rec["bad"] = list(wrappers.bad)
        if entries is not None:
            rec["entry_calls"] = entries.calls
            rec["bad"] += entries.bad
        out.append(rec)
    return out


def entry_point_findings(records: Iterable[dict]) -> List[Finding]:
    """SPKJ201 + SPKJ202 from the records of :func:`trace_entry_points`."""
    findings: List[Finding] = []
    for rec in records:
        label, expected = rec["label"], rec["expected"]
        if rec["error"] is not None:
            findings.append(Finding(
                "SPKJ201", f"<trace:{label}>", 0,
                f"entry point failed to run: {rec['error']}",
                "keep every public engine entry point runnable on tiny "
                "inputs"))
            continue
        for how, key in (("sparse.sort_calls()", "counted"),
                         ("ATen sorts at counted sites", "seen")):
            if rec[key] != expected:
                findings.append(Finding(
                    "SPKJ201", f"<trace:{label}>", 0,
                    f"{rec[key]} sort(s) by {how}, expected {expected}",
                    "route every key sort through sparse.stable_argsort and "
                    "share the canonical plan's sort (plan_and_partition) "
                    "instead of re-sorting"))
        findings.extend(index_dtype_findings(rec["bad"], label))
    return findings


def check_entry_points(device="cpu") -> List[Finding]:
    """SPKJ201 + SPKJ202 over the whole geometry matrix on ``device``."""
    return entry_point_findings(trace_entry_points(device))


# ---------------------------------------------------------------------------
# SPKJ203: step-table legality
# ---------------------------------------------------------------------------


def validate_step_tables(chunk_id: np.ndarray, part_id: np.ndarray, *,
                         keys_sorted: np.ndarray, mn: int, part_elems: int,
                         parts: int, chunk: int,
                         label: str = "") -> List[Finding]:
    """Prove one (chunk_id, part_id) schedule legal for a sorted stream.

    Legality = (a) both tables non-decreasing (consecutive output-tile
    revisits: one block owns a tile and walks its chunks in order), (b)
    every payload (chunk, part) pair scheduled exactly once (no double
    accumulation, no dropped payload), (c) no real pair scheduled twice.
    """
    where = f"<steps:{label or f'mn={mn},parts={parts},chunk={chunk}'}>"
    findings: List[Finding] = []

    def emit(msg: str, fixit: str) -> None:
        findings.append(Finding("SPKJ203", where, 0, msg, fixit))

    chunk_id = np.asarray(chunk_id)
    part_id = np.asarray(part_id)
    if np.any(np.diff(part_id) < 0):
        emit("part_id table is not non-decreasing — output-tile revisits "
             "would be non-consecutive (a tile no one block owns)",
             "partition_steps must emit parts in ascending key order")
    if np.any(np.diff(chunk_id) < 0):
        emit("chunk_id table is not non-decreasing — chunks would be "
             "re-fetched after eviction (breaks the I/O bound)",
             "partition_steps must sweep chunks forward only")

    # payload pairs the schedule must cover exactly once
    keys = np.asarray(keys_sorted)
    valid = keys < mn
    pos = np.nonzero(valid)[0]
    required = {(int(p // chunk), int(k // part_elems))
                for p, k in zip(pos, keys[valid])}
    real = [(int(c), int(p)) for c, p in zip(chunk_id, part_id) if p < parts]
    seen = set()
    dup = set()
    for pair in real:
        (dup if pair in seen else seen).add(pair)
    missing = required - seen
    if dup:
        emit(f"(chunk, part) pair(s) scheduled more than once: "
             f"{sorted(dup)[:4]} — the fold would double-count them",
             "each chunk may be folded into a part at most once")
    if missing:
        emit(f"payload (chunk, part) pair(s) never scheduled: "
             f"{sorted(missing)[:4]} — their nonzeros would be dropped",
             "every chunk holding a part's keys must get a step")
    return findings


#: step-table geometry sweep: (mn, part_elems, chunk, nnz) cells covering
#: part boundaries mid-chunk, empty parts, the single-part degenerate, and
#: all-sentinel streams.
STEP_MATRIX = [
    (64 * 8, 128, 8, 100),
    (64 * 8, 128, 8, 0),
    (64 * 8, 512, 8, 40),    # single part
    (16 * 4, 128, 8, 10),    # part_elems > mn
    (1024, 128, 64, 7),      # sparse stream, most parts empty
]


def check_step_tables() -> List[Finding]:
    from repro_torch.core.sparse import partition_steps

    findings: List[Finding] = []
    rng = np.random.default_rng(0)
    for mn, part_elems, chunk, nnz in STEP_MATRIX:
        parts = max(1, (mn + part_elems - 1) // part_elems)
        keys = np.sort(rng.choice(mn, size=min(nnz, mn), replace=False)) \
            if nnz else np.zeros((0,), np.int64)
        cap_pad = ((max(len(keys), 1) + chunk - 1) // chunk) * chunk
        keys_p = np.full((cap_pad,), mn, np.int32)
        keys_p[:len(keys)] = keys.astype(np.int32)
        steps = partition_steps(torch.from_numpy(keys_p), mn=mn,
                                part_elems=part_elems, parts=parts,
                                chunk=chunk)
        findings.extend(validate_step_tables(
            steps.chunk_id.reshape(-1).numpy(),
            steps.part_id.reshape(-1).numpy(),
            keys_sorted=keys_p, mn=mn, part_elems=part_elems, parts=parts,
            chunk=chunk,
            label=f"mn={mn},pe={part_elems},chunk={chunk},nnz={nnz}"))
    return findings


def run(device="cpu") -> List[Finding]:
    """All trace-layer rules (SPKJ201-204) on ``device``."""
    from repro_torch.analysis import smem

    findings = check_entry_points(device)
    findings.extend(check_step_tables())
    findings.extend(smem.check_all(backend=torch.device(device).type))
    return findings
