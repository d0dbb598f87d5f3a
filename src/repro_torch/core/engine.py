"""Regime-aware SpKAdd engine: auto-dispatch + batched execution.

The port of ``src/repro/core/engine.py``. The paper's central empirical
result (Fig. 2, Tables III/IV) is that no single SpKAdd algorithm wins
everywhere: tiny k favours 2-way tree merging, large accumulators the
sliding/partitioned accumulator, low compression factors the sort-free
hash, and the k-way merge (sort + ordered segment fold) is the fallback.
:func:`spkadd_auto` computes the paper's regime signals from capacities —
k, aggregate density ``sum nnz / (m·n)``, and compression factor — and
picks the region's winner from the same layered cost-model table as the
reference (in-code defaults, then ``configs/cost_model_default.json``, then
the file named by ``$SPKADD_COST_MODEL``).

**Canonical output contract.** Every engine path returns the *same*
PaddedCOO bit for bit, and the same PaddedCOO as the reference package on
the same inputs: capacity ``sum_i cap_i``, keys sorted with sentinel
padding, structural ``nnz``, and values folded left to right in
input-stream order from +0.0. The structural layout comes from one
:func:`~repro_torch.core.sparse.compress_plan`; a regime only changes how
the per-key sums are produced: the ordered segment fold (``sorted``,
``spa``, ``tree``), the partitioned accumulator kernel (``vec``,
``blocked_spa``; ``kernels/partition``), or the sliding-hash kernel
(``hash``; ``kernels/hash_slide``).

**One sort per call.** ``vec``/``blocked_spa`` share the plan's stable
argsort with the stream partition (parts are key-aligned ranges); ``hash``
sorts nothing before it accumulates and sorts once to compact its tables
(gauge ``engine.hash.presort_sorts`` pinned at zero); ``spa`` and
``sorted`` fold through the plan's one sort. ``sparse.sort_calls()``
counts them.

**Budgets.** Where the reference sizes launches to 16 MiB of TPU VMEM, the
port sizes them to the shared memory one block may use on the tensors'
device (``kernels.ops.device_smem_budget``). Every entry point takes
``smem_budget_bytes=`` to override it; the CPU tests pass the same budget
to both packages.

On the card every kernel-backed step launches its CUDA kernel; on the CPU
the kernels' plain versions run. There is no other path.
"""
from __future__ import annotations

import functools
import json
import math
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core import spkadd as _alg
from repro_torch.core.sparse import (PaddedCOO, concat, next_pow2,
                                     plan_and_partition, sentinel_key,
                                     sort_calls, stable_argsort, with_capacity)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.segment import segment_fold

# ---------------------------------------------------------------------------
# regime signals (paper Fig. 2 axes)
# ---------------------------------------------------------------------------

class RegimeSignals(NamedTuple):
    """The paper's dispatch axes. ``density`` and ``compression`` are
    capacity-based estimates by default (capacities are the a-priori nnz
    bounds and need no device read); :func:`regime_signals` can compute
    exact values from the inputs."""

    k: int               # number of input matrices
    density: float       # aggregate input density: sum nnz / (m*n)
    compression: float   # cf = sum nnz / nnz(B)  (>= 1)
    accum_elems: int     # dense accumulator size m*n (SPA feasibility)


def estimate_compression(total_nnz: float, mn: int) -> float:
    """Expected cf for uniformly random keys (ER model): distinct keys
    ``≈ mn·(1 − (1 − 1/mn)^N)``, the standard occupancy estimate."""
    if total_nnz <= 0 or mn <= 0:
        return 1.0
    distinct = mn * -math.expm1(total_nnz * math.log1p(-1.0 / mn)) \
        if mn > 1 else 1.0
    return max(1.0, total_nnz / max(distinct, 1.0))


def regime_signals(mats: Sequence[PaddedCOO],
                   exact: bool = False) -> RegimeSignals:
    """Compute the dispatch signals for a collection.

    ``exact=True`` reads ``nnz`` back from the device and runs the symbolic
    phase (one counted sort); the default uses capacities only.
    """
    m, n = mats[0].shape
    mn = m * n
    k = len(mats)
    if exact:
        total = float(sum(int(a.nnz) for a in mats))
        out_nnz = float(int(_alg.symbolic_nnz(mats)))
        cf = total / max(out_nnz, 1.0)
    else:
        total = float(sum(a.cap for a in mats))
        cf = estimate_compression(total, mn)
    return RegimeSignals(k=k, density=total / max(mn, 1), compression=cf,
                         accum_elems=mn)


# ---------------------------------------------------------------------------
# cost model (Fig. 2 region boundaries; calibratable)
# ---------------------------------------------------------------------------

#: Region boundaries of the dispatch table — the reference's in-code
#: defaults, overlaid by :func:`default_cost_model` with the checked-in
#: ``configs/cost_model_default.json`` (a copy of the reference's) and then
#: ``$SPKADD_COST_MODEL``. They were measured for the reference; no
#: boundary has been re-measured on a GPU.
DEFAULT_COST_MODEL: Dict[str, float] = {
    "tree_max_k": 3,
    "spa_max_accum_elems": float(1 << 22),
    "spa_min_density": 1.0 / 64.0,
    "spa_min_compression": 1.25,
    "vec_max_accum_elems": float(1 << 26),
    "vec_min_density": 1.0 / 32.0,
    "vec_onehot_max_block_elems": 4096.0,
    "blocked_spa_max_accum_elems": float(1 << 26),
    "blocked_spa_min_density": 1.0 / 16.0,
    "hash_min_total_nnz": 512.0,
    "hash_max_compression": 1.5,
    "hash_max_table_elems": float(1 << 21),
}

#: Env var naming a JSON cost-model file that overrides the checked-in
#: defaults for every dispatch in the process.
COST_MODEL_ENV = "SPKADD_COST_MODEL"

#: The checked-in default table.
COST_MODEL_CONFIG_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "cost_model_default.json")


@functools.lru_cache(maxsize=None)
def _cost_model_from(path: str) -> Dict[str, float]:
    with open(path) as f:
        return {str(k): float(v) for k, v in json.load(f).items()}


def default_cost_model() -> Dict[str, float]:
    """The process-wide dispatch table: in-code defaults, overlaid with the
    checked-in ``configs/cost_model_default.json``, overlaid with the file
    named by ``$SPKADD_COST_MODEL`` (if set). A missing env-var path
    raises."""
    cm = dict(DEFAULT_COST_MODEL)
    if os.path.exists(COST_MODEL_CONFIG_PATH):
        cm.update(_cost_model_from(COST_MODEL_CONFIG_PATH))
    env_path = os.environ.get(COST_MODEL_ENV)
    if env_path:
        cm.update(_cost_model_from(env_path))
    return cm


def select_algorithm(signals: RegimeSignals,
                     cost_model: Optional[Dict[str, float]] = None) -> str:
    """Map regime signals to the Fig. 2 region winner."""
    cm = default_cost_model()
    if cost_model:
        cm.update(cost_model)
    if signals.k <= cm["tree_max_k"]:
        return "tree"
    spa_worthwhile = (signals.density >= cm["spa_min_density"]
                      or signals.compression >= cm["spa_min_compression"])
    if signals.accum_elems <= cm["spa_max_accum_elems"] and spa_worthwhile:
        return "spa"
    total = signals.density * signals.accum_elems
    table_elems = next_pow2(2 * max(int(min(total, signals.accum_elems)), 1))
    if (total >= cm["hash_min_total_nnz"]
            and signals.compression <= cm["hash_max_compression"]
            and table_elems <= cm["hash_max_table_elems"]):
        return "hash"
    if (signals.accum_elems <= cm["vec_max_accum_elems"]
            and signals.density >= cm["vec_min_density"]):
        return "vec"
    if (signals.accum_elems <= cm["blocked_spa_max_accum_elems"]
            and signals.density >= cm["blocked_spa_min_density"]):
        return "blocked_spa"
    return "sorted"


def calibrate_cost_model(cells) -> Dict[str, float]:
    """Fit region boundaries from measured per-cell winners: an iterable of
    ``((k, aggregate_density), winner)`` pairs or
    ``((k, aggregate_density, compression), winner)`` triples (or an
    equivalent dict). Boundaries not identifiable from the sample keep their
    defaults."""
    items = list(cells.items()) if hasattr(cells, "items") else list(cells)
    cm = dict(DEFAULT_COST_MODEL)
    tree_ks = [key[0] for key, alg in items if alg == "tree"]
    if tree_ks:
        cm["tree_max_k"] = max(tree_ks)
    spa_ds = [key[1] for key, alg in items if alg in ("spa", "blocked_spa")]
    if spa_ds:
        cm["spa_min_density"] = min(spa_ds)
        cm["blocked_spa_min_density"] = min(spa_ds)
    vec_ds = [key[1] for key, alg in items if alg == "vec"]
    if vec_ds:
        cm["vec_min_density"] = min(vec_ds)
    hash_cfs = [key[2] for key, alg in items if alg == "hash" and len(key) > 2]
    if hash_cfs:
        cm["hash_max_compression"] = max(hash_cfs)
    return cm


def dump_cost_model(cm: Dict[str, float], path: str) -> None:
    with open(path, "w") as f:
        json.dump(cm, f, indent=2, sort_keys=True)
        f.write("\n")


def load_cost_model(path: str) -> Dict[str, float]:
    with open(path) as f:
        loaded = json.load(f)
    cm = dict(DEFAULT_COST_MODEL)
    cm.update(loaded)
    return cm


# ---------------------------------------------------------------------------
# canonical execution paths
# ---------------------------------------------------------------------------

def scatter_accumulate(keys: torch.Tensor, vals: torch.Tensor,
                       length: int) -> torch.Tensor:
    """Dense SPA numeric phase: fold a (key, val) stream into a flat
    accumulator of ``length`` slots, each slot's values in stream order
    from +0.0. Keys outside ``[0, length)`` land in a discard slot.

    The reference scatters in operand order; the port sorts the clipped
    keys once (counted) and folds each slot's run with the ordered segment
    fold, which is the same fold. The discard slot is the fold's dropped
    id ``length``.
    """
    safe = torch.clamp(keys, 0, length).to(torch.int32)
    order = stable_argsort(safe)
    return segment_fold(torch.gather(vals, -1, order),
                        torch.gather(safe, -1, order), length)


def _canonical_gather(out_keys: torch.Tensor, nnz: torch.Tensor,
                      flat: torch.Tensor, sent: int, dtype) -> torch.Tensor:
    """The canonical value gather every dense-accumulator regime shares,
    over a leading batch dimension: ``flat[..., key]`` for the plan's keys,
    0.0 past ``nnz``."""
    gather_keys = torch.where(out_keys != sent, out_keys, 0).long()
    slot = torch.arange(out_keys.shape[-1], device=out_keys.device)
    return torch.where(slot < nnz.unsqueeze(-1),
                       torch.gather(flat, -1, gather_keys), 0.0).to(dtype)


def _run_spa(mats: Sequence[PaddedCOO],
             cost_model: Optional[Dict[str, float]] = None) -> PaddedCOO:
    """SPA regime. The reference scatters into a dense accumulator and
    gathers through the plan; on the card the port folds the plan's sorted
    stream with the ordered segment fold — the k-way merge's fold, which
    gives every key the same sum with one counted sort — so this regime is
    :func:`~repro_torch.core.spkadd.spkadd_sorted`."""
    return _alg.spkadd_sorted(mats)


def _budget(smem_budget_bytes: Optional[int], device) -> int:
    return (kops.device_smem_budget(device) if smem_budget_bytes is None
            else smem_budget_bytes)


def _partitioned_core(keys: torch.Tensor, vals: torch.Tensor,
                      shape: Tuple[int, int], regime: str,
                      smem_budget_bytes: Optional[int]) -> PaddedCOO:
    """The ONE partitioned pipeline — plan/sort, step tables, kernel launch,
    canonical gather — over ``(B, cap)`` concatenated streams. Both the
    single-collection regimes (B = 1) and :func:`spkadd_batched` run it.
    Its leaf spans, in stream order: ``engine.plan`` and
    ``engine.accumulate`` inside ``engine.partitioned_launch``, then
    ``engine.canonical_gather``."""
    m, n = shape
    cap = keys.shape[-1]
    budget = _budget(smem_budget_bytes, keys.device)
    geom = kops.partitioned_launch_geometry(
        cap, m=m, n=n, smem_budget_bytes=budget)
    obs.counter("engine.partitioned.launches").inc()
    with obs.span("engine.partitioned_launch", regime=regime,
                  batch=keys.shape[0], cap=cap, parts=geom.parts,
                  part_elems=geom.part_elems, chunk=geom.chunk,
                  num_chunks=geom.num_chunks, max_steps=geom.max_steps):
        with obs.span("engine.plan"):
            plan, keys_p, steps = plan_and_partition(
                keys, shape, part_elems=geom.part_elems, chunk=geom.chunk)
        with obs.span("engine.accumulate"):
            vals_p = torch.zeros(keys_p.shape, dtype=torch.float32,
                                 device=keys.device)
            vals_p[:, :cap] = torch.gather(vals, -1, plan.order)
            flat = kops.partitioned_accumulate_flat(
                keys_p, vals_p, steps.chunk_id, steps.part_id, m=m, n=n,
                part_elems=geom.part_elems, parts=geom.parts,
                chunk=geom.chunk)
    with obs.span("engine.canonical_gather"):
        out_vals = _canonical_gather(plan.out_keys, plan.nnz, flat,
                                     sentinel_key(shape), vals.dtype)
    return PaddedCOO(keys=plan.out_keys, vals=out_vals, nnz=plan.nnz,
                     shape=shape)


def _first_row(out: PaddedCOO) -> PaddedCOO:
    return PaddedCOO(keys=out.keys[0], vals=out.vals[0], nnz=out.nnz[0],
                     shape=out.shape)


def _run_partitioned(mats: Sequence[PaddedCOO], regime: str,
                     smem_budget_bytes: Optional[int] = None) -> PaddedCOO:
    """One-pass partitioned regimes (``vec`` / ``blocked_spa``) as a B = 1
    batch of the shared core."""
    with obs.span("engine.concat", k=len(mats)):
        cat = concat(mats)
    return _first_row(_partitioned_core(
        cat.keys[None], cat.vals[None], cat.shape, regime, smem_budget_bytes))


def _run_blocked_spa(mats: Sequence[PaddedCOO],
                     cost_model: Optional[Dict[str, float]] = None,
                     **kw) -> PaddedCOO:
    """Sliding-SPA regime: the partitioned one-pass launch."""
    return _run_partitioned(mats, "blocked_spa", **kw)


def _run_vec(mats: Sequence[PaddedCOO],
             cost_model: Optional[Dict[str, float]] = None,
             **kw) -> PaddedCOO:
    """Vec regime: the partitioned one-pass launch (the reference's
    lane-parallel folds are the same fold)."""
    return _run_partitioned(mats, "vec", **kw)


def _hash_core(keys: torch.Tensor, vals: torch.Tensor, shape: Tuple[int, int],
               smem_budget_bytes: Optional[int]) -> PaddedCOO:
    """The ONE sort-free sliding-hash pipeline over ``(B, cap)`` streams.

    No sort before accumulation: the unsorted stream goes straight into the
    sliding-hash launch, whose per-key values are the canonical left folds.
    Compacting the tables (occupied slots sorted by key, sentinel padding,
    structural ``nnz``) is the single counted sort of a hash dispatch.
    """
    m, n = shape
    B, cap = keys.shape
    sent = sentinel_key(shape)
    geom = kops.hash_launch_geometry(
        cap, m=m, n=n, smem_budget_bytes=_budget(smem_budget_bytes,
                                                 keys.device))
    obs.counter("engine.hash.launches").inc()
    sorts_before = sort_calls()
    with obs.span("engine.hash_launch", batch=B, cap=cap,
                  table_size=geom.table_size, parts=geom.parts,
                  part_span=geom.part_span, chunk=geom.chunk,
                  num_chunks=geom.num_chunks):
        tkeys, tvals = kops.hash_slide_tables(
            keys, vals, m=m, n=n, table_size=geom.table_size,
            part_span=geom.part_span, parts=geom.parts, chunk=geom.chunk)
    # the zero-presort pin: tables were built without any canonical sort
    obs.gauge("engine.hash.presort_sorts").set(sort_calls() - sorts_before)

    # compaction — the ONE stable sort of a hash dispatch. Part tables are
    # key-range ordered, so one batched argsort over the concatenated
    # tables yields canonical order; empty slots sort behind every key.
    obs.counter("engine.hash.compaction_sorts").inc()
    occupied = tkeys != -1
    ck = torch.where(occupied, tkeys, sent)
    order = stable_argsort(ck)
    ck_s = torch.gather(ck, -1, order)
    cv_s = torch.gather(tvals, -1, order)
    tab = ck.shape[-1]
    if tab >= cap:
        out_keys = ck_s[:, :cap]
        out_f32 = cv_s[:, :cap]
    else:
        out_keys = torch.cat([ck_s, torch.full((B, cap - tab), sent,
                                               dtype=torch.int32,
                                               device=keys.device)], -1)
        out_f32 = torch.cat([cv_s, torch.zeros((B, cap - tab),
                                               dtype=torch.float32,
                                               device=keys.device)], -1)
    nnz = occupied.sum(-1, dtype=torch.int32)
    out_vals = torch.where(out_keys != sent, out_f32, 0.0).to(vals.dtype)
    return PaddedCOO(keys=out_keys, vals=out_vals, nnz=nnz, shape=shape)


def _run_hash(mats: Sequence[PaddedCOO],
              cost_model: Optional[Dict[str, float]] = None,
              smem_budget_bytes: Optional[int] = None) -> PaddedCOO:
    """Sort-free sliding-hash regime as a B = 1 batch of the shared core."""
    cat = concat(mats)
    return _first_row(_hash_core(cat.keys[None], cat.vals[None], cat.shape,
                                 smem_budget_bytes))


def _run_tree(mats: Sequence[PaddedCOO],
              cost_model: Optional[Dict[str, float]] = None) -> PaddedCOO:
    """Tiny-k regime, canonical for any ``tree_max_k``: k = 1 compresses
    (no 2-way add would dedup), k <= 3 is the balanced tree (a left fold
    there), larger k folds left (the incremental schedule), which sums
    every key in stream order."""
    if len(mats) == 1:
        return _alg.spkadd_sorted(mats)
    if len(mats) <= 3:
        return _alg.spkadd_tree(mats)
    return _alg.spkadd_incremental(mats)


#: Engine-canonical paths: every entry returns the same PaddedCOO bitwise.
#: Entries share the signature ``(mats, cost_model=None)``.
_CANONICAL = {
    "tree": _run_tree,
    "sorted": lambda mats, cost_model=None: _alg.spkadd_sorted(mats),
    "spa": _run_spa,
    "vec": _run_vec,
    "blocked_spa": _run_blocked_spa,
    "hash": _run_hash,
}


def spkadd_auto(mats: Sequence[PaddedCOO], *,
                cost_model: Optional[Dict[str, float]] = None,
                signals: Optional[RegimeSignals] = None) -> PaddedCOO:
    """``B = sum_i A_i`` with the regime's winning algorithm.

    Dispatch uses capacity-based signals (no device read). Pass
    ``signals=regime_signals(mats, exact=True)`` to dispatch on exact
    nnz/compression, or ``cost_model=`` a calibrated table.
    """
    sig = signals if signals is not None else regime_signals(mats)
    selected = select_algorithm(sig, cost_model)
    obs.counter(f"engine.dispatch.{selected}").inc()
    with obs.span("engine.spkadd_auto", selected=selected, k=sig.k,
                  density=sig.density, compression=sig.compression,
                  accum_elems=sig.accum_elems):
        return _CANONICAL[selected](mats, cost_model=cost_model)


def explain_dispatch(mats: Sequence[PaddedCOO], *,
                     cost_model: Optional[Dict[str, float]] = None,
                     exact: bool = False) -> Tuple[RegimeSignals, str]:
    """(signals, selected algorithm) — observability for callers/tests."""
    sig = regime_signals(mats, exact=exact)
    return sig, select_algorithm(sig, cost_model)


def spkadd_run(mats: Sequence[PaddedCOO], algorithm: str = "auto",
               **kw) -> PaddedCOO:
    """Single entry point for every SpKAdd consumer: ``"auto"`` goes through
    the regime dispatcher; any other name runs that member of
    :mod:`repro_torch.core.spkadd`."""
    if algorithm == "auto":
        return spkadd_auto(mats, **kw)
    return _alg.spkadd(mats, algorithm=algorithm, **kw)


# ---------------------------------------------------------------------------
# batched execution
# ---------------------------------------------------------------------------

def stack_collections(collections: Sequence[Sequence[PaddedCOO]]
                      ) -> List[PaddedCOO]:
    """Stack B same-shaped collections of k matrices into one *batched*
    collection: k PaddedCOOs whose leaves carry a leading batch dim
    (keys ``(B, cap)``, vals ``(B, cap)``, nnz ``(B,)``)."""
    k = len(collections[0])
    shape = collections[0][0].shape
    for coll in collections:
        if len(coll) != k:
            raise ValueError("all collections must have the same k")
        for a in coll:
            if a.shape != shape:
                raise ValueError("stacked collections must share a shape")
    return [
        PaddedCOO(
            keys=torch.stack([coll[i].keys for coll in collections]),
            vals=torch.stack([coll[i].vals for coll in collections]),
            nnz=torch.stack([torch.as_tensor(coll[i].nnz, dtype=torch.int32,
                                             device=coll[i].keys.device)
                             for coll in collections]),
            shape=shape,
        )
        for i in range(k)
    ]


def unstack_collection(batched: Sequence[PaddedCOO], b: int) -> List[PaddedCOO]:
    """Slice batch element ``b`` back out of a stacked collection/result."""
    return [PaddedCOO(a.keys[b], a.vals[b], a.nnz[b], a.shape)
            for a in batched]


def batched_regime_signals(stacked_mats: Sequence[PaddedCOO]
                           ) -> RegimeSignals:
    """Regime signals for a stacked collection (capacity is the trailing
    axis of every leaf)."""
    m, n = stacked_mats[0].shape
    mn = m * n
    total = float(sum(a.keys.shape[-1] for a in stacked_mats))
    return RegimeSignals(k=len(stacked_mats), density=total / max(mn, 1),
                         compression=estimate_compression(total, mn),
                         accum_elems=mn)


def explain_batched_dispatch(stacked_mats: Sequence[PaddedCOO], *,
                             algorithm: str = "auto",
                             cost_model: Optional[Dict[str, float]] = None
                             ) -> Tuple[RegimeSignals, str, str]:
    """(signals, requested, effective) for a batched run, with the
    reference's return shape. Every regime runs natively batched on the
    port, so ``effective`` is always ``requested``."""
    sig = batched_regime_signals(stacked_mats)
    requested = (select_algorithm(sig, cost_model) if algorithm == "auto"
                 else algorithm)
    with obs.span("engine.batched_dispatch", requested=requested,
                  effective=requested, k=sig.k, density=sig.density,
                  compression=sig.compression, accum_elems=sig.accum_elems,
                  batch=int(stacked_mats[0].keys.shape[0])):
        pass
    return sig, requested, requested


def spkadd_batched(stacked_mats: Sequence[PaddedCOO], *,
                   algorithm: str = "auto",
                   cost_model: Optional[Dict[str, float]] = None,
                   smem_budget_bytes: Optional[int] = None) -> PaddedCOO:
    """Add B independent collections at once.

    ``stacked_mats`` is a batched collection as built by
    :func:`stack_collections`; returns a batched PaddedCOO. The dispatch is
    made once for the whole stack. ``vec``/``blocked_spa`` run one batched
    partitioned launch, ``hash`` one batched sliding-hash launch, ``sorted``
    and ``spa`` one batched plan and segment fold; ``tree`` and the other
    family members run row by row. Each row is bit-identical to the
    per-collection canonical output.
    """
    _, _, effective = explain_batched_dispatch(
        stacked_mats, algorithm=algorithm, cost_model=cost_model)
    if effective in ("blocked_spa", "vec"):
        cat = concat(stacked_mats)
        return _partitioned_core(cat.keys, cat.vals, cat.shape, effective,
                                 smem_budget_bytes)
    if effective == "hash":
        cat = concat(stacked_mats)
        return _hash_core(cat.keys, cat.vals, cat.shape, smem_budget_bytes)
    if effective in ("sorted", "spa"):
        return _CANONICAL[effective](list(stacked_mats), cost_model=cost_model)

    def one(mats):
        return _CANONICAL[effective](mats, cost_model=cost_model) \
            if effective in _CANONICAL \
            else _alg.spkadd(mats, algorithm=effective)

    rows = [one(unstack_collection(stacked_mats, b))
            for b in range(stacked_mats[0].keys.shape[0])]
    return PaddedCOO(keys=torch.stack([r.keys for r in rows]),
                     vals=torch.stack([r.vals for r in rows]),
                     nnz=torch.stack([r.nnz for r in rows]),
                     shape=stacked_mats[0].shape)


# ---------------------------------------------------------------------------
# ragged batched execution (capacity bucketing)
# ---------------------------------------------------------------------------

def bucket_collections(collections: Sequence[Sequence[PaddedCOO]]):
    """Group collections by (shape, k, pow2-rounded per-matrix capacities).

    Returns ``{bucket_key: [(orig_index, padded_collection), ...]}`` where
    every matrix's capacity is rounded up to the next power of two.
    """
    buckets: Dict[tuple, List[tuple]] = {}
    for i, coll in enumerate(collections):
        caps = tuple(next_pow2(a.cap) for a in coll)
        padded = [with_capacity(a, c) for a, c in zip(coll, caps)]
        key = (coll[0].shape, caps)
        buckets.setdefault(key, []).append((i, padded))
    return buckets


def spkadd_batched_ragged(collections: Sequence[Sequence[PaddedCOO]], *,
                          algorithm: str = "auto",
                          cost_model: Optional[Dict[str, float]] = None,
                          smem_budget_bytes: Optional[int] = None
                          ) -> List[PaddedCOO]:
    """:func:`spkadd_batched` for *ragged* stacks: collections are bucketed
    by (shape, k, pow2-rounded capacities) and each bucket runs as one
    batched call. Results come back in input order; a result's capacity is
    its bucket's rounded total."""
    results: List[Optional[PaddedCOO]] = [None] * len(collections)
    buckets = bucket_collections(collections)
    obs.counter("engine.ragged.calls").inc()
    with obs.span("engine.spkadd_batched_ragged", algorithm=algorithm,
                  collections=len(collections), buckets=len(buckets)):
        for _, members in buckets.items():
            obs.histogram("engine.ragged.bucket_occupancy").observe(
                len(members))
            idxs = [i for i, _ in members]
            stacked = stack_collections([padded for _, padded in members])
            out = spkadd_batched(stacked, algorithm=algorithm,
                                 cost_model=cost_model,
                                 smem_budget_bytes=smem_budget_bytes)
            for b, i in enumerate(idxs):
                results[i] = unstack_collection([out], b)[0]
    return results
