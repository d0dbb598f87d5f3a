"""The port's engine and SpKAdd family against the reference, on the CPU.

Every regime of the port — forced, auto-dispatched, batched and ragged — is
held bitwise against the reference's ``sorted`` path on the same numpy
inputs (the reference's partitioned and hash regimes do not all run on this
tree's JAX, its ``sorted`` path does, and the canonical contract makes
them equal). Dispatch, cost-model layering and the sort pins are held
against the reference's own.
"""
import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis.jaxpr_rules import REGIME_FORCES
from repro.core import engine as E
from repro.core import sparse as S
from repro.core.spkadd import (spkadd, symbolic_nnz,
                               symbolic_nnz_per_column)
from repro_torch import obs as tobs
from repro_torch.core import engine as TE
from repro_torch.core import sparse as TS
from repro_torch.core import spkadd as TA

from _torch_parity import (CPU, assert_bytes_equal, assert_same_coo,
                           jax_collection, jax_sorted, np_of, to_port)

REGIMES = ["tree", "sorted", "spa", "vec", "blocked_spa", "hash"]


def port_rows(out):
    return [TS.PaddedCOO(out.keys[b], out.vals[b], out.nnz[b], out.shape)
            for b in range(out.keys.shape[0])]


# ---------------------------------------------------------------------------
# forced regimes and auto dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("forced", REGIMES)
def test_forced_regime_bit_identical_to_reference_sorted(forced):
    k = 3 if forced == "tree" else 8
    mats = jax_collection(42, k, 48, 8, 36)
    assert_same_coo(jax_sorted(mats), TE._CANONICAL[forced](to_port(mats)),
                    forced)


@pytest.mark.parametrize("forced", REGIMES)
def test_forced_regime_via_cost_model(forced):
    k = 3 if forced == "tree" else 8
    mats = jax_collection(9, k, 48, 8, 36)
    force = dict(REGIME_FORCES[forced])
    assert E.explain_dispatch(mats, cost_model=force)[1] == forced
    assert TE.explain_dispatch(to_port(mats), cost_model=force)[1] == forced
    assert_same_coo(jax_sorted(mats),
                    TE.spkadd_auto(to_port(mats), cost_model=force), forced)


@pytest.mark.parametrize("budget", [1024, 2048, 8192])
def test_multi_part_geometries_bit_identical(budget):
    """Small budgets cut the accumulator into many parts and the hash key
    space into many tables."""
    mats = jax_collection(17, 8, 64, 16, 60)
    ref = jax_sorted(mats)
    port = to_port(mats)
    for regime in ("vec", "blocked_spa"):
        assert_same_coo(ref, TE._run_partitioned(port, regime,
                                                 smem_budget_bytes=budget),
                        f"{regime} at {budget}")
    assert_same_coo(ref, TE._run_hash(port, smem_budget_bytes=budget),
                    f"hash at {budget}")
    assert TE.kops.hash_launch_geometry(
        480, m=64, n=16, smem_budget_bytes=budget).parts > 1


@pytest.mark.parametrize("k,nnz", [(2, 4), (8, 4), (32, 4), (2, 160),
                                   (8, 160), (32, 160)])
def test_auto_dispatch_and_output_match(k, nnz):
    mats = jax_collection(k * 1000 + nnz, k, 64, 8, nnz)
    port = to_port(mats)
    rsig, ralg = E.explain_dispatch(mats)
    psig, palg = TE.explain_dispatch(port)
    assert tuple(rsig) == tuple(psig) and ralg == palg
    assert_same_coo(jax_sorted(mats), TE.spkadd_auto(port), palg)


def test_exact_signals_match():
    mats = jax_collection(3, 6, 16, 8, 20)
    assert tuple(E.regime_signals(mats, exact=True)) == \
        tuple(TE.regime_signals(to_port(mats), exact=True))


def test_select_algorithm_regions_match():
    for k in (1, 2, 3, 4, 16):
        for mn in (1024, 1 << 22, 1 << 23, 1 << 25, 1 << 27):
            for density in (1e-6, 1e-4, 0.01, 0.05, 0.5, 2.0):
                for cf in (1.0, 1.2, 1.4, 2.0):
                    sig = (k, density, cf, mn)
                    assert E.select_algorithm(E.RegimeSignals(*sig)) == \
                        TE.select_algorithm(TE.RegimeSignals(*sig)), sig
    assert E.estimate_compression(5e6, 1 << 25) == \
        TE.estimate_compression(5e6, 1 << 25)


def test_main_path_shapes_dispatch_as_the_chip_smoke_expects():
    """The chip run's two phases, by signals alone (no data)."""
    vec = TE.RegimeSignals(k=64, density=0.5,
                           compression=TE.estimate_compression(1 << 24,
                                                               1 << 25),
                           accum_elems=1 << 25)
    assert TE.select_algorithm(vec) == E.select_algorithm(vec) == "vec"
    hsh = TE.RegimeSignals(k=16, density=8192 / (1 << 24),
                           compression=TE.estimate_compression(8192, 1 << 24),
                           accum_elems=1 << 24)
    assert TE.select_algorithm(hsh) == E.select_algorithm(hsh) == "hash"


def test_edge_collections_match():
    # k = 1 with duplicate keys inside the matrix (tree must still dedup)
    rows = np.array([0, 0, 1], np.int32)
    vals = np.array([1.0, 2.0, 3.0], np.float32)
    ref = S.from_coords(jnp.asarray(rows), jnp.asarray(rows),
                        jnp.asarray(vals), (4, 4))
    port = TS.from_coords(rows, rows, vals, (4, 4), device=CPU)
    assert_same_coo(spkadd([ref], algorithm="sorted"), TE.spkadd_auto([port]))
    # all-sentinel collection, every regime
    empty = [S.make_empty((16, 4), cap=8) for _ in range(8)]
    for regime in REGIMES:
        assert_same_coo(jax_sorted(empty),
                        TE._CANONICAL[regime](to_port(empty)), regime)
    # exact cancellation keeps structural keys
    rng = np.random.default_rng(3)
    d = np.zeros((32, 8), np.float32)
    d.flat[rng.choice(d.size, 40, replace=False)] = rng.standard_normal(40)
    a = S.from_dense(jnp.asarray(d), cap=64)
    b = S.from_dense(jnp.asarray(-d), cap=64)
    for regime in REGIMES:
        assert_same_coo(jax_sorted([a, b, a]),
                        TE._CANONICAL[regime](to_port([a, b, a])), regime)


def test_duplicate_heavy_stream_all_regimes():
    mats = jax_collection(101, 16, 6, 2, 8)   # stream 10x the key space
    ref = jax_sorted(mats)
    for regime in REGIMES[1:]:
        assert_same_coo(ref, TE._CANONICAL[regime](to_port(mats)), regime)


# ---------------------------------------------------------------------------
# batched and ragged execution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["auto"] + REGIMES + ["incremental"])
def test_batched_rows_match_reference(algorithm):
    colls = [jax_collection(100 + b, 4, 32, 8, 24) for b in range(3)]
    stacked_ref = E.stack_collections(colls)
    stacked = TE.stack_collections([to_port(c) for c in colls])
    _, rreq, reff = E.explain_batched_dispatch(stacked_ref,
                                               algorithm=algorithm)
    _, preq, peff = TE.explain_batched_dispatch(stacked, algorithm=algorithm)
    assert (rreq, reff) == (preq, peff)
    out = TE.spkadd_batched(stacked, algorithm=algorithm)
    for coll, row in zip(colls, port_rows(out)):
        assert_same_coo(jax_sorted(coll), row, algorithm)


def test_ragged_matches_reference_buckets():
    colls = [jax_collection(7, 4, 16, 4, 10), jax_collection(8, 4, 16, 4, 12),
             jax_collection(9, 3, 16, 4, 10), jax_collection(10, 4, 16, 4, 16)]
    for algorithm in ("auto", "hash", "vec", "sorted"):
        outs = TE.spkadd_batched_ragged([to_port(c) for c in colls],
                                        algorithm=algorithm)
        refs = [jax_sorted(c) for c in colls]
        for c, ref, out in zip(colls, refs, outs):
            assert out.cap == sum(S.next_pow2(a.cap) for a in c)
            nnz = int(ref.nnz)
            assert int(out.nnz) == nnz
            np.testing.assert_array_equal(np.asarray(ref.keys)[:nnz],
                                          np_of(out.keys)[:nnz])
            assert_bytes_equal(np.asarray(ref.vals)[:nnz],
                               np_of(out.vals)[:nnz])
            assert (np_of(out.keys)[nnz:] == 16 * 4).all()
    rb = E.bucket_collections(colls)
    pb = TE.bucket_collections([to_port(c) for c in colls])
    assert {k: [i for i, _ in v] for k, v in rb.items()} == \
        {k: [i for i, _ in v] for k, v in pb.items()}


# ---------------------------------------------------------------------------
# sort pins and observability
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regime", REGIMES)
def test_one_counted_sort_per_call(regime):
    k = 3 if regime == "tree" else 5
    port = to_port(jax_collection(5, k, 32, 8, 24))
    before = TS.sort_calls()
    TE.spkadd_auto(port, cost_model=dict(REGIME_FORCES[regime]))
    expected = k - 1 if regime == "tree" else 1
    assert TS.sort_calls() - before == expected


def test_batched_calls_sort_once():
    stacked = TE.stack_collections([to_port(jax_collection(60 + b, 4, 32, 8,
                                                           24))
                                    for b in range(3)])
    for regime in ("vec", "blocked_spa", "hash", "sorted", "spa"):
        before = TS.sort_calls()
        TE.spkadd_batched(stacked, cost_model=dict(REGIME_FORCES[regime]))
        assert TS.sort_calls() - before == 1, regime


def test_hash_is_sort_free_before_compaction():
    port = to_port(jax_collection(42, 8, 48, 8, 24))
    comp = tobs.counter("engine.hash.compaction_sorts").value
    TE.spkadd_auto(port, cost_model=dict(REGIME_FORCES["hash"]))
    assert tobs.gauge("engine.hash.presort_sorts").value == 0
    assert tobs.counter("engine.hash.compaction_sorts").value == comp + 1


def test_engine_counters_and_spans_match_reference_names():
    port = to_port(jax_collection(4, 8, 48, 8, 36))
    tobs.reset("engine.")
    tobs.set_enabled(True)
    tobs.clear()
    try:
        TE.spkadd_auto(port, cost_model=dict(REGIME_FORCES["vec"]))
        names = [s["name"] for s in tobs.spans()]
    finally:
        tobs.set_enabled(None)
        tobs.clear()
    # the port's leaves (plan, accumulate, gather) in finish order; the
    # reference's two names still come in the reference's order
    assert names == ["engine.concat", "engine.plan", "engine.accumulate",
                     "engine.partitioned_launch", "engine.canonical_gather",
                     "engine.spkadd_auto"]
    ref_names = ["engine.partitioned_launch", "engine.spkadd_auto"]
    assert [n for n in names if n in ref_names] == ref_names
    snap = tobs.snapshot("engine.")
    assert snap["engine.dispatch.vec"]["value"] == 1
    assert snap["engine.partitioned.launches"]["value"] == 1
    # the reference's per-fold counters have no counterpart: the port runs
    # one fold, so it reports none
    assert not [k for k in snap if k.startswith("engine.partitioned.fold.")]


# ---------------------------------------------------------------------------
# the SpKAdd family, symbolic phase, scatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["incremental", "tree", "sorted",
                                       "spa", "vec", "blocked_spa", "hash"])
def test_family_matches_reference(algorithm):
    """The family's members against the reference's; ``blocked_spa`` and
    ``hash`` against the reference paths that run on this tree and that
    the contract makes equal (``vec``, ``sorted``)."""
    mats = jax_collection(21, 5, 16, 8, 20)
    oracle = {"blocked_spa": "vec", "hash": "sorted"}.get(algorithm,
                                                          algorithm)
    ref = jax.jit(functools.partial(spkadd, algorithm=oracle))(mats)
    assert_same_coo(ref, TA.spkadd(to_port(mats), algorithm=algorithm))
    assert_same_coo(ref, TE.spkadd_run(to_port(mats), algorithm=algorithm))


def test_family_names_not_yet_ported_and_unknown_raise():
    """Every member of the reference's family is ported (nothing is left
    that raises "not yet ported"); an unknown name still raises."""
    from repro.core.spkadd import ALGORITHMS

    assert set(TA.ALGORITHMS) == set(ALGORITHMS)
    assert not hasattr(TA, "NOT_YET_PORTED")
    port = to_port(jax_collection(1, 2, 8, 4, 4))
    for name in ALGORITHMS:
        assert int(TA.spkadd(port, algorithm=name).nnz) >= 0
    with pytest.raises(ValueError, match="unknown SpKAdd algorithm"):
        TE.spkadd_run(port, algorithm="typo")
    with pytest.raises(ValueError, match="unknown SpKAdd algorithm"):
        TA.spkadd(port, algorithm="typo")


def test_symbolic_phase_and_two_way_add_match():
    mats = jax_collection(31, 6, 16, 8, 20)
    port = to_port(mats)
    assert int(symbolic_nnz(mats)) == int(TA.symbolic_nnz(port))
    np.testing.assert_array_equal(np.asarray(symbolic_nnz_per_column(mats)),
                                  np_of(TA.symbolic_nnz_per_column(port)))
    from repro.core.spkadd import two_way_add
    assert_same_coo(two_way_add(mats[0], mats[1], cap=25),
                    TA.two_way_add(port[0], port[1], cap=25))


def test_scatter_accumulate_matches():
    rng = np.random.default_rng(13)
    keys = rng.integers(-3, 70, 200).astype(np.int32)
    vals = rng.standard_normal(200).astype(np.float32)
    vals[::11] = -0.0
    assert_bytes_equal(E.scatter_accumulate(jnp.asarray(keys),
                                            jnp.asarray(vals), 64),
                       TE.scatter_accumulate(torch.as_tensor(keys),
                                             torch.as_tensor(vals), 64))


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

def test_cost_model_json_copies_are_equal():
    with open(E.COST_MODEL_CONFIG_PATH) as f:
        ref = json.load(f)
    with open(TE.COST_MODEL_CONFIG_PATH) as f:
        port = json.load(f)
    assert ref == port
    assert E.DEFAULT_COST_MODEL == TE.DEFAULT_COST_MODEL
    assert E.default_cost_model() == TE.default_cost_model()


def test_cost_model_layering_and_calibration(tmp_path, monkeypatch):
    path = tmp_path / "cm.json"
    TE.dump_cost_model({"tree_max_k": 7, "hash_max_compression": 1.1},
                       str(path))
    assert TE.load_cost_model(str(path)) == E.load_cost_model(str(path))
    monkeypatch.setenv(TE.COST_MODEL_ENV, str(path))
    assert TE.default_cost_model()["tree_max_k"] == 7
    assert TE.default_cost_model() == E.default_cost_model()
    monkeypatch.setenv(TE.COST_MODEL_ENV, str(tmp_path / "missing.json"))
    with pytest.raises(OSError):
        TE.default_cost_model()
    cells = [((2, 0.5), "tree"), ((16, 0.02), "spa"), ((16, 0.04), "vec"),
             ((16, 0.001, 1.3), "hash"), ((16, 0.001, 1.1), "hash")]
    assert TE.calibrate_cost_model(cells) == E.calibrate_cost_model(cells)
    assert TE.calibrate_cost_model(dict(cells)) == \
        E.calibrate_cost_model(dict(cells))


def test_entry_points_follow_the_input_device():
    port = to_port(jax_collection(2, 8, 48, 8, 36))
    for regime in REGIMES:
        out = TE._CANONICAL[regime](port)
        assert out.keys.device.type == out.vals.device.type == "cpu"
        assert out.keys.dtype == torch.int32 and out.nnz.dtype == torch.int32
    assert os.path.basename(TE.COST_MODEL_CONFIG_PATH) == \
        "cost_model_default.json"
