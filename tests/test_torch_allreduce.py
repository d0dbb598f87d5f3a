"""The port's sparse gradient allreduce (``repro_torch.core.allreduce``)
against the reference (``repro.core.allreduce``), on the CPU.

The port runs in one gloo world of 8 ranks, started once for this file
(``repro_torch.launch.world.spawn_world``, each rank a fresh process,
joined with a time limit); the ranks run ``tests/_torch_world.py``. The
reference runs its own functions unchanged under ``jax.vmap(...,
axis_name=...)`` (nested for the 2-D mesh) in this process: its collectives
then act on the vmapped axis, with no devices to fake. Both sides take the
same numpy inputs, and each rank's result is compared with the reference's
row for that rank, bitwise where the reference's arithmetic is the port's:
every schedule's fold adds each key's values in the same stream order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_world as W
from _torch_parity import assert_bytes_equal
from repro.core import allreduce as RAR
from repro.core import topk as RT
from repro_torch.core import allreduce as AR
from repro_torch.core import topk as T
from repro_torch.launch.world import WorldError, spawn_world

#: The world's time limit: a stuck rank fails the tests, not the suite.
WORLD_TIMEOUT_S = 150


@pytest.fixture(scope="module")
def world():
    return spawn_world(W.allreduce_rank, W.P, timeout=WORLD_TIMEOUT_S)


def _ref_update(g, case):
    c = W.STREAM_CASES[case]
    return (RT.topk_global(g, c["k"]) if c["selector"] == "global"
            else RT.topk_block(g, c["k"]))


@functools.lru_cache(maxsize=None)
def ref_streams(case, p=W.P):
    """The reference's ``sparse_allreduce`` under ``vmap`` over ``p``
    workers: ``{schedule: (p, size)}``."""
    scheds = W.SCHEDULES if p & (p - 1) == 0 else ("gather_kway",
                                                   "ring_2way")

    def worker(g):
        u = _ref_update(g, case)
        out = {s: RAR.sparse_allreduce(u, "data", s) for s in scheds}
        if case == "k50" and p == W.P:
            # the reference's vec accumulator runs here only where its
            # tile takes the one-hot fold (the sort fold needs pl.store,
            # which this jax lacks)
            out["gather_kway_vec"] = RAR.sparse_allreduce(
                u, "data", "gather_kway", accumulator="vec")
        return out

    res = jax.jit(jax.vmap(worker, axis_name="data"))(
        jnp.asarray(W.stream_inputs(case, p)))
    return {k: np.asarray(v) for k, v in res.items()}


@pytest.mark.parametrize("sched", W.SCHEDULES + ("gather_kway_vec",))
@pytest.mark.parametrize("case", sorted(W.STREAM_CASES))
def test_schedule_bitwise_equal_to_reference(world, case, sched):
    ref = ref_streams(case)
    # where the reference's vec fold cannot run, its own contract stands
    # in: vec is bitwise its scatter (tests/test_distributed.py)
    want = ref.get(sched, ref["gather_kway"])
    for rank, res in enumerate(world):
        assert_bytes_equal(want[rank], res[f"{case}/{sched}"],
                           f"{case} {sched} rank {rank}")


@pytest.mark.parametrize("case", sorted(W.STREAM_CASES))
def test_vec_accumulator_equals_scatter(world, case):
    for res in world:
        assert_bytes_equal(res[f"{case}/gather_kway"],
                           res[f"{case}/gather_kway_vec"], case)


@pytest.mark.parametrize("sched", W.SCHEDULES)
def test_schedules_match_the_numpy_expectation(world, sched):
    """The expectation of ``tests/test_distributed.py``'s schedule test:
    the mean of the P workers' top-k, at its tolerance."""
    g = W.stream_inputs("k50")
    size, kk = g.shape[1], W.STREAM_CASES["k50"]["k"]
    expect = np.zeros(size, np.float32)
    for i in range(W.P):
        idx = np.argsort(-np.abs(g[i]))[:kk]
        s = np.zeros(size, np.float32)
        s[idx] = g[i][idx]
        expect += s
    expect /= W.P
    for res in world:
        np.testing.assert_allclose(res[f"k50/{sched}"], expect, rtol=1e-5,
                                   atol=1e-6, err_msg=sched)


@pytest.mark.parametrize("sched", ["gather_kway", "ring_2way"])
def test_group_of_six_bitwise_equal_to_reference(world, sched):
    ref = ref_streams("k50", W.SUBGROUP)
    for rank in range(W.SUBGROUP):
        assert_bytes_equal(ref[sched][rank], world[rank][f"six/{sched}"],
                           f"{sched} rank {rank}")
    for rank in range(W.SUBGROUP, W.P):
        assert f"six/{sched}" not in world[rank]


def test_halving_raises_on_a_group_of_six(world):
    for rank in range(W.SUBGROUP):
        assert "power-of-two" in world[rank]["six/tree_2way_error"]
    with pytest.raises(ValueError, match="power-of-two"):
        AR.stream_order("tree_2way", 6, 0)


@pytest.mark.parametrize("sched", W.SCHEDULES)
@pytest.mark.parametrize("case", sorted(W.STREAM_CASES))
def test_received_bytes_equal_the_model(world, case, sched):
    """What lands in each rank's receive buffers (counted by wrapping the
    exchange) is the modeled payload."""
    s = world[0][f"stream_len/{case}"]
    want = AR.modeled_schedule_bytes(sched, W.P, s)
    assert want == RAR.modeled_schedule_bytes(sched, W.P, s)
    for rank, res in enumerate(world):
        assert res[f"bytes/{case}/{sched}"] == want, (case, sched, rank)


@pytest.mark.parametrize("entry_bytes", [4, 8])
@pytest.mark.parametrize("s", [1, 50, 3500, 70000])
@pytest.mark.parametrize("p", [1, 2, 6, 8, 256])
@pytest.mark.parametrize("sched", W.SCHEDULES)
def test_modeled_schedule_bytes_equal(sched, p, s, entry_bytes):
    assert AR.modeled_schedule_bytes(sched, p, s, entry_bytes) == \
        RAR.modeled_schedule_bytes(sched, p, s, entry_bytes)


def test_obs_counters_under_the_reference_names(world):
    calls = 2 * len(W.STREAM_CASES)  # gather_kway: scatter and vec
    modeled = sum(
        AR.modeled_schedule_bytes(s, W.P, world[0][f"stream_len/{c}"])
        * (2 if s == "gather_kway" else 1)
        for c in W.STREAM_CASES for s in W.SCHEDULES)
    for res in world:
        assert res["obs"] == {
            "allreduce.calls.gather_kway": calls,
            "allreduce.calls.ring_2way": len(W.STREAM_CASES),
            "allreduce.calls.tree_2way": len(W.STREAM_CASES),
            "allreduce.modeled_bytes": modeled}


@pytest.mark.parametrize("sched", W.SCHEDULES)
@pytest.mark.parametrize("case", sorted(W.STREAM_CASES))
def test_stream_order_folds_to_each_ranks_result(world, case, sched):
    """The P workers' streams stacked in :func:`stream_order` and folded
    in one process give each rank's result bitwise: what ``chip_smoke.py``
    drives on one card."""
    g = W.stream_inputs(case)
    us = [W._update(g[w], case) for w in range(W.P)]
    for rank, res in enumerate(world):
        order = AR.stream_order(sched, W.P, rank)
        got = AR.local_fold(torch.stack([us[w].idx for w in order]),
                            torch.stack([us[w].val for w in order]),
                            us[0].size)
        assert_bytes_equal(res[f"{case}/{sched}"], got, f"rank {rank}")


def test_unknown_names_raise():
    u = T.topk_global(torch.arange(8.0), 2)
    with pytest.raises(ValueError, match="unknown schedule"):
        AR.sparse_allreduce(u, None, "butterfly")
    with pytest.raises(ValueError, match="unknown schedule"):
        AR.stream_order("butterfly", 2, 0)
    with pytest.raises(ValueError, match="unknown accumulator"):
        AR.local_fold(u.idx[None], u.val[None], u.size, "heap")


def test_a_failed_rank_fails_the_world_in_time():
    with pytest.raises(WorldError, match="rank 1"):
        spawn_world(W.fail_on_rank_one, 2, timeout=WORLD_TIMEOUT_S)


# -- the compressed means ---------------------------------------------------

#: The dense fallback's tolerance: gloo sums the P values in another order
#: than XLA's reduce over the vmapped axis, a few f32 ulps apart.
FALLBACK_TOL = dict(rtol=1e-6, atol=1e-7)


@functools.lru_cache(maxsize=None)
def ref_cgm(sel, sched):
    grads, res = W.tree_inputs((W.P,), seed=11)

    def worker(g, r):
        return RAR.compressed_gradient_mean(g, r, "data", W.K_FRACTION,
                                            schedule=sched, selector=sel)

    mean, new_r = jax.jit(jax.vmap(worker, axis_name="data"))(grads, res)
    return jax.tree.map(np.asarray, (mean, new_r))


@functools.lru_cache(maxsize=None)
def ref_cgm2d(model_reduce, sched):
    grads, res = W.tree_inputs(W.MESH_2D, seed=12, shard=W.MESH_2D[1])

    def worker(g, r):
        return RAR.compressed_gradient_mean_2d(
            g, r, "data", "model", W.K_FRACTION, schedule=sched,
            model_reduce=model_reduce)

    f = jax.vmap(jax.vmap(worker, axis_name="model"), axis_name="data")
    mean, new_r = jax.jit(f)(grads, res)
    return jax.tree.map(np.asarray, (mean, new_r))


def _check_tree(ref, got, where, label):
    mean_ref, res_ref = ref
    mean, new_r = got
    for name, shape in W.TREE_SHAPES.items():
        msg = f"{label} leaf {name}"
        if int(np.prod(shape)) < AR.MIN_COMPRESS_ELEMS:
            np.testing.assert_allclose(mean[name], mean_ref[name][where],
                                       err_msg=msg, **FALLBACK_TOL)
        else:
            assert_bytes_equal(mean_ref[name][where], mean[name], msg)
        # a fallback leaf's residual comes back untouched
        assert_bytes_equal(res_ref[name][where], new_r[name], msg)


@pytest.mark.parametrize("sched", W.SCHEDULES)
@pytest.mark.parametrize("sel", W.SELECTORS)
def test_compressed_gradient_mean_bitwise(world, sel, sched):
    ref = ref_cgm(sel, sched)
    for rank, res in enumerate(world):
        _check_tree(ref, res[f"cgm/{sel}/{sched}"], rank,
                    f"{sel} {sched} rank {rank}")


@pytest.mark.parametrize("sched", W.SCHEDULES)
@pytest.mark.parametrize("model_reduce", W.MODEL_REDUCES)
def test_compressed_gradient_mean_2d_bitwise(world, model_reduce, sched):
    """With T = 2 the model group's sum is ``a + b`` in either order, so
    the compressed leaves are held bitwise; the fallback leaf's two-group
    mean to :data:`FALLBACK_TOL`."""
    ref = ref_cgm2d(model_reduce, sched)
    t = W.MESH_2D[1]
    for rank, res in enumerate(world):
        _check_tree(ref, res[f"cgm2d/{model_reduce}/{sched}"],
                    (rank // t, rank % t),
                    f"{model_reduce} {sched} rank {rank}")


def test_compressed_2d_rejects_an_unknown_model_reduce():
    with pytest.raises(ValueError, match="unknown model_reduce"):
        AR.compressed_gradient_mean_2d({}, {}, None, None, 0.1,
                                       model_reduce="allreduce")
