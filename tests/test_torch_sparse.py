"""The port's sparse core, interop and observability against the reference.

Same numpy inputs through ``repro.core.sparse`` (JAX) and
``repro_torch.core.sparse`` (PyTorch, CPU); outputs compared bitwise.
"""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import sparse as S
from repro_torch import interop, obs as tobs
from repro_torch.core import sparse as TS
from repro_torch.obs import metrics as tmetrics

from _torch_parity import (CPU, assert_bytes_equal, assert_same_coo,
                           dense_collection, jax_collection, jax_compress,
                           jax_compress_plan, jax_partition_steps,
                           jax_plan_and_partition, np_of, to_port)


def coords(seed, m, n, cap, dup_every=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, size=cap).astype(np.int32)
    cols = rng.integers(0, n, size=cap).astype(np.int32)
    if dup_every:
        rows[::dup_every] = rows[0]
        cols[::dup_every] = cols[0]
    vals = rng.standard_normal(cap).astype(np.float32)
    return rows, cols, vals


def test_next_pow2_matches():
    for x in list(range(0, 70)) + [1023, 1024, 1025, 1 << 20]:
        assert TS.next_pow2(x) == S.next_pow2(x)


@pytest.mark.parametrize("nnz", [None, 0, 5, 17])
def test_from_coords_matches(nnz):
    rows, cols, vals = coords(1, 12, 5, 17, dup_every=4)
    ref = S.from_coords(jnp.asarray(rows), jnp.asarray(cols),
                        jnp.asarray(vals), (12, 5), nnz=nnz)
    port = TS.from_coords(rows, cols, vals, (12, 5), nnz=nnz, device=CPU)
    assert_same_coo(ref, port)
    np.testing.assert_array_equal(np_of(ref.rows), np_of(port.rows))
    np.testing.assert_array_equal(np_of(ref.cols), np_of(port.cols))


def test_from_coords_batched_rows_match_per_row():
    rows = np.stack([coords(s, 8, 4, 10)[0] for s in range(3)])
    cols = np.stack([coords(s, 8, 4, 10)[1] for s in range(3)])
    vals = np.stack([coords(s, 8, 4, 10)[2] for s in range(3)])
    port = TS.from_coords(rows, cols, vals, (8, 4), nnz=[10, 3, 7],
                          device=CPU)
    for b, nnz in enumerate([10, 3, 7]):
        ref = S.from_coords(jnp.asarray(rows[b]), jnp.asarray(cols[b]),
                            jnp.asarray(vals[b]), (8, 4), nnz=nnz)
        assert_same_coo(ref, TS.PaddedCOO(port.keys[b], port.vals[b],
                                          port.nnz[b], port.shape))


def test_make_empty_matches():
    assert_same_coo(S.make_empty((6, 3), cap=9),
                    TS.make_empty((6, 3), cap=9, device=CPU))


@pytest.mark.parametrize("cap", [4, 10, 40])
def test_from_dense_matches(cap):
    d = dense_collection(3, 1, 6, 5, 10)[0]
    d[0, 0] = -0.0  # a signed zero is not a nonzero
    ref = S.from_dense(jnp.asarray(d), cap=cap)
    port = TS.from_dense(torch.as_tensor(d), cap=cap)
    assert_same_coo(ref, port)


def test_to_dense_matches_with_duplicates_and_signed_zeros():
    rows, cols, vals = coords(5, 7, 4, 40, dup_every=3)
    vals[1::5] = -0.0
    ref = S.from_coords(jnp.asarray(rows), jnp.asarray(cols),
                        jnp.asarray(vals), (7, 4), nnz=33)
    port = TS.from_coords(rows, cols, vals, (7, 4), nnz=33, device=CPU)
    assert_bytes_equal(ref.to_dense(), port.to_dense())


def test_sort_by_key_and_compress_plan_match():
    rows, cols, vals = coords(7, 9, 6, 50, dup_every=5)
    ref = S.from_coords(jnp.asarray(rows), jnp.asarray(cols),
                        jnp.asarray(vals), (9, 6), nnz=44)
    port = TS.from_coords(rows, cols, vals, (9, 6), nnz=44, device=CPU)
    assert_same_coo(S.sort_by_key(ref), TS.sort_by_key(port))
    rp = jax_compress_plan(ref.keys, shape=ref.shape)
    pp = TS.compress_plan(port.keys, port.shape)
    for field in ("order", "gid", "is_new", "out_keys", "nnz"):
        np.testing.assert_array_equal(np_of(getattr(rp, field)),
                                      np_of(getattr(pp, field)),
                                      err_msg=field)


def test_compress_plan_batched_rows_match_per_row():
    keys = np.stack([S.from_coords(*(jnp.asarray(x) for x in coords(s, 8, 4, 24,
                                                                    3)),
                                   (8, 4), nnz=20).keys for s in range(3)])
    batched = TS.compress_plan(torch.as_tensor(keys), (8, 4))
    for b in range(3):
        ref = jax_compress_plan(jnp.asarray(keys[b]), shape=(8, 4))
        for field in ("order", "gid", "is_new", "out_keys", "nnz"):
            np.testing.assert_array_equal(np_of(getattr(ref, field)),
                                          np_of(getattr(batched, field))[b])


@pytest.mark.parametrize("seed,k,m,n,nnz", [(0, 4, 16, 4, 12), (1, 8, 6, 2, 8),
                                            (2, 3, 32, 8, 40)])
def test_compress_and_concat_match(seed, k, m, n, nnz):
    mats = jax_collection(seed, k, m, n, nnz)
    port = to_port(mats)
    assert_same_coo(S.concat(mats), TS.concat(port))
    assert_same_coo(jax_compress(S.concat(mats)),
                    TS.compress(TS.concat(port)))
    assert_same_coo(S.concat(mats, total_cap=5 * nnz),
                    TS.concat(port, total_cap=5 * nnz))


@pytest.mark.parametrize("cap", [3, 12, 30])
def test_with_capacity_matches(cap):
    ref = jax_collection(4, 1, 8, 4, 12)[0]
    assert_same_coo(S.with_capacity(ref, cap),
                    TS.with_capacity(to_port([ref])[0], cap))


def test_allclose_agrees():
    a, b = jax_collection(6, 2, 8, 4, 10)
    pa, pb = to_port([a, b])
    assert TS.allclose(pa, pa) and S.allclose(a, a)
    assert TS.allclose(pa, pb) == S.allclose(a, b)


@pytest.mark.parametrize("mn,cap,part_elems,chunk,dup", [
    (256, 100, 64, 16, 1),    # multi-part, boundary-spanning chunks
    (256, 100, 256, 32, 4),   # single part
    (4096, 40, 128, 8, 1),    # mostly empty parts
    (200, 64, 128, 16, 1),    # sentinel inside the last part's range
    (128, 48, 32, 16, 64),    # one key repeated across chunks
])
def test_partition_steps_match(mn, cap, part_elems, chunk, dup):
    rng = np.random.default_rng(mn + cap)
    keys = (rng.integers(0, max(mn // dup, 1), size=cap) * dup).astype(np.int32)
    keys[rng.random(cap) < 0.15] = mn
    cap_pad = -(-cap // chunk) * chunk
    kp = np.full(cap_pad, mn, np.int32)
    kp[:cap] = np.sort(keys)
    parts = -(-mn // part_elems)
    ref = jax_partition_steps(jnp.asarray(kp), mn=mn, part_elems=part_elems,
                              parts=parts, chunk=chunk)
    port = TS.partition_steps(torch.as_tensor(kp), mn=mn,
                              part_elems=part_elems, parts=parts, chunk=chunk)
    np.testing.assert_array_equal(np_of(ref.chunk_id), np_of(port.chunk_id))
    np.testing.assert_array_equal(np_of(ref.part_id), np_of(port.part_id))
    # the batched form gives each row its own tables
    both = TS.partition_steps(torch.as_tensor(np.stack([kp, kp])), mn=mn,
                              part_elems=part_elems, parts=parts, chunk=chunk)
    np.testing.assert_array_equal(np_of(both.part_id)[1], np_of(ref.part_id))


def test_partition_steps_all_sentinel_match():
    kp = np.full(64, 256, np.int32)
    ref = jax_partition_steps(jnp.asarray(kp), mn=256, part_elems=64,
                              parts=4, chunk=16)
    port = TS.partition_steps(torch.as_tensor(kp), mn=256, part_elems=64,
                              parts=4, chunk=16)
    np.testing.assert_array_equal(np_of(ref.chunk_id), np_of(port.chunk_id))
    np.testing.assert_array_equal(np_of(ref.part_id), np_of(port.part_id))


@pytest.mark.parametrize("part_elems,chunk", [(128, 16), (512, 64), (1024, 8)])
def test_plan_and_partition_matches(part_elems, chunk):
    cat = S.concat(jax_collection(8, 6, 32, 16, 30))
    rp, rk, rs = jax_plan_and_partition(cat.keys, shape=cat.shape,
                                        part_elems=part_elems, chunk=chunk)
    pp, pk, ps = TS.plan_and_partition(to_port([cat])[0].keys, cat.shape,
                                       part_elems=part_elems, chunk=chunk)
    np.testing.assert_array_equal(np_of(rk), np_of(pk))
    np.testing.assert_array_equal(np_of(rs.chunk_id), np_of(ps.chunk_id))
    np.testing.assert_array_equal(np_of(rs.part_id), np_of(ps.part_id))
    np.testing.assert_array_equal(np_of(rp.out_keys), np_of(pp.out_keys))


def test_sort_counter_counts_each_stable_sort():
    before = TS.sort_calls()
    keys = torch.as_tensor(np.array([3, 1, 2, 1], np.int32))
    TS.stable_argsort(keys)
    TS.stable_sort(keys)
    TS.compress_plan(keys, (4, 4))
    assert TS.sort_calls() - before == 3
    snap = tmetrics.snapshot(TS.SORT_COUNTER_NAME)
    assert snap[TS.SORT_COUNTER_NAME]["value"] == TS.sort_calls()


def test_constructors_need_a_device_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.make_empty((4, 4), cap=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.from_coords([0], [0], [1.0], (4, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.padded_coo_from_numpy([0], [1.0], 1, (4, 4))


def test_interop_roundtrip():
    ref = jax_collection(9, 3, 8, 4, 6)
    port = interop.collection_from_numpy(ref, device=CPU)
    back = interop.collection_to_numpy(port)
    for r, (k, v, n, shape) in zip(ref, back):
        np.testing.assert_array_equal(np.asarray(r.keys), k)
        assert np.asarray(r.vals).tobytes() == v.tobytes()
        assert int(r.nnz) == int(n) and tuple(r.shape) == shape
        assert k.dtype == np.int32 and n.dtype == np.int32


def test_metrics_registry_semantics():
    c = tobs.counter("test_torch.counter")
    g = tobs.gauge("test_torch.gauge")
    h = tobs.histogram("test_torch.hist")
    c.inc(2)
    g.set(5.0)
    for v in (1, 3):
        h.observe(v)
    snap = tobs.snapshot("test_torch.")
    assert snap["test_torch.counter"] == {"type": "counter", "value": 2}
    assert snap["test_torch.hist"]["count"] == 2
    assert snap["test_torch.hist"]["max"] == 3
    tobs.reset("test_torch.")
    assert c.value == 0 and tobs.counter("test_torch.counter") is c
    with pytest.raises(TypeError):
        tobs.gauge("test_torch.counter")


def test_spans_gated_and_exported(tmp_path, monkeypatch):
    tobs.clear()
    monkeypatch.delenv(tobs.OBS_ENV, raising=False)
    tobs.set_enabled(None)
    with tobs.span("off") as sp:
        sp.set_attr("x", 1)
    assert tobs.spans() == []
    tobs.set_enabled(True)
    try:
        with tobs.span("outer", k=2):
            with tobs.span("inner") as sp:
                sp.set_attr("n", torch.tensor(3))
        path = tmp_path / "spans.jsonl"
        assert tobs.export_jsonl(str(path)) == 2
        recs = tobs.read_jsonl(str(path))
    finally:
        tobs.set_enabled(None)
        tobs.clear()
    inner, outer = recs
    assert inner["name"] == "inner" and inner["parent"] == "outer"
    assert inner["depth"] == 1 and inner["attrs"] == {"n": 3}
    assert outer["attrs"] == {"k": 2}
    assert json.dumps(outer)
