"""The port's kernel modules (plain versions on the CPU) against the reference.

- partition: the plain version against the reference's Pallas kernel
  (``fold="onehot"``, interpret mode — the fold that runs on this tree) and
  against ``ref.spa_accumulate_ref``, on the same step tables;
- hash_slide: the plain version against a numpy replay of the reference's
  probe sequence (the reference kernel's own tests' replay, copied), whose
  slot placement the raw tables must match;
- segment fold against ``jax.ops.segment_sum``;
- launch geometry, modelled counts and oracles against the reference's.

Tolerance everywhere: bitwise.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import hash_accum as J_hash
from repro.kernels import hash_slide as J_hslide
from repro.kernels import ops as J_ops
from repro.kernels import partition as J_part
from repro.kernels import ref as J_ref
from repro.kernels import vec_accum as J_vec
from repro_torch.core import sparse as TS
from repro_torch.kernels import hash_accum as T_hash
from repro_torch.kernels import hash_slide as T_hslide
from repro_torch.kernels import ops as T_ops
from repro_torch.kernels import partition as T_part
from repro_torch.kernels import ref as T_ref
from repro_torch.kernels import segment as T_seg
from repro_torch.kernels import vec_accum as T_vec

from _torch_parity import (assert_bytes_equal, jax_partition_steps,
                           jax_plan_and_partition, np_of)
from test_torch_cuda import SEGMENT_FOLD_CASES, fold_inputs, segment_fold_case


# ---------------------------------------------------------------------------
# partition: plain version vs the reference kernel and oracle
# ---------------------------------------------------------------------------

def both_partitioned(keys, vals, *, m, n, part_elems, chunk):
    """Plan + step tables + raw launch in both packages, as the engines wire
    them; returns (reference flat, port flat)."""
    kj, vj = jnp.asarray(keys), jnp.asarray(vals)
    plan, keys_p, steps = jax_plan_and_partition(kj, shape=(m, n),
                                                 part_elems=part_elems,
                                                 chunk=chunk)
    vals_p = jnp.zeros(keys_p.shape, jnp.float32).at[:len(keys)].set(
        vj[plan.order])
    parts = -(-m * n // part_elems)
    ref = J_ops.partitioned_accumulate_flat(
        keys_p, vals_p, steps.chunk_id, steps.part_id, m=m, n=n,
        part_elems=part_elems, parts=parts, chunk=chunk, fold="onehot",
        interpret=True)
    tk, tv = torch.as_tensor(keys), torch.as_tensor(vals)
    tplan, tkeys_p, tsteps = TS.plan_and_partition(tk, (m, n),
                                                   part_elems=part_elems,
                                                   chunk=chunk)
    tvals_p = torch.zeros(tkeys_p.shape)
    tvals_p[:len(keys)] = tv[tplan.order]
    port = T_part.partitioned_accumulate_raw(
        tkeys_p[None], tvals_p[None], tsteps.chunk_id[None],
        tsteps.part_id[None], mn=m * n, part_elems=part_elems, parts=parts,
        chunk=chunk)
    tail = np_of(port)[0, m * n:]
    assert tail.tobytes() == np.zeros_like(tail).tobytes()
    return ref, port[0, :m * n]


def flat_oracle(keys, vals, m, n):
    return np.asarray(J_ref.spa_accumulate_ref(
        jnp.asarray(keys), jnp.asarray(vals), m=m, n=n)).T.reshape(-1)


@pytest.mark.parametrize("m,n,nnz,part_elems,chunk", [
    (16, 6, 40, 32, 8),     # 3 parts, boundary chunks span parts
    (32, 8, 100, 256, 16),  # single-part degenerate
    (16, 4, 50, 8, 8),      # tiny parts: many empty + multi-part chunks
    (24, 4, 30, 128, 32),   # chunk > nnz: sentinel-tail padding
])
def test_partition_plain_vs_reference_kernel(m, n, nnz, part_elems, chunk):
    rng = np.random.default_rng(m * n + nnz)
    keys = rng.integers(0, m * n, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    ref, port = both_partitioned(keys, vals, m=m, n=n,
                                 part_elems=part_elems, chunk=chunk)
    assert_bytes_equal(ref, port)
    assert_bytes_equal(flat_oracle(keys, vals, m, n), port)


def test_partition_plain_boundary_spanning_runs():
    keys = np.concatenate([np.full(20, 15), np.full(20, 16),
                           np.full(3, 63)]).astype(np.int32)
    vals = np.random.default_rng(3).standard_normal(len(keys)).astype(
        np.float32)
    ref, port = both_partitioned(keys, vals, m=8, n=8, part_elems=16, chunk=8)
    assert_bytes_equal(ref, port)


def test_partition_plain_empty_parts_and_all_sentinel():
    keys = np.array([0, 1, 127, 126, 0], np.int32)
    ref, port = both_partitioned(keys, np.ones(5, np.float32), m=16, n=8,
                                 part_elems=16, chunk=8)
    assert_bytes_equal(ref, port)
    ref, port = both_partitioned(np.full(5, 128, np.int32),
                                 np.zeros(5, np.float32), m=16, n=8,
                                 part_elems=16, chunk=8)
    assert_bytes_equal(ref, port)
    assert np_of(port).tobytes() == np.zeros(128, np.float32).tobytes()


def test_partition_plain_duplicate_heavy():
    rng = np.random.default_rng(7)
    uniq = rng.choice(128, 12, replace=False)
    keys = np.concatenate([uniq, rng.choice(uniq, 108)]).astype(np.int32)
    rng.shuffle(keys)
    vals = rng.standard_normal(len(keys)).astype(np.float32)
    ref, port = both_partitioned(keys, vals, m=16, n=8, part_elems=32,
                                 chunk=16)
    assert_bytes_equal(ref, port)


def test_partition_plain_batched_rows_are_independent():
    rng = np.random.default_rng(5)
    m, n, pe, chunk = 16, 8, 32, 16
    keys = np.sort(rng.integers(0, m * n + 1, size=(3, 64)), axis=1)
    keys = keys.astype(np.int32)
    vals = rng.standard_normal((3, 64)).astype(np.float32)
    vals[keys >= m * n] = 0.0
    steps = TS.partition_steps(torch.as_tensor(keys), mn=m * n,
                               part_elems=pe, parts=4, chunk=chunk)
    port = T_part.partitioned_accumulate_raw(
        torch.as_tensor(keys), torch.as_tensor(vals), *steps, mn=m * n,
        part_elems=pe, parts=4, chunk=chunk)
    jsteps = jax.vmap(lambda k: jax_partition_steps(
        k, mn=m * n, part_elems=pe, parts=4, chunk=chunk))(jnp.asarray(keys))
    ref = J_part.partitioned_accumulate_raw(
        jnp.asarray(keys), jnp.asarray(vals), jsteps.chunk_id, jsteps.part_id,
        mn=m * n, part_elems=pe, parts=4, chunk=chunk, fold="onehot")
    assert_bytes_equal(ref, port)


def test_partition_wrapper_checks_and_counts_no_cpu_launch():
    keys = torch.full((1, 16), 64, dtype=torch.int32)
    steps = TS.partition_steps(keys, mn=64, part_elems=32, parts=2, chunk=8)
    before = T_part.partitioned_accumulate_raw.launches
    T_part.partitioned_accumulate_raw(keys, torch.zeros(1, 16), *steps,
                                      mn=64, part_elems=32, parts=2, chunk=8)
    assert T_part.partitioned_accumulate_raw.launches == before
    with pytest.raises(ValueError, match="chunk multiple"):
        T_part.partitioned_accumulate_raw(keys, torch.zeros(1, 16), *steps,
                                          mn=64, part_elems=32, parts=2,
                                          chunk=5)
    with pytest.raises(ValueError, match="matching"):
        T_part.partitioned_accumulate_raw(keys, torch.zeros(1, 8), *steps,
                                          mn=64, part_elems=32, parts=2,
                                          chunk=8)


def test_fold_runs_left_associated_from_the_tile_value():
    vals = np.array([1e8, 1.0, 1.0, 1.0, 2.5, -2.5], np.float32)
    slot = torch.tensor([[0, 0, 0, 0, 2, 2]])
    tile = torch.tensor([[3.0, -0.0, 0.5, 7.0]])
    out = T_vec.fold_runs(tile, slot, torch.as_tensor(vals)[None],
                          torch.ones(1, 6, dtype=torch.bool))
    want0 = np.float32(3.0)
    for v in vals[:4]:
        want0 = np.float32(want0 + v)
    want2 = np.float32(np.float32(np.float32(0.5) + np.float32(2.5))
                       + np.float32(-2.5))
    expect = np.array([[want0, -0.0, want2, 7.0]], np.float32)
    assert_bytes_equal(expect, out)   # untouched -0.0 keeps its sign


def test_folds_and_store_counts_match_reference():
    assert T_vec.FOLDS == J_vec.FOLDS
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 64 * 8, 300)
    for block_rows, chunk in ((8, 16), (16, 64), (64, 32)):
        assert T_vec.chunk_store_counts(keys, m=64, n=8,
                                        block_rows=block_rows,
                                        chunk=chunk) == \
            J_vec.chunk_store_counts(keys, m=64, n=8, block_rows=block_rows,
                                     chunk=chunk)


@pytest.mark.parametrize("mn,cap,part_elems,chunk", [
    (256, 100, 64, 16), (4096, 700, 1024, 64), (1000, 37, 128, 8)])
def test_modeled_chunk_loads_match(mn, cap, part_elems, chunk):
    keys = np.random.default_rng(cap).integers(0, mn + 1, cap)
    parts = -(-mn // part_elems)
    kw = dict(mn=mn, part_elems=part_elems, parts=parts, chunk=chunk)
    assert T_part.modeled_chunk_loads(keys, **kw) == \
        J_part.modeled_chunk_loads(keys, **kw)


# ---------------------------------------------------------------------------
# hash_slide: plain version vs the numpy probe replay
# ---------------------------------------------------------------------------

def reference_tables(keys, vals, *, mn, table_size, part_span, parts):
    """Pure-numpy replay of the reference kernel (copied from
    ``tests/test_hash_accum.py``): per-part linear-probe tables,
    insert-or-accumulate in stream order, f32 folds from 0.0."""
    keys = np.asarray(keys)
    vals = np.asarray(vals, np.float32)
    B = keys.shape[0]
    mask = table_size - 1
    tkeys = np.full((B, parts * table_size), -1, np.int32)
    tvals = np.zeros((B, parts * table_size), np.float32)
    for b in range(B):
        for k, v in zip(keys[b], vals[b]):
            k = int(k)
            if k >= mn:
                continue
            p = k // part_span
            h = (k * J_hash.HASH_PRIME) & mask
            while tkeys[b, p * table_size + h] not in (-1, k):
                h = (h + 1) & mask
            tkeys[b, p * table_size + h] = k
            tvals[b, p * table_size + h] = np.float32(
                tvals[b, p * table_size + h] + np.float32(v))
    return tkeys, tvals


@pytest.mark.parametrize("parts,chunk", [(1, 64), (2, 64), (4, 32), (3, 16)])
def test_hash_slide_plain_vs_numpy_replay(parts, chunk):
    mn, cap = 256, 128
    rng = np.random.default_rng(7 + parts)
    keys = rng.integers(0, mn, size=(2, cap)).astype(np.int32)
    vals = rng.standard_normal((2, cap)).astype(np.float32)
    keys[:, ::5] = mn
    vals[:, ::5] = 0.0
    part_span = -(-mn // parts)
    table_size = T_hash.hash_table_size(min(cap, part_span))
    kw = dict(mn=mn, table_size=table_size, part_span=part_span, parts=parts)
    tk, tv = T_hslide.hash_slide_raw(torch.as_tensor(keys),
                                     torch.as_tensor(vals), chunk=chunk, **kw)
    rk, rv = reference_tables(keys, vals, **kw)
    np.testing.assert_array_equal(np_of(tk), rk)
    assert_bytes_equal(rv, tv)


def test_hash_slide_plain_crafted_collision_chain():
    mn, table_size = 1 << 12, 128
    chain = [5 + i * table_size for i in range(6)]
    stream = chain + chain[::-1] + chain
    keys = np.asarray([stream + [mn] * (64 - len(stream))], np.int32)
    vals = np.asarray([np.arange(64, dtype=np.float32) + 1.0])
    vals[keys >= mn] = 0.0
    kw = dict(mn=mn, table_size=table_size, part_span=mn, parts=1)
    tk, tv = T_hslide.hash_slide_raw(torch.as_tensor(keys),
                                     torch.as_tensor(vals), chunk=64, **kw)
    rk, rv = reference_tables(keys, vals, **kw)
    np.testing.assert_array_equal(np_of(tk), rk)
    assert_bytes_equal(rv, tv)
    stats = T_hslide.modeled_insert_stats(keys, chunk=64, **kw)
    assert stats == J_hslide.modeled_insert_stats(keys, chunk=64, **kw)
    assert stats["max_probes"] == len(chain)


def test_hash_slide_multi_part_collisions_across_parts():
    """Keys congruent mod the table collide inside each part; parts > 1
    keep separate tables."""
    mn, parts, table_size = 1024, 4, 128
    part_span = mn // parts
    keys = np.asarray([[3, 3 + 128, 259, 259 + 128 - 256 + 256, 3, 700, 700,
                        1023, 3 + 128] + [mn] * 7], np.int32)
    vals = np.asarray([np.linspace(-2, 2, 16, dtype=np.float32)])
    vals[keys >= mn] = 0.0
    kw = dict(mn=mn, table_size=table_size, part_span=part_span, parts=parts)
    tk, tv = T_hslide.hash_slide_raw(torch.as_tensor(keys),
                                     torch.as_tensor(vals), chunk=8, **kw)
    rk, rv = reference_tables(keys, vals, **kw)
    np.testing.assert_array_equal(np_of(tk), rk)
    assert_bytes_equal(rv, tv)


def test_hash_slide_rejects_bad_geometry():
    keys = torch.zeros((1, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="load factor"):
        T_hslide.hash_slide_raw(keys, torch.zeros(1, 64), mn=256,
                                table_size=64, part_span=256, parts=1,
                                chunk=64)
    with pytest.raises(ValueError, match="2\\^q"):
        T_hslide.hash_slide_raw(keys, torch.zeros(1, 64), mn=256,
                                table_size=200, part_span=256, parts=1,
                                chunk=64)
    with pytest.raises(ValueError, match="cover"):
        T_hslide.hash_slide_raw(keys, torch.zeros(1, 64), mn=256,
                                table_size=128, part_span=32, parts=2,
                                chunk=64)


def test_modeled_insert_stats_match():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 600, size=(1, 96)).astype(np.int32)
    for parts in (1, 3):
        span = -(-512 // parts)
        kw = dict(mn=512, table_size=T_hash.hash_table_size(min(96, span)),
                  part_span=span, parts=parts, chunk=32)
        assert T_hslide.modeled_insert_stats(keys, **kw) == \
            J_hslide.modeled_insert_stats(keys, **kw)


def test_hash_helpers_match():
    assert T_hash.HASH_PRIME == J_hash.HASH_PRIME
    for bound in [0, 1, 2, 3, 7, 8, 100, 1023, 1024, 5000]:
        assert T_hash.hash_table_size(bound) == J_hash.hash_table_size(bound)


# ---------------------------------------------------------------------------
# segment fold vs jax.ops.segment_sum
# ---------------------------------------------------------------------------

#: The card tests' edge cases at a tile of 64 (the kernel's is 2,048):
#: run lengths around strips, warp slices and tiles, runs of 3 tiles and
#: more, dropped ids, ragged rows, -0.0, subnormals, bf16 ties and NaNs.
CPU_FOLD_TILE = 64


@pytest.mark.parametrize("case", [f"seed:{n}:{s}:{seed}" for n, s, seed in (
    (50, 50, 0), (200, 13, 1), (64, 1, 2), (7, 30, 3))] + SEGMENT_FOLD_CASES)
def test_segment_fold_matches_segment_sum(case):
    if case.startswith("seed:"):
        length, segs, seed = map(int, case.split(":")[1:])
        rng = np.random.default_rng(seed)
        gid = np.sort(rng.integers(0, segs, size=length)).astype(np.int32)
        vals = (rng.standard_normal(length) * 10.0 ** rng.integers(
            -3, 8, size=length)).astype(np.float32)
        vals[::9] = -0.0
        bf16 = False  # one (L,) stream
    else:
        vals, gid, segs, bf16 = segment_fold_case(case, CPU_FOLD_TILE)
    port = T_seg.segment_fold(*fold_inputs(vals, gid, bf16), segs)
    port = np.atleast_2d(np_of(port.view(torch.int16) if bf16 else port))
    jvals = jnp.asarray(np.atleast_2d(vals))
    jvals = jvals.view(jnp.bfloat16) if bf16 else jvals
    for b, row in enumerate(np.atleast_2d(gid)):
        ref = np.asarray(jax.ops.segment_sum(jvals[b], jnp.asarray(row),
                                             num_segments=segs))
        assert_bytes_equal(ref.view(np.int16) if bf16 else ref, port[b],
                           case)


def test_segment_fold_geometry_covers_every_row():
    """The kernel's grid: every element of every row lies in one of its
    row's tiles, which start at the 8-element boundary at or before the
    row, and the grid has no tile more than a row 7 elements past that
    boundary needs (the kernel skips a tile past its row's end)."""
    for rows, length in ((1, 1), (3, 7), (5, 2041), (2, 2048), (3, 2049),
                         (70000, 9), (1, 1 << 24)):
        geo = T_seg.fold_geometry(rows, length)
        assert geo.tile == T_seg.TILE == 2048
        assert geo.grid_rows == min(rows, 65535)
        assert geo.blocks == geo.tiles_per_row * geo.grid_rows
        for r in {0, 1, rows - 1} & set(range(rows)):
            r0 = r * length
            a0 = r0 - r0 % T_seg.ITEMS
            assert a0 + geo.tiles_per_row * geo.tile >= r0 + length
        assert (geo.tiles_per_row - 1) * geo.tile < length + T_seg.ITEMS - 1


def test_segment_fold_batched_and_out_of_range_ids_drop():
    rng = np.random.default_rng(4)
    gid = np.sort(rng.integers(-2, 12, size=(3, 40)), axis=1).astype(np.int32)
    vals = rng.standard_normal((3, 40)).astype(np.float32)
    port = T_seg.segment_fold(torch.as_tensor(vals), torch.as_tensor(gid), 10)
    for b in range(3):
        ref = jax.ops.segment_sum(jnp.asarray(vals[b]), jnp.asarray(gid[b]),
                                  num_segments=10)
        assert_bytes_equal(ref, np_of(port)[b])
    before = T_seg.segment_fold.launches
    T_seg.segment_fold(torch.as_tensor(vals), torch.as_tensor(gid), 10)
    assert T_seg.segment_fold.launches == before  # the CPU runs the plain fold


# ---------------------------------------------------------------------------
# launch geometry and oracles vs the reference
# ---------------------------------------------------------------------------

GEOM_GRID = [(cap, m, n, budget)
             for cap in (1, 100, 5000, 1 << 17)
             for m, n in ((16, 4), (256, 32), (65536, 512))
             for budget in (4096, 232448, 16 * 1024 * 1024)]


@pytest.mark.parametrize("budget", [4096, 232448, 16 * 1024 * 1024])
def test_launch_geometry_matches_reference(budget):
    for cap, m, n, b in GEOM_GRID:
        if b != budget:
            continue
        assert tuple(T_ops.partitioned_launch_geometry(
            cap, m=m, n=n, smem_budget_bytes=b)) == tuple(
            J_ops.partitioned_launch_geometry(cap, m=m, n=n,
                                              vmem_budget_bytes=b)), (cap, m, n)
        assert tuple(T_ops.hash_launch_geometry(
            cap, m=m, n=n, smem_budget_bytes=b)) == tuple(
            J_ops.hash_launch_geometry(cap, m=m, n=n,
                                       vmem_budget_bytes=b)), (cap, m, n)
        assert T_ops.choose_block_rows(m, n, b) == \
            J_ops.choose_block_rows(m, n, b)
    for fold in ("serial", "sort", "onehot"):
        assert T_ops.fold_working_set_bytes(fold, tile_elems=512, chunk=64) \
            == J_ops.fold_working_set_bytes(fold, tile_elems=512, chunk=64)


def test_card_budget_geometry_of_the_main_path():
    """At the H100 block limit the formula gives a 54,016-element tile and
    one 16,384-slot table for an 8,192-nonzero collection."""
    g = T_ops.partitioned_launch_geometry(1 << 24, m=65536, n=512,
                                          smem_budget_bytes=232448)
    assert (g.part_elems, g.parts, g.chunk) == (54016, 622, 1024)
    assert g.part_elems * 4 <= 232448
    h = T_ops.hash_launch_geometry(8192, m=65536, n=256,
                                   smem_budget_bytes=232448)
    assert (h.table_size, h.parts) == (16384, 1)
    assert (h.table_size + h.chunk) * 8 <= 232448
    assert T_ops.device_smem_budget("cpu") == T_ops.REFERENCE_VMEM_BUDGET


def test_flat_wrapper_matches_reference_wrapper():
    rng = np.random.default_rng(8)
    m, n, cap = 16, 8, 60
    keys = np.sort(rng.integers(0, m * n, cap)).astype(np.int32)
    vals = rng.standard_normal(cap).astype(np.float32)
    g = T_ops.partitioned_launch_geometry(cap, m=m, n=n, part_elems=32,
                                          chunk=16)
    kp = np.full(g.num_chunks * g.chunk, m * n, np.int32)
    vp = np.zeros(g.num_chunks * g.chunk, np.float32)
    kp[:cap], vp[:cap] = keys, vals
    js = jax_partition_steps(jnp.asarray(kp), mn=m * n, part_elems=32,
                             parts=g.parts, chunk=16)
    ref = J_ops.partitioned_accumulate_flat(
        jnp.asarray(kp), jnp.asarray(vp), js.chunk_id, js.part_id, m=m, n=n,
        part_elems=32, parts=g.parts, chunk=16, fold="onehot")
    ts = TS.partition_steps(torch.as_tensor(kp), mn=m * n, part_elems=32,
                            parts=g.parts, chunk=16)
    port = T_ops.partitioned_accumulate_flat(
        torch.as_tensor(kp), torch.as_tensor(vp), ts.chunk_id, ts.part_id,
        m=m, n=n, part_elems=32, parts=g.parts, chunk=16)
    assert_bytes_equal(ref, port)


# ---------------------------------------------------------------------------
# plain references (kernels/ref.py)
# ---------------------------------------------------------------------------

def test_refs_match_reference_refs():
    rng = np.random.default_rng(12)
    m, n, cap = 12, 5, 80
    keys = rng.integers(0, m * n + 1, cap).astype(np.int32)
    vals = rng.standard_normal(cap).astype(np.float32)
    vals[keys == m * n] = 0.0
    assert_bytes_equal(
        J_ref.spa_accumulate_ref(jnp.asarray(keys), jnp.asarray(vals), m=m,
                                 n=n),
        T_ref.spa_accumulate_ref(torch.as_tensor(keys), torch.as_tensor(vals),
                                 m=m, n=n))
    rk, rv, rn = J_ref.hash_accumulate_ref(jnp.asarray(keys),
                                           jnp.asarray(vals), sent=m * n)
    pk, pv, pn = T_ref.hash_accumulate_ref(torch.as_tensor(keys),
                                           torch.as_tensor(vals), sent=m * n)
    np.testing.assert_array_equal(np.asarray(rk), np_of(pk))
    assert_bytes_equal(rv, pv)
    assert int(rn) == int(pn)
    assert int(J_ref.hash_symbolic_ref(jnp.asarray(keys), sent=m * n)) == \
        int(T_ref.hash_symbolic_ref(torch.as_tensor(keys), sent=m * n))
    x = rng.permutation(np.linspace(-3, 3, 64).astype(np.float32))
    ri, rvv = J_ref.topk_block_ref(jnp.asarray(x), 3, 16)
    pi, pvv = T_ref.topk_block_ref(torch.as_tensor(x), 3, 16)
    np.testing.assert_array_equal(np.asarray(ri), np_of(pi))
    assert_bytes_equal(rvv, pvv)
