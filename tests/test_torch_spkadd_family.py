"""The port's SpKAdd algorithm family and its kernels' plain versions against
the reference, on the CPU.

- ``spkadd(mats, a)`` for all seven algorithms against the reference's
  ``spkadd`` on the same numpy inputs. The reference's ``blocked_spa`` and
  ``hash`` reach Pallas kernels that do not run on this tree's JAX
  (``pl.load``), so they are held against the reference paths that do and
  that the contract makes equal: ``vec`` (the same dense accumulator and
  re-sparsification; its one-hot fold runs here) for ``blocked_spa``,
  ``sorted`` for ``hash``;
- ``spa_accum``: the plain version against the reference's
  ``ref.spa_accumulate_ref`` under all three fold names, and ``vec`` against
  the reference's ``ops.vec_accumulate`` (one-hot fold);
- ``hash_accum``: raw tables against a numpy replay, written here, of the
  reference's ``_hash_kernel`` probe loop (including an undersized table),
  and the symbolic count against ``ref.hash_symbolic_ref``;
- the two tie repairs (``from_dense``, ``topk_block_ref``) against the
  reference's ``lax.top_k`` rule.

Tolerance everywhere: bitwise (keys and nnz exactly, values as bytes).
"""
import functools
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import sparse as S
from repro.kernels import hash_accum as J_hash
from repro.kernels import ops as J_ops
from repro.kernels import ref as J_ref
from repro_torch import obs as tobs
from repro_torch.core import sparse as TS
from repro_torch.core import spkadd as TA
from repro_torch.kernels import hash_accum as T_hash
from repro_torch.kernels import ops as T_ops
from repro_torch.kernels import ref as T_ref
from repro_torch.kernels import spa_accum as T_spa
from repro_torch.kernels import vec_accum as T_vec

from _torch_parity import assert_bytes_equal, assert_same_coo, np_of, to_port

# ``repro.core`` re-exports the function ``spkadd`` under the module's name
J_alg = importlib.import_module("repro.core.spkadd")

ALGOS = ["incremental", "tree", "sorted", "spa", "vec", "blocked_spa", "hash"]

#: the reference path each port algorithm is held against (see the module
#: docstring for the two that differ)
ORACLE = {"blocked_spa": "vec", "hash": "sorted"}


@functools.lru_cache(maxsize=None)
def jax_spkadd(algorithm):
    return jax.jit(functools.partial(J_alg.spkadd, algorithm=algorithm))


def assert_family_matches(mats, algorithm, msg=""):
    ref = jax_spkadd(ORACLE.get(algorithm, algorithm))(mats)
    assert_same_coo(ref, TA.spkadd(to_port(mats), algorithm=algorithm),
                    f"{algorithm} {msg}")


def random_sparse(rng, m, n, nnz, cap):
    """The reference tests' ``random_sparse``: a dense matrix with ``nnz``
    normal nonzeros and its ``from_dense``."""
    d = np.zeros((m, n), np.float32)
    nnz = min(nnz, m * n)
    idx = rng.choice(m * n, size=nnz, replace=False)
    d.flat[idx] = rng.standard_normal(nnz).astype(np.float32)
    return d, S.from_dense(jnp.asarray(d), cap=cap)


def make_stream(rng, m, n, nnz, pad, dup_frac=0.5):
    """The reference kernel tests' stream: shuffled keys with a controlled
    duplicate fraction, then sentinel padding."""
    uniq = rng.choice(m * n, size=max(1, int(nnz * (1 - dup_frac))),
                      replace=False)
    dups = rng.choice(uniq, size=nnz - len(uniq), replace=True) if \
        nnz > len(uniq) else np.empty((0,), np.int64)
    keys = np.concatenate([uniq, dups]).astype(np.int32)
    rng.shuffle(keys)
    vals = rng.standard_normal(len(keys)).astype(np.float32)
    keys = np.concatenate([keys, np.full(pad, m * n, np.int32)])
    vals = np.concatenate([vals, np.zeros(pad, np.float32)])
    return keys, vals


def pad_to(keys, vals, sent, chunk):
    cap_pad = -(-max(len(keys), 1) // chunk) * chunk
    kp = np.full(cap_pad, sent, np.int32)
    vp = np.zeros(cap_pad, np.float32)
    kp[:len(keys)], vp[:len(keys)] = keys, vals
    return kp, vp


# ---------------------------------------------------------------------------
# the tie repairs: top_k_abs keeps lax.top_k's rule
# ---------------------------------------------------------------------------

def test_from_dense_truncation_ties_match_reference():
    d = np.zeros((8, 4), np.float32)
    d[::2, :] = 1.0
    d[1, 1] = -1.0
    ref = S.from_dense(jnp.asarray(d), cap=5)
    np.testing.assert_array_equal(np.asarray(ref.keys), [0, 2, 4, 6, 8])
    before = TS.sort_calls()
    port = TS.from_dense(torch.as_tensor(d), cap=5)
    assert TS.sort_calls() - before == 1  # its key sort; top_k_abs is free
    assert_same_coo(ref, port)


def test_topk_block_ref_ties_match_reference():
    x = np.asarray([1, -1, 1, 0.5, 1, -1, 0, 0] * 4, np.float32)
    ri, rv = J_ref.topk_block_ref(jnp.asarray(x), 3, 8)
    before = TS.sort_calls()
    pi, pv = T_ref.topk_block_ref(torch.as_tensor(x), 3, 8)
    assert TS.sort_calls() == before
    np.testing.assert_array_equal(np.asarray(ri)[:3], [0, 1, 2])
    np.testing.assert_array_equal(np.asarray(ri), np_of(pi))
    assert_bytes_equal(rv, pv)


def test_resparsify_truncation_ties_match_reference():
    flat = np.zeros(40, np.float32)
    flat[[3, 7, 11, 20, 21, 30]] = [2.0, -2.0, 2.0, 1.0, -2.0, 2.0]
    flat[5] = -0.0
    ref = J_alg._resparsify_flat(jnp.asarray(flat), (8, 5), 4)
    port = TA._resparsify_flat(torch.as_tensor(flat), (8, 5), 4)
    np.testing.assert_array_equal(np.asarray(ref.keys), [3, 7, 11, 21])
    assert_same_coo(ref, port)


# ---------------------------------------------------------------------------
# spkadd(mats, algorithm) for all seven, on the reference tests' cases
# ---------------------------------------------------------------------------

def test_algorithm_names_are_the_references():
    assert set(TA.ALGORITHMS) == set(J_alg.ALGORITHMS) == set(ALGOS)
    with pytest.raises(ValueError, match="unknown SpKAdd algorithm"):
        TA.spkadd([], algorithm="typo")


@pytest.mark.parametrize("algorithm", ALGOS)
@pytest.mark.parametrize("k,m,n,nnz", [(2, 16, 8, 10), (5, 32, 12, 40),
                                       (8, 64, 4, 30), (3, 8, 8, 64)])
def test_spkadd_matches_reference(algorithm, k, m, n, nnz):
    rng = np.random.default_rng(k * 1000 + m * 10 + n)
    mats = [random_sparse(rng, m, n, nnz, cap=nnz + 8)[1] for _ in range(k)]
    assert_family_matches(mats, algorithm)


@pytest.mark.parametrize("algorithm", ALGOS)
def test_spkadd_cancellation_matches_reference(algorithm):
    """A + (-A): the dense-accumulator algorithms drop the exact zeros,
    ``sorted``/``hash`` keep them as structural nonzeros; both as the
    reference does."""
    rng = np.random.default_rng(0)
    _, a = random_sparse(rng, 16, 8, 20, cap=32)
    neg = S.PaddedCOO(a.keys, -a.vals, a.nnz, a.shape)
    assert_family_matches([a, neg], algorithm)


@pytest.mark.parametrize("algorithm", ALGOS)
def test_spkadd_unsorted_inputs_match_reference(algorithm):
    rng = np.random.default_rng(3)
    _, a = random_sparse(rng, 16, 4, 12, cap=16)
    perm = rng.permutation(a.cap)
    shuffled = S.PaddedCOO(a.keys[perm], a.vals[perm], a.nnz, a.shape)
    assert_family_matches([shuffled, a], algorithm)


@pytest.mark.parametrize("algorithm", ALGOS)
def test_spkadd_bf16_values_match_reference(algorithm):
    """bf16 inputs, carried into the port by ``interop`` as they are:
    ``spa`` and the merge paths accumulate in bf16 (both packages round
    every add to bf16); ``vec``/``blocked_spa``/``hash`` cast to f32 first,
    so ``hash`` is held against ``sorted`` of the f32-cast inputs. Values
    are compared in their own type, bit for bit."""
    rng = np.random.default_rng(5)
    f32 = [random_sparse(rng, 16, 8, 24, cap=28)[1] for _ in range(4)]
    mats = [S.PaddedCOO(a.keys, a.vals.astype(jnp.bfloat16), a.nnz, a.shape)
            for a in f32]
    ports = to_port(mats)
    assert all(a.vals.dtype == torch.bfloat16 for a in ports)
    if algorithm == "hash":
        mats = [a._replace(vals=a.vals.astype(jnp.float32)) for a in mats]
    ref = jax_spkadd(ORACLE.get(algorithm, algorithm))(mats)
    port = TA.spkadd(ports, algorithm=algorithm)
    np.testing.assert_array_equal(np.asarray(ref.keys), np_of(port.keys))
    assert int(ref.nnz) == int(port.nnz)
    rv = np.asarray(ref.vals)
    pv = port.vals.view(torch.int16) if port.vals.dtype == torch.bfloat16 \
        else port.vals
    assert rv.dtype.itemsize == pv.element_size()
    assert rv.tobytes() == np_of(pv).tobytes()


def test_spkadd_spa_dense_and_out_cap_match_reference():
    rng = np.random.default_rng(9)
    mats = [random_sparse(rng, 12, 6, 20, cap=24)[1] for _ in range(5)]
    port = to_port(mats)
    assert_bytes_equal(J_alg.spkadd_spa_dense(mats),
                       TA.spkadd_spa_dense(port))
    assert_same_coo(J_alg.spkadd_spa(mats, out_cap=7),
                    TA.spkadd_spa(port, out_cap=7))


def test_sort_counts_of_the_kernel_backed_members():
    """``vec`` sorts once before its kernel and once to re-sparsify, as the
    reference does; ``blocked_spa`` only to re-sparsify; ``hash`` once to
    compact and once by key; ``spa`` once more than the reference (its
    ordered accumulation goes through a sort, see ``_spa_flat``)."""
    rng = np.random.default_rng(4)
    port = to_port([random_sparse(rng, 16, 8, 20, cap=24)[1]
                    for _ in range(4)])
    for algorithm, want in (("vec", 2), ("blocked_spa", 1), ("hash", 2),
                            ("spa", 2)):
        before = TS.sort_calls()
        TA.spkadd(port, algorithm=algorithm)
        assert TS.sort_calls() - before == want, algorithm


def test_budget_and_geometry_knobs_match_reference():
    rng = np.random.default_rng(6)
    mats = [random_sparse(rng, 64, 8, 40, cap=48)[1] for _ in range(4)]
    port = to_port(mats)
    for kw in (dict(block_rows=8), dict(block_rows=24),
               dict(smem_budget_bytes=256)):
        jkw = {("vmem_budget_bytes" if k == "smem_budget_bytes" else k): v
               for k, v in kw.items()}
        ref = jax.jit(functools.partial(J_alg.spkadd_vec, fold="onehot",
                                        **jkw))(mats)
        assert_same_coo(ref, TA.spkadd_blocked_spa(port, **kw), str(kw))
        assert_same_coo(ref, TA.spkadd_vec(port, fold="sort", **kw), str(kw))


# ---------------------------------------------------------------------------
# spa_accum: the plain version and the vec wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fold", T_vec.FOLDS)
@pytest.mark.parametrize("m,n,nnz,block_rows,chunk", [
    (32, 8, 50, 8, 16),
    (64, 16, 300, 16, 64),
    (128, 4, 100, 32, 128),     # chunk > nnz: padding path
    (56, 12, 200, 8, 32),       # m not a block multiple
    (8, 8, 64, 64, 16),         # block > m
])
def test_spa_accumulate_sweep_matches_reference(m, n, nnz, block_rows, chunk,
                                                fold):
    rng = np.random.default_rng(m * 1000 + n * 10 + nnz)
    keys, vals = make_stream(rng, m, n, nnz, pad=13)
    want = J_ref.spa_accumulate_ref(jnp.asarray(keys), jnp.asarray(vals),
                                    m=m, n=n)
    kp, vp = pad_to(keys, vals, m * n, chunk)
    got = T_spa.spa_accumulate_raw(torch.as_tensor(kp), torch.as_tensor(vp),
                                   m=m, n=n, block_rows=min(block_rows, m),
                                   chunk=chunk, fold=fold)
    assert_bytes_equal(want, got, fold)
    if fold == "serial":
        got = T_ops.spa_accumulate(torch.as_tensor(keys),
                                   torch.as_tensor(vals), m=m, n=n,
                                   block_rows=min(block_rows, m), chunk=chunk)
        assert_bytes_equal(want, got, "ops.spa_accumulate")


def test_spa_accumulate_bf16_matches_reference():
    rng = np.random.default_rng(7)
    m, n = 32, 8
    keys, vals = make_stream(rng, m, n, 80, pad=0)
    vb = jnp.asarray(vals).astype(jnp.bfloat16)
    want = J_ref.spa_accumulate_ref(jnp.asarray(keys), vb, m=m, n=n)
    got = T_ops.spa_accumulate(torch.as_tensor(keys),
                               torch.as_tensor(vals).to(torch.bfloat16),
                               m=m, n=n, block_rows=8, chunk=32)
    assert got.dtype == torch.float32
    assert_bytes_equal(want, got)


def test_spa_accumulate_signed_zeros_and_out_of_range_keys():
    """``-0.0`` values fold as the reference's scatter folds them (from
    ``+0.0``); keys ``>= m*n`` in the middle of the stream add nothing."""
    m, n = 8, 4
    keys = np.asarray([3, 3, 40, 5, 3, 32, 5, 9], np.int32)
    vals = np.asarray([-0.0, -0.0, 7.0, 1.5, -0.0, 9.0, -1.5, -0.0],
                      np.float32)
    want = J_ref.spa_accumulate_ref(jnp.asarray(keys), jnp.asarray(vals),
                                    m=m, n=n)
    got = T_ops.spa_accumulate(torch.as_tensor(keys), torch.as_tensor(vals),
                               m=m, n=n, chunk=8)
    assert_bytes_equal(want, got)


@pytest.mark.parametrize("m,n,nnz,chunk", [(32, 8, 120, None),
                                           (64, 16, 400, 64),
                                           (40, 6, 90, 16)])
def test_vec_accumulate_flat_matches_reference(m, n, nnz, chunk):
    rng = np.random.default_rng(m + n + nnz)
    keys, vals = make_stream(rng, m, n, nnz, pad=7, dup_frac=0.7)
    kw = dict(m=m, n=n, block_rows=8, chunk=chunk)
    want = J_ops.vec_accumulate_flat(jnp.asarray(keys), jnp.asarray(vals),
                                     fold="onehot", **kw)
    for fold in ("auto",) + T_vec.FOLDS:
        got = T_ops.vec_accumulate_flat(torch.as_tensor(keys),
                                        torch.as_tensor(vals), fold=fold,
                                        **kw)
        assert_bytes_equal(want, got, fold)


def test_vec_geometry_and_store_counts_match_reference():
    for cap in (1, 100, 5000):
        for m, n in ((16, 4), (256, 32), (65536, 512)):
            for budget in (4096, 232448 - 8336, 16 * 1024 * 1024):
                assert T_ops.vec_launch_geometry(
                    cap, m=m, n=n, smem_budget_bytes=budget) == \
                    J_ops.vec_launch_geometry(cap, m=m, n=n,
                                              vmem_budget_bytes=budget)
    rng = np.random.default_rng(2)
    keys, _ = make_stream(rng, 48, 8, 200, pad=5)
    for kw in (dict(), dict(block_rows=16, chunk=32)):
        want = J_ops.vec_store_counts(keys, m=48, n=8, **kw)
        got = T_ops.vec_store_counts(keys, m=48, n=8, **kw)
        assert got == want
        assert tobs.gauge("kernels.vec.stores.sort_fold").value == \
            want["sort_fold"]
    assert T_ops.spa_tile_budget("cpu") == T_ops.REFERENCE_VMEM_BUDGET


def test_spa_accumulate_raw_argument_checks():
    keys = torch.full((24,), 64, dtype=torch.int32)
    vals = torch.zeros(24)
    kw = dict(m=8, n=8, block_rows=8)
    with pytest.raises(ValueError, match="chunk multiple"):
        T_spa.spa_accumulate_raw(keys, vals, chunk=16, **kw)
    with pytest.raises(ValueError, match="unknown fold"):
        T_spa.spa_accumulate_raw(keys, vals, chunk=8, fold="bitonic", **kw)
    with pytest.raises(ValueError, match="power-of-two chunk"):
        T_spa.spa_accumulate_raw(keys, vals, chunk=12, fold="sort", **kw)
    with pytest.raises(ValueError, match="1-D"):
        T_spa.spa_accumulate_raw(keys[None], vals[None], chunk=8, **kw)
    got = T_spa.spa_accumulate_raw(keys, vals, chunk=12, fold="serial", **kw)
    assert bool((got == 0).all())
    assert T_spa.spa_accumulate_raw.launches == 0  # the CPU runs no kernel


# ---------------------------------------------------------------------------
# hash_accum: raw tables against a numpy replay of the reference kernel
# ---------------------------------------------------------------------------

def replay_hash(keys, vals, *, sent, table_size):
    """Pure-numpy replay of the reference's ``_hash_kernel`` and
    ``_hash_symbolic_kernel``: uint32 multiplicative hash, a probe loop of at
    most ``table_size`` steps that ends on an empty slot or the key's own
    (else back on its first slot), then store-and-add (or count a new
    key). Returns ``(tkeys, tvals, distinct_count)``."""
    mask = table_size - 1
    tkeys = np.full(table_size, -1, np.int32)
    tvals = np.zeros(table_size, np.float32)
    sym = np.full(table_size, -1, np.int32)
    count = 0
    for k, v in zip(np.asarray(keys).tolist(), np.asarray(vals, np.float32)):
        if k == sent:
            continue
        for table in (tkeys, sym):
            h = ((k & 0xFFFFFFFF) * J_hash.HASH_PRIME) & mask
            steps = 0
            while steps < table_size and table[h] not in (-1, k):
                h = (h + 1) & mask
                steps += 1
            if table is tkeys:
                tkeys[h] = k
                tvals[h] = np.float32(tvals[h] + np.float32(v))
            elif sym[h] == -1:
                sym[h] = k
                count += 1
    return tkeys, tvals, count


def chain_stream(table_size, sent, length=64):
    """Keys ``5 + i * table_size`` all hash to one slot: a collision chain
    inserted forwards, backwards and forwards again, then sentinels."""
    chain = [5 + i * table_size for i in range(6)]
    stream = chain + chain[::-1] + chain
    keys = np.asarray(stream + [sent] * (length - len(stream)), np.int32)
    vals = np.arange(length, dtype=np.float32) + 1.0
    vals[keys == sent] = 0.0
    return keys, vals


def hash_case(name):
    rng = np.random.default_rng(len(name))
    if name == "random":          # default table (1,024 slots)
        keys, vals = make_stream(rng, 32, 16, 300, pad=9, dup_frac=0.7)
        return keys, vals, 512, None
    if name == "large":           # default table of 16,384 slots (> 8,192)
        keys, vals = make_stream(rng, 256, 64, 5000, pad=11, dup_frac=0.5)
        return keys, vals, 256 * 64, None
    if name == "collisions":
        keys, vals = chain_stream(128, 4096)
        return keys, vals, 4096, 128
    if name == "undersized":      # 8 slots for 20 distinct keys
        keys = rng.permutation(np.repeat(np.arange(20) * 3, 2)).astype(
            np.int32)
        vals = rng.standard_normal(40).astype(np.float32)
        return keys, vals, 1000, 8
    if name == "same_key":
        return (np.full(64, 7, np.int32), np.ones(64, np.float32), 1000,
                None)
    if name == "all_sentinel":
        return (np.full(16, 100, np.int32), np.zeros(16, np.float32), 100,
                None)
    assert name == "empty"
    return np.zeros(0, np.int32), np.zeros(0, np.float32), 100, None


HASH_CASES = ["random", "large", "collisions", "undersized", "same_key",
              "all_sentinel", "empty"]


@pytest.mark.parametrize("case", HASH_CASES)
def test_hash_raw_tables_match_numpy_replay(case):
    keys, vals, sent, table_size = hash_case(case)
    size = (T_hash.hash_table_size(len(keys) + 1) if table_size is None
            else table_size)
    assert size == (J_hash.hash_table_size(len(keys) + 1)
                    if table_size is None else table_size)
    rk, rv, rcount = replay_hash(keys, vals, sent=sent, table_size=size)
    tk, tv = T_hash.hash_accumulate_raw(torch.as_tensor(keys),
                                        torch.as_tensor(vals), sent=sent,
                                        table_size=table_size)
    np.testing.assert_array_equal(np_of(tk), rk)
    assert_bytes_equal(rv, tv)
    got = T_hash.hash_symbolic_raw(torch.as_tensor(keys), sent=sent,
                                   table_size=table_size)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == rcount
    if case != "undersized" and len(keys):
        assert rcount == int(J_ref.hash_symbolic_ref(jnp.asarray(keys),
                                                     sent=sent))
    assert T_hash.hash_accumulate_raw.launches == 0
    assert T_hash.hash_symbolic_raw.launches == 0


@pytest.mark.parametrize("case", HASH_CASES)
def test_hash_accumulate_compaction_matches_replay_and_reference(case):
    """``ops.hash_accumulate``: occupied slots in table order, truncated to
    the capacity; sorted by key, the same keys and bits as the reference's
    ``hash_accumulate_ref`` (exact-table cases) and its count."""
    keys, vals, sent, table_size = hash_case(case)
    size = (T_hash.hash_table_size(len(keys) + 1) if table_size is None
            else table_size)
    rk, rv, _ = replay_hash(keys, vals, sent=sent, table_size=size)
    occ = rk != -1
    cap = len(keys)
    before = TS.sort_calls()
    ck, cv, nnz = T_ops.hash_accumulate(torch.as_tensor(keys),
                                        torch.as_tensor(vals), sent=sent,
                                        table_size=table_size)
    assert TS.sort_calls() - before == 1
    # the compacted table, cut to the capacity (never longer than the table)
    want_k = np.concatenate([rk[occ], np.full(size, sent, np.int32)])[
        :min(cap, size)]
    want_v = np.concatenate([rv[occ], np.zeros(size, np.float32)])[
        :min(cap, size)]
    np.testing.assert_array_equal(np_of(ck), want_k)
    assert_bytes_equal(want_v, cv)
    assert int(nnz) == int(occ.sum())
    if case != "undersized" and cap:
        jk, jv, jn = J_ref.hash_accumulate_ref(jnp.asarray(keys),
                                               jnp.asarray(vals), sent=sent)
        assert int(jn) == int(nnz)
        order = np.argsort(np_of(ck), kind="stable")
        np.testing.assert_array_equal(np.asarray(jk), np_of(ck)[order])
        assert_bytes_equal(jv, np_of(cv)[order])


def test_hash_wrappers_reject_bad_tables():
    keys = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^q"):
        T_hash.hash_accumulate_raw(keys, torch.zeros(8), sent=64,
                                   table_size=12)
    with pytest.raises(ValueError, match="1-D"):
        T_hash.hash_accumulate_raw(keys[None], torch.zeros(1, 8), sent=64)
