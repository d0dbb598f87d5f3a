"""The plain versions behind the redesigned symbolic hash count and dense SPA
kernels, on the CPU.

- ``hash_symbolic``: the plain count against the numpy replay of the
  reference's sequential loop (``replay_hash``) on streams with ``-1`` keys,
  undersized tables with and without them, and tables that cannot fill;
  there it must also equal the order-free identity the parallel route
  relies on, ``#distinct(keys not in {sent, -1}) + #(keys == -1)``, and,
  without ``-1`` keys, the reference's ``ref.hash_symbolic_ref``;
- ``spa_accum``: the plain bucketing (stable by row part, sentinels
  dropped) is a stable partition of the stream, and folding its output
  with ``spa_accumulate_plain`` gives the same bits as
  ``spa_accumulate_plain`` on the original stream, and as the reference's
  ``ref.spa_accumulate_ref``;
- the bucketing's geometry keeps its count matrix small, and its byte
  count adds up.

Tolerance everywhere: bitwise (counts exactly, values as bytes).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as J_ref
from repro_torch.kernels import hash_accum as T_hash
from repro_torch.kernels import spa_accum as T_spa

from _torch_parity import assert_bytes_equal, np_of
from test_torch_spkadd_family import chain_stream, replay_hash


# ---------------------------------------------------------------------------
# hash_symbolic: the plain count, the replay and the order-free identity
# ---------------------------------------------------------------------------

def symbolic_case(name):
    """``(keys, sent, table_size)``: ``table_size`` None = the default
    sizing, under which the table cannot fill."""
    rng = np.random.default_rng(len(name) + 100)
    if name == "minus_one":           # -1 keys among repeats, default table
        keys = rng.integers(-1, 40, size=300).astype(np.int32)
        keys[rng.random(300) < 0.1] = 999
        return keys, 999, None
    if name == "minus_one_only":
        return np.full(17, -1, np.int32), 5, None
    if name == "cannot_fill":         # wide keys, negatives, sentinels
        keys = rng.integers(-5000, 5000, size=2000).astype(np.int32)
        keys[rng.random(2000) < 0.2] = 7777
        return keys, 7777, None
    if name == "explicit_large":      # an explicit table > cap
        keys = rng.integers(0, 500, size=700).astype(np.int32)
        return keys, 10_000, 1024
    if name == "collisions":
        keys, _ = chain_stream(128, 4096)
        return keys, 4096, 256
    if name == "undersized":          # 16 slots for 30 distinct keys
        keys = rng.permutation(np.repeat(np.arange(30) * 5, 3)).astype(
            np.int32)
        return keys, 1000, 16
    if name == "undersized_minus_one":
        keys = rng.permutation(np.repeat(np.arange(30) * 5, 3)).astype(
            np.int32)
        keys[rng.choice(keys.size, 12, replace=False)] = -1
        return keys, 1000, 16
    if name == "table_equals_cap":    # table_size == cap: the serial route
        keys = rng.integers(0, 20, size=64).astype(np.int32)
        keys[::9] = -1
        return keys, 99, 64
    assert name == "empty"
    return np.zeros(0, np.int32), 3, None


SYMBOLIC_CASES = ["minus_one", "minus_one_only", "cannot_fill",
                  "explicit_large", "collisions", "undersized",
                  "undersized_minus_one", "table_equals_cap", "empty"]


def order_free_count(keys, sent):
    keys = np.asarray(keys)
    normal = keys[(keys != sent) & (keys != -1)]
    return np.unique(normal).size + int((keys == -1).sum())


@pytest.mark.parametrize("case", SYMBOLIC_CASES)
def test_hash_symbolic_plain_matches_replay(case):
    keys, sent, table_size = symbolic_case(case)
    size = (T_hash.hash_table_size(len(keys) + 1) if table_size is None
            else table_size)
    _, _, want = replay_hash(keys, np.zeros(len(keys), np.float32),
                             sent=sent, table_size=size)
    got = T_hash.hash_symbolic_plain(torch.as_tensor(keys), sent=sent,
                                     table_size=table_size)
    assert got.dtype == torch.int32 and int(got) == want
    assert int(T_hash.hash_symbolic_raw(torch.as_tensor(keys), sent=sent,
                                        table_size=table_size)) == want
    serial = size <= len(keys)
    if serial:
        assert T_hash.symbolic_route(len(keys), size, device="cpu") == \
            "serial"
    else:
        # the table cannot fill: the count is order-free
        assert want == order_free_count(keys, sent)
        perm = np.random.default_rng(3).permutation(len(keys))
        shuffled = T_hash.hash_symbolic_plain(torch.as_tensor(keys[perm]),
                                              sent=sent,
                                              table_size=table_size)
        assert int(shuffled) == want
        if len(keys) and not (keys == -1).any():
            assert want == int(J_ref.hash_symbolic_ref(jnp.asarray(keys),
                                                       sent=sent))
    assert T_hash.hash_symbolic_raw.launches == 0
    assert T_hash.hash_symbolic_raw.serial_launches == 0


def test_undersized_count_depends_on_where_minus_one_falls():
    """Why a table that can fill keeps the one-thread route: the same
    multiset of keys counts differently in another order."""
    keys = np.asarray([1, 2, 3, 4, -1, -1], np.int32)
    early = np.asarray([-1, -1, 1, 2, 3, 4], np.int32)
    counts = {int(T_hash.hash_symbolic_plain(torch.as_tensor(k), sent=99,
                                             table_size=4))
              for k in (keys, early)}
    assert counts == {4, 6}


# ---------------------------------------------------------------------------
# spa_accum: the plain bucketing
# ---------------------------------------------------------------------------

def bucket_case(name):
    """``(keys, vals, m, n, block_rows)``: keys may hold sentinels (>= m*n)
    and negatives, which the bucketing drops."""
    rng = np.random.default_rng(len(name) + 7)
    m, n, block_rows = 40, 6, 8
    mn = m * n
    if name == "random":
        keys = rng.integers(0, mn, size=500)
    elif name == "sorted":
        keys = np.sort(rng.integers(0, mn, size=500), kind="stable")
    elif name == "sentinel_run":
        keys = rng.integers(0, mn, size=500)
        keys[100:300] = mn
        keys[::17] = -3
    elif name == "duplicates":
        keys = rng.choice(np.asarray([0, 7, mn - 1, 3 * m + 9]), size=400)
    elif name == "empty_parts":       # rows 8-15 and 32-39 never appear
        rows = rng.choice(np.r_[0:8, 16:32], size=300)
        cols = rng.integers(0, n, size=300)
        keys = cols * m + rows
    elif name == "odd_rows":          # m % block_rows != 0, one element
        m, block_rows = 37, 16
        mn = m * n
        keys = np.asarray([mn - 1])
    else:
        assert name == "all_sentinel"
        keys = np.full(64, mn)
    keys = keys.astype(np.int32)
    vals = rng.standard_normal(keys.size).astype(np.float32)
    vals[::5] = -0.0
    return keys, vals, m, n, block_rows


BUCKET_CASES = ["random", "sorted", "sentinel_run", "duplicates",
                "empty_parts", "odd_rows", "all_sentinel"]


@pytest.mark.parametrize("case", BUCKET_CASES)
def test_spa_bucket_plain_is_a_stable_partition(case):
    keys, vals, m, n, block_rows = bucket_case(case)
    bkeys, bvals, base = T_spa.spa_bucket_plain(
        torch.as_tensor(keys), torch.as_tensor(vals), m=m, n=n,
        block_rows=block_rows)
    assert bkeys.dtype == torch.int32 and bvals.dtype == torch.float32
    assert base.dtype == torch.int32
    parts = -(-m // block_rows)
    assert base.shape == (parts + 1,) and int(base[0]) == 0
    # numpy's stable partition of the valid elements by part
    valid = (keys >= 0) & (keys < m * n)
    kv, vv = keys[valid], vals[valid]
    part = (kv % m) // block_rows
    order = np.argsort(part, kind="stable")
    np.testing.assert_array_equal(np_of(bkeys), kv[order])
    assert_bytes_equal(vv[order], bvals)
    np.testing.assert_array_equal(
        np_of(base), np.r_[0, np.cumsum(np.bincount(part, minlength=parts))])
    # the CPU wrapper is the plain version and launches nothing
    before = T_spa.spa_bucket_raw.launches
    rkeys, rvals, rbase = T_spa.spa_bucket_raw(
        torch.as_tensor(keys), torch.as_tensor(vals), m=m, n=n,
        block_rows=block_rows)
    assert torch.equal(rkeys, bkeys) and torch.equal(rbase, base)
    assert_bytes_equal(np_of(bvals), rvals)
    assert T_spa.spa_bucket_raw.launches == before


@pytest.mark.parametrize("case", BUCKET_CASES)
def test_folding_the_buckets_gives_the_same_bits(case):
    """Folding the bucketed stream gives the bits of folding the stream:
    the bucketing keeps each slot's values in stream order."""
    keys, vals, m, n, block_rows = bucket_case(case)
    bkeys, bvals, _ = T_spa.spa_bucket_plain(
        torch.as_tensor(keys), torch.as_tensor(vals), m=m, n=n,
        block_rows=block_rows)
    kw = dict(m=m, n=n, block_rows=block_rows, chunk=1)
    from_buckets = T_spa.spa_accumulate_plain(bkeys, bvals, **kw)
    from_stream = T_spa.spa_accumulate_plain(torch.as_tensor(keys),
                                             torch.as_tensor(vals), **kw)
    assert_bytes_equal(np_of(from_stream), from_buckets)
    # the reference takes sentinels as keys >= m*n only
    want = J_ref.spa_accumulate_ref(jnp.asarray(np.where(keys < 0, m * n,
                                                         keys)),
                                    jnp.asarray(vals), m=m, n=n)
    assert_bytes_equal(want, from_buckets)


@pytest.mark.parametrize("cap,m,block_rows,passes", [
    (16_777_216, 65_536, 8, 2),    # the family's stream at 16 KiB tiles
    (16_777_216, 65_536, 104, 2),  # ... at the block-limit tile
    (1, 8, 8, 1),                  # one element, one part
    (5000, 2048, 8, 1),            # 256 parts: one pass
    (5000, 2056, 8, 2),            # 257 parts: two
    (5000, 2 ** 30, 8, 4),         # 2^27 parts
])
def test_bucket_geometry_keeps_the_count_matrix_small(cap, m, block_rows,
                                                      passes):
    g = T_spa.bucket_geometry(cap, m=m, block_rows=block_rows)
    assert g.parts == -(-m // block_rows) and g.passes == passes
    assert (g.parts - 1) >> (T_spa.RADIX_BITS * g.passes) == 0
    assert g.ntile == -(-cap // T_spa.TILE)
    # the count matrix, 4 B per tile and digit, is 1/32 of 8 B per element
    assert 32 * 4 * (1 << T_spa.RADIX_BITS) == 8 * T_spa.TILE
    moved = T_spa.moved_bytes(cap, cap, m=m, n=4, block_rows=block_rows)
    assert set(moved) == {"count", "offsets", "scatter", "fold"}
    assert moved["scatter"] >= 16 * cap * passes
    assert moved["fold"] >= 4 * g.parts * block_rows * 4 + 8 * cap


@pytest.mark.parametrize("d", [1, 2, 3, 7, 8, 16, 104, 512, 1000, 65_536,
                               65_537, 480_000, 2 ** 30, 2 ** 31 - 1])
def test_fast_div_is_exact_below_2_31(d):
    """The kernels' division by m and block_rows: (umulhi(x, magic) + x)
    >> shift, in 32-bit arithmetic, equals x // d for 0 <= x < 2^31."""
    magic, shift = T_spa.fast_div(d)
    assert 0 <= magic < 2 ** 32 and 0 <= shift <= 31
    rng = np.random.default_rng(d)
    xs = np.concatenate([
        rng.integers(0, 2 ** 31, size=20_000, dtype=np.int64),
        np.arange(0, min(3 * d + 3, 5000), dtype=np.int64),
        (np.arange(1, 2000, dtype=np.int64) * d)[:, None]
        + np.asarray([-1, 0, 1]), np.asarray([2 ** 31 - 1])], axis=None)
    xs = xs[(xs >= 0) & (xs < 2 ** 31)].astype(np.uint64)
    hi = (xs * np.uint64(magic)) >> np.uint64(32)
    s = hi + xs
    assert (s < 2 ** 32).all()   # the sum fits 32 bits
    np.testing.assert_array_equal(s >> np.uint64(shift), xs // np.uint64(d))
