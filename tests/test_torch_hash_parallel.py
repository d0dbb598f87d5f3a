"""The parallel designs of the two hash kernels, held on the CPU through
their host models (``csrc/hash_slide.cu``, ``csrc/hash_accum.cu``).

On the card both kernels place keys by ordered linear probing with
priority = a key's first stream position, many threads at once, then fold
each slot's values in stream order. Their contract is the raw tables of
the one-at-a-time insertion loops, bit for bit. The host models
(``hash_slide.placement_model``, ``hash_accum.accumulate_model``) replay
that placement with every step of every inserter interleaved at random
from a seed, and must equal the plain versions, which the reference's
oracles hold (``tests/test_torch_kernels.py``), in every interleaving.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import hash_accum, hash_slide
from repro_torch.kernels.hash_accum import HASH_PRIME

SEEDS = (0, 1, 2, 3)


def h0(key, table_size):
    return ((key & 0xFFFFFFFF) * HASH_PRIME) & (table_size - 1)


def keys_hashing_to(slot, table_size, count, start=0, stride=1):
    """``count`` non-negative keys whose first slot is ``slot``."""
    out, k = [], start
    while len(out) < count:
        if h0(k, table_size) == slot:
            out.append(k)
        k += stride
    return out


def slide_case(name):
    """``(keys (B, cap), mn, table_size, part_span, parts)``."""
    rng = np.random.default_rng(len(name))
    if name == "random":
        mn, T = 300, 128
        keys = rng.integers(0, mn + 20, (3, 64))
        return keys, mn, T, mn, 1
    if name == "random_parts":
        mn, T = 200, 32
        keys = rng.integers(0, mn + 5, (2, 96))
        return keys, mn, T, T // 2, -(-mn // (T // 2))
    if name == "wrap_chain":
        # a chain that starts in the last slot and wraps to slot 0
        T = 64
        chain = keys_hashing_to(T - 1, T, 5)
        mn = max(chain) + 1
        keys = np.array([chain + chain[::-1] + [mn] * 6])
        return keys, mn, T, mn, 1
    if name == "one_key":
        return np.full((2, 48), 11), 50, 128, 50, 1
    if name == "empty_parts":
        # keys only in parts 0 and 5 of 8; row 1 all sentinels
        T = 16
        keys = np.stack([rng.choice([1, 2, 3, 41, 42, 47], 40),
                         np.full(40, 64)])
        return keys, 64, T, 8, 8
    if name == "parts_over_256":
        # 260 parts of 4 keys: the card's bucketing takes two radix passes
        T, span = 8, 4
        mn = 260 * span
        keys = rng.integers(0, mn, (2, 128))
        return keys, mn, T, span, 260
    raise KeyError(name)


@pytest.mark.parametrize("name", ["random", "random_parts", "wrap_chain",
                                  "one_key", "empty_parts", "parts_over_256"])
def test_slide_placement_model_equals_the_plain_tables(name):
    keys, mn, T, span, parts = slide_case(name)
    kt = torch.as_tensor(keys.astype(np.int32))
    vals = torch.ones(kt.shape, dtype=torch.float32)
    want, _ = hash_slide.hash_slide_plain(kt, vals, mn=mn, table_size=T,
                                          part_span=span, parts=parts,
                                          chunk=kt.shape[1])
    for seed in (None,) + SEEDS:
        rng = None if seed is None else np.random.default_rng(seed)
        got = hash_slide.placement_model(kt, mn=mn, table_size=T,
                                         part_span=span, parts=parts, rng=rng)
        np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                      err_msg=f"{name} seed {seed}")


def accum_case(name):
    """``(keys, vals, sent, table_size)``, ``table_size > cap``."""
    rng = np.random.default_rng(len(name) + 100)
    sent = 1 << 20
    if name == "random":
        keys = rng.integers(0, 200, 100)
        keys[rng.random(100) < 0.1] = sent
        return keys, rng.standard_normal(100), sent, 256
    if name == "minus_one_mixed":
        keys = rng.integers(-1, 12, 120)
        return keys, rng.standard_normal(120), sent, 128
    if name == "all_minus_one":
        return np.full(30, -1), rng.standard_normal(30), sent, 64
    if name == "wrap_chain":
        T = 64
        chain = keys_hashing_to(T - 2, T, 6)
        minus = [-1] if h0(-1, T) in range(T - 2, T) else []
        keys = np.array(chain + minus + chain[::-1] + [sent] * 3 + chain)
        return keys, np.arange(len(keys)) + 1.0, sent, T
    if name == "one_key":
        return np.full(40, 7), rng.standard_normal(40), sent, 64
    if name == "empty":
        return np.zeros(0, np.int64), np.zeros(0), sent, 4
    raise KeyError(name)


@pytest.mark.parametrize("name", ["random", "minus_one_mixed",
                                  "all_minus_one", "wrap_chain", "one_key",
                                  "empty"])
def test_accumulate_model_equals_the_plain_table(name):
    keys, vals, sent, T = accum_case(name)
    vals = vals.astype(np.float32)
    assert hash_accum.accumulate_route(len(keys), T) == "parallel"
    wk, wv = hash_accum.hash_accumulate_plain(
        torch.as_tensor(keys.astype(np.int32)), torch.as_tensor(vals),
        sent=sent, table_size=T)
    for seed in (None,) + SEEDS:
        rng = None if seed is None else np.random.default_rng(seed)
        gk, gv = hash_accum.accumulate_model(keys, vals, sent=sent,
                                             table_size=T, rng=rng)
        np.testing.assert_array_equal(gk, wk.numpy(), err_msg=str(seed))
        assert gv.tobytes() == wv.numpy().tobytes(), seed


def test_minus_one_key_takes_the_first_slot_empty_at_its_time():
    """A -1 stops on the first slot empty at its time and adds its value
    there, leaving the key -1; a key that takes the slot later folds onto
    that value; a later -1 passes the slot (taken before it) and lands on
    the next one."""
    T = 16
    k = keys_hashing_to(h0(-1, T), T, 1, start=1)[0]
    keys = np.array([-1, k, -1], np.int32)
    vals = np.float32([1.0, 2.0, 4.0])
    tk, tv = hash_accum.hash_accumulate_plain(torch.as_tensor(keys),
                                              torch.as_tensor(vals),
                                              sent=1 << 20, table_size=T)
    h = h0(-1, T)
    want_k = np.full(T, -1, np.int32)
    want_k[h] = k
    want_v = np.zeros(T, np.float32)
    want_v[h] = 3.0                   # 1 (the first -1) + 2 (the key)
    want_v[(h + 1) % T] = 4.0         # the later -1, on the next slot
    np.testing.assert_array_equal(tk.numpy(), want_k)
    np.testing.assert_array_equal(tv.numpy(), want_v)
    mk, mv = hash_accum.accumulate_model(keys, vals, sent=1 << 20,
                                         table_size=T)
    np.testing.assert_array_equal(mk, want_k)
    np.testing.assert_array_equal(mv, want_v)


@pytest.mark.parametrize("cap,table_size,route", [
    (100, 64, "serial"),       # can fill and wrap to h0
    (100, 100, "serial"),      # exactly cap slots: can still fill
    (100, 128, "parallel"),
    (1 << 20, 1 << 22, "parallel"),   # hash_alg's default sizing
    (0, 2, "parallel"),
])
def test_accumulate_route_is_serial_only_for_tables_that_can_fill(
        cap, table_size, route):
    assert hash_accum.accumulate_route(cap, table_size) == route
    # the default sizing never takes the one-thread loop
    assert hash_accum.accumulate_route(
        cap, hash_accum.hash_table_size(cap + 1)) == "parallel"


@pytest.mark.parametrize("parts,passes", [(1, 0), (255, 1), (256, 2),
                                          (3240, 2)])
def test_slide_moved_bytes_counts_the_bucketing_passes(parts, passes):
    B, cap, T = 3, 4096, 16
    moved = hash_slide.moved_bytes(B, cap, table_size=T, parts=parts)
    direct = 8 * B * cap + 8 * B * parts * T
    per_pass = 20 * B * cap
    extra = 0 if parts == 1 else passes * per_pass + 4 * B * cap
    assert moved == direct + extra
