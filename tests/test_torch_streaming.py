"""The port's streaming accumulator (``repro_torch.core.streaming``) against
the reference (``repro.core.streaming``), on the CPU.

- ``truncate_by_magnitude`` on ties, NaN, +-0, sentinel slots picked by a
  cap past the valid entries, batched inputs and ``cap >= a.cap``;
- ``StreamingAccumulator`` at ``window_batch`` 1 and 3, with a budget that
  holds everything and one that truncates, the running sum after every
  flush;
- twins of the accumulator tests of ``tests/test_stream_service.py``
  (exception safety, dtype and device validation, partial windows, a
  tight budget, the flush-once ``value``).

Inputs are made with numpy from a seed and fed to both packages.
Tolerance: bitwise (keys, value bytes, nnz), except where a test compares
with a float32 dense sum, as the reference's tests do.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import obs as jobs
from repro.core import sparse as JS
from repro.core import streaming as JST
from repro_torch import obs
from repro_torch.core import sparse as TS
from repro_torch.core import streaming as TST

from _torch_parity import (assert_bytes_equal, assert_same_coo,
                           jax_from_dense, np_of, to_port)

CPU = "cpu"
NAN = np.float32(np.nan)


def coo_pair(keys, vals, nnz, shape):
    """The same PaddedCOO in both packages (keys/vals numpy, any batch)."""
    keys = np.asarray(keys, np.int32)
    vals = np.asarray(vals, np.float32)
    ref = JS.PaddedCOO(jnp.asarray(keys), jnp.asarray(vals),
                       jnp.asarray(np.asarray(nnz, np.int32)), shape)
    port = TS.PaddedCOO(torch.from_numpy(keys), torch.from_numpy(vals),
                        torch.from_numpy(np.asarray(nnz, np.int32)), shape)
    return ref, port


S = 4 * 4  # sentinel of the 4x4 cases

TRUNCATE_CASES = {
    # equal magnitudes of both signs: ties go to the lower slot
    "ties": ([0, 1, 2, 3, 4, 5, S, S], [1, -1, 2, -2, 1, 2, 0, 0], 6, 3),
    # a NaN ranks above every number; -NaN is a NaN too
    "nan": ([0, 2, 5, 7, 9, S], [1.0, NAN, 3.0, -NAN, 0.5, 0], 5, 3),
    # +0 and -0 tie at magnitude 0, above the sentinels' -1
    "signed_zeros": ([1, 3, 4, 8, S, S], [-0.0, 0.0, 5.0, -0.0, 0, 0], 4,
                     3),
    # cap past the valid entries: sentinel slots are picked and stay 0
    "sentinels_picked": ([2, 6, S, S, S, S, S, S],
                         [4.0, -3.0, 0, 0, 0, 0, 0, 0], 2, 5),
    # unsorted keys, duplicates of magnitude, cap 1
    "unsorted": ([9, 3, 12, 0, S, 5], [-2.5, 2.5, 1.0, -7.0, 0, 7.0], 5, 1),
}


@pytest.mark.parametrize("case", sorted(TRUNCATE_CASES))
def test_truncate_by_magnitude_matches_reference(case):
    keys, vals, nnz, cap = TRUNCATE_CASES[case]
    ref_in, port_in = coo_pair(keys, vals, nnz, (4, 4))
    ref = JST.truncate_by_magnitude(ref_in, cap)
    port = TST.truncate_by_magnitude(port_in, cap)
    assert port.cap == cap
    assert_same_coo(ref, port, case)


def test_truncate_by_magnitude_counts_one_sort():
    _, port_in = coo_pair(*TRUNCATE_CASES["ties"][:3], (4, 4))
    before = TS.sort_calls()
    TST.truncate_by_magnitude(port_in, 3)
    assert TS.sort_calls() == before + 1


def test_truncate_by_magnitude_batched_rows_match_reference():
    """A leading batch axis: each row truncated as the reference truncates
    it alone."""
    rng = np.random.default_rng(3)
    keys = np.stack([rng.permutation(16)[:10] for _ in range(3)])
    keys[:, 8:] = S
    vals = rng.choice(np.float32([1, -1, 2, 0.5, -0.0, NAN]), (3, 10))
    vals[keys == S] = 0.0
    _, port_in = coo_pair(keys, vals, [8, 8, 8], (4, 4))
    port = TST.truncate_by_magnitude(port_in, 4)
    for b in range(3):
        ref_in, _ = coo_pair(keys[b], vals[b], 8, (4, 4))
        ref = JST.truncate_by_magnitude(ref_in, 4)
        row = TS.PaddedCOO(port.keys[b], port.vals[b], port.nnz[b], (4, 4))
        assert_same_coo(ref, row, f"row {b}")


@pytest.mark.parametrize("cap", [6, 9])
def test_truncate_by_magnitude_keeps_input_when_cap_fits(cap):
    _, port_in = coo_pair([3, 1, S, 2, S, S], [1, 2, 0, 3, 0, 0], 3, (4, 4))
    before = TS.sort_calls()
    assert TST.truncate_by_magnitude(port_in, cap) is port_in
    assert TS.sort_calls() == before


def pushes(seed, count, shape=(16, 4), nnz=8):
    """``count`` seeded matrices as (reference, port) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        d = np.zeros(shape, np.float32)
        idx = rng.choice(shape[0] * shape[1], nnz, replace=False)
        d.flat[idx] = rng.standard_normal(nnz)
        ref = jax_from_dense(jnp.asarray(d), cap=nnz)
        out.append((ref, to_port([ref])[0]))
    return out


@pytest.mark.parametrize("window_batch", [1, 3])
@pytest.mark.parametrize("cap_budget", [64, 12])
def test_streaming_accumulator_matches_reference(window_batch, cap_budget):
    """Ten pushes of batch_k 3: the running sum after every flush and the
    final value equal the reference's, bitwise; cap 12 truncates. The
    flush counter and size histogram read the same in both packages."""
    jobs.metrics.reset("streaming.")
    obs.metrics.reset("streaming.")
    kw = dict(batch_k=3, cap_budget=cap_budget, window_batch=window_batch)
    ref = JST.StreamingAccumulator((16, 4), **kw)
    port = TST.StreamingAccumulator((16, 4), device=CPU, **kw)
    for i, (a_ref, a_port) in enumerate(pushes(20 + window_batch, 10)):
        ref.push(a_ref)
        port.push(a_port)
        assert port.n_flushes == ref.n_flushes and port.n_seen == ref.n_seen
        assert_same_coo(ref._sum, port._sum, f"after push {i}")
    assert_same_coo(ref.value, port.value, "value")
    assert_bytes_equal(ref.dense(), port.dense(), "dense")
    assert obs.metrics.snapshot("streaming.") == \
        jobs.metrics.snapshot("streaming.")


# ---------------------------------------------------------------------------
# twins of the accumulator tests of tests/test_stream_service.py
# ---------------------------------------------------------------------------

def test_streaming_flush_failure_leaves_state_unchanged(monkeypatch):
    """An engine raise mid-flush must not half-commit: buffer retained,
    running sum / counters untouched, and the re-flush succeeds."""
    acc = TST.StreamingAccumulator((16, 4), batch_k=4, cap_budget=64,
                                   device=CPU)
    for _, a in pushes(0, 3):
        acc.push(a)
    before_sum = acc._sum
    obs.metrics.reset("streaming.")
    before = obs.metrics.snapshot("streaming.")

    def boom(*a, **k):
        raise RuntimeError("injected engine failure")
    monkeypatch.setattr(TST, "spkadd_run", boom)
    with pytest.raises(RuntimeError, match="injected engine failure"):
        acc.flush()
    assert len(acc._buffer) == 3
    assert acc.n_flushes == 0
    assert acc._sum is before_sum
    assert obs.metrics.snapshot("streaming.") == before

    monkeypatch.undo()
    acc.flush()
    assert acc.n_flushes == 1 and acc._buffer == []
    assert obs.metrics.counter("streaming.flushes").value == 1


def test_streaming_push_rejects_dtype_and_device_mismatch():
    acc = TST.StreamingAccumulator((16, 4), batch_k=4, cap_budget=64,
                                   device=CPU)
    _, a = pushes(1, 1)[0]
    with pytest.raises(ValueError, match="dtype"):
        acc.push(a._replace(vals=a.vals.to(torch.bfloat16)))
    with pytest.raises(ValueError, match="device"):
        acc.push(a._replace(keys=a.keys.to("meta")))
    assert acc.n_seen == 0 and acc._buffer == []


def test_streaming_partial_window_and_tight_budget():
    """Buffered count not a multiple of batch_k still sums as the
    reference does, and a cap_budget smaller than one input's nnz
    truncates instead of raising."""
    m, n = 16, 4
    ref = JST.StreamingAccumulator((m, n), batch_k=4, cap_budget=m * n)
    port = TST.StreamingAccumulator((m, n), batch_k=4, cap_budget=m * n,
                                    device=CPU)
    total = np.zeros((m, n), np.float32)
    for a_ref, a_port in pushes(2, 5):  # one full window + one buffered
        total += np.asarray(a_ref.to_dense())
        ref.push(a_ref)
        port.push(a_port)
    np.testing.assert_allclose(np_of(port.dense()), total, rtol=1e-5,
                               atol=1e-6)
    assert_same_coo(ref.value, port.value)

    tight_ref = JST.StreamingAccumulator((m, n), batch_k=2, cap_budget=4)
    tight = TST.StreamingAccumulator((m, n), batch_k=2, cap_budget=4,
                                     device=CPU)
    for a_ref, a_port in pushes(3, 2, nnz=12):
        tight_ref.push(a_ref)
        tight.push(a_port)
    assert int(tight.value.nnz) <= 4
    assert_same_coo(tight_ref.value, tight.value)


def test_streaming_value_flushes_exactly_once():
    acc = TST.StreamingAccumulator((16, 4), batch_k=8, cap_budget=64,
                                   device=CPU)
    for _, a in pushes(4, 3):
        acc.push(a)
    v1 = acc.value
    assert acc.n_flushes == 1
    v2 = acc.value
    assert acc.n_flushes == 1 and v2 is v1
