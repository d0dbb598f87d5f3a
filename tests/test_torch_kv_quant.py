"""The port's int8 KV-cache quantization (``repro_torch.serve``) against
the reference's (``repro.serve``), on the CPU.

The twins of the three tests of ``tests/test_extensions.py`` (round trip
within 0.02, attention within 5e-2 of the exact one, a decode update),
run in both packages on the same numpy draws; the int8 codes and the f32
scales bitwise against the reference's (both round half to even and clip
to ±127), in f32 and from bf16 inputs; the decode update's ring write at
``length % S_max``; dequantization and the quantized attention against
the reference's at f32 tolerance (1e-5 of their scale).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro.serve import kv_quant as RQ
from repro_torch import interop
from repro_torch.models import layers as TL
from repro_torch.serve import kv_quant as TQ

RTOL = 1e-5


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _assert_same_cache(ref, got):
    for name in ("k_q", "v_q", "k_scale", "v_scale"):
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert g.tobytes() == r.tobytes(), name
    assert int(got.length) == int(ref.length)
    assert got.length.dtype == torch.int32


def scaled_err(ref, got) -> float:
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    return float(np.abs(ref - got).max()) / (float(np.abs(ref).max()) or 1.0)


# ---------------------------------------------------------------------------
# the twins of tests/test_extensions.py
# ---------------------------------------------------------------------------

def test_kv_quant_roundtrip_accuracy():
    k, v = _normal(0, 2, 32, 4, 64), _normal(1, 2, 32, 4, 64)
    (rk, rv), (tk, tv) = _both(k, v)
    cache = TQ.quantize_kv(tk, tv)
    kd, vd = TQ.dequantize_kv(cache, dtype=torch.float32)
    # symmetric int8: <=1% relative error on the max element per row
    np.testing.assert_allclose(kd.numpy(), k, atol=0.02)
    np.testing.assert_allclose(vd.numpy(), v, atol=0.02)
    ref = RQ.quantize_kv(rk, rv)
    _assert_same_cache(ref, cache)
    rkd, rvd = RQ.dequantize_kv(ref, dtype=jnp.float32)
    assert scaled_err(rkd, kd) <= RTOL and scaled_err(rvd, vd) <= RTOL


def test_kv_quant_attention_close_to_exact():
    q = _normal(2, 2, 1, 8, 64)
    k, v = _normal(3, 2, 40, 4, 64), _normal(4, 2, 40, 4, 64)
    (rq, rk, rv), (tq, tk, tv) = _both(q, k, v)
    exact = TL.blockwise_attention(tq, tk, tv, causal=False, kv_len=40,
                                   chunk=16)
    cache = TQ.quantize_kv(tk, tv)
    approx = TQ.attention_with_quant_cache(tq, cache, chunk=16)
    np.testing.assert_allclose(approx.numpy(), exact.numpy(), rtol=5e-2,
                               atol=5e-2)
    want = RQ.attention_with_quant_cache(rq, RQ.quantize_kv(rk, rv),
                                         chunk=16)
    assert scaled_err(want, approx) <= RTOL


def test_kv_quant_decode_update():
    k = torch.zeros((1, 8, 2, 16))
    cache = TQ.quantize_kv(k, k, length=3)
    newk = torch.ones((1, 1, 2, 16)) * 0.5
    cache = TQ.quant_cache_update_decode(cache, newk, newk)
    assert int(cache.length) == 4
    kd, _ = TQ.dequantize_kv(cache, dtype=torch.float32)
    np.testing.assert_allclose(kd[0, 3].numpy(), 0.5, atol=0.01)
    ref = RQ.quant_cache_update_decode(
        RQ.quantize_kv(jnp.zeros((1, 8, 2, 16)), jnp.zeros((1, 8, 2, 16)),
                       length=3),
        jnp.ones((1, 1, 2, 16)) * 0.5, jnp.ones((1, 1, 2, 16)) * 0.5)
    _assert_same_cache(ref, cache)


# ---------------------------------------------------------------------------
# int8 codes bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 1e-3, 300.0])
def test_codes_and_scales_bitwise(scale):
    """The codes and scales of the same f32 draws, bitwise; rows of
    zeros (scale 0, the 1e-8 floor) and rows with exact halves included."""
    k = _normal(5, 2, 17, 3, 32, scale=scale)
    v = _normal(6, 2, 17, 3, 32, scale=scale)
    k[0, 0] = 0.0                       # an all-zero row
    v[1, 2, 1] = np.arange(32) - 15.5   # codes at exact .5 multiples
    v[1, 2, 1, 0] = 127 * 0.5          # the max sets scale 0.5
    (rk, rv), (tk, tv) = _both(k, v)
    ref, got = RQ.quantize_kv(rk, rv), TQ.quantize_kv(tk, tv)
    _assert_same_cache(ref, got)
    assert int(got.k_q.abs().max()) == 127
    assert not got.k_q[0, 0].any() and not got.k_scale[0, 0].any()


def test_codes_bitwise_from_bf16():
    """bf16 keys and values (the compute dtype of the full configs) are
    quantized in f32: the same codes and scales as the reference's."""
    k = jnp.asarray(_normal(7, 2, 9, 4, 64), jnp.bfloat16)
    v = jnp.asarray(_normal(8, 2, 9, 4, 64), jnp.bfloat16)
    tk = interop.array_to_tensor(np.asarray(k), "cpu")
    tv = interop.array_to_tensor(np.asarray(v), "cpu")
    _assert_same_cache(RQ.quantize_kv(k, v), TQ.quantize_kv(tk, tv))
    kd, _ = TQ.dequantize_kv(TQ.quantize_kv(tk, tv))
    assert kd.dtype == torch.bfloat16


def test_decode_update_wraps_the_ring():
    """Ten decode writes into a cache of 4 positions, from length 2: each
    at ``length % S_max``, bitwise to the reference's after every step."""
    k0, v0 = _normal(9, 1, 4, 2, 8), _normal(10, 1, 4, 2, 8)
    (rk, rv), (tk, tv) = _both(k0, v0)
    ref, got = RQ.quantize_kv(rk, rv, length=2), TQ.quantize_kv(tk, tv,
                                                                length=2)
    for step in range(10):
        kn = _normal(20 + step, 1, 1, 2, 8, scale=step + 1.0)
        vn = _normal(40 + step, 1, 1, 2, 8)
        (rkn, rvn), (tkn, tvn) = _both(kn, vn)
        ref = RQ.quant_cache_update_decode(ref, rkn, rvn)
        got = TQ.quant_cache_update_decode(got, tkn, tvn)
        _assert_same_cache(ref, got)
        slot = (2 + step) % 4
        kq, _ = TQ._quant(tkn)
        assert torch.equal(got.k_q[:, slot], kq[:, 0])


@pytest.mark.parametrize("length", [5, 40, 43])
def test_quant_attention_matches_reference(length):
    """A partly filled cache (``kv_len`` = length), a full one and one past
    its size (``min(length, S_max)``), GQA heads, against the
    reference's."""
    q = _normal(11, 2, 1, 8, 16)
    k, v = _normal(12, 2, 40, 2, 16), _normal(13, 2, 40, 2, 16)
    (rq, rk, rv), (tq, tk, tv) = _both(q, k, v)
    want = RQ.attention_with_quant_cache(
        rq, RQ.quantize_kv(rk, rv, length=length), chunk=16)
    got = TQ.attention_with_quant_cache(
        tq, TQ.quantize_kv(tk, tv, length=length), chunk=16)
    assert got.shape == (2, 1, 8, 16)
    assert scaled_err(want, got) <= RTOL
    exact = RL.blockwise_attention(rq, rk, rv, causal=False,
                                   kv_len=min(length, 40), chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(exact), rtol=5e-2,
                               atol=5e-2)
