"""The port's Mamba2 SSM (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``), on the CPU.

- ``softplus``, ``_causal_conv_full`` and ``_ssd_chunk_scan`` against the
  reference's, with S below, at and above the chunk, a multiple of it and
  not, and a given ``state0``; the scan's gradients through its
  per-chunk recomputation;
- the Mamba2 smoke config on the reference's init
  (``interop.params_from_numpy``): the loss, every leaf's gradient,
  prefill logits and caches and eight decode steps, from a prompt of 32
  tokens (four chunks), one of 13 (not a multiple of the chunk) and one
  of 5 (under one chunk);
- ``prefill`` ignores ``max_len`` in both packages, one under the prompt
  included;
- one and two compressed train steps at world size 1 against the
  reference's on a one-device mesh;
- in bf16, 48 layers: decode drifts from prefill no more than the
  reference's own decode drifts from its prefill.

Tolerances are those of ``tests/test_torch_models.py`` (f32: loss and
logits to 1e-5 of their scale, gradients to 1e-4 of a leaf's largest
magnitude): XLA and PyTorch sum a product's terms in other orders, and
``torch.einsum`` may contract the scan's three-operand products in
another order than XLA. Measured: loss 9e-8, gradients 1.6e-6, logits
8e-7; the scan's outputs 2.6e-7, its state 3.4e-7.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro import configs as RC
from repro.models import build_model as ref_build_model
from repro.models import ssm as RS
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import tree as TR
from repro_torch.models import build_model
from repro_torch.models import ssm as TS
from repro_torch.models.common import tree_param_count

CPU = "cpu"
ARCH = "mamba2-370m"
SHAPE = (2, 32)
CE_CHUNK, ATTN_CHUNK = 16, 8
NEW_TOKENS = 8
RTOL, RTOL_GRAD = 1e-5, 1e-4


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def scaled_err(ref, got) -> float:
    ref, got = np_of(ref), np_of(got)
    return float(np.abs(ref - got).max()) / (float(np.abs(ref).max()) or 1.0)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the block's pieces
# ---------------------------------------------------------------------------

def test_softplus_is_the_references():
    """``jax.nn.softplus`` has no threshold (``F.softplus`` returns x above
    20); the port's form is the reference's, within two f32 ulps (``exp``
    and ``log1p`` round differently in XLA and PyTorch). Below x = -87
    the result is subnormal, which XLA flushes to zero: x stays above."""
    x = np.concatenate([np.linspace(-80, 80, 4001, dtype=np.float32),
                        np.clip(_normal(0, 1000) * 30, -80, 80)]).astype(
                            np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = TS.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


@pytest.mark.parametrize("S", [1, 2, 3, 8, 13])
def test_causal_conv_full_matches_reference(S):
    x, w, b = _normal(1, 2, S, 12), _normal(2, 4, 12), _normal(3, 12)
    want = RS._causal_conv_full(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b))
    got = TS._causal_conv_full(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b))
    assert got.shape == (2, S, 12)
    assert scaled_err(want, got) <= RTOL


def _scan_inputs(S, H=3, P_=4, N=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, H, P_)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, S, H)))).astype(np.float32)
    Bm = rng.standard_normal((2, S, N)).astype(np.float32)
    Cm = rng.standard_normal((2, S, N)).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    state0 = rng.standard_normal((2, H, P_, N)).astype(np.float32)
    return x, dt, Bm, Cm, A, state0


#: S below, at and above the chunk of 8, a multiple and not.
SCAN_S = [1, 5, 8, 13, 16, 24]


@pytest.mark.parametrize("with_state0", [False, True])
@pytest.mark.parametrize("S", SCAN_S)
def test_ssd_chunk_scan_matches_reference(S, with_state0):
    x, dt, Bm, Cm, A, s0 = _scan_inputs(S)
    s0 = s0 if with_state0 else None
    want_y, want_s = RS._ssd_chunk_scan(
        *(jnp.asarray(a) for a in (x, dt, Bm, Cm, A)), 8,
        None if s0 is None else jnp.asarray(s0))
    t = torch.from_numpy
    got_y, got_s = TS._ssd_chunk_scan(t(x), t(dt), t(Bm), t(Cm), t(A), 8,
                                      None if s0 is None else t(s0))
    assert got_y.shape == x.shape and got_s.shape == (2, 3, 4, 5)
    assert got_s.dtype == torch.float32
    assert scaled_err(want_y, got_y) <= RTOL
    assert scaled_err(want_s, got_s) <= RTOL


@pytest.mark.parametrize("S", [5, 13, 24])
def test_ssd_chunk_scan_gradients_match_reference(S):
    """Backward through the per-chunk recomputation, against JAX's through
    its checkpointed scan: no NaN from the masked decay."""
    x, dt, Bm, Cm, A, s0 = _scan_inputs(S, seed=1)
    cot = _normal(2, *x.shape)

    def ref_f(*a):
        y, s = RS._ssd_chunk_scan(*a[:5], 8, a[5])
        return (y * cot).sum() + s.sum()

    want = jax.grad(ref_f, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (x, dt, Bm, Cm, A, s0)))
    ins = [torch.from_numpy(a).requires_grad_() for a in
           (x, dt, Bm, Cm, A, s0)]
    y, s = TS._ssd_chunk_scan(*ins[:5], 8, ins[5])
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum() + s.sum(),
                              ins)
    for i, (w, g) in enumerate(zip(want, got)):
        assert bool(torch.isfinite(g).all()), i
        assert scaled_err(w, g) <= RTOL_GRAD, (i, scaled_err(w, g))


# ---------------------------------------------------------------------------
# the smoke model on reference weights
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def models():
    rm = ref_build_model(RC.get_smoke_config(ARCH))
    m = build_model(TC.get_smoke_config(ARCH))
    rp = rm.init(jax.random.PRNGKey(0))
    return rm, m, rp, interop.params_from_numpy(jax.tree.map(np.asarray, rp),
                                                CPU)


def _batches(cfg, S, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (SHAPE[0], S + 1),
                                                dtype=np.int32)
    arrays = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


@functools.lru_cache(maxsize=None)
def train_case():
    rm, m, rp, params = models()
    rb, tb = _batches(m.cfg, SHAPE[1])
    loss, grads = jax.jit(jax.value_and_grad(lambda p: rm.loss(
        p, rb, ce_chunk=CE_CHUNK)))(rp)
    leaves, treedef = TR.flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    tl = m.loss(TR.unflatten(treedef, leaves), tb, ce_chunk=CE_CHUNK)
    got = torch.autograd.grad(tl, leaves)
    return (float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)],
            float(tl.detach()), [g.numpy() for g in got])


@functools.lru_cache(maxsize=None)
def serve_case(prompt: int):
    rm, m, rp, params = models()
    rb, tb = _batches(m.cfg, prompt, seed=1)
    rlog, rc = jax.jit(rm.prefill)(rp, tokens=rb["tokens"])
    log, c = m.prefill(params, tb["tokens"])
    out = {"prefill": (np.asarray(rlog), log.numpy()),
           "caches": (P.tree_arrays(rc), P.tree_arrays(c))}
    ref_decode = jax.jit(rm.decode_step)
    decode, tok = [], jnp.argmax(rlog, -1)
    for _ in range(NEW_TOKENS):
        rlog, rc = ref_decode(rp, rc, tok)
        log, c = m.decode_step(params, c, torch.from_numpy(np.array(tok)))
        decode.append((np.asarray(rlog), log.numpy()))
        tok = jnp.argmax(rlog, -1)  # both sides take the reference's token
    out["decode"] = decode
    out["decode_caches"] = (P.tree_arrays(rc), P.tree_arrays(c))
    return out


def test_init_tree_matches_reference():
    rm, m, rp, _ = models()
    got = m.init(0, device=CPU)
    w_leaves, _ = jax.tree_util.tree_flatten_with_path(rp)
    leaves, names, _ = TR.flatten_with_names(got)
    assert names == [jax.tree_util.keystr(p) for p, _ in w_leaves]
    for g, (_, w) in zip(leaves, w_leaves):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
    assert sum(g.numel() for g in leaves) == tree_param_count(m.cfg)
    # the reference's constants: A_log = log(linspace(1, 16, H)), D = 1,
    # dt_bias = softplus^-1 of a dt in [1e-3, 1e-1]
    np.testing.assert_array_max_ulp(got["layers"]["A_log"].numpy(),
                                    np.asarray(rp["layers"]["A_log"]), 2)
    assert not (got["layers"]["D"] - 1).any()
    dt = TS.softplus(got["layers"]["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1001


def test_loss_matches_reference():
    ref_loss, _, loss, _ = train_case()
    assert np.isfinite(loss)
    assert abs(loss - ref_loss) <= RTOL * abs(ref_loss)


def test_grads_match_reference_per_leaf():
    _, ref_grads, _, grads = train_case()
    assert len(grads) == len(ref_grads) == 12
    for i, (want, got) in enumerate(zip(ref_grads, grads)):
        assert got.shape == want.shape, i
        assert scaled_err(want, got) <= RTOL_GRAD, (i, scaled_err(want, got))


PROMPTS = [SHAPE[1], 13, 5]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_prefill_logits_and_caches_match_reference(prompt):
    r = serve_case(prompt)
    want, got = r["prefill"]
    assert scaled_err(want, got) <= RTOL
    ref_c, port_c = r["caches"]
    assert [a.shape for a in ref_c] == [a.shape for a in port_c]
    for i, (a, b) in enumerate(zip(ref_c, port_c)):
        assert scaled_err(a, b) <= RTOL, i


@pytest.mark.parametrize("prompt", PROMPTS)
def test_decode_steps_match_reference(prompt):
    r = serve_case(prompt)
    for i, (want, got) in enumerate(r["decode"]):
        assert scaled_err(want, got) <= RTOL, i
    ref_c, port_c = r["decode_caches"]
    for i, (a, b) in enumerate(zip(ref_c, port_c)):
        assert a.shape == b.shape, i
        assert scaled_err(a, b) <= RTOL, i


def test_init_cache_matches_reference():
    rm, m, _, _ = models()
    want = P.tree_arrays(rm.init_cache(3, 10))
    got = P.tree_arrays(m.init_cache(3, 10, device=CPU))
    assert [(a.shape, a.dtype) for a in want] == [(a.shape, a.dtype)
                                                  for a in got]
    assert not any(a.any() for a in got)


def test_prefill_ignores_max_len():
    """The reference's MambaLM.prefill takes ``max_len`` and ignores it,
    one under the prompt included; so does the port's."""
    rm, m, rp, params = models()
    toks = np.array([[1, 2, 3, 4, 5]], np.int32)
    r_a, _ = rm.prefill(rp, tokens=jnp.asarray(toks), max_len=3)
    r_b, _ = rm.prefill(rp, tokens=jnp.asarray(toks))
    assert np.array_equal(np.asarray(r_a), np.asarray(r_b))
    a, ca = m.prefill(params, torch.from_numpy(toks), max_len=3)
    b, cb = m.prefill(params, torch.from_numpy(toks), max_len=64)
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(ca, cb))
    assert scaled_err(r_a, a) <= RTOL


def test_module_holds_the_reference_tree():
    cfg = TC.get_smoke_config(ARCH)
    m = build_model(cfg)
    params = m.init(0, device=CPU)
    m.load_params(params)
    got = m.params_tree()
    assert TR.flatten_with_names(got)[1] == TR.flatten_with_names(params)[1]
    for a, b in zip(TR.leaves(got), TR.leaves(params)):
        assert a.data_ptr() == b.data_ptr()
    _, tb = _batches(cfg, 16)
    with torch.no_grad():
        assert float(m(tb, ce_chunk=8)) == float(m.loss(params, tb,
                                                        ce_chunk=8))


# ---------------------------------------------------------------------------
# the compressed step at world size 1
# ---------------------------------------------------------------------------

COMPRESSED_K, COMPRESSED_MIN = 0.05, 1024
COMPRESSED_HP = dict(ce_chunk=16, attn_chunk=16, remat=True, total_steps=10,
                     warmup=2)


@functools.lru_cache(maxsize=None)
def compressed_steps():
    return P.compressed_steps(
        ARCH, lambda cfg, s: _batches(cfg, 32, seed=10 + s), COMPRESSED_HP,
        COMPRESSED_K, COMPRESSED_MIN)


@pytest.mark.parametrize("n_steps", [1, 2])
def test_compressed_step_matches_reference(n_steps):
    P.assert_compressed_step(compressed_steps()[n_steps - 1], RTOL)


# ---------------------------------------------------------------------------
# bf16 drift of decode from prefill, against the reference's own
# ---------------------------------------------------------------------------

def test_bf16_decode_drift_is_the_references():
    """Mamba2 at 48 layers (d 128) in bf16: the chunked prefill and the
    recurrent decode round differently at every layer, and the gap of the
    last of 8 decode steps' logits to a prefill of prompt plus tokens
    compounds with depth. The port's gap stays within 1.25 times the
    reference's on the same weights and tokens (measured: 0.0137 against
    0.0275 of the largest logit; ``chip_smoke.py`` holds the full width in
    f32 and reports bf16)."""
    port, ref = P.bf16_decode_drift(ARCH, 48, 128, 128)
    assert ref > 0.01
    assert port <= 1.25 * ref, (port, ref)
