"""The port's Zamba2 hybrid (``repro_torch.models.hybrid``) and Whisper
encoder-decoder (``repro_torch.models.encdec``) against the reference's,
on the CPU, and the dry-run's shape functions of ``repro_torch.data``.

- for the two smoke configs on the reference's init
  (``interop.params_from_numpy``: the 5-D ``mamba_layers`` leaves, the
  ``shared`` block, the nested ``attn``/``self``/``cross`` dicts): the
  init tree, the loss, every leaf's gradient, prefill logits and caches
  and eight decode steps, from a prompt of 32 tokens and one of 13 (not a
  multiple of the SSM chunk of 8); Whisper's 12 frames are not a multiple
  of the attention chunk of 8;
- both packages refuse a prefill whose ``max_len`` is under the prompt's
  length, and accept ``max_len`` equal to it;
- one and two compressed train steps of the Zamba2 smoke config at world
  size 1 against the reference's on a one-device mesh;
- ``sinusoidal_positions``, at an offset given as a tensor too;
- in bf16, Zamba2's 54 layers: decode drifts from prefill no more than
  the reference's own decode drifts from its prefill;
- ``input_specs`` and ``decode_inputs`` against the reference's
  ``ShapeDtypeStruct`` and ``jax.eval_shape`` of ``init_cache``, for every
  arch and shape at full size (``meta`` tensors, nothing allocated).

Tolerances are those of ``tests/test_torch_models.py`` (f32: loss and
logits to 1e-5 of their scale, gradients to 1e-4 of a leaf's largest
magnitude). The shared block's gradient is the sum of its sites'
gradients, which autograd and XLA's scan transpose add in other orders.
Measured: loss equal, gradients 8.9e-6 (Zamba2) and 1.1e-6 (Whisper),
logits 1.3e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro import configs as RC
from repro.data import decode_inputs as ref_decode_inputs
from repro.data import input_specs as ref_input_specs
from repro.models import build_model as ref_build_model
from repro.models import encdec as RE
from repro.models.common import SHAPES as REF_SHAPES
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import tree as TR
from repro_torch.data import decode_inputs, input_specs
from repro_torch.models import build_model
from repro_torch.models import encdec as TE
from repro_torch.models.common import SHAPES
from repro_torch.models.common import tree_param_count

CPU = "cpu"
ARCHS = ("zamba2-2.7b", "whisper-medium")
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


@functools.lru_cache(maxsize=None)
def models(arch: str):
    rm = ref_build_model(RC.get_smoke_config(arch))
    m = build_model(TC.get_smoke_config(arch))
    rp = rm.init(jax.random.PRNGKey(0))
    return rm, m, rp, interop.params_from_numpy(jax.tree.map(np.asarray, rp),
                                                CPU)


def _batches(cfg, S, seed=0):
    """(reference batch, port batch) of the same numpy draws: tokens,
    labels and, for the encoder-decoder, frame embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (SHAPE[0], S + 1), dtype=np.int32)
    arrays = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    if cfg.family == "encdec":
        arrays["embeds"] = rng.standard_normal(
            (SHAPE[0], cfg.n_frames, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _prompt_kw(batch):
    return {k: batch[k] for k in ("tokens", "embeds") if k in batch}


@functools.lru_cache(maxsize=None)
def train_case(arch: str):
    rm, m, rp, params = models(arch)
    rb, tb = _batches(m.cfg, SHAPE[1])
    loss, grads = jax.jit(jax.value_and_grad(lambda p: rm.loss(
        p, rb, ce_chunk=CE_CHUNK, attn_chunk=ATTN_CHUNK)))(rp)
    leaves, treedef = TR.flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    tl = m.loss(TR.unflatten(treedef, leaves), tb, ce_chunk=CE_CHUNK,
                attn_chunk=ATTN_CHUNK)
    got = torch.autograd.grad(tl, leaves)
    return (float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)],
            float(tl.detach()), [g.numpy() for g in got])


@functools.lru_cache(maxsize=None)
def serve_case(arch: str, prompt: int):
    rm, m, rp, params = models(arch)
    rb, tb = _batches(m.cfg, prompt, seed=1)
    kw = dict(max_len=prompt + NEW_TOKENS, attn_chunk=ATTN_CHUNK)
    rlog, rc = jax.jit(functools.partial(rm.prefill, **kw))(
        rp, **_prompt_kw(rb))
    log, c = m.prefill(params, **_prompt_kw(tb), **kw)
    out = {"prefill": (np.asarray(rlog), log.numpy()),
           "caches": (P.tree_arrays(rc), P.tree_arrays(c))}
    ref_decode = jax.jit(functools.partial(rm.decode_step,
                                           attn_chunk=ATTN_CHUNK))
    decode, tok = [], jnp.argmax(rlog, -1)
    for _ in range(NEW_TOKENS):
        rlog, rc = ref_decode(rp, rc, tok)
        log, c = m.decode_step(params, c, torch.from_numpy(np.array(tok)),
                               attn_chunk=ATTN_CHUNK)
        decode.append((np.asarray(rlog), log.numpy()))
        tok = jnp.argmax(rlog, -1)  # both sides take the reference's token
    out["decode"] = decode
    out["decode_caches"] = (P.tree_arrays(rc), P.tree_arrays(c))
    return out


def _assert_trees_close(ref, got):
    assert [a.shape for a in ref] == [a.shape for a in got]
    for i, (a, b) in enumerate(zip(ref, got)):
        if a.dtype.kind in "iu":
            assert np.array_equal(a, b), i
        else:
            assert scaled_err(a, b) <= RTOL, i


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    rm, m, rp, _ = models(arch)
    got = m.init(0, device=CPU)
    w_leaves, _ = jax.tree_util.tree_flatten_with_path(rp)
    leaves, names, _ = TR.flatten_with_names(got)
    assert names == [jax.tree_util.keystr(p) for p, _ in w_leaves]
    for g, (_, w) in zip(leaves, w_leaves):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
    assert sum(g.numel() for g in leaves) == tree_param_count(m.cfg)
    if m.cfg.family == "hybrid":
        assert got["mamba_layers"]["in_proj"].dim() == 4  # (G, ae, d, ...)


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_round_trip_keeps_bits(arch):
    """``params_from_numpy`` and back keep the reference's tree: names,
    shapes and bits."""
    _, _, rp, params = models(arch)
    back = interop.params_to_numpy(params)
    ref = jax.tree_util.tree_flatten_with_path(rp)[0]
    leaves, names, _ = TR.flatten_with_names(back)
    assert names == [jax.tree_util.keystr(p) for p, _ in ref]
    for a, (_, r) in zip(leaves, ref):
        assert a.tobytes() == np.asarray(r).tobytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    ref_loss, _, loss, _ = train_case(arch)
    assert np.isfinite(loss)
    assert abs(loss - ref_loss) <= RTOL * abs(ref_loss)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference_per_leaf(arch):
    _, ref_grads, _, grads = train_case(arch)
    assert len(grads) == len(ref_grads)
    for i, (want, got) in enumerate(zip(ref_grads, grads)):
        assert got.shape == want.shape, i
        assert scaled_err(want, got) <= RTOL_GRAD, (i, scaled_err(want, got))


CASES = [(a, s) for a in ARCHS for s in (SHAPE[1], 13)]
IDS = [f"{a}-prompt{s}" for a, s in CASES]


@pytest.mark.parametrize("arch,prompt", CASES, ids=IDS)
def test_prefill_logits_and_caches_match_reference(arch, prompt):
    r = serve_case(arch, prompt)
    want, got = r["prefill"]
    assert scaled_err(want, got) <= RTOL
    _assert_trees_close(*r["caches"])


@pytest.mark.parametrize("arch,prompt", CASES, ids=IDS)
def test_decode_steps_match_reference(arch, prompt):
    r = serve_case(arch, prompt)
    for i, (want, got) in enumerate(r["decode"]):
        assert scaled_err(want, got) <= RTOL, i
    ref_c, port_c = r["decode_caches"]
    assert int(ref_c[-1]) == int(port_c[-1]) == prompt + NEW_TOKENS
    _assert_trees_close(ref_c, port_c)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_refuses_max_len_under_the_prompt(arch):
    """The reference pads its KV caches by ``max_len - S`` and raises on a
    negative pad; the port refuses before the forward."""
    rm, m, rp, params = models(arch)
    rb, tb = _batches(m.cfg, 5)
    with pytest.raises(ValueError):
        rm.prefill(rp, max_len=3, **_prompt_kw(rb))
    with pytest.raises(ValueError, match="under the prompt"):
        m.prefill(params, max_len=3, **_prompt_kw(tb))
    # at max_len == S both build caches of S positions
    _, rc = rm.prefill(rp, max_len=5, **_prompt_kw(rb))
    _, c = m.prefill(params, max_len=5, **_prompt_kw(tb))
    assert [a.shape for a in P.tree_arrays(c)] == [
        a.shape for a in P.tree_arrays(rc)]


@pytest.mark.parametrize("arch", ARCHS)
def test_module_holds_the_reference_tree(arch):
    cfg = TC.get_smoke_config(arch)
    m = build_model(cfg)
    params = m.init(0, device=CPU)
    m.load_params(params)
    got = m.params_tree()
    assert TR.flatten_with_names(got)[1] == TR.flatten_with_names(params)[1]
    for a, b in zip(TR.leaves(got), TR.leaves(params)):
        assert a.data_ptr() == b.data_ptr()
    _, tb = _batches(cfg, 16)
    kw = dict(ce_chunk=8, attn_chunk=8)
    with torch.no_grad():
        assert float(m(tb, **kw)) == float(m.loss(params, tb, **kw))


@pytest.mark.parametrize("S,d,offset", [(7, 16, 0), (1, 64, 37),
                                        (12, 8, 1000)])
def test_sinusoidal_positions_match_reference(S, d, offset):
    want = RE.sinusoidal_positions(S, d, offset=jnp.asarray(offset,
                                                            jnp.int32))
    got = TE.sinusoidal_positions(S, d, offset=torch.tensor(
        offset, dtype=torch.int32))
    assert got.shape == (S, d) and got.dtype == torch.float32
    assert scaled_err(want, got) <= RTOL
    assert torch.equal(got, TE.sinusoidal_positions(S, d, offset=offset))


# ---------------------------------------------------------------------------
# the compressed step of the hybrid at world size 1
# ---------------------------------------------------------------------------

COMPRESSED_K, COMPRESSED_MIN = 0.05, 1024
COMPRESSED_HP = dict(ce_chunk=16, attn_chunk=16, remat=True, total_steps=10,
                     warmup=2)


@functools.lru_cache(maxsize=None)
def compressed_steps():
    return P.compressed_steps(
        "zamba2-2.7b", lambda cfg, s: _batches(cfg, 32, seed=10 + s),
        COMPRESSED_HP, COMPRESSED_K, COMPRESSED_MIN)


@pytest.mark.parametrize("n_steps", [1, 2])
def test_hybrid_compressed_step_matches_reference(n_steps):
    P.assert_compressed_step(compressed_steps()[n_steps - 1], RTOL)


def test_hybrid_bf16_decode_drift_is_the_references():
    """Zamba2's 54 layers and 9 shared-block sites (d 128) in bf16: the
    gap of the last of 8 decode steps' logits to a prefill of prompt plus
    tokens compounds with depth to a few percent in both packages. The
    port's stays within 1.25 times the reference's on the same weights and
    tokens (measured: 0.0381 against 0.0390 of the largest logit;
    ``chip_smoke.py`` holds the full width in f32 and reports bf16)."""
    port, ref = P.bf16_decode_drift("zamba2-2.7b", 54, 128, 128)
    assert ref > 0.01
    assert port <= 1.25 * ref, (port, ref)


# ---------------------------------------------------------------------------
# the dry-run's shape functions, every arch at full size
# ---------------------------------------------------------------------------

def _spec(x):
    """(shape, dtype name) of a ShapeDtypeStruct or a meta tensor."""
    return tuple(x.shape), str(x.dtype).split(".")[-1]


@functools.lru_cache(maxsize=None)
def _models(arch):
    return (ref_build_model(RC.get_config(arch)),
            build_model(TC.get_config(arch)))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", RC.ARCHS)
def test_input_specs_and_decode_inputs_match_reference(arch, shape):
    ref_m, m = _models(arch)
    want = ref_input_specs(RC.get_config(arch), REF_SHAPES[shape])
    got = input_specs(TC.get_config(arch), SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device.type == "meta", k
        assert _spec(got[k]) == _spec(want[k]), k
    ref_caches, ref_tok = ref_decode_inputs(RC.get_config(arch),
                                            REF_SHAPES[shape], ref_m)
    caches, tok = decode_inputs(TC.get_config(arch), SHAPES[shape], m)
    assert _spec(tok) == _spec(ref_tok) and tok.device.type == "meta"
    want_leaves = jax.tree.leaves(ref_caches)
    got_leaves = P.tree_leaves(caches)
    assert [_spec(x) for x in got_leaves] == [_spec(x) for x in want_leaves]
    assert all(x.device.type == "meta" for x in got_leaves)

