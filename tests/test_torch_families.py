"""The port's gemma3 local:global pattern, MoE and VLM decoders
(``repro_torch.models``) against the reference's (``repro.models``), on
the CPU.

- ``layers.local_window_attention`` and ``layers.apply_mrope`` against the
  reference's, at the banded path's edges (S below, at and above the
  window, a multiple of it and not);
- the ring caches: the port's ``_ring_from_tail`` against the
  reference's on the same arrays, and the prefill's rings against the
  port's own keys, each position in slot p mod w, bitwise;
- for the smoke configs of Moonshot, Llama4-Scout, gemma3 and Qwen2-VL on
  the reference's init (``interop.params_from_numpy``): the loss, every leaf's gradient, the MoE aux
  term, prefill logits and caches and eight decode steps (for gemma3 from
  a prompt longer and one shorter than the window, both crossing the
  ring's wrap); the VLM's prefill from embeddings with and without M-RoPE
  positions;
- one and two compressed train steps of the Moonshot smoke config at
  world size 1 (a gloo world of one rank) against the reference's on a
  one-device mesh;
- fault F: both packages refuse a prefill whose ``max_len`` is under the
  prompt's length.

Tolerances are those of ``tests/test_torch_models.py`` (f32: loss and
logits to 1e-5 of their scale, gradients to 1e-4 of a leaf's largest
magnitude): XLA and PyTorch sum a product's terms in other orders.
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
from repro.models import layers as RL
from repro.models.transformer import TransformerLM as RefLM
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import tree as TR
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models.transformer import TransformerLM

CPU = "cpu"
FAMILIES = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "gemma3-27b",
            "qwen2-vl-72b")
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
# layers
# ---------------------------------------------------------------------------

#: (S, window, Hq, Hkv): S under, at and over the window, a multiple and
#: not, one block of one query, MQA.
WINDOW_CASES = [(5, 8, 4, 2), (8, 8, 4, 2), (16, 8, 4, 2), (21, 8, 6, 2),
                (33, 8, 4, 1), (7, 1, 2, 2), (64, 16, 4, 4)]


@pytest.mark.parametrize("S,w,hq,hkv", WINDOW_CASES,
                         ids=[f"S{c[0]}-w{c[1]}" for c in WINDOW_CASES])
def test_local_window_attention_matches_reference(S, w, hq, hkv):
    q, k, v = (_normal(1, 2, S, hq, 16), _normal(2, 2, S, hkv, 16),
               _normal(3, 2, S, hkv, 16))
    want = RL.local_window_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), window=w)
    t = torch.from_numpy
    got = TL.local_window_attention(t(q), t(k), t(v), window=w)
    assert got.shape == (2, S, hq, 16) and got.dtype == torch.float32
    assert scaled_err(want, got) <= RTOL
    # the twin of test_layers.py::test_local_window_banded_matches_reference:
    # the banded form is the blockwise scan with the window's mask
    for chunk in (4, 16):
        full = TL.blockwise_attention(t(q), t(k), t(v), causal=True,
                                      window=w, chunk=chunk)
        assert scaled_err(full, got) <= RTOL


def test_local_window_attention_bf16():
    q, k, v = (_normal(4, 2, 20, 4, 16), _normal(5, 2, 20, 2, 16),
               _normal(6, 2, 20, 2, 16))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [interop.array_to_tensor(np.asarray(a), CPU) for a in jb]
    want = RL.local_window_attention(*jb, window=8)
    got = TL.local_window_attention(*tb, window=8)
    assert got.dtype == torch.bfloat16
    # f32 math on the same bf16 operands, one bf16 rounding of the output
    assert scaled_err(want, got) <= 2 ** -7


@pytest.mark.parametrize("sections", [(8, 4, 4), (4, 2, 2), (16, 0, 0)])
def test_apply_mrope_matches_reference(sections):
    D = 2 * sum(sections)
    x = _normal(7, 2, 9, 3, D)
    rng = np.random.default_rng(8)
    pos = rng.integers(0, 50, (3, 2, 9)).astype(np.int32)
    for theta in (1e4, 1e6):
        want = RL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections,
                              theta)
        got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                             sections, theta)
        assert scaled_err(want, got) <= RTOL
    with pytest.raises(ValueError, match="sum to head_dim/2"):
        TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                       (1, 1, 1), 1e4)


def test_mrope_reduces_to_rope_on_text():
    """The twin of test_layers.py::test_mrope_reduces_to_rope_on_text: with
    three equal position streams M-RoPE is RoPE, bitwise."""
    x = torch.from_numpy(_normal(9, 2, 6, 3, 32))
    pos = torch.arange(6, dtype=torch.int32)[None].expand(2, 6) + 3
    mpos = pos[None].expand(3, 2, 6)
    a = TL.apply_mrope(x, mpos, (8, 4, 4), 1e4)
    b = TL.apply_rope(x, pos, 1e4)
    assert torch.equal(a, b)


@pytest.mark.parametrize("S,w", [(3, 8), (8, 8), (13, 8), (16, 8),
                                 (9, 1)])
def test_ring_from_tail_bitwise(S, w):
    k = _normal(10, 2, S, 2, 4)
    want = RefLM._ring_from_tail(None, jnp.asarray(k), S, w)
    got = TransformerLM._ring_from_tail(torch.from_numpy(k), S, w)
    assert np.array_equal(got.numpy().view(np.int32),
                          np.asarray(want).view(np.int32))
    for p in range(max(0, S - w), S):  # position p sits in slot p mod w
        assert torch.equal(got[:, p % w], torch.from_numpy(k)[:, p])


# ---------------------------------------------------------------------------
# whole models on reference weights
# ---------------------------------------------------------------------------

def _batches(cfg, S, seed=0):
    """(reference batch, port batch) of the same numpy draws."""
    B = SHAPE[0]
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1), dtype=np.int32)
    arrays = {"labels": toks[:, 1:].copy()}
    if cfg.family == "vlm":
        arrays["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
        pos[1] //= 3   # distinct streams: the M-RoPE path differs from RoPE
        pos[2] %= 5
        arrays["mrope_positions"] = pos
    else:
        arrays["tokens"] = toks[:, :-1].copy()
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _cache_leaves(caches):
    """The reference's or the port's caches as a flat list of numpy arrays
    (k, v, length of each KVCache in layout order, then the length)."""
    layers = caches.layers
    if isinstance(layers, dict):
        loc, glob = layers["groups"]
        kvs = [loc, glob] + ([layers["extra"]] if layers["extra"] is not None
                             else [])
    else:
        kvs = [layers]
    out = []
    for c in kvs:
        out += [np_of(c.k), np_of(c.v), np.asarray(c.length)]
    return out + [np.asarray(caches.length)]


@functools.lru_cache(maxsize=None)
def models(arch: str):
    """(reference model, port model, reference params, port params): the
    reference's init, carried across."""
    rm = ref_build_model(RC.get_smoke_config(arch))
    m = build_model(TC.get_smoke_config(arch))
    rp = rm.init(jax.random.PRNGKey(0))
    return rm, m, rp, interop.params_from_numpy(jax.tree.map(np.asarray, rp),
                                                CPU)


@functools.lru_cache(maxsize=None)
def train_case(arch: str):
    """The reference's and the port's loss, grads and aux term, as numpy."""
    rm, m, rp, params = models(arch)
    cfg = m.cfg
    rb, tb = _batches(cfg, SHAPE[1])
    out = {}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: rm.loss(
        p, rb, ce_chunk=CE_CHUNK, attn_chunk=ATTN_CHUNK)))(rp)
    out["ref_loss"], out["ref_grads"] = float(loss), [
        np.asarray(g) for g in jax.tree.leaves(grads)]
    leaves, treedef = TR.flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    tl = m.loss(TR.unflatten(treedef, leaves), tb, ce_chunk=CE_CHUNK,
                attn_chunk=ATTN_CHUNK)
    out["loss"] = float(tl.detach())
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    out["grads"] = [np.zeros(x.shape, np.float32) if g is None else g.numpy()
                    for g, x in zip(grads, leaves)]

    # the aux term, from each backbone on the same embeddings
    B, S = SHAPE
    x0 = (rb["embeds"] if "embeds" in rb else rp["embed"][rb["tokens"]])
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    _, raux, _ = jax.jit(functools.partial(rm.backbone, chunk=ATTN_CHUNK))(
        rp, x0, positions, rb.get("mrope_positions"))
    with torch.no_grad():
        _, aux, _ = m.backbone(params, torch.from_numpy(np.array(x0)),
                               torch.from_numpy(np.array(positions)),
                               tb.get("mrope_positions"), chunk=ATTN_CHUNK)
    out["aux"] = (float(raux), float(aux))
    return out


@functools.lru_cache(maxsize=None)
def serve_case(arch: str, prompt_len: int = SHAPE[1]):
    """The reference's and the port's prefill logits and caches and
    :data:`NEW_TOKENS` decode steps, as numpy; the VLM prefills from
    embeddings, with and without M-RoPE positions."""
    rm, m, rp, params = models(arch)
    cfg = m.cfg
    B, S = SHAPE[0], prompt_len
    rb, tb = _batches(cfg, S, seed=1)
    out = {}
    kw = dict(max_len=S + NEW_TOKENS, attn_chunk=ATTN_CHUNK)
    ref_prefill = jax.jit(functools.partial(rm.prefill, **kw))
    if cfg.family == "vlm":
        rlog, rc = ref_prefill(rp, embeds=rb["embeds"])
        log, c = m.prefill(params, embeds=tb["embeds"], **kw)
        r2, _ = ref_prefill(rp, embeds=rb["embeds"],
                            mrope_positions=rb["mrope_positions"])
        t2, _ = m.prefill(params, embeds=tb["embeds"],
                          mrope_positions=tb["mrope_positions"], **kw)
        out["prefill_mrope"] = (np.asarray(r2), t2.numpy())
        out["prefill_mrope_vs_rope"] = float(np.abs(t2.numpy()
                                                    - log.numpy()).max())
    else:
        rlog, rc = ref_prefill(rp, tokens=rb["tokens"])
        log, c = m.prefill(params, tb["tokens"], **kw)
        # the port's own keys and values, to hold its rings bitwise
        with torch.no_grad():
            pos = torch.arange(S, dtype=torch.int32).expand(B, S)
            _, _, kv = m.backbone(params, m._embed(params, tb["tokens"]),
                                  pos, collect_kv=True, chunk=ATTN_CHUNK)
        out["kv"] = kv
        out["port_caches"] = c
    out["prefill"] = (np.asarray(rlog), log.numpy())
    out["caches"] = (_cache_leaves(rc), _cache_leaves(c))
    ref_decode = jax.jit(functools.partial(rm.decode_step,
                                           attn_chunk=ATTN_CHUNK))
    decode = []
    tok = jnp.argmax(rlog, -1)
    for _ in range(NEW_TOKENS):
        rlog, rc = ref_decode(rp, rc, tok)
        log, c = m.decode_step(params, c, torch.from_numpy(np.array(tok)),
                               attn_chunk=ATTN_CHUNK)
        decode.append((np.asarray(rlog), log.numpy()))
        tok = jnp.argmax(rlog, -1)  # both sides take the reference's token
    out["decode"] = decode
    out["decode_caches"] = (_cache_leaves(rc), _cache_leaves(c))
    return out


CASES = [(a, SHAPE[1]) for a in FAMILIES] + [("gemma3-27b", 5)]
IDS = [f"{a}-prompt{s}" for a, s in CASES]


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_matches_reference(arch):
    r = train_case(arch)
    assert np.isfinite(r["loss"])
    assert abs(r["loss"] - r["ref_loss"]) <= RTOL * abs(r["ref_loss"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_grads_match_reference_per_leaf(arch):
    r = train_case(arch)
    assert len(r["grads"]) == len(r["ref_grads"])
    for i, (want, got) in enumerate(zip(r["ref_grads"], r["grads"])):
        assert got.shape == want.shape, i
        assert scaled_err(want, got) <= RTOL_GRAD, (i, scaled_err(want, got))


@pytest.mark.parametrize("arch", FAMILIES)
def test_aux_term_matches_reference(arch):
    want, got = train_case(arch)["aux"]
    if TC.get_smoke_config(arch).family == "moe":
        assert want > 0.0
        assert abs(got - want) <= RTOL * want
    else:
        assert want == got == 0.0


@pytest.mark.parametrize("arch,prompt", CASES, ids=IDS)
def test_prefill_logits_and_caches_match_reference(arch, prompt):
    r = serve_case(arch, prompt)
    want, got = r["prefill"]
    assert scaled_err(want, got) <= RTOL
    ref_c, port_c = r["caches"]
    assert len(ref_c) == len(port_c)
    for i, (a, b) in enumerate(zip(ref_c, port_c)):
        assert a.shape == b.shape, i
        if a.dtype.kind in "iu":
            assert np.array_equal(a, b), i
        else:
            assert scaled_err(a, b) <= RTOL, i


@pytest.mark.parametrize("arch,prompt", [c for c in CASES
                                         if c[0] == "gemma3-27b"],
                         ids=[i for c, i in zip(CASES, IDS)
                              if c[0] == "gemma3-27b"])
def test_ring_caches_hold_each_position_in_its_slot(arch, prompt):
    """The prefill's local rings, bitwise: position p of a local layer's
    keys and values in slot p mod w, unfilled slots zero; the global
    caches padded with zeros past the prompt."""
    r = serve_case(arch, prompt)
    cfg = TC.get_smoke_config(arch)
    kv, c = r["kv"], r["port_caches"]
    w = min(cfg.sliding_window, prompt + NEW_TOKENS)
    loc, glob = c.layers["groups"]
    rings = ([(loc.k[0, i], loc.v[0, i]) for i in range(loc.k.shape[1])]
             + [(c.layers["extra"].k[i], c.layers["extra"].v[i])
                for i in range(c.layers["extra"].k.shape[0])])
    pairs = kv["local"] + kv["extra"]
    assert len(rings) == len(pairs) == cfg.n_layers - 1
    for (rk, rv), (k, v) in zip(rings, pairs):
        assert rk.shape[1] == w
        filled = set()
        for p in range(max(0, prompt - w), prompt):
            assert torch.equal(rk[:, p % w], k[:, p])
            assert torch.equal(rv[:, p % w], v[:, p])
            filled.add(p % w)
        for s in set(range(w)) - filled:
            assert not rk[:, s].any() and not rv[:, s].any()
    (gk, gv), = kv["global"]
    assert torch.equal(glob.k[0, :, :prompt], gk)
    assert not glob.k[0, :, prompt:].any()


@pytest.mark.parametrize("arch,prompt", CASES, ids=IDS)
def test_decode_steps_match_reference(arch, prompt):
    r = serve_case(arch, prompt)
    for i, (want, got) in enumerate(r["decode"]):
        assert scaled_err(want, got) <= RTOL, i
    ref_c, port_c = r["decode_caches"]
    assert int(ref_c[-1]) == int(port_c[-1]) == prompt + NEW_TOKENS
    for i, (a, b) in enumerate(zip(ref_c, port_c)):
        assert a.shape == b.shape, i
        if a.dtype.kind in "iu":
            assert np.array_equal(a, b), i
        else:
            assert scaled_err(a, b) <= RTOL, i


def test_vlm_prefill_with_mrope_positions():
    r = serve_case("qwen2-vl-72b")
    want, got = r["prefill_mrope"]
    assert scaled_err(want, got) <= RTOL
    # the M-RoPE positions (distinct streams) change the logits
    assert r["prefill_mrope_vs_rope"] > 1e-3


@pytest.mark.parametrize("arch", FAMILIES)
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


# ---------------------------------------------------------------------------
# fault F: a prefill shorter than its prompt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ("smollm-135m",) + FAMILIES)
def test_prefill_refuses_max_len_under_the_prompt(arch):
    """The reference's global caches pad by ``max_len - S`` and raise on a
    negative pad; the port refuses before the forward (it once cropped)."""
    rm, m, rp, params = models(arch)
    cfg = m.cfg
    toks = np.array([[1, 2, 3]], np.int32)
    if cfg.family == "vlm":
        e = np.zeros((1, 3, cfg.d_model), np.float32)
        rkw, kw = {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    else:
        rkw, kw = ({"tokens": jnp.asarray(toks)},
                   {"tokens": torch.from_numpy(toks)})
    with pytest.raises(ValueError):
        rm.prefill(rp, max_len=2, **rkw)
    with pytest.raises(ValueError, match="under the prompt"):
        m.prefill(params, max_len=2, **kw)
    # at max_len == S both build caches of S positions
    _, c = m.prefill(params, max_len=3, **kw)
    _, rc = rm.prefill(rp, max_len=3, **rkw)
    assert [a.shape for a in _cache_leaves(c)] == [
        a.shape for a in _cache_leaves(rc)]


# ---------------------------------------------------------------------------
# the compressed step of the MoE model at world size 1
# ---------------------------------------------------------------------------

COMPRESSED_ARCH = "moonshot-v1-16b-a3b"
COMPRESSED_K, COMPRESSED_MIN = 0.05, 1024
COMPRESSED_HP = dict(ce_chunk=16, attn_chunk=16, remat=True, total_steps=10,
                     warmup=2)


@functools.lru_cache(maxsize=None)
def compressed_steps():
    return P.compressed_steps(
        COMPRESSED_ARCH, lambda cfg, s: _batches(cfg, 32, seed=10 + s),
        COMPRESSED_HP, COMPRESSED_K, COMPRESSED_MIN)


@pytest.mark.parametrize("n_steps", [1, 2])
def test_moe_compressed_step_matches_reference(n_steps):
    P.assert_compressed_step(compressed_steps()[n_steps - 1], RTOL)
