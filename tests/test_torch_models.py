"""The port's dense decoder stack (``repro_torch.models``, ``configs``,
``data``) against the reference (``repro.models``, ``repro.configs``,
``repro.data``), on the CPU.

The reference runs with no mesh, as ``tests/test_models_smoke.py`` runs
it; its parameters come from its own seeded init and cross into the port
through ``interop.params_from_numpy``. Both sides take the same numpy
inputs. The arithmetic is the reference's, operation for operation, but
not bitwise: XLA and PyTorch sum a matrix product's terms in another order.
Each tolerance is stated where it is used; the f32 ones are a few f32
ulps of the compared values' scale (measured: loss equal to 1e-7, logits
to 3e-6, grads to 2e-6 of a leaf's largest magnitude).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.data import make_batch as ref_make_batch
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro.models.common import ShapeConfig as RefShape
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import tree as TR
from repro_torch.data import make_batch
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models.common import SHAPES, ShapeConfig

CPU = "cpu"
DENSE = ("smollm-135m", "internlm2-1.8b", "stablelm-3b")
#: The other decoder families (tests/test_torch_families.py holds them).
FAMILIES = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "gemma3-27b",
            "qwen2-vl-72b")
SHAPE = (2, 32)         # the batch of tests/test_models_smoke.py
CE_CHUNK, ATTN_CHUNK = 16, 8
#: f32: the loss and logits to this share of their scale; gradients to
#: RTOL_GRAD of each leaf's largest magnitude.
RTOL, RTOL_GRAD = 1e-5, 1e-4
#: bf16 compute: each matrix product rounds its output to 8 bits of
#: mantissa, in another order than XLA's (measured: loss 3e-4, logits
#: 0.04, grads 0.021 of a leaf's largest magnitude).
BF16_RTOL_LOSS, BF16_ATOL_LOGITS, BF16_RTOL_GRAD = 2e-3, 0.1, 0.06


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def scaled_err(ref, got) -> float:
    """max |ref - got| over the max |ref| (1 where ref is all zero)."""
    ref, got = np_of(ref), np_of(got)
    return float(np.abs(ref - got).max()) / (float(np.abs(ref).max()) or 1.0)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_arch_lists_equal():
    assert TC.ARCHS == RC.ARCHS
    assert TC.all_cells() == RC.all_cells()


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_configs_field_for_field(arch):
    for getter in ("get_config", "get_smoke_config"):
        ref = getattr(RC, getter)(arch)
        port = getattr(TC, getter)(arch.replace("_", "-"))
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), getter
        assert port.head_dim == ref.head_dim
        assert (port.q_dim, port.kv_dim, port.d_inner) == (
            ref.q_dim, ref.kv_dim, ref.d_inner)
        assert str(port.cdtype).split(".")[-1] == str(ref.cdtype)
        assert str(port.pdtype).split(".")[-1] == str(ref.pdtype)
    assert TC._module(arch).SHAPE_SKIPS == RC._module(arch).SHAPE_SKIPS
    assert TC.canonical(arch.replace("_", "-")) == RC.canonical(
        arch.replace("_", "-"))
    for s in SHAPES:
        assert TC.supports_shape(arch, s) == RC.supports_shape(arch, s)


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_param_counts_equal(arch):
    for getter in ("get_config", "get_smoke_config"):
        ref, port = getattr(RC, getter)(arch), getattr(TC, getter)(arch)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()


def test_shapes_equal():
    from repro.models.common import SHAPES as REF_SHAPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("gpt-5")


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_build_model_returns_the_references_counterpart(arch):
    """Every family is built, by the class of the reference's name."""
    for getter in ("get_config", "get_smoke_config"):
        ref = ref_build_model(getattr(RC, getter)(arch))
        got = build_model(getattr(TC, getter)(arch))
        assert type(got).__name__ == type(ref).__name__
        assert got.cfg == getattr(TC, getter)(arch)


# ---------------------------------------------------------------------------
# init trees and the data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_init_tree_matches_reference_eval_shape(arch):
    cfg = TC.get_smoke_config(arch)
    ref_model = ref_build_model(RC.get_smoke_config(arch))
    want = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    got = build_model(cfg).init(0, device=CPU)
    w_leaves, _ = jax.tree_util.tree_flatten_with_path(want)
    leaves, names, _ = TR.flatten_with_names(got)
    assert names == [jax.tree_util.keystr(p) for p, _ in w_leaves]
    for g, (_, w) in zip(leaves, w_leaves):
        assert tuple(g.shape) == tuple(w.shape)
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
    assert sum(g.numel() for g in leaves) == cfg.param_count()


def test_init_is_seeded_and_device_independent():
    model = build_model(TC.get_smoke_config("smollm-135m"))
    a, b = model.init(0, device=CPU), model.init(0, device=CPU)
    c = model.init(1, device=CPU)
    assert all(torch.equal(x, y) for x, y in zip(TR.leaves(a), TR.leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])
    # the norms start at zero (scale 1 + 0), the weights at 1/sqrt(fan_in)
    assert not a["final_ln"].any() and not a["layers"]["ln1"].any()
    std = float(a["layers"]["wq"].std())
    assert abs(std - 48 ** -0.5) < 0.02


def test_smollm_shape_table_is_the_port_models_own():
    """``chip_smoke.py``'s SmolLM-135M table (held against
    ``jax.eval_shape`` in ``tests/test_torch_delta_sync.py``) is also the
    port's own init of ``get_config("smollm_135m")``."""
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    params = build_model(TC.get_config("smollm_135m")).init(0, device=CPU)
    shapes = TR.tree_map(lambda x: tuple(x.shape), params)
    assert shapes == chip_smoke.SMOLLM_135M_SHAPES
    assert sum(x.numel() for x in TR.leaves(params)) == 162_826_560
    assert all(x.dtype == torch.float32 for x in TR.leaves(params))


@pytest.mark.parametrize("arch", DENSE + FAMILIES + ("whisper-medium",))
@pytest.mark.parametrize("step", [0, 3])
def test_make_batch_bitwise(arch, step):
    """The same draws in one process (the seed is Python's ``hash``)."""
    shape = ShapeConfig("smoke", "train", 24, 3)
    ref = ref_make_batch(RC.get_smoke_config(arch),
                         RefShape("smoke", "train", 24, 3), step)
    got = make_batch(TC.get_smoke_config(arch), shape, step, device=CPU)
    assert sorted(got) == sorted(ref)
    for k in ref:
        r = np.asarray(ref[k])
        g = got[k].numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, k
        assert g.tobytes() == r.tobytes(), k


def test_make_batch_overrides():
    cfg = TC.get_smoke_config("smollm-135m")
    b = make_batch(cfg, SHAPES["train_4k"], 1, batch_override=2,
                   seq_override=16, device=CPU)
    assert b["tokens"].shape == (2, 16) and b["tokens"].dtype == torch.int32
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_rms_norm():
    x, s = _normal(0, 2, 5, 48), 0.1 * _normal(1, 48)
    want = RL.rms_norm(jnp.asarray(x), jnp.asarray(s))
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(s))
    assert scaled_err(want, got) <= RTOL
    # bf16 in, bf16 out, computed in f32
    xb = jnp.asarray(x, jnp.bfloat16)
    want = RL.rms_norm(xb, jnp.asarray(s))
    got = TL.rms_norm(interop.array_to_tensor(np.asarray(xb), CPU),
                      torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the same f32 value, at most one ulp apart
    assert scaled_err(want, got) <= 2 ** -7


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope(theta):
    x = _normal(2, 2, 7, 3, 16)
    pos = np.tile(np.arange(7, dtype=np.int32) + 5, (2, 1))
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    assert scaled_err(want, got) <= RTOL
    assert scaled_err(RL.rope_freqs(16, theta),
                      TL.rope_freqs(16, theta)) <= RTOL


def test_mlps():
    x = _normal(3, 2, 5, 48)
    w1, w3, w2 = _normal(4, 48, 96), _normal(5, 48, 96), _normal(6, 96, 48)
    t = torch.from_numpy
    want = RL.swiglu(*(jnp.asarray(a) for a in (x, w1, w3, w2)))
    assert scaled_err(want, TL.swiglu(t(x), t(w1), t(w3), t(w2))) <= RTOL
    want = RL.gelu_mlp(*(jnp.asarray(a) for a in (x, w1, w2)))
    assert scaled_err(want, TL.gelu_mlp(t(x), t(w1), t(w2))) <= RTOL


ATTN_CASES = {
    # name: (Sq, Skv, Hq, Hkv, chunk, causal, q_offset, kv_len)
    "gqa_chunk16": (24, 24, 6, 2, 16, True, 0, None),      # padded last chunk
    "gqa_chunk7": (24, 24, 6, 2, 7, True, 0, None),
    "chunk1": (9, 9, 4, 4, 1, True, 0, None),
    "decode_kv_len": (1, 40, 6, 3, 16, False, 33, 34),
    "prefix_q_offset": (5, 40, 4, 2, 7, True, 20, 25),
    "mqa_noncausal": (11, 19, 4, 1, 16, False, 0, None),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_blockwise_attention_matches_reference(case):
    sq, skv, hq, hkv, chunk, causal, q_off, kv_len = ATTN_CASES[case]
    q, k, v = (_normal(7, 2, sq, hq, 16), _normal(8, 2, skv, hkv, 16),
               _normal(9, 2, skv, hkv, 16))
    kw = dict(causal=causal, q_offset=q_off, kv_len=kv_len)
    want = RL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), chunk=chunk, **kw)
    want_ref = RL.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
    t = torch.from_numpy
    got = TL.blockwise_attention(t(q), t(k), t(v), chunk=chunk, **kw)
    got_ref = TL.attention_ref(t(q), t(k), t(v), **kw)
    assert got.shape == (2, sq, hq, 16)
    assert scaled_err(want, got) <= RTOL
    assert scaled_err(want_ref, got_ref) <= RTOL
    assert scaled_err(want_ref, got) <= RTOL


def test_blockwise_attention_bf16_rounds_p_and_v_as_the_reference():
    q, k, v = (_normal(10, 2, 20, 6, 16), _normal(11, 2, 20, 2, 16),
               _normal(12, 2, 20, 2, 16))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [interop.array_to_tensor(np.asarray(a), CPU) for a in jb]
    want = RL.blockwise_attention(*jb, chunk=8)
    got = TL.blockwise_attention(*tb, chunk=8)
    assert got.dtype == torch.bfloat16
    # the same bf16 operands; the outputs round to bf16 once (one ulp of
    # the output's scale, 2^-7, after f32 sums in two orders)
    assert scaled_err(want, got) <= 2 ** -7


def test_cache_update_decode_wraps():
    S_max = 4
    k = torch.zeros(1, S_max, 1, 2)
    cache = TL.KVCache(k, k.clone(), torch.tensor(0, dtype=torch.int32))
    rk = RL.KVCache(jnp.zeros((1, S_max, 1, 2)), jnp.zeros((1, S_max, 1, 2)),
                    jnp.asarray(0, jnp.int32))
    for step in range(7):  # wraps past S_max
        new = np.full((1, 1, 1, 2), step + 1.0, np.float32)
        cache = TL.cache_update_decode(cache, torch.from_numpy(new),
                                       torch.from_numpy(-new))
        rk = RL.cache_update_decode(rk, jnp.asarray(new), jnp.asarray(-new))
        assert np.array_equal(cache.k.numpy(), np.asarray(rk.k))
        assert np.array_equal(cache.v.numpy(), np.asarray(rk.v))
        assert int(cache.length) == int(rk.length) == step + 1
    assert cache.k[0, :, 0, 0].tolist() == [5.0, 6.0, 7.0, 4.0]


# ---------------------------------------------------------------------------
# whole models on reference weights
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def model_case(arch: str, compute_dtype: str):
    """The reference's and the port's loss, grads, prefill and 8 decode
    steps on the reference's init, as numpy."""
    rcfg = dataclasses.replace(RC.get_smoke_config(arch),
                               compute_dtype=compute_dtype)
    cfg = dataclasses.replace(TC.get_smoke_config(arch),
                              compute_dtype=compute_dtype)
    rm, m = ref_build_model(rcfg), build_model(cfg)
    rp = rm.init(jax.random.PRNGKey(0))
    params = interop.params_from_numpy(jax.tree.map(np.asarray, rp), CPU)
    B, S = SHAPE
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S + 1),
                                             dtype=np.int32)
    rb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
          "labels": torch.from_numpy(toks[:, 1:].copy())}
    out = {}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: rm.loss(
        p, rb, ce_chunk=CE_CHUNK, attn_chunk=ATTN_CHUNK)))(rp)
    out["ref_loss"], out["ref_grads"] = float(loss), [
        np.asarray(g) for g in jax.tree.leaves(grads)]
    leaves, treedef = TR.flatten(params)
    leaves = [x.requires_grad_() for x in leaves]
    tl = m.loss(TR.unflatten(treedef, leaves), tb, ce_chunk=CE_CHUNK,
                attn_chunk=ATTN_CHUNK)
    out["loss"] = float(tl.detach())
    out["grads"] = [g.numpy() for g in torch.autograd.grad(tl, leaves)]
    params = TR.unflatten(treedef, [x.detach() for x in leaves])

    max_len = S + 8
    rlog, rc = rm.prefill(rp, tokens=rb["tokens"], max_len=max_len,
                          attn_chunk=ATTN_CHUNK)
    log, c = m.prefill(params, tb["tokens"], max_len=max_len,
                       attn_chunk=ATTN_CHUNK)
    out["prefill"] = (np.asarray(rlog), log.numpy())
    out["caches"] = ([np.asarray(rc.layers.k, np.float32),
                      np.asarray(rc.layers.v, np.float32),
                      np.asarray(rc.layers.length), np.asarray(rc.length)],
                     [c.layers.k.float().numpy(), c.layers.v.float().numpy(),
                      c.layers.length.numpy(), c.length.numpy()])
    decode = []
    tok = jnp.argmax(rlog, -1)
    for _ in range(8):
        rlog, rc = rm.decode_step(rp, rc, tok, attn_chunk=ATTN_CHUNK)
        log, c = m.decode_step(params, c, torch.from_numpy(np.array(tok)),
                               attn_chunk=ATTN_CHUNK)
        decode.append((np.asarray(rlog), log.numpy()))
        tok = jnp.argmax(rlog, -1)  # both sides take the reference's token
    out["decode"] = decode
    out["decode_len"] = (int(rc.length), int(c.length))
    return out


VARIANTS = [(a, "float32") for a in DENSE] + [("smollm-135m", "bfloat16")]
IDS = [f"{a}-{d}" for a, d in VARIANTS]


def _tols(dtype):
    if dtype == "float32":
        return RTOL, RTOL, RTOL_GRAD
    return BF16_RTOL_LOSS, BF16_ATOL_LOGITS, BF16_RTOL_GRAD


@pytest.mark.parametrize("arch,dtype", VARIANTS, ids=IDS)
def test_loss_matches_reference(arch, dtype):
    r = model_case(arch, dtype)
    rtol = _tols(dtype)[0]
    assert np.isfinite(r["loss"])
    assert abs(r["loss"] - r["ref_loss"]) <= rtol * abs(r["ref_loss"])


@pytest.mark.parametrize("arch,dtype", VARIANTS, ids=IDS)
def test_grads_match_reference_per_leaf(arch, dtype):
    r = model_case(arch, dtype)
    tol = _tols(dtype)[2]
    assert len(r["grads"]) == len(r["ref_grads"]) == 12
    for i, (want, got) in enumerate(zip(r["ref_grads"], r["grads"])):
        assert got.shape == want.shape, i
        assert scaled_err(want, got) <= tol, (i, scaled_err(want, got))


@pytest.mark.parametrize("arch,dtype", VARIANTS, ids=IDS)
def test_prefill_logits_and_caches_match_reference(arch, dtype):
    r = model_case(arch, dtype)
    want, got = r["prefill"]
    if dtype == "float32":
        assert scaled_err(want, got) <= RTOL
    else:
        assert float(np.abs(want - got).max()) <= BF16_ATOL_LOGITS
    (rk, rv, rlen, rl), (k, v, lens, length) = r["caches"]
    assert k.shape == rk.shape and v.shape == rv.shape
    assert np.array_equal(lens, rlen) and int(length) == int(rl)
    # keys and values in the compute dtype after RoPE; the padded tail zero
    tol = RTOL if dtype == "float32" else 2 ** -6
    assert scaled_err(rk, k) <= tol and scaled_err(rv, v) <= tol
    assert not k[:, :, SHAPE[1]:].any() and not v[:, :, SHAPE[1]:].any()


@pytest.mark.parametrize("arch,dtype", VARIANTS, ids=IDS)
def test_eight_decode_steps_match_reference(arch, dtype):
    r = model_case(arch, dtype)
    assert r["decode_len"] == (SHAPE[1] + 8,) * 2
    for i, (want, got) in enumerate(r["decode"]):
        if dtype == "float32":
            assert scaled_err(want, got) <= RTOL, i
        else:
            assert float(np.abs(want - got).max()) <= BF16_ATOL_LOGITS, i


def test_module_forward_is_the_loss_on_its_parameters():
    cfg = TC.get_smoke_config("stablelm-3b")
    m = build_model(cfg)
    params = m.init(0, device=CPU)
    m.load_params(params)
    batch = make_batch(cfg, ShapeConfig("s", "train", 16, 2), 0, device=CPU)
    assert sorted(n for n, _ in m.named_parameters()) == sorted(
        ["top.embed", "top.final_ln", "top.head"]
        + [f"layers.{k}" for k in params["layers"]])
    kw = dict(ce_chunk=8, attn_chunk=8)
    with torch.no_grad():
        assert float(m(batch, **kw)) == float(m.loss(params, batch, **kw))
    assert m.params_tree()["layers"]["wq"].data_ptr() == \
        params["layers"]["wq"].data_ptr()


def test_entry_points_default_to_the_card():
    """``device=None`` is the CUDA card: without one the model, the data
    pipeline and the launchers' default refuse rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None is valid here")
    from repro_torch.launch import serve, train, train_100m

    cfg = TC.get_smoke_config("smollm-135m")
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(cfg, ShapeConfig("s", "train", 8, 1), 0)
    assert train.parse_args(["--arch", "smollm-135m"]).device == "cuda"
    assert serve.parse_args(["--arch", "smollm-135m"]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_100m.main(["--steps", "1"])
