"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``), on the CPU.

The reference runs with no mesh; its intermediates are read by wrapping
the module's ``shard`` (an identity without a mesh), which every step of
``moe_ffn`` passes through: the router's gates and experts, the flat
expert ids, the sort's ``order``, the sorted ids, each assignment's rank
``pos``, the contributions and the combined output. Both sides take the
reference's parameters (through ``interop``) and the same numpy inputs.

Tolerances: f32 outputs and aux to 1e-5 of their scale (the expert
products sum their terms in another order than XLA's); the dispatch
(experts, order, slots, keep, tokens) bitwise; the combine bitwise on the
same contributions (an ordered fold, as XLA applies its scatter).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.core import sparse as RS
from repro.models import moe as RM
from repro_torch import configs as TC
from repro_torch import interop
from repro_torch import tree as TR
from repro_torch.core import sparse as TS
from repro_torch.kernels import xla_float
from repro_torch.models import moe as TM

CPU = "cpu"
MOE = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e")
RTOL = 1e-5
#: (arch, capacity_factor, top-k or None for the config's): the smoke
#: configs' drop-free 8.0, a dropping 0.5 and 0.25, and Moonshot's full
#: top-6 on the smoke width.
CASES = [("moonshot-v1-16b-a3b", 8.0, None), ("moonshot-v1-16b-a3b", 0.5,
                                              None),
         ("moonshot-v1-16b-a3b", 0.25, 6), ("moonshot-v1-16b-a3b", 1.25, 6),
         ("llama4-scout-17b-a16e", 8.0, None),
         ("llama4-scout-17b-a16e", 0.5, None)]
IDS = [f"{a.split('-')[0]}-cf{c}-k{k or 'cfg'}" for a, c, k in CASES]


def scaled_err(ref, got) -> float:
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    return float(np.abs(ref - got).max()) / (float(np.abs(ref).max()) or 1.0)


def configs(arch, cf, k):
    kw = {"capacity_factor": cf}
    if k is not None:
        kw["moe_topk"] = k
    return (dataclasses.replace(RC.get_smoke_config(arch), **kw),
            dataclasses.replace(TC.get_smoke_config(arch), **kw))


def ref_moe(p, x, cfg, monkeypatch):
    """The reference's ``moe_ffn`` and its intermediates."""
    seen = []

    def recording(a, *logical):
        seen.append(a)
        return a

    monkeypatch.setattr(RM, "shard", recording)
    y, aux = RM.moe_ffn(p, x, cfg)
    monkeypatch.undo()
    names = ("xf", "probs", "gate", "expert", "flat_e", "order", "sorted_e",
             "pos", "buf", "h", "out_buf", "contrib", "y")
    assert len(seen) == len(names)
    got = dict(zip(names, (np.asarray(a) for a in seen)))
    C = RM.capacity_for(x.shape[0] * x.shape[1], cfg)
    got["keep"] = got["pos"] < C
    got["slot"] = got["sorted_e"] * C + got["pos"]
    got["tok"] = got["order"] // cfg.moe_topk
    return np.asarray(y), float(aux), got


def draw(cfg, seed=0, B=2, S=24):
    p = RM.init_moe_params(jax.random.PRNGKey(seed), cfg)
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return p, interop.params_from_numpy(jax.tree.map(np.asarray, p), CPU), x


@pytest.mark.parametrize("arch,cf,k", CASES, ids=IDS)
def test_moe_ffn_matches_reference(arch, cf, k, monkeypatch):
    rcfg, cfg = configs(arch, cf, k)
    rp, tp, x = draw(rcfg)
    want, want_aux, _ = ref_moe(rp, jnp.asarray(x), rcfg, monkeypatch)
    got, aux = TM.moe_ffn(tp, torch.from_numpy(x), cfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert scaled_err(want, got) <= RTOL
    assert abs(float(aux) - want_aux) <= RTOL * abs(want_aux)


@pytest.mark.parametrize("arch,cf,k", CASES, ids=IDS)
def test_dispatch_bitwise(arch, cf, k, monkeypatch):
    """The router's experts and the sort-based dispatch, bitwise; the
    dropping cases drop some assignments, the others none."""
    rcfg, cfg = configs(arch, cf, k)
    rp, tp, x = draw(rcfg, seed=1)
    _, _, ref = ref_moe(rp, jnp.asarray(x), rcfg, monkeypatch)
    T = x.shape[0] * x.shape[1]
    xf = torch.from_numpy(x).reshape(T, -1)
    probs, gate, expert = TM.route(tp["router"], xf, cfg.moe_topk)
    assert np.array_equal(expert.numpy(), ref["expert"])
    assert scaled_err(ref["gate"], gate) <= RTOL
    assert scaled_err(ref["probs"], probs) <= RTOL
    C = TM.capacity_for(T, cfg)
    d = TM.dispatch(expert, cfg.n_experts, C)
    for name in ("order", "slot", "keep", "tok"):
        assert np.array_equal(getattr(d, name).numpy(), ref[name]), name
    assert (not ref["keep"].all()) == (cf < 1.0)
    # the expert buffer the slots gather
    buf = (xf[d.src_tok] * d.slot_valid[:, None]).reshape(ref["buf"].shape)
    assert np.array_equal(buf.numpy(), ref["buf"])


@pytest.mark.parametrize("arch,cf,k", CASES, ids=IDS)
def test_combine_bitwise_on_reference_contributions(arch, cf, k,
                                                    monkeypatch):
    """The combine of the reference's own contributions, laid out token by
    token, equals its ``y.at[tok].add(contrib)`` bitwise (XLA folds each
    token's contributions in operand order)."""
    rcfg, cfg = configs(arch, cf, k)
    rp, tp, x = draw(rcfg, seed=2)
    _, _, ref = ref_moe(rp, jnp.asarray(x), rcfg, monkeypatch)
    T, K = x.shape[0] * x.shape[1], cfg.moe_topk
    d = TM.dispatch(torch.from_numpy(ref["expert"].copy()), cfg.n_experts,
                    TM.capacity_for(T, cfg))
    pos = TM.token_order(d, T, K).reshape(-1)
    # the reference's gather of expert outputs, times each sorted gate
    gated = ref["contrib"] * ref["gate"].reshape(-1)[ref["order"]][:, None]
    contrib = torch.from_numpy(gated)[pos]
    contrib = torch.where(d.keep[pos, None], contrib, 0.0)
    y = TM.combine(contrib.reshape(T, K, -1))
    assert np.array_equal(y.numpy().view(np.int32),
                          ref["y"].view(np.int32))


def test_token_order_is_stream_order_within_each_token():
    rng = np.random.default_rng(3)
    T, K, E = 40, 6, 16
    expert = torch.from_numpy(np.stack([rng.permutation(E)[:K]
                                        for _ in range(T)]))
    d = TM.dispatch(expert, E, 8)
    pos = TM.token_order(d, T, K)
    assert torch.equal(d.tok[pos], torch.arange(T)[:, None].expand(T, K))
    assert bool((pos[:, 1:] > pos[:, :-1]).all())  # ascending stream order
    # ascending stream order within a token is ascending expert id
    sorted_e = expert.reshape(-1)[d.order]
    assert torch.equal(sorted_e[pos], expert.sort(dim=1).values)


def left_to_right(contrib: np.ndarray) -> np.ndarray:
    """A numpy fold, one element at a time: y = ((+0 + c0) + c1) + ...
    with XLA's flushing f32 add."""
    T, K, d = contrib.shape
    y = np.zeros((T, d), np.float32)
    for t in range(T):
        for j in range(d):
            acc = np.float32(0.0)
            for r in range(K):
                acc = xla_float.add_scalar(acc, contrib[t, r, j])
            y[t, j] = acc
    return y


def edge_contributions(seed, T=24, K=6, d=16):
    """Normals with planted exact cancellations, signed zeros, subnormals,
    ties and a NaN."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((T, K, d)).astype(np.float32)
    c[0, 1] = -c[0, 0]                    # exact cancellation
    c[1] = -0.0                           # all -0.0: the sum stays +0.0
    c[2, :, :4] = np.float32(1e-40)       # subnormals flush
    c[3, :, 4:8] = np.float32(2.0 ** -24)  # ties at rounding
    c[3, 0, 4:8] = 1.0
    c[4, 2, 9] = np.nan
    return c


@pytest.mark.parametrize("seed", [0, 1])
def test_combine_plain_path_bitwise_to_a_left_to_right_fold(seed):
    c = edge_contributions(seed)
    want = left_to_right(c)
    got = TM.combine(torch.from_numpy(c))
    plain = TM.combine_plain(torch.from_numpy(c))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert np.array_equal(plain.numpy().view(np.int32), want.view(np.int32))
    assert np.signbit(got[1].numpy()).sum() == 0


def test_combine_bf16_rounds_after_every_add():
    c = torch.from_numpy(edge_contributions(4)).to(torch.bfloat16)
    got, plain = TM.combine(c), TM.combine_plain(c)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), plain.view(torch.int16))
    # one rounding at the end would differ somewhere
    once = c.float().sum(1).to(torch.bfloat16)
    assert not torch.equal(got.view(torch.int16), once.view(torch.int16))


def test_combine_gradient_is_each_tokens():
    c = torch.from_numpy(edge_contributions(5)).nan_to_num().requires_grad_()
    dy = torch.randn(c.shape[0], c.shape[2])
    (TM.combine(c) * dy).sum().backward()
    assert torch.equal(c.grad, dy[:, None, :].expand_as(c))


@pytest.mark.parametrize("arch", MOE)
def test_router_ties_pick_the_lower_experts(arch, monkeypatch):
    """An all-zero router: every probability equal; both packages pick
    experts 0..K-1 for every token, in that order."""
    rcfg, cfg = configs(arch, 8.0, 6 if arch.startswith("moonshot") else None)
    rp, tp, x = draw(rcfg)
    rp = dict(rp, router=jnp.zeros_like(rp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    _, _, ref = ref_moe(rp, jnp.asarray(x), rcfg, monkeypatch)
    T = x.shape[0] * x.shape[1]
    _, gate, expert = TM.route(tp["router"], torch.from_numpy(x).reshape(
        T, -1), cfg.moe_topk)
    want = np.broadcast_to(np.arange(cfg.moe_topk), (T, cfg.moe_topk))
    assert np.array_equal(ref["expert"], want)
    assert np.array_equal(expert.numpy(), want)
    assert np.array_equal(gate.numpy(), ref["gate"])
    y, aux = TM.moe_ffn(tp, torch.from_numpy(x), cfg)
    want_y, want_aux, _ = ref_moe(rp, jnp.asarray(x), rcfg, monkeypatch)
    assert scaled_err(want_y, y) <= RTOL
    assert abs(float(aux) - want_aux) <= RTOL * abs(want_aux)


@pytest.mark.parametrize("arch", MOE)
def test_one_counted_sort_a_call(arch):
    rcfg, cfg = configs(arch, 0.5, None)
    rp, tp, x = draw(rcfg)
    r0 = RS.sort_calls()
    RM.moe_ffn(rp, jnp.asarray(x), rcfg)
    t0 = TS.sort_calls()
    TM.moe_ffn(tp, torch.from_numpy(x), cfg)
    assert TS.sort_calls() - t0 == RS.sort_calls() - r0 == 1


def test_a_remat_loss_counts_one_sort_a_layer_forward():
    """Backward's recomputation of a layer repeats its sort uncounted: a
    loss and gradient of the two-layer smoke model counts two sorts."""
    from repro_torch.models import build_model

    cfg = TC.get_smoke_config("moonshot-v1-16b-a3b")
    model = build_model(cfg)
    leaves, treedef = TR.flatten(model.init(0, device=CPU))
    leaves = [x.requires_grad_() for x in leaves]
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 17), dtype=np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    t0 = TS.sort_calls()
    loss = model.loss(TR.unflatten(treedef, leaves), batch, remat=True,
                      ce_chunk=8, attn_chunk=8)
    assert TS.sort_calls() - t0 == cfg.n_layers
    torch.autograd.grad(loss, leaves)
    assert TS.sort_calls() - t0 == cfg.n_layers


@pytest.mark.parametrize("arch,getter", [
    (a, g) for a in MOE for g in ("get_config", "get_smoke_config")])
@pytest.mark.parametrize("tokens", [1, 7, 8 * 2048, 4096, 3 * 512])
def test_capacity_for(arch, getter, tokens):
    rcfg, cfg = getattr(RC, getter)(arch), getattr(TC, getter)(arch)
    assert TM.capacity_for(tokens, cfg) == RM.capacity_for(tokens, rcfg)


@pytest.mark.parametrize("arch", MOE)
def test_init_moe_params_tree(arch):
    rcfg, cfg = RC.get_smoke_config(arch), TC.get_smoke_config(arch)
    want = jax.eval_shape(lambda k: RM.init_moe_params(k, rcfg),
                          jax.random.PRNGKey(0))
    got = TM.init_moe_params(torch.Generator().manual_seed(0), cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32
    # std 1 / sqrt(fan_in): d for we1/we3 and the router, d_ff for we2
    assert abs(float(got["we2"].std()) - cfg.d_ff ** -0.5) < 0.02


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_grads_match_reference(arch):
    rcfg, cfg = configs(arch, 0.5, None)
    rp, tp, x = draw(rcfg, seed=6)
    w = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def ref_obj(p, xx):
        y, aux = RM.moe_ffn(p, xx, rcfg)
        return jnp.sum(y * w) + aux

    rg, rgx = jax.grad(ref_obj, argnums=(0, 1))(rp, jnp.asarray(x))
    leaves, treedef = TR.flatten(tp)
    leaves = [a.requires_grad_() for a in leaves]
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = TM.moe_ffn(TR.unflatten(treedef, leaves), xt, cfg)
    obj = (y * torch.from_numpy(w)).sum() + aux
    grads = torch.autograd.grad(obj, leaves + [xt])
    for want, got in zip(jax.tree.leaves(rg) + [rgx], grads):
        assert scaled_err(want, got) <= 1e-4
