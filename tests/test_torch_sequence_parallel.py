"""Sequence parallelism (``use_sp``) on the CPU.

Under ``cfg.use_sp`` the ``TransformerLM`` families compute each rank's
block of S / model positions in the sharded train step and the placed
prefill, as the reference's ``seq_sp`` hints lay the residual stream out:
the weights gathered whole at use, q on every head at the block's global
positions, k and v all-gathered along the sequence, the embedding's
partial lookups reduce-scattered along it, the MoE and the loss on the
whole sequence all-gathered (``repro_torch.sharding.api``: ``seq_split``,
``gather_seq``, ``gather_seq_equal``, ``scatter_seq``, ``slice_seq``). In
gloo worlds of 1, 2 and 4 ranks (one ``spawn_world`` a world size, run at
once; rank bodies in ``tests/_torch_world.py``), on ``("data", "model")``
meshes (1, 2), (2, 2) and (1, 4), and gemma3's also on a ``("pod",
"data", "model")`` mesh (2, 1, 2), the smoke configs of StableLM,
InternLM2 (GQA), SmolLM (3 heads, split by rows here), gemma3 (its
window of 8 below the sequence of 32), Qwen2-VL (patch embeddings, M-RoPE
positions of three distinct streams), Moonshot and Llama4-Scout (MoE),
against the reference's unsharded ``jit`` step with ``use_sp=True``
(``shard`` is a no-op there; its gemma3 switch, no banded local path under
SP, applies):

- the loss and every leaf's gradient of the first step (the sharded
  step's ``sharded_loss_and_grads``), and the params, moments and metrics
  after two steps, within ``tests/test_torch_train_step.py``'s
  tolerances; the same bits on every rank;
- each rank's residual stream (B / data, S / model, d), each attention's
  q (B / data, S / model, H, head_dim), the MoE's input the whole
  sequence (B / data, S, d); no all-reduce of a (rows, S, d) activation
  among the first step's collectives, which include the all-gathers of k
  and v along the sequence;
- at world 1 the step bitwise to the plain step with ``use_sp=True``;
- the placed prefill of StableLM, gemma3 and Moonshot on (1, 2) and (1,
  4), and of Qwen2-VL's patch embeddings on (1, 2), then four decoded
  tokens: the logits and the caches within
  ``RTOL`` of the reference's unsharded prefill and decode steps, each
  cache shard on ``cache_shardings``' region, the logits the same bits on
  every rank; the tokens decoded from its caches bitwise those the model
  without ``use_sp`` decodes from them (decode is the same step under
  ``use_sp``);
- a sequence the ``model`` ranks do not divide raises ``ValueError`` in
  the train step and in prefill.
"""
import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_world as W
from repro.configs import get_smoke_config as ref_smoke
from repro.models import build_model as ref_build_model
from repro.optim import adamw_init as ref_adamw_init
from repro.train import TrainHParams as RefHP
from repro.train import make_decode_step as ref_make_decode_step
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.launch.world import spawn_world
from repro_torch.optim import cosine_schedule
from repro_torch.train import TrainHParams
from test_torch_families import RTOL, scaled_err
from test_torch_train_step import (RTOL_METRIC, TOL, assert_leaves_close,
                                   ref_params)

WORLD_TIMEOUT_S = 240
CASES = sorted(k for k, (_, m) in W.SP_CASES.items() if m != (1, 1))
ONE = sorted(k for k, (_, m) in W.SP_CASES.items() if m == (1, 1))
PREFILL = sorted(W.SP_PREFILL_CASES)


@functools.lru_cache(maxsize=None)
def ref_train(arch: str) -> dict:
    """The reference's unsharded step under ``use_sp=True``: the loss and
    gradients of the first batch, then the params, moments and metrics
    after :data:`W.TP_STEPS` steps."""
    model = ref_build_model(W.sp_config(arch, ref_smoke))
    hp = RefHP(**W.TRAIN_HP)
    p = ref_params(arch)

    def loss_fn(params, batch):
        return model.loss(params, batch, remat=hp.remat,
                          ce_chunk=hp.ce_chunk, attn_chunk=hp.attn_chunk)

    def batch_of(s):
        return {k: jnp.asarray(v)
                for k, v in W.tp_batch(s, model.cfg).items()}

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(p, batch_of(0))
    step = jax.jit(ref_make_train_step(model, hp))
    o = ref_adamw_init(p)
    mets = []
    for s in range(W.TP_STEPS):
        p, o, met = step(p, o, batch_of(s))
        mets.append({k: float(v) for k, v in met.items()})
    return {"loss": float(loss),
            "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
            "params": jax.tree.leaves(p), "mu": jax.tree.leaves(o.mu),
            "nu": jax.tree.leaves(o.nu), "metrics": mets}


@functools.lru_cache(maxsize=None)
def ref_serving(arch: str) -> list:
    """The reference's unsharded prefill (``use_sp=True``, with
    ``max_len``) and decode steps under ``jit`` on :func:`W.serve_inputs`:
    ``(logits, cache leaves)`` a step."""
    rm = ref_build_model(W.sp_config(arch, ref_smoke))
    rp = ref_params(arch)
    batch, toks = W.serve_inputs(rm.cfg)
    B, S = W.SERVE_BATCH
    prefill = jax.jit(functools.partial(
        rm.prefill, max_len=S + W.SERVE_TOKENS, attn_chunk=W.SERVE_CHUNK))
    decode = jax.jit(ref_make_decode_step(rm, attn_chunk=W.SERVE_CHUNK))
    logits, caches = prefill(rp, **{k: jnp.asarray(v)
                                    for k, v in batch.items()})
    out = [(logits, caches)]
    for t in toks:
        logits, caches = decode(rp, caches, jnp.asarray(t))
        out.append((logits, caches))
    return [(np.asarray(lg), [np.asarray(x) for x in jax.tree.leaves(c)])
            for lg, c in out]


@pytest.fixture(scope="module")
def worlds():
    """``{world size: [each rank's results]}``, every world
    (:data:`W.SP_WORLDS`) at once, the reference's steps computed while
    they run."""
    by_arch = {a: jax.tree.map(np.asarray, ref_params(a))
               for a in W.SP_ARCHS}
    runs = [(n, part) for n, parts in W.SP_WORLDS.items()
            for part in range(parts)]
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        futs = {run: pool.submit(spawn_world, W.sequence_parallel_rank,
                                 run[0], by_arch, run[1],
                                 timeout=WORLD_TIMEOUT_S) for run in runs}
        for a in W.SP_ARCHS:
            ref_train(a)
        for a in sorted({a for a, _ in W.SP_PREFILL_CASES.values()}):
            ref_serving(a)
        out = {n: [{} for _ in range(n)] for n in W.SP_WORLDS}
        for (n, _), fut in futs.items():
            for merged, res in zip(out[n], fut.result()):
                merged.update(res)
        return out


def ranks_of(worlds, case, cases=W.SP_CASES, prefix=""):
    shape = cases[case][1]
    return [r[prefix + case] for r in worlds[int(np.prod(shape))]]


def lr_sum() -> float:
    hp = W.TRAIN_HP
    return sum(float(cosine_schedule(
        torch.tensor(s), peak_lr=TrainHParams().peak_lr,
        warmup=hp["warmup"], total=hp["total_steps"]))
        for s in range(W.TP_STEPS))


def rows_and_block(case):
    """``(B / data, S / model)`` of a case's mesh."""
    shape = W.SP_CASES[case][1]
    B, S = W.TRAIN_BATCH
    return B // int(np.prod(shape[:-1])), S // shape[-1]


@pytest.mark.parametrize("case", CASES)
def test_loss_and_gradients_match_reference(worlds, case):
    ref = ref_train(W.SP_CASES[case][0])
    for rank, res in enumerate(ranks_of(worlds, case)):
        what = f"{case} rank {rank}"
        assert abs(res["loss"] - ref["loss"]) <= RTOL_METRIC * abs(
            ref["loss"]), what
        assert_leaves_close(ref["grads"], res["grads"], what=what + " grads")


@pytest.mark.parametrize("case", CASES)
def test_two_steps_match_reference(worlds, case):
    ref = ref_train(W.SP_CASES[case][0])
    for rank, res in enumerate(ranks_of(worlds, case)):
        what = f"{case} rank {rank}"
        assert_leaves_close(ref["params"], res["params"],
                            what=what + " params", lr_sum=lr_sum())
        assert_leaves_close(ref["mu"], res["mu"], what=what + " mu")
        assert_leaves_close(ref["nu"], res["nu"], what=what + " nu")
        for s, (want, got) in enumerate(zip(ref["metrics"],
                                            res["metrics"])):
            for k in ("loss", "grad_norm", "lr"):
                assert abs(got[k] - want[k]) <= RTOL_METRIC * abs(want[k]), \
                    (what, s, k)


@pytest.mark.parametrize("case", CASES)
def test_every_rank_holds_the_same_bits(worlds, case):
    ranks = ranks_of(worlds, case)
    for res in ranks[1:]:
        assert res["loss"] == ranks[0]["loss"]
        for a, b in zip(ranks[0]["metrics"], res["metrics"]):
            assert a["grad_norm_bits"] == b["grad_norm_bits"]
            assert a["loss"] == b["loss"]
        for kind in ("grads", "params", "mu", "nu"):
            for a, b in zip(ranks[0][kind], res[kind]):
                assert a.tobytes() == b.tobytes(), kind


@pytest.mark.parametrize("case", CASES)
def test_blocks_run_on_this_ranks_positions(worlds, case):
    """Every layer's residual stream (B / data, S / model, d), every q
    (B / data, S / model, H, head_dim), every MoE input the whole
    sequence (B / data, S, d)."""
    cfg = get_smoke_config(W.SP_CASES[case][0])
    rows, block = rows_and_block(case)
    d = cfg.d_model
    for res in ranks_of(worlds, case):
        assert res["residual"] == [(rows, block, d)]
        assert res["queries"] == [(rows, block, cfg.n_heads, cfg.head_dim)]
        want = ([(rows, W.TRAIN_BATCH[1], d)] if cfg.family == "moe"
                else [])
        assert res["moe_inputs"] == want


@pytest.mark.parametrize("case", CASES)
def test_no_activation_is_all_reduced(worlds, case):
    """Among the first step's collectives: no all-reduce of a (rows, s,
    d) activation (tensor parallelism sums each block's output over
    ``model`` so), and the all-gathers of each layer's k and v, (rows, S /
    model, kv heads, head_dim), along the sequence."""
    cfg = get_smoke_config(W.SP_CASES[case][0])
    rows, block = rows_and_block(case)
    kv = (rows, block, cfg.n_kv_heads, cfg.head_dim)
    for res in ranks_of(worlds, case):
        reduced = [s for kind, shapes in res["collectives"]
                   if kind == "all-reduce" for s in shapes]
        assert not [s for s in reduced
                    if len(s) == 3 and s[0] == rows and s[2] == cfg.d_model]
        gathered = [s for kind, shapes in res["collectives"]
                    if kind == "all-gather" for s in shapes]
        assert gathered.count(kv) >= 2 * cfg.n_layers, gathered


@pytest.mark.parametrize("case", ONE)
def test_world_one_is_bitwise_the_plain_step(worlds, case):
    (res,) = ranks_of(worlds, case)
    plain = res["plain"]
    for a, b in zip(res["metrics"], plain["metrics"]):
        assert a["grad_norm_bits"] == b["grad_norm_bits"]
        assert a["loss"] == b["loss"]
    for kind in ("params", "mu", "nu"):
        for a, b in zip(res[kind], plain[kind]):
            assert a.tobytes() == b.tobytes(), kind


@pytest.mark.parametrize("case", PREFILL)
def test_prefill_matches_reference(worlds, case):
    ref = ref_serving(W.SP_PREFILL_CASES[case][0])
    for rank, res in enumerate(ranks_of(worlds, case, W.SP_PREFILL_CASES,
                                        "prefill/")):
        for i, ((rlog, rc), got) in enumerate(zip(ref, res["steps"])):
            what = f"{case} rank {rank} step {i}"
            assert scaled_err(rlog, got["logits"]) <= RTOL, what
            assert len(rc) == len(got["caches"]), what
            for j, (a, b) in enumerate(zip(rc, got["caches"])):
                assert a.shape == b.shape, (what, j)
                if np.issubdtype(a.dtype, np.integer):
                    assert np.array_equal(a, b), (what, j)
                else:
                    assert scaled_err(a, b) <= RTOL, (what, j)


@pytest.mark.parametrize("case", PREFILL)
def test_prefill_caches_lie_on_cache_shardings(worlds, case):
    ranks = ranks_of(worlds, case, W.SP_PREFILL_CASES, "prefill/")
    for res in ranks:
        for i, step in enumerate(res["steps"]):
            assert all(step["on_shardings"]), (case, i)
            assert (step["local_logits"].tobytes()
                    == ranks[0]["steps"][i]["local_logits"].tobytes())


@pytest.mark.parametrize("case", PREFILL)
def test_decode_from_the_prefill_is_the_plain_decode(worlds, case):
    for res in ranks_of(worlds, case, W.SP_PREFILL_CASES, "prefill/"):
        for got, want in zip(res["steps"][1:], res["decoded_without_sp"]):
            assert got["local_logits"].tobytes() == want.tobytes()


@pytest.mark.parametrize("what", ["train", "prefill"])
def test_a_sequence_the_ranks_do_not_divide_is_refused(worlds, what):
    for res in worlds[4]:
        kind, msg = res["refused"][what]
        assert kind == "ValueError", (kind, msg)
        assert str(W.SP_ODD_SEQ) in msg and "4 model ranks" in msg
